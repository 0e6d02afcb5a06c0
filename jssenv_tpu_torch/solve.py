"""Schedule search: massively parallel noisy dispatching rollouts, refined in
order space.

The PyTorch counterpart of ``jssenv_tpu/solve.py``. Thousands of lanes roll
out in lockstep on the card, each following a dispatching rule from a
portfolio with Gumbel noise on its standardized priority key (a GRASP-style
randomized multi-start), and the best complete schedule of each lane is
kept. With ``refine_iters > 0`` those schedules seed simulated annealing or
tabu search in order space (:mod:`jssenv_tpu_torch.anneal`), and the refined
winner is certified by replaying its machine order through the exact
environment semantics.

The returned schedule is a replayable artifact: ``SolveResult.machine_order()``
gives the per-machine job order of the reference's golden-solution tests, and
``replay.replay_machine_order`` reproduces the claimed makespan.

The rollout steps the eager ``core.engine.step`` on the full state (not the
driven kernel, which resets finished lanes inside the launch and would lose
the finished episode's ``solution``). Its random draws come from a
``torch.Generator`` seeded with ``seed``; they are not ``jax.random``'s, so
noisy lanes agree with the JAX package in distribution only, while the first
``num_rules`` lanes (temperature 0, pure greedy) agree exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Union

import numpy as np
import torch

from jssenv_tpu_torch import anneal, replay, vector
from jssenv_tpu_torch.core import engine
from jssenv_tpu_torch.core.state import I32_MAX, Device, EnvState, resolve_device
from jssenv_tpu_torch.instances import InstanceSet, InstanceSpec
from jssenv_tpu_torch.rules import dispatching as rules

# portfolio entries: (name, priority function, minimize?) — the seven
# reference rules, the strongest makespan rules first
_PORTFOLIO = (
    ("SPT", rules.current_op_duration, True),
    ("MWR", rules.remaining_work, False),
    ("MOR", rules.remaining_ops, False),
    ("FIFO", rules.idle_since_last_op, False),
    ("CR", rules.critical_ratio, True),
    ("LWR", rules.remaining_work, True),
    ("LOR", rules.remaining_ops, True),
)


@dataclasses.dataclass
class SolveResult:
    """Best schedule found: integer makespan + (J, M) op start-time matrix."""

    makespan: int
    solution: np.ndarray  # (num_jobs, num_machines) start time of op k of job j
    episodes: int  # completed episodes searched
    op_machine: np.ndarray  # (num_jobs, num_machines) machine of op k (static)
    # host-clock seconds per stage, the card synchronised before each
    # reading: rollout, refine (order-space search), certify (replay of the
    # refined winner)
    timings: dict = dataclasses.field(default_factory=dict)

    def machine_order(self) -> list:
        """Per-machine job order (the reference golden-solution format):
        entry m lists job ids in increasing start time on machine m."""
        J, M = self.solution.shape
        orders = []
        for m in range(M):
            starts = []
            for j in range(J):
                k = int(np.where(self.op_machine[j] == m)[0][0])
                starts.append((int(self.solution[j, k]), j))
            orders.append([j for _, j in sorted(starts)])
        return orders


def _score(state: EnvState, rule_ids: torch.Tensor, noise: torch.Tensor, temps: torch.Tensor,
           num_rules: int) -> torch.Tensor:
    """(B, J) per-lane scores: the lane's portfolio priority, standardized
    over its legal jobs, plus ``temps``-scaled Gumbel noise."""
    prios = []
    for _, fn, minimize in _PORTFOLIO[:num_rules]:
        p = fn(state).to(torch.float32)
        prios.append(-p if minimize else p)
    stack = torch.stack(prios, dim=1)  # (B, R, J)
    p = stack.gather(1, rule_ids[:, None, None].expand(-1, 1, stack.shape[2]))[:, 0]
    legal = state.legal
    n = legal.sum(dim=1).clamp(min=1).to(torch.float32)
    mean = torch.where(legal, p, 0.0).sum(dim=1) / n
    var = torch.where(legal, (p - mean[:, None]) ** 2, 0.0).sum(dim=1) / n
    p_std = (p - mean[:, None]) * torch.rsqrt(var + 1e-6)[:, None]
    return p_std + temps[:, None] * noise


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve(
    source: Union[InstanceSpec, InstanceSet],
    batch: int = 2048,
    sweeps: int = 4,
    temperature: float = 0.7,
    num_rules: int = 5,
    seed: int = 0,
    refine_iters: int = 0,
    anneal_t0: float = 0.08,
    anneal_t1: float = 0.004,
    refine_method: str = "anneal",
    tabu_chains: int = 128,
    tabu_proposals: int = 8,
    tabu_neighborhood: str = "sampled",
    tabu_guided_temp: float = 4.0,
    device: Device = None,
) -> SolveResult:
    """Search for a low-makespan schedule with ``batch`` parallel noisy
    rollouts for ``sweeps`` episodes each, on ``device`` (the card unless
    ``device="cpu"``).

    ``refine_iters > 0`` adds a second stage in order space and certifies
    its winner by replay (module docstring): ``refine_method="anneal"``
    anneals every lane's best schedule (``anneal_t0`` / ``anneal_t1``: the
    temperature schedule as fractions of the seed makespan); ``"tabu"``
    runs ``anneal.tabu_search`` from the ``tabu_chains`` best distinct
    rollout schedules, ``tabu_proposals`` proposals an iteration in the
    ``tabu_neighborhood`` (``"sampled"``, ``"full"`` or ``"guided"``).

    The first ``num_rules`` lanes run their rule pure-greedy, so the result
    is never worse than the best of the first ``num_rules`` portfolio rules;
    the other lanes spread temperatures geometrically from 0.5 to 2 times
    ``temperature``. One instance per call: makespans of different
    instances are not comparable."""
    if isinstance(source, InstanceSet) and len(source) > 1:
        raise ValueError(
            "solve() searches one instance; loop over the set and call it "
            "per instance (makespans of different instances are not comparable)"
        )
    dev = resolve_device(device)
    state = vector.make_batch(source, batch, device=dev)
    J, M = int(state.num_jobs.max()), int(state.num_machines.max())
    steps = J * M * int(sweeps) + 8  # no-op-free episodes take J*M agent steps
    _sync(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    best_mk, best_sol, episodes = _solve_scan(state, gen, steps, float(temperature),
                                              int(min(num_rules, len(_PORTFOLIO))))
    best_mk_h = best_mk.cpu().numpy()
    rollout_s = time.perf_counter() - t0
    lane = int(np.argmin(best_mk_h))
    if best_mk_h[lane] == I32_MAX:
        raise RuntimeError("no episode completed; increase sweeps or batch")
    nj, nm = int(state.num_jobs[lane]), int(state.num_machines[lane])
    result = SolveResult(
        makespan=int(best_mk_h[lane]),
        solution=best_sol[lane, :nj, :nm].cpu().numpy(),
        episodes=int(episodes),
        op_machine=state.op_machine[lane, :nj, :nm].cpu().numpy().astype(np.int32),
        timings={"rollout_s": rollout_s},
    )
    if refine_iters > 0:
        result = _refine(
            state, best_sol, result, int(refine_iters), int(seed),
            float(anneal_t0), float(anneal_t1), refine_method,
            int(tabu_chains), int(tabu_proposals), tabu_neighborhood,
            float(tabu_guided_temp),
        )
    return result


def top_k_distinct_orders(orders, mks, k: int) -> torch.Tensor:
    """Seed orders for refinement, on the host: the k best distinct
    machine-order schedules of a lane batch (duplicates collapse to one
    entry, infeasible lanes are skipped, a short set tiles round-robin).
    Distinct seeds keep the chains exploring different basins. The result
    is an int32 tensor on ``orders``' device."""
    orders = anneal._tensor(orders)
    host_orders = orders.cpu().numpy()
    mk = anneal._tensor(mks).cpu().numpy()
    seen = {}
    for lane in np.argsort(mk, kind="stable"):
        if mk[lane] >= I32_MAX:
            continue
        key = host_orders[lane].tobytes()
        if key not in seen:
            seen[key] = lane
        if len(seen) >= k:
            break
    lanes = list(seen.values())
    if not lanes:
        raise RuntimeError("no feasible rollout schedule to seed refinement")
    idx = np.asarray([lanes[i % len(lanes)] for i in range(k)])
    return torch.from_numpy(host_orders[idx]).to(orders.device, torch.int32)


def _refine(state, best_sol, rollout_result, iters, seed,
            t0_frac=0.08, t1_frac=0.004, method="anneal",
            tabu_chains=128, tabu_proposals=8,
            tabu_neighborhood="sampled",
            tabu_guided_temp=4.0) -> SolveResult:
    """Refine the rollout schedules in order space (annealing or tabu) and
    certify the refined winner through the exact engine (module
    docstring)."""
    if method not in ("anneal", "tabu"):
        raise ValueError(f"bad refine_method {method!r}")
    dev = state.device
    _sync(dev)
    t0 = time.perf_counter()
    op_machine, op_dur, op_pos = state.op_machine[0], state.op_dur[0], state.op_pos[0]
    tables = anneal.schedule_tables(op_machine, op_dur, op_pos, device=dev)
    orders_all = anneal.orders_from_solutions(op_pos, best_sol)
    if method == "tabu":
        mks_all = anneal.evaluate_orders(tables, orders_all)
        seeds_k = top_k_distinct_orders(orders_all, mks_all, tabu_chains)
        best_orders, best_mk = anneal.tabu_search(
            tables, seeds_k, seed + 1, iters,
            proposals=tabu_proposals, neighborhood=tabu_neighborhood,
            guided_temp=tabu_guided_temp,
        )
    else:
        best_orders, best_mk = anneal.anneal(
            tables, orders_all, seed + 1, iters, t0_frac=t0_frac, t1_frac=t1_frac,
        )
    best_mk = best_mk.cpu().numpy()
    rollout_result.timings["refine_s"] = time.perf_counter() - t0
    lane = int(np.argmin(best_mk))
    if int(best_mk[lane]) >= rollout_result.makespan:
        return rollout_result  # refinement found nothing better
    t0 = time.perf_counter()
    order = best_orders[lane].cpu().numpy().tolist()
    nj, nm = rollout_result.solution.shape
    # backend "auto": the scalar C++ engine when it builds (a J*M-step
    # sequential drive costs device round trips per step on the card),
    # else core.engine on the card
    one = torch.tensor([nj], dtype=torch.int32, device=dev)
    certified_mk, final = replay.replay_machine_order(
        engine.init_state(op_machine[None], op_dur[None], one, one.new_tensor([nm])), order, backend="auto"
    )
    _sync(dev)
    rollout_result.timings["certify_s"] = time.perf_counter() - t0
    if certified_mk >= rollout_result.makespan:
        return rollout_result
    sol = final.solution
    sol = sol[0].cpu().numpy() if isinstance(sol, torch.Tensor) else np.asarray(sol)
    return SolveResult(
        makespan=int(certified_mk),
        solution=sol[:nj, :nm],
        episodes=rollout_result.episodes,
        op_machine=rollout_result.op_machine,
        timings=rollout_result.timings,
    )


def _solve_scan(state: EnvState, generator: torch.Generator, steps: int, temperature: float, num_rules: int):
    """``steps`` policy steps of every lane with auto-reset; returns each
    lane's best completed makespan (INT32_MAX where none), its solution
    matrix (-1 where none) and the number of completed episodes."""
    B, jp, dev = state.batch_size, state.jobs_pad, state.device
    lane = torch.arange(B, device=dev)
    rule_ids = lane % num_rules
    # per-lane temperature spread (x0.5 .. x2 around the requested value);
    # the first num_rules lanes are pinned to temperature 0: one pure-greedy
    # elite per rule
    spread = 0.5 * 4.0 ** torch.linspace(0.0, 1.0, B, dtype=torch.float32, device=dev)
    temps = torch.where(lane < num_rules, 0.0, temperature * spread)
    best_mk = torch.full((B,), I32_MAX, dtype=torch.int32, device=dev)
    best_sol = torch.full_like(state.solution, -1)
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(int(steps)):
        noise = anneal._gumbel(generator, (B, jp))
        score = torch.where(state.legal, _score(state, rule_ids, noise, temps, num_rules), -torch.inf)
        a = score.argmax(dim=1).to(torch.int32)
        a = torch.where(state.legal.any(dim=1), a, state.num_jobs)
        new, tr = engine.step(state, a)
        improved = tr.done & (new.time < best_mk)
        best_mk = torch.where(improved, new.time, best_mk)
        best_sol = torch.where(improved[:, None, None], new.solution, best_sol)
        episodes += tr.done.sum()
        state = vector.reset_lanes(new, tr.done)
    return best_mk, best_sol, episodes

"""Training traffic: back-to-back learner updates (``make_train_step``).

A closed loop, one trainer: each update is the port's REINFORCE step (a
``unroll_steps``-step on-policy rollout of every lane, the driven kernel at
T=1 a step, then the loss, backward and Adam), and ends in the host read of
its metrics. On a mesh (``world > 1``) each rank is one process on its own
card, joined as ``learner.train(mesh=...)`` joins them
(``multihost.initialize``, ``make_mesh(dp=world)``, ``host_sharded_batch``),
and the ranks stop together: after each update they agree on whether the
window is over (one all-reduce of a flag).

The configuration's ``learner`` names the net (``arch``: ``flat`` or
``perjob``) and its observation (``features``: ``reference``, 7 columns, or
``rich``, 13); both sides run what it names. Set-up builds the lanes from
the instance pack, the policy weights of that net from the seed
(``lib/weights.py``), the train state and its step, and drives
that same step through its first ``checked_updates`` updates: the warm-up,
and the first phase of the check. The window then runs the same train
state on. Once it has closed, the same step runs ``checked_updates`` more
updates on the window's train state: the second phase. Each phase records
what the program produces (``_checked``).

The check, once the program's state is freed: the plain reference
(``reference/learner.py``) replays each phase's recorded actions on the
plain env over the global batch, and its float32 updates are held against
the program's (``lib/compare.py``), each number the worse of the two
phases. The first phase starts from what the reference makes itself: the
raw tables, the harness's weights, a fresh Adam. The second starts from
the program's own state after the window (its env state, parameters and
Adam moments), since the window's trajectory is not recorded; its loss is
not compared, as the loss's relative gap there swings with the loss's own
size (``PERF.md``). With ``ctx.control`` ("float8") the reference computed
with float8 products is judged in the program's place.
"""

from __future__ import annotations

import math
import statistics
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from perfbench.lib import compare, weights
from perfbench.lib.trace import Stretch
from perfbench.reference import env as ref_env
from perfbench.reference import learner as ref_learner

LEARNER_KEYS = ("unroll_steps", "gamma", "learning_rate", "value_coef", "entropy_coef", "algo", "features", "arch",
                "loss_chunks")


def _record(fused_rollout, updates: list):
    """A stand-in for ``fused_rollout.step_autoreset`` that calls it and
    keeps, for the current update (``updates[-1]``), each step's mask before
    the step, actions, raw rewards and ends."""
    step = fused_rollout.step_autoreset

    def recording(state, actions, stats):
        rec = {"mask": state.action_mask(), "actions": actions.to(torch.int32).clone()}
        state, tr, stats = step(state, actions, stats)
        rec.update(raw=tr.raw_reward.clone(), done=tr.done.clone())
        updates[-1].append(rec)
        return state, tr, stats

    return recording


def _optimizer_state(ts) -> dict:
    """Adam's moments (``m``, ``v``, per parameter name) and step count
    ``t``, zeros before its first step."""
    named = dict(ts.model.named_parameters())
    st = {n: ts.optimizer.state.get(p, {}) for n, p in named.items()}
    return {"m": {n: s.get("exp_avg", torch.zeros_like(named[n])).detach().clone() for n, s in st.items()},
            "v": {n: s.get("exp_avg_sq", torch.zeros_like(named[n])).detach().clone() for n, s in st.items()},
            "t": int(next(iter(st.values())).get("step", 0))}


def _checked(update, fused_rollout, ts, K: int, b1: float):
    """``K`` updates of the window's own call on ``ts``, recorded. Returns
    (ts, phase): the ``start`` the updates set out from (``params``,
    ``adam``, the env state's dynamic fields ``env``), each update's env
    ``steps`` (``_record``), the first update's ``logits`` on each
    sampled step (a forward hook on the train state's net), the
    ``losses``, the first update's gradient as Adam got it (``grads``), the
    ``params`` and ``env`` after the last update."""
    def env_fields(state):
        return {k: getattr(state, k).clone() for k in ref_env.DYNAMIC}

    def params():
        return {n: p.detach().clone() for n, p in ts.model.named_parameters()}

    adam = _optimizer_state(ts)
    start = {"params": params(), "adam": adam, "env": env_fields(ts.env_state)}
    steps, logits, losses = [], [], []

    def hook(module, args, out):
        if len(steps) == 1 and not torch.is_grad_enabled():  # the first rollout's calls, not the loss's
            logits.append(out[0].float().clone())

    handle = ts.model.register_forward_hook(hook)
    fused_rollout.step_autoreset, original = _record(fused_rollout, steps), fused_rollout.step_autoreset
    try:
        for i in range(K):
            steps.append([])
            ts, vals = update(ts)
            losses.append(vals[0])
            if i == 0:  # Adam's new first moment is b1 m + (1 - b1) g
                grads = {n: (m.double() - b1 * adam["m"][n].double()) / (1 - b1)
                         for n, m in _optimizer_state(ts)["m"].items()}
    finally:
        fused_rollout.step_autoreset = original
        handle.remove()
    T = len(steps[0])
    if T == 0 or len(logits) != T or any(len(u) != T for u in steps):
        raise RuntimeError("the train step no longer calls fused_rollout.step_autoreset and its net once a "
                           "sampled step: the check cannot read its trajectory")
    return ts, dict(start=start, steps=steps, logits=logits, losses=losses, grads=grads, params=params(),
                    env=env_fields(ts.env_state))


def _gather(t: torch.Tensor, world: int, dim: int) -> torch.Tensor:
    """Every rank's ``t`` joined along ``dim`` in rank order (all ranks)."""
    if world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim)


def _joined(phase: dict, world: int) -> dict:
    """``phase`` with every rank's lanes joined in rank order (all ranks):
    ``steps[k][t]``, ``logits`` as (T, B, J+1), the env fields; the rest
    is global already."""
    K, T = len(phase["steps"]), len(phase["steps"][0])
    rows = [r for u in phase["steps"] for r in u]
    f = {k: _gather(torch.stack([r[k].to(torch.int32) for r in rows]), world, 1)
         for k in ("mask", "actions", "raw", "done")}
    logits = _gather(torch.stack(phase["logits"]), world, 1)
    env = {which: {k: _gather(v.to(torch.int32), world, 0) for k, v in fields.items()}
           for which, fields in (("start", phase["start"]["env"]), ("end", phase["env"]))}
    return {**phase, "env_start": env["start"], "env": env["end"],
            "steps": [[{"mask": f["mask"][k * T + t].bool(), "actions": f["actions"][k * T + t],
                        "raw": f["raw"][k * T + t], "done": f["done"][k * T + t].bool()} for t in range(T)]
                      for k in range(K)],
            "logits": logits}


def run(ctx) -> SimpleNamespace:
    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import fused_rollout
    from jssenv_tpu_torch.parallel import learner
    from jssenv_tpu_torch.parallel import mesh as meshlib
    from jssenv_tpu_torch.parallel import multihost

    cfg, traffic, dev, world = ctx.config, ctx.traffic, ctx.device, ctx.world
    L = cfg["learner"]
    B, K = cfg["batch"]["train"], traffic["checked_updates"]
    C = ref_env.features(L["features"])[0]
    ctx.mark("imported")
    source = instances.get_instance_set(cfg["instances"])
    mesh = None
    if world > 1:
        multihost.initialize(f"127.0.0.1:{ctx.port}", world, ctx.rank, backend=ctx.backend)
        mesh = meshlib.make_mesh(dp=world, device=dev)
        env_state = multihost.host_sharded_batch(source, B * world, mesh)
    else:
        env_state = vector.make_batch(source, B, device=dev)
    env_state = vector.strip_solution(env_state)
    ctx.mark("lanes built")
    J, M = env_state.jobs_pad, env_state.machines_pad
    config = learner.LearnerConfig(**{k: L[k] for k in LEARNER_KEYS}, hidden=tuple(L["hidden"]),
                                   compute_dtype=getattr(torch, L["compute_dtype"]))
    params0 = weights.make(ctx.seed, J, C, L["hidden"], dev, L["arch"])
    ctx.mark("weights made")
    ts = learner.init_train_state(ctx.seed, env_state, config, params=params0)
    train_step = learner.make_train_step(config, mesh)
    del env_state
    ctx.mark("train state built")

    def update(ts):
        ts, m = train_step(ts)
        return ts, torch.stack([m[k].to(torch.float64) for k in ("loss", "episodes", "total_makespan")]).tolist()

    b1 = L["adam"][0]
    ts, first = _checked(update, fused_rollout, ts, K, b1)  # also the warm-up
    ctx.mark("checked updates done")

    if mesh is not None:
        dist.barrier()
    times, stretch, bad = [], None, 0
    start = time.perf_counter()
    ctx.setup_s = time.monotonic() - ctx.t_start
    while True:
        if ctx.trace and stretch is None and len(times) == traffic["trace_after"]:
            with Stretch(dev) as stretch:
                for _ in range(traffic["trace_updates"]):
                    ts, vals = update(ts)
        t0 = time.perf_counter()
        ts, vals = update(ts)
        times.append(time.perf_counter() - t0)
        bad += not math.isfinite(vals[0])
        done = time.perf_counter() - start >= ctx.seconds and (not ctx.trace or stretch is not None)
        if mesh is not None:
            flag = torch.tensor([int(done)], device=dev)
            done = bool(meshlib.all_reduce(flag, mesh.dp_group, dist.ReduceOp.MAX).item())
        if done:
            break
    window_s = time.perf_counter() - start
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    ctx.mark(f"window closed: {len(times)} updates, ms quartiles {[round(x * 1e3, 3) for x in q]}, "
             f"first {times[0] * 1e3:.3f}, max {max(times) * 1e3:.3f}")
    n = len(times) + (traffic["trace_updates"] if stretch is not None else 0)

    peak = torch.tensor([torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0], device=dev)
    if mesh is not None:
        meshlib.all_reduce(peak, mesh.dp_group, dist.ReduceOp.MAX)
    ts, last = _checked(update, fused_rollout, ts, K, b1)
    ctx.mark("checked updates after the window done")
    del ts, train_step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phases = [_joined(first, world), _joined(last, world)]
    del first, last
    out = SimpleNamespace(attempted=n, failed=bad, checks=[], memory_peak_bytes=int(peak.item()), trace=None,
                          metrics={"train_env_steps_per_s": n * B * world * config.unroll_steps / window_s,
                                   "update_p95_ms": statistics.quantiles(times, n=20)[-1] * 1e3
                                   if len(times) > 1 else times[0] * 1e3})
    if stretch is not None:
        out.trace = stretch.trace
        out.trace.units = traffic["trace_updates"]
        out.trace.sizes = dict(mode="train", B=B, unroll=config.unroll_steps, J=J, M=M, C=C, hidden=list(L["hidden"]),
                               arch=L["arch"], features=L["features"], instances=len(cfg["instances"]),
                               update_s=statistics.median(times))
        busy = torch.tensor([out.trace.busy_s, out.trace.window_s], dtype=torch.float64, device=dev)
        if mesh is not None:
            meshlib.all_reduce(busy, mesh.dp_group)
        out.trace.busy, out.trace.span = (busy / world).tolist()
    if mesh is not None:
        dist.destroy_process_group()
    if ctx.rank != 0:
        return out

    tables = ref_env.load_tables(ctx.root / cfg["instance_pack"], cfg["instances"])
    fresh = ref_env.batch(tables, torch.arange(B * world), dev)
    checks = []
    for i, ph in enumerate(phases):
        # the first phase from the reference's own start, the second from the program's state after the window
        if i == 0:
            state, params, adam = fresh, dict(params0), None
        else:
            state = {**fresh, **{k: v.to(fresh[k].dtype) for k, v in ph["env_start"].items()}}
            params, adam = ph["start"]["params"], ph["start"]["adam"]
        ref = ref_learner.follow(state, dict(params), ph["steps"], L, adam=adam)
        prog = {"losses": ph["losses"], "grads": ph["grads"], "params": ph["params"], "logits": ph["logits"],
                "mismatches": sum(int((ph["env"][k] != ref["state"][k].to(torch.int32)).sum()) for k in ph["env"])}
        if ctx.control is not None:  # the reference with float8 products, in the program's place
            if ctx.control != "float8":
                raise ValueError(f"the training control is float8, not {ctx.control!r}")
            prog = {**ref_learner.follow(state, dict(params), ph["steps"], L, fp8=True, adam=adam), "mismatches": 0}
        phase = compare.train(prog, ref, params, cfg["limits"]["train"])
        checks.append(phase if i == 0 else [c for c in phase if c[0] != "loss_rel_gap"])
        del ref, prog
    ctx.mark("reference done")
    out.checks = compare.worst(*checks)
    return out

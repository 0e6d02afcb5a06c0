"""Schedule-space refinement: batched simulated annealing and tabu search.

The PyTorch counterpart of ``jssenv_tpu/anneal.py``, the second search stage
behind :mod:`jssenv_tpu_torch.solve`. A candidate is a per-machine job order
``orders[b, m, r]`` (the r-th job machine m processes); its makespan is the
longest path of the induced precedence DAG. Thousands of chains run in
lockstep, with moves drawn from the critical-path neighborhood: an op is
critical iff ``head + dur + tail == makespan`` (heads from a forward sweep,
tails from a sweep of the time-reversed instance), and the proposals swap
machine-adjacent critical pairs (Nowicki & Smutnicki's candidate set), with a
random-swap mix and an optional critical-block insertion move.

The evaluator (``evaluate_orders``) computes the semi-active schedule of an
order batch by order-driven frontier sweeps: each pass, every machine starts
its next-in-order job if that op is its job's current op; the passes
converge to exactly the DAG longest path. A lane that makes no progress
before completing is infeasible (a precedence cycle, reachable by swaps) and
is priced at INT32_MAX. The results are the JAX package's integers, bit for
bit (``tests/test_torch_anneal.py``).

Differences of form, none of result:

* the JAX package's sweep is one ``lax.while_loop`` whose condition the
  device reads; here it is a Python loop that reads its condition on the
  host every ``SWEEP_PASSES`` passes (a pass is idempotent once a lane has
  completed or stalled, so extra passes change nothing). ``SWEEP_STATS``
  counts sweeps, passes and host reads;
* dynamic indices are gathers (``torch.gather`` / flat indexing), not the
  one-hot masked sums the TPU lowering needed, and each committed op
  reaches its job by a scatter from the machine that committed it (the
  JAX package looks it up from each job's side): the same integers with
  about half the launches a pass;
* random draws come from an explicit ``torch.Generator`` on the tables'
  device, seeded from ``seed``: they are not ``jax.random``'s, so the
  searches agree with the JAX package in distribution only;
* the searches run as one host loop over iterations; the JAX package's
  chunked device calls (``_CHUNK``) change nothing numerically there and
  have no counterpart here.

Certification: the searches treat DAG makespans as the objective; the final
winner is re-verified through the exact environment semantics with
``replay.replay_machine_order`` (``solve.solve(refine_iters=...)`` does so).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from jssenv_tpu_torch.core.state import I32_MAX, Device, resolve_device

_I32 = torch.int32
_RESTART_EVERY = 250  # anneal intensification period (iterations)

# Sweep passes between two host reads of the loop condition (did any lane
# commit an op in the last pass?). A pass is idempotent once a lane has
# completed or stalled, so the result does not depend on this number; it
# trades up to SWEEP_PASSES wasted passes a sweep against one device-to-host
# read per pass.
SWEEP_PASSES = 4

# sweeps run, passes run and host reads of the loop condition since the last
# reset_sweep_stats()
SWEEP_STATS = {"sweeps": 0, "passes": 0, "host_syncs": 0}

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_sweep_stats() -> None:
    for k in SWEEP_STATS:
        SWEEP_STATS[k] = 0


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def schedule_tables(op_machine, op_dur, op_pos, device: Device = None) -> Tables:
    """Static tables the evaluator needs, as int32 tensors on ``device`` (the
    card unless ``device="cpu"``): machine ids, op positions, and durations
    re-indexed by machine (``dur_by_machine[j, m]`` = duration of job j's op
    on machine m).

    Accepts ``(J, M)`` tables (one instance, shared by every lane) or
    ``(B, J, M)`` stacks (one instance per lane, all of one padded (J, M)
    shape): lane b of an order batch is evaluated against table row b, or
    the shared table."""
    dev = resolve_device(device)
    op_machine, op_dur, op_pos = (_tensor(t).to(dev, _I32) for t in (op_machine, op_dur, op_pos))
    mp = op_machine.shape[-1]
    dur_by_machine = torch.take_along_dim(op_dur, op_pos.clamp(0, mp - 1).long(), dim=-1)
    return op_machine, op_pos, dur_by_machine


def _orders_on(tables: Tables, orders) -> torch.Tensor:
    return _tensor(orders).to(tables[0].device, _I32)


def _dur_T(tables: Tables) -> torch.Tensor:
    """(1|B, M, J) durations keyed by (machine, job)."""
    d = tables[2]
    return d.transpose(-1, -2)[None] if d.dim() == 2 else d.transpose(-1, -2)


def _sweep(tables: Tables, orders) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order-driven frontier sweep (module docstring).

    Returns ``(mk (B,), starts (B, M, J))``, int32: makespans (INT32_MAX
    when infeasible) and the start time of the op at each machine rank (0
    where a stalled lane never started it)."""
    op_machine, op_pos, dur_by_machine = tables
    orders = _orders_on(tables, orders)
    J, M = op_machine.shape[-2:]
    B = orders.shape[0]
    dev = orders.device
    lanes = torch.arange(B if op_machine.dim() == 3 else 1, device=dev)[:, None]
    # flat (machine, job) keyed tables, entry [lane*M*J + m*J + j]
    opos_T = op_pos.transpose(-1, -2).reshape(-1).long()
    dur_T = dur_by_machine.transpose(-1, -2).reshape(-1)
    base = lanes * (M * J) + torch.arange(M, device=dev)[None] * J  # (B|1, M)
    order_l = orders.long().clamp(0, J - 1)

    ready = torch.zeros((B, J), dtype=_I32, device=dev)
    free = torch.zeros((B, M), dtype=_I32, device=dev)
    cnt = torch.zeros((B, M), dtype=torch.long, device=dev)
    done = torch.zeros((B, J), dtype=torch.long, device=dev)
    starts = torch.zeros((B, M, J), dtype=_I32, device=dev)
    SWEEP_STATS["sweeps"] += 1
    while True:
        for _ in range(SWEEP_PASSES):
            rank = cnt.clamp(max=J - 1)
            h = order_l.gather(2, rank[..., None])[..., 0]  # (B, M) next-in-order job
            at = base + h
            # commit machine m's head job iff that op is the job's current op
            # (its job predecessor is then final; the machine predecessor is
            # final by construction of the frontier)
            alloc = (cnt < J) & (opos_T[at] == done.gather(1, h))
            begin = torch.maximum(ready.gather(1, h), free)
            end = begin + dur_T[at]
            # the slot at an uncommitted rank is still 0, so adding writes it
            starts.scatter_add_(2, rank[..., None], torch.where(alloc, begin, 0)[..., None])
            free = torch.where(alloc, end, free)
            cnt = cnt + alloc
            # the job side: a job's current op is on one machine, so at most
            # one machine commits each job, and its end is at least the job's
            # ready time
            ready = ready.scatter_reduce(1, h, torch.where(alloc, end, 0), "amax")
            done = done.scatter_add(1, h, alloc.long())
        SWEEP_STATS["passes"] += SWEEP_PASSES
        SWEEP_STATS["host_syncs"] += 1
        # a lane that commits nothing in a pass keeps its state, so it never
        # commits again: complete, or stalled on a cycle (the JAX package's
        # "stuck")
        if not bool(alloc.any()):
            break
    mk = torch.where(cnt.sum(dim=1) < J * M, I32_MAX, ready.amax(dim=1))
    return mk.to(_I32), starts


def evaluate_orders(tables: Tables, orders) -> torch.Tensor:
    """(B,) int32 makespans of the semi-active schedules of ``orders``
    (``orders[b, m, r]`` = the r-th job machine m processes); infeasible
    orders return INT32_MAX."""
    return _sweep(tables, orders)[0]


def reverse_tables(tables: Tables) -> Tables:
    """Tables of the time-reversed instance (each job's op sequence flipped):
    its forward sweep computes each op's tail, the longest dependency chain
    after it in the original."""
    op_machine, op_pos, dur_by_machine = tables
    M = op_machine.shape[-1]
    return torch.flip(op_machine, dims=(-1,)), (M - 1) - op_pos, dur_by_machine


def _tails(rtables: Tables, orders: torch.Tensor) -> torch.Tensor:
    """(B, M, J) tail lengths: the tail of the op at forward rank r is the
    start of the same op in the time-reversed problem, where machine orders
    flip rank -> J-1-r."""
    _, starts_rev = _sweep(rtables, torch.flip(orders, dims=(2,)))
    return torch.flip(starts_rev, dims=(2,))


def _dur_rank(tables: Tables, orders: torch.Tensor) -> torch.Tensor:
    """(B, M, J) duration of the op at each machine rank."""
    B, M, J = orders.shape
    return torch.take_along_dim(_dur_T(tables).expand(B, M, J), orders.long(), dim=2)


def _critical_ops(tables: Tables, orders, mk, starts, tails) -> torch.Tensor:
    """(B, M, J) bool: rank r's op is on a critical path
    (head + dur + tail == makespan)."""
    return (starts + _dur_rank(tables, orders) + tails) == mk[:, None, None]


def _pairs(crit: torch.Tensor) -> torch.Tensor:
    pair = crit & torch.roll(crit, -1, dims=2)
    pair[:, :, -1] = False
    return pair


def _critical_pairs_from(tables: Tables, orders, mk, starts, tails) -> torch.Tensor:
    """``critical_pairs`` with the tails already computed (see ``_tails``)."""
    return _pairs(_critical_ops(tables, orders, mk, starts, tails))


def _block_bounds(crit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Critical-block boundaries per rank: where ``crit[r]``, ``s[r]`` / ``e[r]``
    are the first / last rank of the maximal run of consecutive critical
    ranks containing r (the Nowicki-Smutnicki critical block); values at
    non-critical ranks are meaningless. int32, by cummax / cummin along the
    rank axis."""
    J = crit.shape[2]
    pos = torch.arange(J, dtype=_I32, device=crit.device)[None, None]
    last_nc = torch.cummax(torch.where(crit, -1, pos), dim=2).values  # last non-critical <= r
    first_nc = torch.flip(torch.cummin(torch.flip(torch.where(crit, J, pos), dims=(2,)), dim=2).values,
                          dims=(2,))  # first non-critical >= r (J when none)
    return (last_nc + 1).to(_I32), (first_nc - 1).to(_I32)


def critical_pairs(tables: Tables, rtables: Tables, orders, mk, starts) -> torch.Tensor:
    """(B, M, J) bool: rank r is True iff the ops at ranks (r, r+1) of that
    machine are both on a critical path: the only adjacent swaps that can
    reduce the makespan, and never a source of a cycle. ``mk`` / ``starts``
    must come from ``_sweep(tables, orders)``."""
    orders = _orders_on(tables, orders)
    return _critical_pairs_from(tables, orders, mk, starts, _tails(rtables, orders))


def _sample_true(generator: torch.Generator, flat: torch.Tensor, n: int = 0):
    """Uniformly sample one True index per row of ``flat`` (B, N) bool; with
    ``n > 0``, n independent samples per row. Returns (idx int32, any): idx
    (B,) or (B, n), arbitrary (but in range) where ``any`` is False."""
    counts = torch.cumsum(flat, dim=1, dtype=_I32)
    total = counts[:, -1:]
    shape = (flat.shape[0], max(n, 1))
    u = torch.randint(0, 2**31 - 1, shape, generator=generator, device=flat.device, dtype=_I32)
    u = u % total.clamp(min=1)
    idx = torch.searchsorted(counts, u, right=True).clamp(max=flat.shape[1] - 1).to(_I32)
    has = (total > 0).expand(shape)
    return (idx, has) if n else (idx[:, 0], has[:, 0])


def orders_from_solutions(op_pos, solution) -> torch.Tensor:
    """(B, M, J) int32 machine orders from (B, J, M) op start-time matrices
    (ties and -1 padding resolve by lowest job index: a stable argsort).
    ``op_pos`` may be shared (J, M) or per-lane (B, J, M); the result is on
    ``solution``'s device."""
    solution = _tensor(solution)
    op_pos = _tensor(op_pos).to(solution.device)
    B = solution.shape[0]
    J, M = op_pos.shape[-2:]
    idx = op_pos.clamp(0, M - 1).long().expand(B, J, M)
    start_by_machine = torch.take_along_dim(solution, idx, dim=2)  # (B, J, M)
    return torch.argsort(start_by_machine.transpose(1, 2), dim=2, stable=True).to(_I32)


def _rows(orders: torch.Tensor, msel: torch.Tensor) -> torch.Tensor:
    """(B, J) the order row of machine ``msel`` per lane."""
    return orders[torch.arange(orders.shape[0], device=orders.device), msel.long()]


def _swap_adjacent(orders: torch.Tensor, msel: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Swap ranks p and p+1 (p in [0, J-2]) on machine msel, per lane."""
    ar = torch.arange(orders.shape[0], device=orders.device)
    m, p = msel.long(), p.long()
    out = orders.clone()
    out[ar, m, p] = orders[ar, m, p + 1]
    out[ar, m, p + 1] = orders[ar, m, p]
    return out


def _move_insert(orders, msel, p, q, to_front) -> torch.Tensor:
    """Remove one op and reinsert it at the far end of the rank segment
    [p, q] on machine ``msel``, per lane (the Nowicki-Smutnicki block
    insertion; ``_swap_adjacent`` is the case q == p+1). ``to_front`` True:
    the op at rank q moves to rank p (the segment rotates right); False: the
    op at rank p moves to rank q (it rotates left). The result may be
    infeasible; the sweep prices it INT32_MAX. A rank p or q outside [0, J)
    (a lane whose proposal the caller does not use) reads as rank J-1."""
    B, M, J = orders.shape
    row = _rows(orders, msel)
    pos = torch.arange(J, device=orders.device)[None]
    p_, q_ = p.long()[:, None], q.long()[:, None]
    v_p = row.gather(1, p_.clamp(0, J - 1))
    v_q = row.gather(1, q_.clamp(0, J - 1))
    right = torch.where(pos == p_, v_q, torch.where((pos > p_) & (pos <= q_), torch.roll(row, 1, dims=1), row))
    left = torch.where(pos == q_, v_p, torch.where((pos >= p_) & (pos < q_), torch.roll(row, -1, dims=1), row))
    out = orders.clone()
    out[torch.arange(B, device=orders.device), msel.long()] = torch.where(to_front[:, None], right, left)
    return out


def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def _randint(generator: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, max(high, 1), shape, generator=generator, device=generator.device, dtype=_I32)


def _gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise from u on the open interval (0, 1), as
    ``jax.random.gumbel`` draws it: ``torch.rand`` can return exactly 0,
    whose noise would be -inf."""
    u = _uniform(generator, shape).clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _seed_lanes(tables: Tables, orders0, seed: int):
    """The searches' common start: the seed orders swept, their tails, and
    a generator seeded with ``seed`` on the tables' device. With shared
    tables, lanes whose seed is infeasible restart from the best lane (with
    per-lane tables lanes belong to different instances, so an infeasible
    seed stays at INT32_MAX and never moves)."""
    orders0 = _orders_on(tables, orders0)
    mk0, starts0 = _sweep(tables, orders0)
    if tables[0].dim() == 2:
        ref = int(torch.argmin(mk0))
        bad = mk0 == I32_MAX
        orders0 = torch.where(bad[:, None, None], orders0[ref][None], orders0)
        mk0 = torch.where(bad, mk0[ref], mk0)
        starts0 = torch.where(bad[:, None, None], starts0[ref][None], starts0)
    gen = torch.Generator(device=tables[0].device).manual_seed(int(seed))
    return gen, (orders0, mk0, starts0, _tails(reverse_tables(tables), orders0))


def anneal(
    tables: Tables,
    orders0,
    seed: int,
    iters: int = 2000,
    t0_frac: float = 0.08,
    t1_frac: float = 0.004,
    p_random: float = 0.05,
    p_insert: float = 0.0,
    tails_refresh: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine an order batch by simulated annealing on the tables' device;
    returns (best_orders (B, M, J), best_makespans (B,)), int32.

    One move per lane per iteration: with probability ``p_insert`` a
    critical-block insertion (a uniformly sampled critical op moves to the
    front or back of its block; default off, as in the JAX package, whose
    round-4 A/B measured it slightly worse on ta41); otherwise an adjacent
    swap drawn uniformly from the lane's critical pairs, or with
    probability ``p_random`` (or when there is none) a uniformly random
    adjacent pair. Metropolis acceptance with a geometric temperature
    schedule on the global iteration, scaled per lane by its seed makespan
    (``t0_frac`` to ``t1_frac`` of it); every 250 iterations, lanes more
    than 5% above their own best snap back to it.

    ``tails_refresh``: recompute the tails (the reversed sweep behind the
    criticality test) only every k-th iteration; makespans and acceptance
    stay exact, only the candidate set may be up to k-1 iterations stale."""
    carry = _anneal_chunk(tables, _anneal_init(tables, orders0, seed), 0, int(iters), int(iters), t0_frac,
                          t1_frac, p_random, p_insert, tails_refresh)
    _, _, (best_orders, best_mk, _), _ = carry
    return best_orders, best_mk


def _anneal_init(tables: Tables, orders0, seed: int):
    """The annealing carry: (generator, current (orders, mk, starts, tails),
    best (orders, mk, starts), the seed makespans)."""
    gen, cur = _seed_lanes(tables, orders0, seed)
    return gen, cur, cur[:3], cur[1]


def _anneal_chunk(tables: Tables, carry, i0: int, n: int, iters: int, t0_frac: float, t1_frac: float,
                  p_random: float, p_insert: float = 0.0, tails_refresh: int = 1):
    """Iterations ``i0 .. i0+n-1`` of an ``iters``-iteration run; splitting
    a run into chunks changes nothing (the temperature and the restarts
    follow the global iteration, the scale the seed makespans)."""
    gen, (orders, mk, starts, tails), (best_orders, best_mk, best_starts), mk_seed = carry
    B, M, J = orders.shape
    rtables = reverse_tables(tables)
    scale = mk_seed.to(torch.float32).clamp(min=1.0)
    for i in range(i0, i0 + n):
        crit = _critical_ops(tables, orders, mk, starts, tails)
        idx, has = _sample_true(gen, _pairs(crit).reshape(B, M * J))
        msel_r = _randint(gen, M, (B,))
        p_r = _randint(gen, J - 1, (B,))
        use_crit = has & (_uniform(gen, (B,)) >= p_random)
        msel = torch.where(use_crit, idx // J, msel_r)
        p = torch.where(use_crit, idx % J, p_r)
        prop = _swap_adjacent(orders, msel, p)
        if p_insert > 0:
            # the critical-block insertion proposal
            s_blk, e_blk = _block_bounds(crit)
            idx_i, has_i = _sample_true(gen, crit.reshape(B, M * J))
            s_i = s_blk.reshape(B, M * J).gather(1, idx_i.long()[:, None])[:, 0]
            e_i = e_blk.reshape(B, M * J).gather(1, idx_i.long()[:, None])[:, 0]
            msel_i, r_i = idx_i // J, idx_i % J
            valid_front, valid_back = r_i > s_i, r_i < e_i
            to_front = ((_uniform(gen, (B,)) < 0.5) & valid_front) | ~valid_back
            use_ins = use_crit & has_i & (valid_front | valid_back) & (_uniform(gen, (B,)) < p_insert)
            prop_ins = _move_insert(orders, msel_i, torch.where(to_front, s_i, r_i),
                                    torch.where(to_front, r_i, e_i), to_front)
            prop = torch.where(use_ins[:, None, None], prop_ins, prop)
        mk_p, starts_p = _sweep(tables, prop)
        temp = scale * (t0_frac * (t1_frac / t0_frac) ** (i / max(iters - 1, 1)))
        delta = (mk_p - mk).to(torch.float32)
        accept = (mk_p < I32_MAX) & ((delta <= 0) | (_uniform(gen, (B,)) < torch.exp(-delta / temp)))
        a3 = accept[:, None, None]
        orders = torch.where(a3, prop, orders)
        mk = torch.where(accept, mk_p, mk)
        starts = torch.where(a3, starts_p, starts)
        better = mk_p < best_mk
        b3 = better[:, None, None]
        best_orders = torch.where(b3, prop, best_orders)
        best_mk = torch.where(better, mk_p, best_mk)
        best_starts = torch.where(b3, starts_p, best_starts)
        if i % _RESTART_EVERY == _RESTART_EVERY - 1:
            # intensification: lanes that drifted >5% above their own best
            # snap back to it
            drifted = mk.to(torch.float32) > 1.05 * best_mk.to(torch.float32)
            d3 = drifted[:, None, None]
            orders = torch.where(d3, best_orders, orders)
            mk = torch.where(drifted, best_mk, mk)
            starts = torch.where(d3, best_starts, starts)
        if tails_refresh <= 1 or i % tails_refresh == tails_refresh - 1:
            tails = _tails(rtables, orders)
    return gen, (orders, mk, starts, tails), (best_orders, best_mk, best_starts), mk_seed


# ---------------------------------------------------------------------------
# tabu search: best of P proposals with short-term move memory
# ---------------------------------------------------------------------------


def _neighbor_bounds(tables: Tables, orders, starts, tails, dur_rank):
    """Per-rank job-neighbor path bounds for the O(1) swap estimator:
    ``(JPend, JStail)``, both (B, M, J) int32 in rank layout. ``JPend[b, m,
    r]`` = completion time of the job predecessor of the op at machine m
    rank r (0 for a job's first op); ``JStail[b, m, r]`` = dur + tail of its
    job successor (0 for a job's last op). Rank -> job by the inverse
    permutation of the order rows, job-position shifts, then back."""
    op_machine, op_pos, _ = tables
    B, M, J = orders.shape
    end_rank = starts + dur_rank
    T_rank = dur_rank + tails
    rank_of = torch.argsort(orders, dim=2, stable=True)  # inverse permutation (B, M, job)
    E_mj = torch.take_along_dim(end_rank, rank_of, dim=2)
    T_mj = torch.take_along_dim(T_rank, rank_of, dim=2)
    om_b = op_machine.clamp(0, M - 1).long().expand(B, J, M)
    op_pos_b = op_pos.clamp(0, M - 1).long().expand(B, J, M)
    # (machine, job) -> (job, position): X_jpos[b, j, k] = X_mj[b, om[j, k], j]
    E_jpos = torch.take_along_dim(E_mj.transpose(1, 2), om_b, dim=2)
    T_jpos = torch.take_along_dim(T_mj.transpose(1, 2), om_b, dim=2)
    zeros1 = torch.zeros((B, J, 1), dtype=starts.dtype, device=starts.device)
    JPend_jpos = torch.cat([zeros1, E_jpos[..., :-1]], dim=2)
    JStail_jpos = torch.cat([T_jpos[..., 1:], zeros1], dim=2)
    # (job, position) -> (job, machine) -> rank
    JPend_jm = torch.take_along_dim(JPend_jpos, op_pos_b, dim=2)
    JStail_jm = torch.take_along_dim(JStail_jpos, op_pos_b, dim=2)
    o = orders.long()
    JPend = torch.take_along_dim(JPend_jm.transpose(1, 2), o, dim=2)
    JStail = torch.take_along_dim(JStail_jm.transpose(1, 2), o, dim=2)
    return JPend, JStail


def _swap_estimates(tables: Tables, orders, starts, tails, dur_rank) -> torch.Tensor:
    """(B, M, J) int32 estimated post-swap makespans of every adjacent pair
    (r, r+1): the longest path through the swapped pair from its job and
    machine neighbors' heads and tails (Taillard's accelerated evaluation).
    Used to select moves only; the applied move is priced by an exact sweep.
    Entries at r = J-1 are meaningless (no pair)."""
    JPend, JStail = _neighbor_bounds(tables, orders, starts, tails, dur_rank)
    end_rank = starts + dur_rank
    T_rank = dur_rank + tails
    B, M, J = orders.shape
    z1 = torch.zeros((B, M, 1), dtype=starts.dtype, device=starts.device)
    MPend = torch.cat([z1, end_rank[..., :-1]], dim=2)  # end of rank r-1
    MStail = torch.cat([T_rank[..., 2:], z1, z1], dim=2)  # T of rank r+2, 0 past the end
    d_u, d_v = dur_rank, torch.roll(dur_rank, -1, dims=2)
    JP_v = torch.roll(JPend, -1, dims=2)
    JS_v = torch.roll(JStail, -1, dims=2)
    hv = torch.maximum(JP_v, MPend)  # v first after the swap
    hu = torch.maximum(JPend, hv + d_v)
    tu = torch.maximum(JStail, MStail)  # u last after the swap
    tv = torch.maximum(JS_v, d_u + tu)
    return torch.maximum(hv + d_v + tv, hu + d_u + tu)


def tabu_search(
    tables: Tables,
    orders0,
    seed: int,
    iters: int = 2000,
    proposals: int = 8,
    tenure_min: int = 8,
    tenure_spread: int = 6,
    neighborhood: str = "sampled",
    guided_temp: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine an order batch by parallel tabu search on the tables' device;
    returns (best_orders (B, M, J), best_makespans (B,)), int32.

    Per chain and iteration (``"sampled"``): sample ``proposals`` adjacent
    swaps from the critical-pair candidate set (uniform random pairs when a
    chain has none), price them all with one batched sweep, and move to the
    best admissible one: not tabu, or better than the chain's best so far
    (aspiration); if every proposal is tabu, the best tabu one. The applied
    move's inverse (the same ordered job pair on that machine) is tabu for
    ``tenure_min + U[0, tenure_spread)`` iterations.

    ``"full"``: Taillard's O(1) estimate over every critical pair
    (``_swap_estimates``) selects the move, and only that move is priced
    exactly; ``proposals`` is ignored. ``"guided"``: estimate every
    critical pair as in "full", then draw the P exactly priced proposals by
    Gumbel-top-P over ``-estimate / guided_temp``; needs ``proposals <= M *
    J``, the size of the candidate set (``ValueError`` otherwise)."""
    if neighborhood not in ("sampled", "full", "guided"):
        raise ValueError(f"bad neighborhood {neighborhood!r}")
    M, J = tables[0].shape[-1], tables[0].shape[-2]
    if neighborhood == "guided" and not 1 <= int(proposals) <= M * J:
        raise ValueError(f"guided tabu draws {proposals} distinct proposals from the {M * J} (machine, rank) "
                         f"pairs of a {J}x{M} instance; pass 1 <= proposals <= {M * J}")
    carry = _tabu_init(tables, orders0, seed)
    if neighborhood == "full":
        carry = _tabu_chunk_full(tables, carry, 0, int(iters), int(tenure_min), int(tenure_spread))
    else:
        carry = _tabu_chunk(tables, carry, 0, int(iters), int(proposals), int(tenure_min), int(tenure_spread),
                            float(guided_temp) if neighborhood == "guided" else None)
    _, _, _, (best_orders, best_mk) = carry
    return best_orders, best_mk


def _tabu_init(tables: Tables, orders0, seed: int):
    """The tabu carry: (generator, current (orders, mk, starts, tails), the
    tabu table, best (orders, mk)). ``tabu[b, m*J*J + u*J + v]``: swapping
    adjacent (u before v) on machine m is forbidden while the iteration is
    below the value."""
    gen, cur = _seed_lanes(tables, orders0, seed)
    B, M, J = cur[0].shape
    tabu = torch.zeros((B, M * J * J), dtype=_I32, device=cur[0].device)
    return gen, cur, tabu, cur[:2]


def _tenure(gen, B, tenure_min, tenure_spread):
    if tenure_spread > 0:
        return tenure_min + _randint(gen, tenure_spread, (B,))
    return tenure_min


def _tabu_chunk(tables: Tables, carry, i0: int, n: int, P: int, tenure_min: int, tenure_spread: int,
                guided_temp=None):
    """Iterations ``i0 .. i0+n-1`` in the sampled (``guided_temp`` None) or
    guided neighborhood."""
    gen, (orders, mk, starts, tails), tabu, (best_orders, best_mk) = carry
    B, M, J = orders.shape
    ar = torch.arange(B, device=orders.device)
    rtables = reverse_tables(tables)
    # per-lane tables follow the proposal fan-out: lane b*P+p is chain b's
    tabP = tuple(t.repeat_interleave(P, dim=0) for t in tables) if tables[0].dim() == 3 else tables
    for it in range(i0, i0 + n):
        crit = _critical_ops(tables, orders, mk, starts, tails)
        cand = _pairs(crit).reshape(B, M * J)
        if guided_temp is not None:
            # Gumbel-top-P over the estimates: the estimator's selection
            # pressure, with the noise that breaks the full neighborhood's limit
            # cycles; the P picks are distinct
            est = _swap_estimates(tables, orders, starts, tails, _dur_rank(tables, orders)).reshape(B, M * J)
            score = torch.where(cand, -est.to(torch.float32) / guided_temp + _gumbel(gen, (B, M * J)), -torch.inf)
            idx = torch.topk(score, P, dim=1).indices.to(_I32)
            has = cand.gather(1, idx.long())
        else:
            idx, has = _sample_true(gen, cand, P)  # (B, P), with replacement
        msel = torch.where(has, idx // J, _randint(gen, M, (B, P)))
        p = torch.where(has, idx % J, _randint(gen, J - 1, (B, P)))

        # price all B*P proposals with one sweep
        ordP = orders[:, None].expand(B, P, M, J).reshape(B * P, M, J)
        prop = _swap_adjacent(ordP, msel.reshape(-1), p.reshape(-1))
        mk_p, starts_p = _sweep(tabP, prop)
        mk_p = mk_p.reshape(B, P)

        # move attribute of a proposal (u before v -> v before u): the flat index
        # msel*J*J + u*J + v; tabu iff tabu[b, attr] > it
        row = orders.gather(1, msel.long()[:, :, None].expand(B, P, J))  # (B, P, J)
        u = row.gather(2, p.long()[:, :, None])[:, :, 0]
        v = row.gather(2, p.long()[:, :, None] + 1)[:, :, 0]
        attr_fwd = msel * (J * J) + u * J + v
        attr_inv = msel * (J * J) + v * J + u
        is_tabu = tabu.gather(1, attr_fwd.long()) > it
        feas = mk_p < I32_MAX
        admissible = feas & (~is_tabu | (mk_p < best_mk[:, None]))
        # best admissible, else best feasible (stall rather than corrupt)
        any_adm = admissible.any(dim=1)
        sel = torch.where(any_adm, torch.where(admissible, mk_p, I32_MAX).argmin(dim=1),
                          torch.where(feas, mk_p, I32_MAX).argmin(dim=1))
        movable = any_adm | feas.any(dim=1)
        pick = ar * P + sel
        mv3 = movable[:, None, None]
        orders = torch.where(mv3, prop[pick], orders)
        mk = torch.where(movable, mk_p[ar, sel], mk)
        starts = torch.where(mv3, starts_p[pick], starts)

        # tabu the inverse of the applied move, randomized tenure
        tenure = _tenure(gen, B, tenure_min, tenure_spread)
        attr = attr_inv[ar, sel].long()
        new_until = torch.where(movable, it + 1 + tenure, 0).to(_I32)
        tabu[ar, attr] = torch.maximum(tabu[ar, attr], new_until)

        better = mk < best_mk
        best_orders = torch.where(better[:, None, None], orders, best_orders)
        best_mk = torch.where(better, mk, best_mk)
        tails = _tails(rtables, orders)
    return gen, (orders, mk, starts, tails), tabu, (best_orders, best_mk)


def _tabu_chunk_full(tables: Tables, carry, i0: int, n: int, tenure_min: int, tenure_spread: int):
    """Iterations ``i0 .. i0+n-1`` in the full neighborhood: estimate every
    critical-pair swap, take the best admissible, price only it exactly."""
    gen, (orders, mk, starts, tails), tabu, (best_orders, best_mk) = carry
    B, M, J = orders.shape
    ar = torch.arange(B, device=orders.device)
    rtables = reverse_tables(tables)
    m_iota = torch.arange(M, dtype=_I32, device=orders.device)[None, :, None]
    for it in range(i0, i0 + n):
        est = _swap_estimates(tables, orders, starts, tails, _dur_rank(tables, orders))
        cand = _pairs(_critical_ops(tables, orders, mk, starts, tails))
        # tabu status of every pair: attribute (m, u_job, v_job)
        attr_fwd = (m_iota * (J * J) + orders * J + torch.roll(orders, -1, dims=2)).reshape(B, M * J)
        is_tabu = tabu.gather(1, attr_fwd.long()).reshape(B, M, J) > it
        admissible = cand & (~is_tabu | (est < best_mk[:, None, None]))
        any_adm = admissible.reshape(B, -1).any(dim=1)
        has_cand = cand.reshape(B, -1).any(dim=1)
        pick = torch.where(any_adm, torch.where(admissible, est, I32_MAX).reshape(B, -1).argmin(dim=1),
                           torch.where(cand, est, I32_MAX).reshape(B, -1).argmin(dim=1))  # all tabu: least bad
        # no critical pair at all: a random pair
        msel = torch.where(has_cand, pick // J, _randint(gen, M, (B,)))
        p = torch.where(has_cand, pick % J, _randint(gen, J - 1, (B,)))
        prop = _swap_adjacent(orders, msel, p)
        mk_p, starts_p = _sweep(tables, prop)  # exact pricing of the applied move
        movable = mk_p < I32_MAX  # random fallback swaps may be infeasible
        # tabu the inverse move (jobs read from the pre-swap orders)
        row = _rows(orders, msel)
        u = row.gather(1, p.long()[:, None])[:, 0]
        v = row.gather(1, p.long()[:, None] + 1)[:, 0]
        attr = (msel * (J * J) + v * J + u).long()
        tenure = _tenure(gen, B, tenure_min, tenure_spread)
        new_until = torch.where(movable, it + 1 + tenure, 0).to(_I32)
        tabu[ar, attr] = torch.maximum(tabu[ar, attr], new_until)
        mv3 = movable[:, None, None]
        orders = torch.where(mv3, prop, orders)
        mk = torch.where(movable, mk_p, mk)
        starts = torch.where(mv3, starts_p, starts)
        better = mk < best_mk
        best_orders = torch.where(better[:, None, None], orders, best_orders)
        best_mk = torch.where(better, mk, best_mk)
        tails = _tails(rtables, orders)
    return gen, (orders, mk, starts, tails), tabu, (best_orders, best_mk)

"""Simulator core over a batch: reset / advance_time / fast_forward / step.

The PyTorch counterpart of ``jssenv_tpu/core/engine.py``, written batch-first
over (B, J, M) tensors instead of per-env functions under vmap. The semantics
are the JAX package's, field for field and bit for bit (its docstrings carry
the reference citations and the derivations of the closed-form fast-forward
and of the two mask heuristics); ``tests/test_torch_engine.py`` holds every
function here against its JAX counterpart stepwise. Every function returns a
new ``EnvState`` and leaves its input untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from jssenv_tpu_torch.core import ops
from jssenv_tpu_torch.core.state import I32_MAX, Device, EnvState, resolve_device
from jssenv_tpu_torch.instances import InstanceSpec

_I32 = torch.int32


@dataclasses.dataclass
class Transition:
    """Result of one agent step, per lane.

    reward:     (B,) float32 — scaled reward ``raw / max_time_op``.
    raw_reward: (B,) int32 — exact integer reward (+duration on allocation,
                -machine idle holes on fast-forward).
    done:       (B,) bool — nb_legal == 0.
    """

    reward: torch.Tensor
    raw_reward: torch.Tensor
    done: torch.Tensor


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=like.device)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Per-lane count of a (B, X) mask as int32."""
    return mask.sum(dim=-1, dtype=_I32)


# ---------------------------------------------------------------------------
# construction / reset
# ---------------------------------------------------------------------------


def init_state(
    op_machine: torch.Tensor,
    op_dur: torch.Tensor,
    num_jobs: torch.Tensor,
    num_machines: torch.Tensor,
) -> EnvState:
    """Build freshly-reset states from padded (B, J, M) instance tensors and
    (B,) real dimensions. Padded job rows start finished; padded machines are
    permanently free and never needed."""
    op_machine = op_machine.to(_I32)
    op_dur = op_dur.to(_I32)
    jp, mp = op_machine.shape[-2:]
    num_jobs = num_jobs.to(_I32)
    num_machines = num_machines.to(_I32)
    job_valid = _arange(jp, op_machine) < num_jobs[:, None]  # (B, J)
    jobs_length = op_dur.sum(dim=2, dtype=_I32)

    # op_pos[j, m] = position of machine m in job j's op sequence; padded
    # columns get unique large keys so the sort maps real machines exactly
    p_idx = _arange(mp, op_machine)
    col_pad = (p_idx[None, None, :] >= num_machines[:, None, None]) | ~job_valid[:, :, None]
    om_eff = torch.where(col_pad, mp + p_idx, op_machine)
    order = torch.argsort(om_eff, dim=2, stable=True).to(_I32)
    m_valid_col = (p_idx[None, None, :] < num_machines[:, None, None]) & job_valid[:, :, None]
    op_pos = torch.where(m_valid_col, order, mp)
    cum = torch.cumsum(op_dur, dim=2, dtype=_I32)
    cum_excl = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], dim=2)
    cum_before = torch.where(
        m_valid_col, torch.gather(cum_excl, 2, op_pos.clamp(0, mp - 1).long()), 0
    )
    return _fresh_state(
        op_machine=op_machine,
        op_dur=op_dur,
        op_pos=op_pos,
        cum_before=cum_before,
        num_jobs=num_jobs,
        num_machines=num_machines,
        max_time_op=op_dur.amax(dim=(1, 2)).to(_I32),
        max_time_jobs=jobs_length.amax(dim=1).to(_I32),
        sum_op=op_dur.sum(dim=(1, 2), dtype=_I32),
    )


def _fresh_state(
    op_machine,
    op_dur,
    op_pos,
    cum_before,
    num_jobs,
    num_machines,
    max_time_op,
    max_time_jobs,
    sum_op,
    solution_rows=None,
) -> EnvState:
    """Zero-initialize the dynamic state around existing static tables.
    ``solution_rows`` = 0 keeps a light (zero-row) solution."""
    b, jp, mp = op_machine.shape
    dev = op_machine.device
    job_valid = _arange(jp, op_machine) < num_jobs[:, None]
    first_m = op_machine[:, :, 0].to(_I32)
    needed = torch.where(job_valid, first_m, -1)
    rows = jp if solution_rows is None else solution_rows
    ml = ops.segment_any(needed.clamp(0, mp - 1), job_valid, mp)
    zj = lambda: torch.zeros((b, jp), dtype=_I32, device=dev)  # noqa: E731
    return EnvState(
        op_machine=op_machine,
        op_dur=op_dur,
        op_pos=op_pos,
        cum_before=cum_before,
        num_jobs=num_jobs,
        num_machines=num_machines,
        max_time_op=max_time_op,
        max_time_jobs=max_time_jobs,
        sum_op=sum_op,
        time=torch.zeros((b,), dtype=_I32, device=dev),
        legal=job_valid,
        noop_legal=torch.zeros((b,), dtype=torch.bool, device=dev),
        nb_legal=num_jobs.clone(),
        nb_machine_legal=_count(ml),
        machine_legal=ml,
        solution=torch.full((b, rows, mp), -1, dtype=_I32, device=dev),
        machine_busy_for=torch.zeros((b, mp), dtype=_I32, device=dev),
        job_busy_for=zj(),
        next_op=torch.where(job_valid, 0, num_machines[:, None]).to(_I32),
        work_done=zj(),
        needed_machine=needed,
        op_end_at=zj(),
        idle_frozen=zj(),
        idle_total_alloc=zj(),
        noop_pin=torch.zeros((b, jp), dtype=torch.bool, device=dev),
        wait4=zj(),
    )


def compact_static_tables(state: EnvState, max_job_length: int) -> EnvState:
    """Downcast the static tables to the narrowest safe dtypes: machine ids /
    op positions to int8 when ``machines_pad <= 126``, durations / prefix sums
    to int16 when no job's total work exceeds int16. Every consumer widens to
    int32 on read, so arithmetic is unchanged."""
    id_dt = torch.int8 if state.machines_pad <= 126 else _I32
    val_dt = torch.int16 if max_job_length <= 32767 else _I32
    return state.replace(
        op_machine=state.op_machine.to(id_dt),
        op_pos=state.op_pos.to(id_dt),
        op_dur=state.op_dur.to(val_dt),
        cum_before=state.cum_before.to(val_dt),
    )


def reset(state: EnvState) -> EnvState:
    """Fresh dynamic state around the same static tables (every lane).
    A light state keeps its zero-row solution."""
    return _fresh_state(
        op_machine=state.op_machine,
        op_dur=state.op_dur,
        op_pos=state.op_pos,
        cum_before=state.cum_before,
        num_jobs=state.num_jobs,
        num_machines=state.num_machines,
        max_time_op=state.max_time_op,
        max_time_jobs=state.max_time_jobs,
        sum_op=state.sum_op,
        solution_rows=state.solution.shape[1],
    )


def state_from_spec(
    spec: InstanceSpec, jobs_pad: int = 0, machines_pad: int = 0, device: Device = None
) -> EnvState:
    """A batch of one fresh env from a parsed InstanceSpec."""
    dev = resolve_device(device)
    padded = spec.padded(max(jobs_pad, spec.num_jobs), max(machines_pad, spec.num_machines))
    state = init_state(
        torch.as_tensor(padded.op_machine, device=dev)[None],
        torch.as_tensor(padded.op_dur, device=dev)[None],
        torch.tensor([spec.num_jobs], dtype=_I32, device=dev),
        torch.tensor([spec.num_machines], dtype=_I32, device=dev),
    )
    return compact_static_tables(state, max_job_length=spec.max_time_jobs)


# ---------------------------------------------------------------------------
# time advance
# ---------------------------------------------------------------------------


def advance_time(state: EnvState) -> Tuple[EnvState, torch.Tensor]:
    """Advance every lane's clock to its next completion event; returns
    (state, holes (B,)). A lane with no busy machine is left unchanged."""
    mp = state.machines_pad
    busy = state.machine_busy_for > 0
    any_busy = busy.any(dim=1)
    diff = torch.where(
        any_busy, torch.where(busy, state.machine_busy_for, I32_MAX).amin(dim=1), 0
    )
    time = state.time + diff
    d = diff[:, None]

    was_left = state.job_busy_for
    running = was_left > 0
    performed = torch.minimum(d, was_left)
    job_busy_for = torch.where(running, torch.clamp(was_left - d, min=0), was_left)
    work_done = state.work_done + torch.where(running, performed, 0)
    completed = running & (job_busy_for == 0)

    op_end_at = torch.where(completed, time[:, None], state.op_end_at)
    next_op = state.next_op + completed.to(_I32)
    nm = state.num_machines[:, None]
    finished_now = completed & (next_op == nm)
    continues = completed & (next_op < nm)
    next_machine = ops.row_gather(state.op_machine, next_op.clamp(0, mp - 1))
    needed_machine = torch.where(
        continues, next_machine, torch.where(finished_now, -1, state.needed_machine)
    )
    drop_legal = finished_now & state.legal
    legal = state.legal & ~drop_legal
    nb_legal = state.nb_legal - _count(drop_legal)

    nm_clip = needed_machine.clamp(0, mp - 1)
    wait_next = torch.clamp(ops.lookup(state.machine_busy_for, nm_clip) - d, min=0)
    wait4 = torch.where(continues, wait_next, state.wait4)

    m_valid = state.machine_valid
    holes = torch.where(m_valid, torch.clamp(d - state.machine_busy_for, min=0), 0).sum(
        dim=1, dtype=_I32
    )
    machine_busy_for = torch.clamp(state.machine_busy_for - d, min=0)
    free = (machine_busy_for == 0) & m_valid

    cand = (
        any_busy[:, None]
        & (needed_machine >= 0)
        & ops.lookup(free, nm_clip)
        & ~legal
        & ~state.noop_pin
        & state.job_valid
    )
    legal = legal | cand
    nb_legal = nb_legal + _count(cand)
    ml_add = ops.segment_any(nm_clip, cand, mp)
    nb_machine_legal = state.nb_machine_legal + _count(ml_add & ~state.machine_legal)
    machine_legal = state.machine_legal | ml_add

    new_state = state.replace(
        time=time,
        legal=legal,
        nb_legal=nb_legal,
        nb_machine_legal=nb_machine_legal,
        machine_legal=machine_legal,
        machine_busy_for=machine_busy_for,
        job_busy_for=job_busy_for,
        next_op=next_op,
        work_done=work_done,
        needed_machine=needed_machine,
        op_end_at=op_end_at,
        wait4=wait4,
    )
    return new_state, holes


def fast_forward(state: EnvState) -> Tuple[EnvState, torch.Tensor]:
    """Closed-form ``while nb_machine_legal == 0 and queue: advance_time()``
    in one update per lane (derivation in the JAX package's ``fast_forward``):
    jump to the first re-legalization time ``T_stop`` (or the last event),
    telescoping work, completions and machine holes over ``[t0, T_stop]``.
    Returns (state, holes (B,)); lanes that need no advance are unchanged."""
    mp = state.machines_pad
    t0 = state.time[:, None]
    tua0 = state.machine_busy_for
    busy0 = tua0 > 0
    any_busy = busy0.any(dim=1)
    active = (state.nb_machine_legal == 0) & any_busy
    first_ev = t0 + torch.where(busy0, tua0, I32_MAX).amin(dim=1, keepdim=True)
    last_ev = t0 + tua0.amax(dim=1, keepdim=True)

    nm = state.num_machines[:, None]
    running = state.job_busy_for > 0
    c = t0 + state.job_busy_for
    nxt_op = state.next_op + 1
    cont = running & (nxt_op < nm)
    m_next = ops.row_gather(state.op_machine, nxt_op.clamp(0, mp - 1)).clamp(0, mp - 1)
    f_next = t0 + ops.lookup(tua0, m_next)
    run_ok = cont
    e_run = torch.maximum(c, f_next)

    mj = state.needed_machine.clamp(0, mp - 1)
    waiting = (
        ~running
        & (state.needed_machine >= 0)
        & ~state.legal
        & state.job_valid
        & ~state.noop_pin
    )
    e_wait = torch.maximum(first_ev, t0 + ops.lookup(tua0, mj))
    e_j = torch.where(run_ok, e_run, torch.where(waiting, e_wait, I32_MAX))
    T_stop = torch.minimum(e_j.amin(dim=1, keepdim=True), last_ev)
    span = T_stop - t0

    performed = torch.where(running, torch.minimum(span, state.job_busy_for), 0)
    job_busy_for = torch.where(
        running, torch.clamp(state.job_busy_for - span, min=0), state.job_busy_for
    )
    work_done = state.work_done + performed
    completed = running & (c <= T_stop)
    op_end_at = torch.where(completed, c, state.op_end_at)
    next_op = state.next_op + completed.to(_I32)
    finished_now = completed & (next_op == nm)
    continues = completed & (next_op < nm)
    needed_machine = torch.where(
        continues, m_next, torch.where(finished_now, -1, state.needed_machine)
    )
    wait4 = torch.where(continues, torch.clamp(f_next - c, min=0), state.wait4)
    drop_legal = finished_now & state.legal
    legal = state.legal & ~drop_legal
    nb_legal = state.nb_legal - _count(drop_legal)

    m_valid = state.machine_valid
    holes = torch.where(m_valid, span - torch.minimum(tua0, span), 0).sum(dim=1, dtype=_I32)
    machine_busy_for = torch.clamp(tua0 - span, min=0)

    cand = e_j == T_stop
    legal = legal | cand
    nb_legal = nb_legal + _count(cand)
    m_of_cand = torch.where(run_ok, m_next, mj)
    ml_add = ops.segment_any(m_of_cand, cand, mp)
    nb_machine_legal = state.nb_machine_legal + _count(ml_add & ~state.machine_legal)
    machine_legal = state.machine_legal | ml_add

    a1 = active[:, None]

    def sel(new, old):
        return torch.where(a1 if new.dim() == 2 else active, new, old)

    new_state = state.replace(
        time=sel(T_stop[:, 0], state.time),
        legal=sel(legal, state.legal),
        nb_legal=sel(nb_legal, state.nb_legal),
        nb_machine_legal=sel(nb_machine_legal, state.nb_machine_legal),
        machine_legal=sel(machine_legal, state.machine_legal),
        machine_busy_for=sel(machine_busy_for, state.machine_busy_for),
        job_busy_for=sel(job_busy_for, state.job_busy_for),
        next_op=sel(next_op, state.next_op),
        work_done=sel(work_done, state.work_done),
        needed_machine=sel(needed_machine, state.needed_machine),
        op_end_at=sel(op_end_at, state.op_end_at),
        wait4=sel(wait4, state.wait4),
    )
    return new_state, torch.where(active, holes, 0)


# ---------------------------------------------------------------------------
# mask-shaping heuristics
# ---------------------------------------------------------------------------


def prioritization_non_final(state: EnvState) -> EnvState:
    """Per legal machine: if some eligible non-final-op job (its next op's
    machine free) competes for it, mask every final-op job slower than the
    fastest such job (reference ``_prioritization_non_final``)."""
    mp = state.machines_pad
    m_of = state.needed_machine.clamp(0, mp - 1)
    cand = state.legal & (state.needed_machine >= 0)
    gate = ops.lookup(state.machine_legal, m_of)
    dur_cur = ops.row_gather(state.op_dur, state.next_op.clamp(0, mp - 1))
    is_final = state.next_op == (state.num_machines[:, None] - 1)
    next_m = ops.row_gather(state.op_machine, (state.next_op + 1).clamp(0, mp - 1))
    eligible_nf = (
        cand & gate & ~is_final & (ops.lookup(state.machine_busy_for, next_m) == 0)
    )
    min_nf = ops.segment_min(m_of, dur_cur, eligible_nf, mp)
    kill = cand & gate & is_final & (dur_cur > ops.lookup(min_nf, m_of))
    return state.replace(
        legal=state.legal & ~kill, nb_legal=state.nb_legal - _count(kill)
    )


def check_no_op(state: EnvState) -> EnvState:
    """Whether waiting (no-op) is legal (reference ``_check_no_op``): gated on
    a non-empty queue, ≤3 legal machines and ≤4 legal actions; horizons from
    the legal jobs, then the op-chain walk of the illegal jobs as one
    (J, M) elementwise test over the static ``op_pos``/``cum_before`` tables."""
    jp, mp = state.jobs_pad, state.machines_pad
    j_idx = _arange(jp, state.time)
    t = state.time[:, None]
    busy = state.machine_busy_for > 0
    any_busy = busy.any(dim=1)
    gate = any_busy & (state.nb_machine_legal <= 3) & (state.nb_legal <= 4)
    next_ev = t + torch.where(busy, state.machine_busy_for, I32_MAX).amin(dim=1, keepdim=True)

    lj = state.legal
    m1 = state.needed_machine.clamp(0, mp - 1)
    t1 = ops.row_gather(state.op_dur, state.next_op.clamp(0, mp - 1))
    end = t + t1
    early_out = (lj & (end < next_ev)).any(dim=1)
    cap = t + state.max_time_op[:, None]

    first_j = ops.segment_min(m1, j_idx.expand_as(m1), lj, mp)  # (B, M)
    has_legal_m = first_j != I32_MAX
    end_first = ops.lookup(end, first_j.clamp(0, jp - 1))
    contrib = torch.where(has_legal_m, torch.minimum(cap, end_first), -I32_MAX)
    max_horizon = torch.maximum(t, contrib.amax(dim=1, keepdim=True))
    mh = torch.minimum(cap, ops.segment_min(m1, end, lj, mp))

    nm = state.num_machines[:, None]
    illegal = ~state.legal & state.job_valid
    case1 = illegal & (state.job_busy_for > 0) & (state.next_op + 1 < nm)
    case2 = illegal & ~case1 & ~state.noop_pin & (state.next_op < nm)
    start = torch.where(case1, state.next_op + 1, state.next_op)
    active = case1 | case2
    base = torch.where(
        case1,
        t - state.work_done,
        t + ops.lookup(state.machine_busy_for, m1) - state.work_done,
    )
    pos = state.op_pos.to(_I32)
    tn_at = base[:, :, None] + state.cum_before.to(_I32)  # (B, J, M)
    ok_at = (
        active[:, :, None]
        & (pos >= start[:, :, None])
        & (pos < (nm[:, :, None] - 1))
        & (max_horizon[:, :, None] > tn_at)
    )
    tn_min = torch.where(ok_at, tn_at, I32_MAX).amin(dim=1)  # (B, M)
    all_covered = (~state.machine_legal | (tn_min < mh)).all(dim=1)
    noop = gate & ~early_out & (state.nb_machine_legal > 0) & all_covered
    return state.replace(noop_legal=noop)


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------


def step(state: EnvState, action: torch.Tensor) -> Tuple[EnvState, Transition]:
    """One agent step per lane: allocate job ``action[b]`` or wait
    (``action[b] >= num_jobs[b]``), fast-forward, then the two heuristics.
    Branch-free: both branches are masked updates over the batch."""
    jp, mp = state.jobs_pad, state.machines_pad
    j_idx = _arange(jp, state.time)
    m_idx = _arange(mp, state.time)
    action = action.to(_I32)
    is_noop = action >= state.num_jobs
    is_alloc = ~is_noop

    a = torch.where(is_alloc, action.clamp(0, jp - 1), 0)
    lane = torch.arange(a.shape[0], device=a.device)
    a_l = a.long()
    needed_a = state.needed_machine[lane, a_l]
    op = state.next_op[lane, a_l].clamp(0, mp - 1)
    m = needed_a.clamp(0, mp - 1)
    dur = state.op_dur[lane, a_l, op.long()].to(_I32)
    raw_reward = torch.where(is_alloc, dur, 0)

    alloc1 = is_alloc[:, None]
    row_a = (j_idx == a[:, None]) & alloc1  # (B, J)
    row_m = (m_idx == m[:, None]) & alloc1  # (B, M)

    kill_alloc = alloc1 & state.legal & (state.needed_machine == needed_a[:, None])
    machine_busy_for = torch.where(row_m, dur[:, None], state.machine_busy_for)
    job_busy_for = torch.where(row_a, dur[:, None], state.job_busy_for)
    idle_span = state.time[:, None] - state.op_end_at
    idle_frozen = torch.where(row_a, idle_span, state.idle_frozen)
    idle_total_alloc = state.idle_total_alloc + torch.where(row_a, idle_span, 0)
    if state.solution.shape[1]:
        cell = row_a[:, :, None] & (m_idx == op[:, None])[:, None, :]
        solution = torch.where(cell, state.time[:, None, None], state.solution)
    else:
        solution = state.solution
    nm_clip = state.needed_machine.clamp(0, mp - 1)
    unpin = alloc1 & (nm_clip == m[:, None])
    noop_pin = state.noop_pin & ~unpin
    noop1 = is_noop[:, None]
    noop_pin = noop_pin | (noop1 & state.legal)
    ml_clear_noop = ops.segment_any(nm_clip, state.legal, mp)

    legal = state.legal & ~kill_alloc & ~noop1
    nb_legal = torch.where(is_noop, 0, state.nb_legal - _count(kill_alloc))
    machine_legal = torch.where(
        noop1, state.machine_legal & ~ml_clear_noop, state.machine_legal & ~row_m
    )
    nb_machine_legal = torch.where(is_noop, 0, state.nb_machine_legal - 1)

    state = state.replace(
        legal=legal,
        nb_legal=nb_legal,
        machine_legal=machine_legal,
        nb_machine_legal=nb_machine_legal,
        machine_busy_for=machine_busy_for,
        job_busy_for=job_busy_for,
        solution=solution,
        noop_pin=noop_pin,
        idle_frozen=idle_frozen,
        idle_total_alloc=idle_total_alloc,
    )
    state, holes = fast_forward(state)
    raw_reward = raw_reward - holes
    state = prioritization_non_final(state)
    state = check_no_op(state)
    reward = raw_reward.to(torch.float32) / state.max_time_op.to(torch.float32)
    return state, Transition(reward=reward, raw_reward=raw_reward, done=state.done)

"""Plain job-shop env over a batch: the benchmark's frozen reference.

A self-contained copy of the port's plain twin (``core/engine.py``,
``core/ops.py`` and the derived views of ``core/state.py``, as of the
benchmark's first version), frozen here so that no later change to the
program moves the yardstick. It imports nothing of the program, and it works
everything out again from the raw instance tables: the static tables, the
fresh state, every step. Semantics are the reference JSSEnv's
(jss_env.py): allocate a job or wait, the closed-form fast-forward to the
next re-legalisation, the two mask heuristics (prioritisation of non-final
operations, the no-op check), auto-reset of finished lanes. What a policy
sees: the reference's 7 normalised columns, and the 13 of the rich feature
set, written from the JAX package's definition of them.

Every tensor is batch-first and int32 (bool for masks); the state is a dict
of field name -> tensor. ``store_dtype`` narrows every stored integer to a
smaller type after each step, wrapping as that type would: the benchmark's
control (a lower storage precision than the configuration states), never
used to judge a run.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

I32 = torch.int32
I32_MAX = int(np.iinfo(np.int32).max)

DYNAMIC = ("time", "legal", "noop_legal", "nb_legal", "nb_machine_legal", "machine_legal", "machine_busy_for",
           "job_busy_for", "next_op", "work_done", "needed_machine", "op_end_at", "idle_frozen",
           "idle_total_alloc", "noop_pin", "wait4")

State = Dict[str, torch.Tensor]


def load_tables(npz_path, names) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(op_machine, op_dur) (N, J, M) int32 padded to the largest instance
    named, and (num_jobs, num_machines) (N,), read from the instance pack."""
    with np.load(npz_path, allow_pickle=False) as z:
        pack = [str(n) for n in z["names"]]
        idx = [pack.index(n) for n in names]
        nj, nm = z["num_jobs"][idx].astype(np.int32), z["num_machines"][idx].astype(np.int32)
        J, M = int(nj.max()), int(nm.max())
        om = z["op_machine"][idx][:, :J, :M].astype(np.int32)
        od = z["op_dur"][idx][:, :J, :M].astype(np.int32)
    keep = (np.arange(J)[None, :, None] < nj[:, None, None]) & (np.arange(M)[None, None, :] < nm[:, None, None])
    return np.where(keep, om, 0), np.where(keep, od, 0), nj, nm


def batch(tables, lanes: torch.Tensor, device) -> State:
    """Fresh envs for global lane indices ``lanes``: lane ``i`` runs
    instance ``i % N`` of ``tables`` (``load_tables``)."""
    om, od, nj, nm = tables
    idx = (lanes.to(torch.int64) % len(nj)).cpu().numpy()
    take = lambda x: torch.from_numpy(np.ascontiguousarray(x[idx])).to(device)  # noqa: E731
    return init_state(take(om), take(od), take(nj), take(nm))


# ---------------------------------------------------------------------------
# gathers and segment reductions
# ---------------------------------------------------------------------------


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=-1, dtype=I32)


def row_gather(table, idx):
    """table (B, J, M); idx (B, J) -> table[b, j, idx[b, j]]."""
    return torch.gather(table, 2, idx.long()[..., None])[..., 0]


def lookup(vec, idx):
    """vec (B, M); idx (B, ...) -> vec[b, idx[b, ...]]."""
    return torch.gather(vec, 1, idx.reshape(idx.shape[0], -1).long()).reshape(idx.shape)


def segment_min(seg, values, mask, n):
    vals = torch.where(mask, values.to(I32), I32_MAX)
    out = torch.full((seg.shape[0], n), I32_MAX, dtype=I32, device=seg.device)
    return out.scatter_reduce(1, seg.long(), vals, reduce="amin", include_self=True)


def segment_any(seg, mask, n):
    b = seg.shape[0]
    out = torch.zeros((b, n), dtype=I32, device=seg.device)
    out = out.scatter_reduce(1, seg.reshape(b, -1).long(), mask.reshape(b, -1).to(I32), reduce="amax",
                             include_self=True)
    return out > 0


def job_valid(s: State) -> torch.Tensor:
    return _arange(s["op_machine"].shape[1], s["num_jobs"]) < s["num_jobs"][:, None]


def machine_valid(s: State) -> torch.Tensor:
    return _arange(s["op_machine"].shape[2], s["num_machines"]) < s["num_machines"][:, None]


# ---------------------------------------------------------------------------
# construction and reset
# ---------------------------------------------------------------------------


def init_state(op_machine, op_dur, num_jobs, num_machines) -> State:
    op_machine, op_dur = op_machine.to(I32), op_dur.to(I32)
    num_jobs, num_machines = num_jobs.to(I32), num_machines.to(I32)
    jp, mp = op_machine.shape[-2:]
    jv = _arange(jp, op_machine) < num_jobs[:, None]
    p = _arange(mp, op_machine)
    col_pad = (p[None, None, :] >= num_machines[:, None, None]) | ~jv[:, :, None]
    order = torch.argsort(torch.where(col_pad, mp + p, op_machine), dim=2, stable=True).to(I32)
    valid_col = (p[None, None, :] < num_machines[:, None, None]) & jv[:, :, None]
    op_pos = torch.where(valid_col, order, mp)
    cum = torch.cumsum(op_dur, dim=2, dtype=I32)
    cum_excl = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], dim=2)
    cum_before = torch.where(valid_col, torch.gather(cum_excl, 2, op_pos.clamp(0, mp - 1).long()), 0)
    static = dict(op_machine=op_machine, op_dur=op_dur, op_pos=op_pos, cum_before=cum_before,
                  num_jobs=num_jobs, num_machines=num_machines,
                  max_time_op=op_dur.amax(dim=(1, 2)).to(I32),
                  max_time_jobs=op_dur.sum(dim=2, dtype=I32).amax(dim=1).to(I32),
                  sum_op=op_dur.sum(dim=(1, 2), dtype=I32))
    return {**static, **fresh(static)}


def fresh(s: State) -> State:
    """The fresh dynamic fields of every lane around ``s``'s static tables."""
    b, jp, mp = s["op_machine"].shape
    dev = s["op_machine"].device
    jv = job_valid(s)
    needed = torch.where(jv, s["op_machine"][:, :, 0].to(I32), -1)
    ml = segment_any(needed.clamp(0, mp - 1), jv, mp)
    zj = lambda: torch.zeros((b, jp), dtype=I32, device=dev)  # noqa: E731
    return dict(
        time=torch.zeros((b,), dtype=I32, device=dev), legal=jv,
        noop_legal=torch.zeros((b,), dtype=torch.bool, device=dev), nb_legal=s["num_jobs"].clone(),
        nb_machine_legal=_count(ml), machine_legal=ml,
        machine_busy_for=torch.zeros((b, mp), dtype=I32, device=dev), job_busy_for=zj(),
        next_op=torch.where(jv, 0, s["num_machines"][:, None]).to(I32), work_done=zj(),
        needed_machine=needed, op_end_at=zj(), idle_frozen=zj(), idle_total_alloc=zj(),
        noop_pin=torch.zeros((b, jp), dtype=torch.bool, device=dev), wait4=zj(),
    )


def reset_lanes(s: State, done: torch.Tensor) -> State:
    new = fresh(s)
    out = dict(s)
    for k in DYNAMIC:
        out[k] = torch.where(done.reshape((-1,) + (1,) * (s[k].dim() - 1)), new[k], s[k])
    return out


# ---------------------------------------------------------------------------
# fast-forward and the mask heuristics
# ---------------------------------------------------------------------------


def fast_forward(s: State) -> Tuple[State, torch.Tensor]:
    """Closed form of ``while nb_machine_legal == 0 and queue:
    advance_time()``; returns (state, machine idle holes (B,))."""
    mp = s["op_machine"].shape[2]
    t0 = s["time"][:, None]
    tua0 = s["machine_busy_for"]
    busy0 = tua0 > 0
    active = (s["nb_machine_legal"] == 0) & busy0.any(dim=1)
    first_ev = t0 + torch.where(busy0, tua0, I32_MAX).amin(dim=1, keepdim=True)
    last_ev = t0 + tua0.amax(dim=1, keepdim=True)
    nm = s["num_machines"][:, None]
    running = s["job_busy_for"] > 0
    c = t0 + s["job_busy_for"]
    nxt_op = s["next_op"] + 1
    run_ok = running & (nxt_op < nm)
    m_next = row_gather(s["op_machine"], nxt_op.clamp(0, mp - 1)).clamp(0, mp - 1)
    f_next = t0 + lookup(tua0, m_next)
    e_run = torch.maximum(c, f_next)
    mj = s["needed_machine"].clamp(0, mp - 1)
    waiting = ~running & (s["needed_machine"] >= 0) & ~s["legal"] & job_valid(s) & ~s["noop_pin"]
    e_wait = torch.maximum(first_ev, t0 + lookup(tua0, mj))
    e_j = torch.where(run_ok, e_run, torch.where(waiting, e_wait, I32_MAX))
    t_stop = torch.minimum(e_j.amin(dim=1, keepdim=True), last_ev)
    span = t_stop - t0

    performed = torch.where(running, torch.minimum(span, s["job_busy_for"]), 0)
    job_busy_for = torch.where(running, torch.clamp(s["job_busy_for"] - span, min=0), s["job_busy_for"])
    completed = running & (c <= t_stop)
    next_op = s["next_op"] + completed.to(I32)
    finished_now = completed & (next_op == nm)
    continues = completed & (next_op < nm)
    drop = finished_now & s["legal"]
    cand = e_j == t_stop
    ml_add = segment_any(torch.where(run_ok, m_next, mj), cand, mp)
    new = dict(
        time=t_stop[:, 0],
        legal=(s["legal"] & ~drop) | cand,
        nb_legal=s["nb_legal"] - _count(drop) + _count(cand),
        nb_machine_legal=s["nb_machine_legal"] + _count(ml_add & ~s["machine_legal"]),
        machine_legal=s["machine_legal"] | ml_add,
        machine_busy_for=torch.clamp(tua0 - span, min=0),
        job_busy_for=job_busy_for,
        next_op=next_op,
        work_done=s["work_done"] + performed,
        needed_machine=torch.where(continues, m_next, torch.where(finished_now, -1, s["needed_machine"])),
        op_end_at=torch.where(completed, c, s["op_end_at"]),
        wait4=torch.where(continues, torch.clamp(f_next - c, min=0), s["wait4"]),
    )
    out = dict(s)
    for k, v in new.items():
        out[k] = torch.where(active[:, None] if v.dim() == 2 else active, v, s[k])
    holes = torch.where(machine_valid(s), span - torch.minimum(tua0, span), 0).sum(dim=1, dtype=I32)
    return out, torch.where(active, holes, 0)


def prioritization_non_final(s: State) -> State:
    mp = s["op_machine"].shape[2]
    m_of = s["needed_machine"].clamp(0, mp - 1)
    cand = s["legal"] & (s["needed_machine"] >= 0)
    gate = lookup(s["machine_legal"], m_of)
    dur_cur = row_gather(s["op_dur"], s["next_op"].clamp(0, mp - 1))
    is_final = s["next_op"] == (s["num_machines"][:, None] - 1)
    next_m = row_gather(s["op_machine"], (s["next_op"] + 1).clamp(0, mp - 1))
    eligible_nf = cand & gate & ~is_final & (lookup(s["machine_busy_for"], next_m) == 0)
    min_nf = segment_min(m_of, dur_cur, eligible_nf, mp)
    kill = cand & gate & is_final & (dur_cur > lookup(min_nf, m_of))
    return {**s, "legal": s["legal"] & ~kill, "nb_legal": s["nb_legal"] - _count(kill)}


def check_no_op(s: State) -> State:
    jp, mp = s["op_machine"].shape[1:]
    t = s["time"][:, None]
    busy = s["machine_busy_for"] > 0
    gate = busy.any(dim=1) & (s["nb_machine_legal"] <= 3) & (s["nb_legal"] <= 4)
    next_ev = t + torch.where(busy, s["machine_busy_for"], I32_MAX).amin(dim=1, keepdim=True)
    lj = s["legal"]
    m1 = s["needed_machine"].clamp(0, mp - 1)
    end = t + row_gather(s["op_dur"], s["next_op"].clamp(0, mp - 1))
    early_out = (lj & (end < next_ev)).any(dim=1)
    cap = t + s["max_time_op"][:, None]
    first_j = segment_min(m1, _arange(jp, t).expand_as(m1), lj, mp)
    end_first = lookup(end, first_j.clamp(0, jp - 1))
    contrib = torch.where(first_j != I32_MAX, torch.minimum(cap, end_first), -I32_MAX)
    max_horizon = torch.maximum(t, contrib.amax(dim=1, keepdim=True))
    mh = torch.minimum(cap, segment_min(m1, end, lj, mp))
    nm = s["num_machines"][:, None]
    illegal = ~s["legal"] & job_valid(s)
    case1 = illegal & (s["job_busy_for"] > 0) & (s["next_op"] + 1 < nm)
    case2 = illegal & ~case1 & ~s["noop_pin"] & (s["next_op"] < nm)
    start = torch.where(case1, s["next_op"] + 1, s["next_op"])
    base = torch.where(case1, t - s["work_done"], t + lookup(s["machine_busy_for"], m1) - s["work_done"])
    tn_at = base[:, :, None] + s["cum_before"]
    ok_at = ((case1 | case2)[:, :, None] & (s["op_pos"] >= start[:, :, None])
             & (s["op_pos"] < (nm[:, :, None] - 1)) & (max_horizon[:, :, None] > tn_at))
    tn_min = torch.where(ok_at, tn_at, I32_MAX).amin(dim=1)
    all_covered = (~s["machine_legal"] | (tn_min < mh)).all(dim=1)
    return {**s, "noop_legal": gate & ~early_out & (s["nb_machine_legal"] > 0) & all_covered}


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------


def step(s: State, action: torch.Tensor) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """One agent step per lane: allocate job ``action`` or wait (``action >=
    num_jobs``). Returns (state, raw reward (B,) int32, done (B,) bool)."""
    jp, mp = s["op_machine"].shape[1:]
    j_idx, m_idx = _arange(jp, s["time"]), _arange(mp, s["time"])
    action = action.to(I32)
    is_noop = action >= s["num_jobs"]
    is_alloc = ~is_noop
    a = torch.where(is_alloc, action.clamp(0, jp - 1), 0).long()
    lane = torch.arange(a.shape[0], device=a.device)
    needed_a = s["needed_machine"][lane, a]
    op = s["next_op"][lane, a].clamp(0, mp - 1)
    m = needed_a.clamp(0, mp - 1)
    dur = s["op_dur"][lane, a, op.long()]
    raw = torch.where(is_alloc, dur, 0)
    alloc1, noop1 = is_alloc[:, None], is_noop[:, None]
    row_a = (j_idx == a[:, None]) & alloc1
    row_m = (m_idx == m[:, None]) & alloc1
    kill_alloc = alloc1 & s["legal"] & (s["needed_machine"] == needed_a[:, None])
    idle_span = s["time"][:, None] - s["op_end_at"]
    nm_clip = s["needed_machine"].clamp(0, mp - 1)
    noop_pin = (s["noop_pin"] & ~(alloc1 & (nm_clip == m[:, None]))) | (noop1 & s["legal"])
    ml_clear = segment_any(nm_clip, s["legal"], mp)
    s = {
        **s,
        "legal": s["legal"] & ~kill_alloc & ~noop1,
        "nb_legal": torch.where(is_noop, 0, s["nb_legal"] - _count(kill_alloc)),
        "machine_legal": torch.where(noop1, s["machine_legal"] & ~ml_clear, s["machine_legal"] & ~row_m),
        "nb_machine_legal": torch.where(is_noop, 0, s["nb_machine_legal"] - 1),
        "machine_busy_for": torch.where(row_m, dur[:, None], s["machine_busy_for"]),
        "job_busy_for": torch.where(row_a, dur[:, None], s["job_busy_for"]),
        "noop_pin": noop_pin,
        "idle_frozen": torch.where(row_a, idle_span, s["idle_frozen"]),
        "idle_total_alloc": s["idle_total_alloc"] + torch.where(row_a, idle_span, 0),
    }
    s, holes = fast_forward(s)
    s = check_no_op(prioritization_non_final(s))
    return s, raw - holes, s["nb_legal"] == 0


def narrow(s: State, store_dtype: Optional[torch.dtype]) -> State:
    """Every dynamic integer field stored in ``store_dtype`` and read back
    (wrapping as that type does); the identity for None."""
    if store_dtype is None:
        return s
    out = dict(s)
    for k in DYNAMIC:
        if s[k].dtype == I32:
            out[k] = s[k].to(store_dtype).to(I32)
    return out


def step_autoreset(s: State, action: torch.Tensor):
    """``step``, then a fresh start on the finished lanes. Returns (state,
    raw reward, done)."""
    s, raw, done = step(s, action)
    return reset_lanes(s, done), raw, done


# ---------------------------------------------------------------------------
# what a policy sees
# ---------------------------------------------------------------------------


def action_mask(s: State) -> torch.Tensor:
    """(B, J+1) bool: the legal jobs, then the no-op slot."""
    return torch.cat([s["legal"], s["noop_legal"][:, None]], dim=-1)


def observation(s: State) -> torch.Tensor:
    """(B, J, 7) float32: the reference env's normalised state matrix, its
    column 0 the legal mask."""
    f32 = torch.float32
    running = s["job_busy_for"] > 0
    finished_job = s["next_op"] >= s["num_machines"][:, None]
    span = s["time"][:, None] - s["op_end_at"]
    idle_since = torch.where(running, s["idle_frozen"], torch.where(finished_job, 0, span))
    idle_total = s["idle_total_alloc"] + torch.where(running | finished_job, 0, span)
    max_op = s["max_time_op"][:, None].to(f32)
    sum_op = s["sum_op"][:, None].to(f32)
    one = torch.ones((), dtype=f32, device=s["time"].device)
    cols = torch.stack([
        s["legal"].to(f32),
        s["job_busy_for"].to(f32) / max_op,
        s["next_op"].to(f32) / s["num_machines"][:, None].to(f32),
        s["work_done"].to(f32) / s["max_time_jobs"][:, None].to(f32),
        torch.where(s["needed_machine"] == -1, one, s["wait4"].to(f32) / max_op),
        idle_since.to(f32) / sum_op,
        idle_total.to(f32) / sum_op,
    ], dim=-1)
    return torch.where(job_valid(s)[..., None], cols, 0.0)


def rich_observation(s: State) -> torch.Tensor:
    """(B, J, 13) float32: ``observation``'s 7 columns, then 6 channels of a
    job's current operation, its remaining work and the machine it needs,
    as the JAX package's ``EnvState.rich_obs`` defines them; padded rows 0.

    7. the current operation's duration over ``max_time_op``: the duration
       at operation ``min(next_op, M_pad - 1)``, so a finished job of an
       unpadded lane reads its last operation's and one of a lane with
       padded machines the padding's 0, as the definition's clipped index
       does;
    8. the work not yet started (operations from ``next_op`` on) over
       ``max_time_jobs``;
    9. the operations left, ``(num_machines - next_op) / num_machines``, 0
       once the job is finished;
    10. the critical ratio ``(1.5 * job total - time) / max(work left, 1)``
        clipped to [0, 4], over 4;
    11. the time left on the machine the job needs over ``max_time_op``, 0
        for a finished job;
    12. the legal jobs waiting for that machine, the job itself included,
        over ``num_jobs``: counted per machine and read back (the definition
        compares every pair of jobs), 0 for a finished job.
    """
    f32 = torch.float32
    mp = s["op_machine"].shape[2]
    dur = s["op_dur"]
    started = _arange(mp, dur)[None, None, :] < s["next_op"][:, :, None]
    rem_work = torch.where(started, 0, dur).sum(dim=2, dtype=I32).to(f32)
    cur_dur = row_gather(dur, s["next_op"].clamp(0, mp - 1)).to(f32)
    total = dur.sum(dim=2, dtype=I32).to(f32)
    nm = s["num_machines"][:, None]
    left = torch.where(s["next_op"] >= nm, 0.0, (nm - s["next_op"]).to(f32) / nm.to(f32))
    ratio = torch.clamp((1.5 * total - s["time"][:, None].to(f32)) / torch.clamp(rem_work, min=1.0), 0.0, 4.0) / 4.0
    needs = s["needed_machine"] >= 0
    m = s["needed_machine"].clamp(0, mp - 1)
    busy = torch.where(needs, lookup(s["machine_busy_for"], m), 0).to(f32)
    waiting = torch.zeros((s["time"].shape[0], mp), dtype=I32, device=dur.device)
    waiting = waiting.scatter_add(1, m.long(), (s["legal"] & needs).to(I32))
    contention = torch.where(needs, lookup(waiting, m), 0).to(f32)
    max_op = s["max_time_op"][:, None].to(f32)
    extra = torch.stack([cur_dur / max_op, rem_work / s["max_time_jobs"][:, None].to(f32), left, ratio,
                         busy / max_op, contention / s["num_jobs"][:, None].to(f32)], dim=-1)
    return torch.cat([observation(s), torch.where(job_valid(s)[..., None], extra, 0.0)], dim=-1)


FEATURES = {"reference": (7, observation), "rich": (13, rich_observation)}


def features(name: str):
    """(width, observation function) of the feature set ``name``."""
    if name not in FEATURES:
        raise ValueError(f"unknown features {name!r}; one of {sorted(FEATURES)}")
    return FEATURES[name]

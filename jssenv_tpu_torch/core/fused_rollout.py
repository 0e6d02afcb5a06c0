"""The whole auto-resetting rollout in one CUDA launch, with plain twins.

The PyTorch counterpart of ``jssenv_tpu/core/pallas_rollout.py``. Two entry
points with the JAX signatures (minus the TPU's ``tile``/``interpret``):

* ``rollout_driven(state, actions, num_steps, return_ends=False)`` — T steps
  on a caller-supplied (T, B) action stream, finished lanes auto-reset exactly
  like ``vector.step_autoreset``; returns (final state, (T, B) int32 raw
  rewards) and, when asked, the (T, B) int32 episode ends: the makespan where
  a lane finished at that step, else 0. ``step_autoreset`` is one such step
  with ``vector.step_autoreset``'s signature and results: the env step of the
  learner (``parallel.learner``).
* ``rollout_free(state, num_steps, seed=0, with_solution=True, bits=None)`` —
  T steps of a uniform-over-legal policy sampled inside the kernel, auto-reset
  and episode stats with the exact reward-identity check
  ``raw return == 2*sum_op - M*makespan``; returns summary stats.

On a CUDA state each launches its hand-written kernel
(``csrc/rollout.cu``) or raises; on a CPU state each runs its plain twin
(``rollout_driven_reference`` / ``rollout_free_reference``), built on
``core.engine`` and ``vector``. Nothing falls back from one to the other.

Random bits: with ``bits=None`` the free rollout draws one 32-bit Philox4x32-10
word per (step, lane), keyed by ``seed`` with counter (t, lane_offset + lane);
the twin computes the same words (``philox_bits``), so both modes compare
exactly. ``lane_offset`` (0 by default) is the lane's place in a batch split
over ranks: a shard draws the words its lanes draw in the whole batch.

Value dtype: the free rollout keeps its state buffer in int16 wherever every
stored value fits (``value_dtype``, the JAX package's int16 mode) and then
launches the int16 instantiation of its kernel; the driven rollout stays
int32, as in the JAX package.

Host plumbing: the dynamic state moves to one batch-last (R, B) int32 (or
int16) buffer (``_to_lanes`` / ``_from_lanes``, rows in ``_ROWS`` order), the static tables
to one (n_inst, 4, J, M) int32 stack of the batch's distinct instances with a
per-lane instance index, so ragged batches need no lane grouping. The stack
is built once per batch and cached (``_lane_inputs``). ``launch_geometry``
sizes the launch: a warp per lane, each block's lanes with their state in
shared memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from jssenv_tpu_torch import vector
from jssenv_tpu_torch.core import _build, engine
from jssenv_tpu_torch.core.state import I32_MAX, EnvState

_I32 = torch.int32

# Kernel launches per entry point: each wrapper adds one where it launches.
# "rollout_free_i16" counts the free kernel's int16 instantiation.
LAUNCHES: Dict[str, int] = {"rollout_driven": 0, "rollout_free": 0, "rollout_free_i16": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# Dynamic fields in the (R, B) lane buffer, in the kernel's row order
# (csrc/rollout.cu ``Layout``); kinds: l = one row, J/M = one row per job or
# machine, JM = J*M rows (solution, absent for a light state or when the free
# rollout skips the solution).
_ROWS = (
    ("time", "l"),
    ("noop_legal", "l"),
    ("nb_legal", "l"),
    ("nb_machine_legal", "l"),
    ("legal", "J"),
    ("machine_legal", "M"),
    ("machine_busy_for", "M"),
    ("job_busy_for", "J"),
    ("next_op", "J"),
    ("work_done", "J"),
    ("needed_machine", "J"),
    ("op_end_at", "J"),
    ("idle_frozen", "J"),
    ("idle_total_alloc", "J"),
    ("noop_pin", "J"),
    ("wait4", "J"),
    ("solution", "JM"),
)


def _row_sizes(J: int, M: int, with_solution: bool):
    n = {"l": 1, "J": J, "M": M, "JM": J * M if with_solution else 0}
    return [n[kind] for _, kind in _ROWS]


def value_dtype(state: EnvState) -> torch.dtype:
    """The free kernel's storage dtype: int16 wherever every stored value
    fits, i.e. ``sum_op + 2*max_time_jobs + max_time_op < 32000`` with each
    term the maximum over the batch's lanes (so one large instance in a
    ragged batch keeps it int32), else int32. The bound covers every stored
    value: ``time``, ``op_end_at`` and ``idle_total_alloc`` never exceed the
    makespan, which never exceeds ``sum_op``. It is the JAX package's bound
    (``pallas_rollout.value_dtype``); there the int16 mode also waits for
    ``JSS_PALLAS_INT16=1`` because the TPU compiler crashes on it, a gate
    the CUDA kernel does not need."""
    so, mj, mo = torch.stack(
        [state.sum_op.max(), state.max_time_jobs.max(), state.max_time_op.max()]
    ).tolist()
    return torch.int16 if so + 2 * mj + mo < 32000 else _I32


def _to_lanes(state: EnvState, with_solution: bool, vdt: torch.dtype = _I32) -> torch.Tensor:
    """Batch-first dynamic fields -> one contiguous (R, B) buffer of the
    storage dtype ``vdt`` (int32 or int16; masks as 0/1)."""
    B = state.batch_size
    cols = [
        getattr(state, name).reshape(B, -1).to(vdt)
        for name, kind in _ROWS
        if with_solution or kind != "JM"
    ]
    return torch.cat(cols, dim=1).t().contiguous()


def _from_lanes(buf: torch.Tensor, state: EnvState, with_solution: bool) -> EnvState:
    """Inverse of ``_to_lanes`` (of either storage dtype): the fields of
    ``state`` replaced from ``buf``, in their own shapes and dtypes (masks
    back to bool)."""
    parts = torch.split(buf, _row_sizes(state.jobs_pad, state.machines_pad, with_solution))
    upd = {}
    for (name, kind), rows in zip(_ROWS, parts):
        if kind == "JM" and not with_solution:
            continue
        ref = getattr(state, name)
        upd[name] = rows.t().reshape(ref.shape).to(ref.dtype)
    return state.replace(**upd)


# ---------------------------------------------------------------------------
# per-lane instance tables
# ---------------------------------------------------------------------------


_TABLES = ("op_machine", "op_dur", "op_pos", "cum_before")
_LANE_FIELDS = _TABLES + ("num_jobs", "num_machines", "max_time_op", "sum_op")

# (tab, lanec) of a batch, keyed by the identity and in-place version counter
# of its static tensors: a rollout passes the same never-written tables on
# every call (the JAX package caches its lane grouping the same way). The
# entries hold the tensors, so an id is not reused while it is cached.
# Inference-mode tensors keep no version counter and are keyed by id alone.
_LANE_CACHE: Dict[tuple, tuple] = {}
_LANE_CACHE_SIZE = 8


def _lane_inputs(state: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tab, lanec): the (n_inst, 4, J, M) int32 stack of distinct instance
    tables [op_machine, op_dur, op_pos, cum_before], and the (5, B) int32 lane
    constants [instance index, num_jobs, num_machines, max_time_op, sum_op]."""
    fields = tuple(getattr(state, f) for f in _LANE_FIELDS)
    key = tuple((id(t), -1 if t.is_inference() else t._version) for t in fields)
    hit = _LANE_CACHE.get(key)
    if hit is not None:
        return hit[1]
    out = _lane_inputs_uncached(state)
    if len(_LANE_CACHE) >= _LANE_CACHE_SIZE:
        _LANE_CACHE.clear()
    _LANE_CACHE[key] = (fields, out)
    return out


def _fingerprint(flat: torch.Tensor) -> torch.Tensor:
    """(B,) int64 key of each row: equal rows, equal keys."""
    g = torch.Generator().manual_seed(0x5EED)
    w = torch.randint(-(2**62), 2**62, (flat.shape[1],), dtype=torch.int64, generator=g)
    return (flat.to(torch.int64) * w.to(flat.device)).sum(dim=1)


def _lane_inputs_uncached(state: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact deduplication of the lanes' rows of tables and bounds: sorted by
    fingerprint, a new instance starts wherever a row differs from the one
    before it. Equal rows have equal keys and end up side by side; a key
    collision can only split an instance into several equal entries, never
    merge two. (``torch.unique(dim=0)`` does the same exactly but sorts rows
    lexicographically, tens of ms at full width.)"""
    B, J, M = state.batch_size, state.jobs_pad, state.machines_pad
    flat = torch.cat(
        [getattr(state, f).reshape(B, -1).to(_I32) for f in _TABLES]
        + [state.num_jobs[:, None].to(_I32), state.num_machines[:, None].to(_I32)],
        dim=1,
    )
    order = torch.argsort(_fingerprint(flat), stable=True)
    rows = flat[order]
    first = torch.ones((B,), dtype=torch.bool, device=flat.device)
    first[1:] = (rows[1:] != rows[:-1]).any(dim=1)
    inv = torch.empty_like(order)
    inv[order] = torch.cumsum(first, dim=0) - 1
    tab = rows[first][:, : 4 * J * M].reshape(-1, 4, J, M).contiguous()
    lanec = torch.stack(
        [inv.to(_I32), state.num_jobs, state.num_machines, state.max_time_op, state.sum_op]
    ).to(_I32).contiguous()
    return tab, lanec


# ---------------------------------------------------------------------------
# kernel binding
# ---------------------------------------------------------------------------


# Launch geometry (csrc/rollout.cu): a warp per env lane, the lane's state
# rows and 2M int32 scratch words in shared memory.
_WARP = 32  # threads a lane (JSS_WARP in the source)
_BLOCK_THREADS = 256  # a block's threads at most (JSS_MAX_THREADS in the source)
_SMEM_LIMIT = 232448  # shared bytes a block can have on Hopper (227 KB)
_MAX_M = 64  # JSS_MAX_M: at most two machines a thread


class Geometry(NamedTuple):
    group: int  # threads per lane: one warp
    lanes: int  # lanes per block
    threads: int  # threads per block, lanes * group
    state_stride: int  # a lane's state slice, in elements of the storage dtype
    scratch_stride: int  # a lane's scratch slice, in int32 words
    shared_bytes: int  # dynamic shared memory of a block


def _bank_pad(words: int) -> int:
    """The least stride >= ``words`` that is 1 modulo 32 words: the rows of
    consecutive lanes start on different banks."""
    return words + (1 - words) % 32


def launch_geometry(J: int, M: int, vdt: torch.dtype = _I32) -> Geometry:
    """The kernels' launch geometry for a (J, M) batch whose state is stored
    in ``vdt``. A lane runs on one warp: thread r owns jobs r, r + 32, ...
    and machines r, r + 32. Lanes per block: as many as fit
    ``_BLOCK_THREADS`` threads and the shared-memory limit. Raises
    ``ValueError`` where one lane cannot fit."""
    if M > _MAX_M:
        raise ValueError(f"the CUDA kernel handles at most {_MAX_M} machines, got {M}")
    item = 2 if vdt == torch.int16 else 4
    rows = 4 + 10 * J + 2 * M
    state_words = _bank_pad(-(-rows * item // 4))
    scratch = _bank_pad(2 * M)
    lane_bytes = 4 * (state_words + scratch)
    if lane_bytes > _SMEM_LIMIT:
        raise ValueError(
            f"a lane of J={J} jobs and M={M} machines needs {lane_bytes} bytes of shared "
            f"memory; a block has at most {_SMEM_LIMIT}"
        )
    lanes = min(_BLOCK_THREADS // _WARP, _SMEM_LIMIT // lane_bytes)
    return Geometry(_WARP, lanes, lanes * _WARP, state_words * 4 // item, scratch, lanes * lane_bytes)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/rollout.cu`` with its C signatures declared."""
    lib = _build.load("rollout")
    P, I = ctypes.c_void_p, ctypes.c_int
    geometry = [I, I, I, I]  # lanes, state stride, scratch stride, shared bytes
    lib.jss_rollout_driven.argtypes = [P, P, P, P, P, P, I, I, I, I, I, *geometry, P]
    lib.jss_rollout_driven.restype = I
    for fn in (lib.jss_rollout_free, lib.jss_rollout_free_i16):
        fn.argtypes = [P, P, P, P, ctypes.c_ulonglong, P, P, I, I, I, I, I, *geometry, P]
        fn.restype = I
    return lib


def _geometry_args(geo: Geometry):
    return geo.lanes, geo.state_stride, geo.scratch_stride, geo.shared_bytes


def _check_launch(err: int, name: str, geo: Geometry) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch refused or failed with cudaError {err} ({geo})")


def _check_kernel_inputs(state: EnvState, *tensors: torch.Tensor, dtype: torch.dtype = _I32) -> None:
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"kernel input must be contiguous {dtype} on {dev}, got {t.dtype} on {t.device}"
            )


def launch_driven(
    state: EnvState, buf, tab, lanec, actions, rewards, with_solution: bool, ends=None
) -> None:
    """One ``rollout_driven_kernel`` launch on prepared buffers (``buf`` is
    updated in place, ``rewards`` (T, B) and, unless None, ``ends`` (T, B)
    written) on the current stream."""
    _check_kernel_inputs(state, buf, tab, lanec, actions, rewards, *(() if ends is None else (ends,)))
    T, B = actions.shape
    if rewards.shape != (T, B) or (ends is not None and ends.shape != (T, B)):
        raise ValueError(f"rewards and ends must be (T, B)=({T}, {B})")
    geo = launch_geometry(state.jobs_pad, state.machines_pad)
    with torch.cuda.device(state.device):
        err = _lib().jss_rollout_driven(
            buf.data_ptr(), tab.data_ptr(), lanec.data_ptr(), actions.data_ptr(),
            rewards.data_ptr(), None if ends is None else ends.data_ptr(), B, state.jobs_pad,
            state.machines_pad, T, int(with_solution), *_geometry_args(geo),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(err, "rollout_driven_kernel", geo)
    LAUNCHES["rollout_driven"] += 1


def launch_free(
    state: EnvState, buf, tab, lanec, bits, seed: int, stats, ret, T: int, vdt: torch.dtype = _I32,
    lane_offset: int = 0,
) -> None:
    """One ``rollout_free_kernel`` launch on a light ``buf`` (no solution
    rows), which it reads and does not write: per-lane stats (4, B) int64 and
    returns (B,) float32 written. ``vdt`` picks the instantiation (int32 or
    int16) and must be ``buf``'s dtype: a buffer is never converted here.
    ``lane_offset``: the global index of lane 0 in the Philox counter."""
    if vdt not in (_I32, torch.int16):
        raise ValueError(f"the free kernel stores int32 or int16, not {vdt}")
    if buf.dtype != vdt:
        raise ValueError(f"the {vdt} free kernel needs a {vdt} state buffer, got {buf.dtype}")
    _check_kernel_inputs(state, buf, dtype=vdt)
    _check_kernel_inputs(state, tab, lanec, *(() if bits is None else (bits,)))
    if stats.dtype != torch.int64 or ret.dtype != torch.float32:
        raise ValueError("stats must be int64 and ret float32")
    i16 = vdt == torch.int16
    fn = _lib().jss_rollout_free_i16 if i16 else _lib().jss_rollout_free
    geo = launch_geometry(state.jobs_pad, state.machines_pad, vdt)
    with torch.cuda.device(state.device):
        err = fn(
            buf.data_ptr(), tab.data_ptr(), lanec.data_ptr(),
            None if bits is None else bits.data_ptr(), seed & (2**64 - 1),
            stats.data_ptr(), ret.data_ptr(), state.batch_size, state.jobs_pad,
            state.machines_pad, T, int(lane_offset), *_geometry_args(geo),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(err, "rollout_free_kernel<int16>" if i16 else "rollout_free_kernel", geo)
    LAUNCHES["rollout_free_i16" if i16 else "rollout_free"] += 1


# ---------------------------------------------------------------------------
# argument checks shared by the kernel and the twins
# ---------------------------------------------------------------------------


def _solution_mode(state: EnvState) -> bool:
    rows = state.solution.shape[1]
    if rows not in (0, state.jobs_pad):
        raise ValueError(f"solution has {rows} rows; expected 0 or {state.jobs_pad}")
    return rows > 0


def _int_stream(x: torch.Tensor, name: str, T: int, state: EnvState) -> torch.Tensor:
    """A (T, B) integer stream as contiguous int32 on the state's device
    (uint32 words are reinterpreted bit for bit)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.device != state.device:
        raise ValueError(f"{name} is on {x.device}, the state on {state.device}")
    if tuple(x.shape) != (T, state.batch_size):
        raise ValueError(f"{name} must be (T, B)=({T}, {state.batch_size}), got {tuple(x.shape)}")
    if x.dtype == torch.uint32:
        x = x.view(_I32)
    elif x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"{name} must be an integer tensor, got {x.dtype}")
    return x.to(_I32).contiguous()


# ---------------------------------------------------------------------------
# driven rollout
# ---------------------------------------------------------------------------


def rollout_driven(state: EnvState, actions: torch.Tensor, num_steps: int, return_ends: bool = False):
    """Run ``num_steps`` steps on a (T, B) action stream with auto-reset.

    Returns (final state, (T, B) int32 raw rewards), and with
    ``return_ends`` also the (T, B) int32 episode ends (the makespan where
    the lane finished at that step, else 0); stepwise identical to
    ``vector.step_autoreset`` on the same actions. A light state
    (``vector.strip_solution``) stays light. CUDA state: one kernel launch;
    CPU state: the plain twin."""
    T = int(num_steps)
    actions = _int_stream(actions, "actions", T, state)
    with_solution = _solution_mode(state)
    if state.device.type == "cpu":
        return rollout_driven_reference(state, actions, T, return_ends)
    return _driven_kernel(state, actions, T, with_solution, return_ends)


def _driven_kernel(state: EnvState, actions: torch.Tensor, T: int, with_solution: bool, with_ends: bool):
    buf = _to_lanes(state, with_solution)
    tab, lanec = _lane_inputs(state)
    rewards = torch.empty((T, state.batch_size), dtype=_I32, device=state.device)
    ends = torch.empty_like(rewards) if with_ends else None
    launch_driven(state, buf, tab, lanec, actions, rewards, with_solution, ends)
    out = (_from_lanes(buf, state, with_solution), rewards)
    return out + (ends,) if with_ends else out


def rollout_driven_reference(
    state: EnvState, actions: torch.Tensor, num_steps: int, return_ends: bool = False
):
    """Plain twin of the driven kernel: per step, ``vector.step_autoreset``'s
    two calls (``vstep``, then ``reset_lanes`` on the finished lanes), the
    ends taken from ``tr.done`` and the stepped state's time between them."""
    raws, ends = [], []
    for t in range(int(num_steps)):
        new_state, tr = vector.vstep(state, actions[t])
        raws.append(tr.raw_reward)
        ends.append(torch.where(tr.done, new_state.time, 0))
        state = vector.reset_lanes(new_state, tr.done)
    empty = torch.empty((0, state.batch_size), dtype=_I32, device=state.device)
    out = (state, torch.stack(raws) if raws else empty, torch.stack(ends) if ends else empty)
    return out if return_ends else out[:2]


def step_autoreset(
    state: EnvState, actions: torch.Tensor, stats: vector.RolloutStats
) -> Tuple[EnvState, engine.Transition, vector.RolloutStats]:
    """``vector.step_autoreset`` through the driven kernel: one
    ``rollout_driven`` launch at T=1 with ends on a CUDA state (a failed
    build or launch raises), its twin on a CPU state. The same results: the
    Transition (scaled ``reward`` as in ``engine.step``, ``raw_reward``,
    ``done``) and the stats, whose makespans come from the ends, exactly."""
    state, raw, ends = rollout_driven(state, actions[None], 1, return_ends=True)
    raw, ends = raw[0], ends[0]
    done = ends > 0  # a finished episode has a positive makespan
    reward = raw.to(torch.float32) / state.max_time_op.to(torch.float32)
    stats = vector.RolloutStats(
        episodes=stats.episodes + done.sum(),
        total_makespan=stats.total_makespan + ends.sum(dtype=torch.int64),
        min_makespan=torch.minimum(stats.min_makespan, torch.where(done, ends, I32_MAX).amin()),
        total_return=stats.total_return + reward.sum(),
        steps=stats.steps + actions.shape[0],
    )
    return state, engine.Transition(reward=reward, raw_reward=raw, done=done), stats


# ---------------------------------------------------------------------------
# free-running rollout
# ---------------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _philox4x32(c, k0: int, k1: int):
    """Philox4x32-10 on four (N,) int64 counter words holding uint32 values;
    returns the four output words. int64 products wrap like uint64, so the
    high 32 bits come out exact."""
    c0, c1, c2, c3 = c
    for _ in range(10):
        p0, p1 = c0 * _PHILOX_M0, c2 * _PHILOX_M1
        hi0, lo0 = (p0 >> 32) & _U32, p0 & _U32
        hi1, lo1 = (p1 >> 32) & _U32, p1 & _U32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
    return c0, c1, c2, c3


def philox_bits(seed: int, t: int, batch_size: int, device, lane_offset: int = 0) -> torch.Tensor:
    """(B,) int32 random words of step ``t``: word 0 of Philox4x32-10 with
    key = ``seed`` (64 bits) and counter (t, lane_offset + lane, 0, 0) — the
    words the free kernel draws with ``bits=None``."""
    seed &= 2**64 - 1
    lane = (torch.arange(batch_size, dtype=torch.int64, device=device) + lane_offset) & _U32
    z = torch.zeros_like(lane)
    w = _philox4x32((z + (t & _U32), lane, z, z), seed & _U32, seed >> 32)[0]
    return (w - ((w >> 31) << 32)).to(_I32)  # uint32 -> int32, same bits


def sample_from_bits(bits: torch.Tensor, state: EnvState) -> torch.Tensor:
    """The kernel's sampling rule: ``k = (bits >>> 1) mod (nb_legal +
    noop_legal)``; the k-th legal job (index order), or the no-op (action id
    ``num_jobs``) when ``k >= nb_legal``. Logical shift: torch's ``>>`` on
    int32 is arithmetic, hence the mask."""
    k31 = (bits >> 1) & 0x7FFFFFFF
    n = state.nb_legal + state.noop_legal.to(_I32)
    k = k31 % torch.clamp(n, min=1)
    csum = torch.cumsum(state.legal.to(_I32), dim=1)
    chosen = state.legal & (csum == (k + 1)[:, None])
    j = torch.arange(state.jobs_pad, dtype=_I32, device=state.device)
    job = torch.where(chosen, j, 0).sum(dim=1, dtype=_I32)
    return torch.where(k >= state.nb_legal, state.num_jobs, job)


def _reduce_stats(lanes: Dict[str, torch.Tensor], T: int, B: int) -> Dict[str, torch.Tensor]:
    dev = lanes["episodes"].device
    return {
        "episodes": lanes["episodes"].sum(),
        "total_makespan": lanes["mk_sum"].sum(),
        "min_makespan": lanes["mk_min"].min().to(_I32),
        "steps": torch.tensor(T * B, dtype=torch.int64, device=dev),
        "identity_violations": lanes["viol"].sum(),
        "total_return": lanes["ret"].sum(),
    }


def free_lane_stats(
    state: EnvState,
    num_steps: int,
    seed: int = 0,
    bits: Optional[torch.Tensor] = None,
    lane_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """Per-lane stats of a free rollout, (B,) each: ``episodes``, ``mk_sum``
    (int64), ``mk_min`` (int64, INT32_MAX where no episode ended), ``viol``
    (int64), ``ret`` (float32 sum of scaled rewards). Kernel on CUDA (its
    int16 instantiation where ``value_dtype`` says int16), twin on CPU;
    ``rollout_free`` reduces these. The stats never read the schedule, so
    both run on the light state (``vector.strip_solution``).
    ``lane_offset``: where this batch starts in a batch split over ranks
    (``parallel.mesh``); lane ``b`` draws global lane ``lane_offset + b``'s
    Philox words, so a shard's stats are its lanes' stats in the whole
    batch."""
    T = int(num_steps)
    if bits is not None:
        bits = _int_stream(bits, "bits", T, state)
    if state.device.type == "cpu":
        return free_lane_stats_reference(state, T, seed, bits, lane_offset)
    return _free_kernel(state, T, seed, bits, lane_offset=lane_offset)


def _free_kernel(state: EnvState, T: int, seed: int, bits, vdt: Optional[torch.dtype] = None,
                 lane_offset: int = 0):
    """One free-kernel launch in the storage dtype ``vdt`` (by default
    ``value_dtype``'s; an explicit int32 runs a batch that fits int16 in the
    int32 instantiation, to hold the two against each other)."""
    B = state.batch_size
    vdt = value_dtype(state) if vdt is None else vdt
    buf = _to_lanes(state, with_solution=False, vdt=vdt)
    tab, lanec = _lane_inputs(state)
    stats = torch.empty((4, B), dtype=torch.int64, device=state.device)
    ret = torch.empty((B,), dtype=torch.float32, device=state.device)
    launch_free(state, buf, tab, lanec, bits, int(seed), stats, ret, T, vdt, lane_offset)
    return {"episodes": stats[0], "mk_sum": stats[1], "mk_min": stats[2], "viol": stats[3], "ret": ret}


def free_lane_stats_reference(
    state: EnvState,
    num_steps: int,
    seed: int = 0,
    bits: Optional[torch.Tensor] = None,
    lane_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """Plain twin of the free kernel, per lane: sample with
    ``sample_from_bits``, ``engine.step``, identity check, auto-reset."""
    state = vector.strip_solution(state)
    B, dev = state.batch_size, state.device
    z64 = lambda: torch.zeros((B,), dtype=torch.int64, device=dev)  # noqa: E731
    episodes, mk_sum, viol = z64(), z64(), z64()
    mk_min = torch.full((B,), I32_MAX, dtype=torch.int64, device=dev)
    ret = torch.zeros((B,), dtype=torch.float32, device=dev)
    ep_raw = torch.zeros((B,), dtype=_I32, device=dev)
    identity0 = 2 * state.sum_op
    for t in range(int(num_steps)):
        w = bits[t] if bits is not None else philox_bits(seed, t, B, dev, lane_offset)
        state, tr = engine.step(state, sample_from_bits(w, state))
        done = tr.done
        ep_raw = ep_raw + tr.raw_reward
        mk = state.time
        episodes += done
        mk_sum += torch.where(done, mk, 0)
        mk_min = torch.where(done, torch.minimum(mk_min, mk.to(torch.int64)), mk_min)
        viol += done & (ep_raw != identity0 - state.num_machines * mk)
        ret = ret + tr.reward
        ep_raw = torch.where(done, 0, ep_raw)
        state = vector.reset_lanes(state, done)
    return {"episodes": episodes, "mk_sum": mk_sum, "mk_min": mk_min, "viol": viol, "ret": ret}


def rollout_free(
    state: EnvState,
    num_steps: int,
    seed: int = 0,
    with_solution: bool = True,
    bits: Optional[torch.Tensor] = None,
    lane_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """Free-running uniform-over-legal rollout with auto-reset.

    Returns scalars: ``episodes``, ``total_makespan``, ``steps``,
    ``identity_violations`` (int64 — the JAX package's int32 sums wrap at
    full width; the values are equal wherever they do not), ``min_makespan``
    (int32, INT32_MAX if no episode ended) and ``total_return`` (float32).
    ``identity_violations`` must be 0. Assumes a freshly reset ``state``
    (the per-episode return accumulator starts at zero). ``bits``: optional
    (T, B) int32/uint32 words used instead of Philox. ``with_solution`` is
    accepted for the JAX signature and ignored: the stats never read the
    schedule, so the rollout always runs on the light state. ``lane_offset``:
    as in ``free_lane_stats``."""
    T = int(num_steps)
    lanes = free_lane_stats(state, T, seed, bits, lane_offset)
    return _reduce_stats(lanes, T, state.batch_size)


def rollout_free_reference(
    state: EnvState,
    num_steps: int,
    seed: int = 0,
    with_solution: bool = True,
    bits: Optional[torch.Tensor] = None,
    lane_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """Plain twin of ``rollout_free`` on any device (``with_solution`` ignored
    as there)."""
    T = int(num_steps)
    if bits is not None:
        bits = _int_stream(bits, "bits", T, state)
    lanes = free_lane_stats_reference(state, T, seed, bits, lane_offset)
    return _reduce_stats(lanes, T, state.batch_size)

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

A third, ``observe(state)``, builds the policy's three inputs of a step
(observation, action mask, real job rows) in one launch of
``csrc/observe.cu``: the learner's and the evaluation's per-step inputs.

On a CUDA state each launches its hand-written kernel or raises; on a CPU
state each runs its plain twin (``rollout_driven_reference`` /
``rollout_free_reference``, built on ``core.engine`` and ``vector``; the
``EnvState`` expressions for ``observe``). Nothing falls back from one to
the other.

Kernel builds (``Build``; ``driven_build`` and ``free_build`` name the one a
batch takes, or check the one a caller asks for), all compiled at first use:

* ``"static"``: a batch whose every lane is unpadded (``static_shape``) and
  whose shape is within ``STATIC_MAX_J`` jobs and ``STATIC_MAX_M`` machines
  (``static_fits``; all of the repo's instances) launches the static build of
  its shape (J, M), in which every bound is a compile-time constant: the
  counterpart of the JAX package's ``_static_lane`` / ``_fresh_static``.
  ``csrc/driven_static.cu`` for the driven kernel, ``csrc/free_static.cu``
  for the free one.
* ``"slots"``: any other batch within those limits (padded, or lanes of
  several shapes) launches ``csrc/general_lane.cu`` built for its slot class
  (``slot_class``: ceil(J/32) job slots and ceil(M/32) machine words a
  thread, at most 4 and 2), with the padded shape and each lane's own read at
  run time: the counterpart of the JAX kernels with ``static_lane=None``.
* ``"rollout"``: a batch past those limits launches the general build of
  ``csrc/rollout.cu`` (a lane's state in shared memory) for its machine-slot
  class (``machine_slots``: ceil(M/32) machines a thread, at least 2, at most
  ``ROLLOUT_MAX_SLOTS``; one library a class); the tests and the smoke also
  run it on any batch as a comparator.

The static and slot-class builds share their lane (``csrc/static_lane.cuh``:
a lane's state in registers, its boolean rows as warp-wide bitmasks) and
their kernel bodies (``csrc/driven_lane.cuh``, ``csrc/free_lane.cuh``). The
choice is a routing rule, not a fallback: it is computed once per batch, with
the lane inputs (``_lane_inputs``), and costs a launch no host read.

Random bits: with ``bits=None`` the free rollout draws one 32-bit Philox4x32-10
word per (step, lane), keyed by ``seed`` with counter (t, lane_offset + lane);
the twin computes the same words (``philox_bits``), so both modes compare
exactly. ``lane_offset`` (0 by default) is the lane's place in a batch split
over ranks: a shard draws the words its lanes draw in the whole batch.

Value dtype: ``rollout.cu``'s free kernel keeps its state buffer in int16
wherever every stored value fits (``value_dtype``, the JAX package's int16
mode) and then launches its int16 instantiation; the register builds read
the state's own fields and have no storage dtype; the driven rollout stays
int32, as in the JAX package.

Host plumbing: the static and slot-class builds take the state's fields as
they are (``_driven_inputs``, ``_free_inputs``), and the driven ones write
the new state into two allocations (``_driven_outputs``); only
``rollout.cu``'s launches go through a batch-last (R, B) lane buffer
(``_to_lanes``, rows in ``_ROWS`` order; ``_from_lanes`` back for the driven
one), whose storage dtype is cached with the lane inputs. A free call reads
nothing back to the host once its batch's lane inputs are cached, and
returns with its kernel and its reductions queued. The static tables go to one
(n_inst, 4, J, M) int32 stack of the batch's distinct instances with a
per-lane instance index, so ragged batches need no lane grouping; the stack
is built once per batch and cached (``_lane_inputs``). ``launch_geometry``
sizes the launch of ``csrc/rollout.cu`` and names its machine-slot class: a
warp per lane, each block's lanes with their state in shared memory; ``static_geometry`` that of the static
and slot-class builds: a warp per lane, ``STATIC_LANES`` lanes a block, the
state in registers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from jssenv_tpu_torch import diagnostics, vector
from jssenv_tpu_torch.core import _build, engine
from jssenv_tpu_torch.core.state import I32_MAX, EnvState

_I32 = torch.int32

# Kernel launches per kernel: each wrapper adds one where it launches.
# "rollout_free_i16" counts the int16 instantiation of rollout.cu's free
# kernel (the register builds have none); a "_static" key the static build of that kernel (any shape: csrc/driven_static.cu
# and csrc/free_static.cu), a "_slots" key its slot-class build (any slot
# class: csrc/general_lane.cu), the others csrc/rollout.cu's general build: a
# "_m<K>" key its build of K > 2 machine slots a thread, added when that
# library is loaded, no suffix its two-slot build (at most 64 machines).
# "observe" counts observe_kernel's launches (csrc/observe.cu), the policy's
# inputs.
LAUNCHES: Dict[str, int] = {
    "rollout_driven": 0, "rollout_driven_static": 0, "rollout_driven_slots": 0,
    "rollout_free": 0, "rollout_free_static": 0, "rollout_free_slots": 0,
    "rollout_free_i16": 0,
    "observe": 0,
}


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
    """The storage dtype of ``rollout.cu``'s free kernel: int16 wherever every
    stored value fits, i.e. ``sum_op + 2*max_time_jobs + max_time_op <
    32000`` with each term the maximum over the batch's lanes (so one large
    instance in a ragged batch keeps it int32), else int32. The bound covers
    every stored value: ``time``, ``op_end_at`` and ``idle_total_alloc``
    never exceed the makespan, which never exceeds ``sum_op``. It is the JAX
    package's bound (``pallas_rollout.value_dtype``); there the int16 mode
    also waits for ``JSS_PALLAS_INT16=1`` because the TPU compiler crashes
    on it, a gate the CUDA kernel does not need. One host read; a free call
    takes the answer cached with its batch's lane inputs."""
    diagnostics.COUNTS["host_reads"] += 1
    return _storage_dtype(*torch.stack(
        [state.sum_op.max(), state.max_time_jobs.max(), state.max_time_op.max()]
    ).tolist())


def _storage_dtype(sum_op: int, max_time_jobs: int, max_time_op: int) -> torch.dtype:
    """``value_dtype``'s rule on the batch's three maxima."""
    return torch.int16 if sum_op + 2 * max_time_jobs + max_time_op < 32000 else _I32


def _to_lanes(state: EnvState, with_solution: bool, vdt: torch.dtype = _I32) -> torch.Tensor:
    """Batch-first dynamic fields -> one contiguous (R, B) buffer of the
    storage dtype ``vdt`` (int32 or int16; masks as 0/1): ``rollout.cu``'s
    input. Counted in ``diagnostics.COUNTS["lane_buffers_built"]``."""
    diagnostics.COUNTS["lane_buffers_built"] += 1
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
_LANE_FIELDS = _TABLES + ("num_jobs", "num_machines", "max_time_op", "max_time_jobs", "sum_op")

# (tab, lanec, static shape, value dtype) of a batch, keyed by the identity
# and in-place version counter of its static tensors: a rollout passes the same
# never-written tables on every call (the JAX package caches its lane
# grouping and its ``_static_lane`` the same way). The entries hold the
# tensors, so an id is not reused while it is cached. Inference-mode tensors
# keep no version counter and are keyed by id alone.
_LANE_CACHE: Dict[tuple, tuple] = {}
_LANE_CACHE_SIZE = 8


def _lane_entry(state: EnvState) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tuple[int, int]], torch.dtype]:
    fields = tuple(getattr(state, f) for f in _LANE_FIELDS)
    key = tuple((id(t), -1 if t.is_inference() else t._version) for t in fields)
    hit = _LANE_CACHE.get(key)
    if hit is not None:
        return hit[1]
    diagnostics.COUNTS["lane_inputs_built"] += 1
    out = _lane_inputs_uncached(state) + _batch_meta_uncached(state)
    if len(_LANE_CACHE) >= _LANE_CACHE_SIZE:
        _LANE_CACHE.clear()
    _LANE_CACHE[key] = (fields, out)
    return out


def _lane_inputs(state: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tab, lanec): the (n_inst, 4, J, M) int32 stack of distinct instance
    tables [op_machine, op_dur, op_pos, cum_before], and the (5, B) int32 lane
    constants [instance index, num_jobs, num_machines, max_time_op, sum_op]."""
    return _lane_entry(state)[:2]


def static_shape(state: EnvState) -> Optional[Tuple[int, int]]:
    """(J, M) when every lane of the batch is unpadded (``num_jobs ==
    jobs_pad`` and ``num_machines == machines_pad``): the kernels then
    launch their static build for that shape where it is within
    ``STATIC_MAX_J`` and ``STATIC_MAX_M`` (``driven_build``, ``free_build``).
    None otherwise (padded or mixed-shape lanes): the slot-class build.

    The port's form of the JAX package's ``_static_lane``
    (``jssenv_tpu/core/pallas_rollout.py:1018``), which also asks for a
    single instance (``n_groups == 1``) only because its grid streams one
    instance's tables a group; here every lane indexes the deduplicated
    table stack, so a batch of several instances of one shape (ta41-ta50,
    all 30x20) is as static. Cached with the lane inputs: one host read per
    batch, none per launch."""
    return _lane_entry(state)[2]


def _batch_meta_uncached(state: EnvState) -> Tuple[Optional[Tuple[int, int]], torch.dtype]:
    """(``static_shape``, ``value_dtype``) of the batch in one host read (an
    empty batch: None and int32, with no read)."""
    J, M = state.jobs_pad, state.machines_pad
    if state.batch_size == 0:
        return None, _I32
    unpadded = ((state.num_jobs == J) & (state.num_machines == M)).all()
    diagnostics.COUNTS["host_reads"] += 1
    flag, so, mj, mo = torch.stack([unpadded.to(torch.int64), state.sum_op.max().to(torch.int64),
                                    state.max_time_jobs.max().to(torch.int64),
                                    state.max_time_op.max().to(torch.int64)]).tolist()
    return ((J, M) if flag else None), _storage_dtype(so, mj, mo)


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
    diagnostics.COUNTS["host_reads"] += 1  # a boolean index waits for its count
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
_SMEM_LIMIT = 232448  # shared bytes a block can have on Hopper (227 KB; JSS_MAX_SHARED)
_MACHINE_SLOTS = 2  # machines a thread in the default build (JSS_MACHINE_SLOTS): M <= 64
ROLLOUT_MAX_SLOTS = 32  # JSS_MAX_MACHINE_SLOTS: the classes reach M <= 1024
ROLLOUT_MAX_M = _WARP * ROLLOUT_MAX_SLOTS


class Geometry(NamedTuple):
    group: int  # threads per lane: one warp
    lanes: int  # lanes per block
    threads: int  # threads per block, lanes * group
    state_stride: int  # a lane's state slice, in elements of the storage dtype
    scratch_stride: int  # a lane's scratch slice, in int32 words
    shared_bytes: int  # dynamic shared memory of a block
    machine_slots: int  # machines a thread: the library's class (machine_slots)


def _bank_pad(words: int) -> int:
    """The least stride >= ``words`` that is 1 modulo 32 words: the rows of
    consecutive lanes start on different banks."""
    return words + (1 - words) % 32


def machine_slots(M: int) -> int:
    """The machine-slot class of ``csrc/rollout.cu``'s general build for M
    (padded) machines: ceil(M/32) machines a thread, at least the default
    build's two. Past ``ROLLOUT_MAX_SLOTS`` no library is built for it:
    ``launch_geometry`` refuses the batch."""
    return max(_MACHINE_SLOTS, -(-M // _WARP))


def rollout_defines(slots: int) -> Tuple[str, ...]:
    """The nvcc defines of ``csrc/rollout.cu``'s build of a machine-slot
    class: none for the default two slots, which keeps its library."""
    return () if slots == _MACHINE_SLOTS else (f"JSS_MACHINE_SLOTS={slots}",)


def launch_geometry(J: int, M: int, vdt: torch.dtype = _I32) -> Geometry:
    """The kernels' launch geometry for a (J, M) batch whose state is stored
    in ``vdt``. A lane runs on one warp: thread r owns jobs r, r + 32, ...
    and machines r, r + 32, ... (``machine_slots(M)`` of them). Lanes per
    block: as many as fit ``_BLOCK_THREADS`` threads and the shared-memory
    limit. Raises ``ValueError``, naming J and M, past ``ROLLOUT_MAX_M``
    machines or where one lane cannot fit: before anything is built."""
    if M > ROLLOUT_MAX_M:
        raise ValueError(f"the CUDA kernel handles at most {ROLLOUT_MAX_M} machines "
                         f"({ROLLOUT_MAX_SLOTS} a thread); got J={J} jobs and M={M} machines")
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
    return Geometry(_WARP, lanes, lanes * _WARP, state_words * 4 // item, scratch, lanes * lane_bytes,
                    machine_slots(M))


# The static and slot-class builds (csrc/driven_static.cu,
# csrc/free_static.cu, csrc/general_lane.cu, on csrc/static_lane.cuh): a warp
# a lane with its state in registers, STATIC_LANES lanes a block, no shared
# memory; ceil(J/32) job slots and ceil(M/32) machine words a thread, at most
# 4 and 2, so at most STATIC_MAX_J jobs and STATIC_MAX_M machines (padded).
STATIC_LANES = 4  # kLanes in static_lane.cuh; each library's jss_*_lanes()
STATIC_MAX_J = 128
STATIC_MAX_M = 64


class StaticGeometry(NamedTuple):
    lanes: int  # lanes (warps) a block
    threads: int  # threads a block
    blocks: int  # blocks of the grid
    shared_bytes: int  # none: the state lives in registers


def static_geometry(B: int) -> StaticGeometry:
    """The launch of a static build on B lanes."""
    lanes = STATIC_LANES
    return StaticGeometry(lanes, lanes * _WARP, -(-B // lanes), 0)


def static_fits(shape: Optional[Tuple[int, int]]) -> bool:
    """Whether the static builds take the static ``shape``."""
    return shape is not None and shape[0] <= STATIC_MAX_J and shape[1] <= STATIC_MAX_M


def slot_class(J: int, M: int) -> Optional[Tuple[int, int]]:
    """(S, K) = (ceil(J/32), ceil(M/32)): the job slots and machine words a
    thread of the slot-class build holds for the padded shape (J, M); None
    past ``STATIC_MAX_J`` or ``STATIC_MAX_M``."""
    if not (1 <= J <= STATIC_MAX_J and 1 <= M <= STATIC_MAX_M):
        return None
    return -(-J // _WARP), -(-M // _WARP)


def slot_defines(slots: Tuple[int, int]) -> Tuple[str, str]:
    """The nvcc defines of ``csrc/general_lane.cu``'s build for a slot class."""
    return f"JSS_SLOTS_J={slots[0]}", f"JSS_SLOTS_M={slots[1]}"


@functools.lru_cache(maxsize=None)
def _lib(slots: int = _MACHINE_SLOTS) -> ctypes.CDLL:
    """The built general ``csrc/rollout.cu`` (both kernels) of the
    machine-slot class ``slots`` with its C signatures declared, built at its
    first use (a failed build raises with the compiler's output). Loading a
    class past two slots adds its ``LAUNCHES`` keys."""
    lib = _build.load("rollout", None, rollout_defines(slots))
    P, I = ctypes.c_void_p, ctypes.c_int
    geometry = [I, I, I, I]  # lanes, state stride, scratch stride, shared bytes
    lib.jss_rollout_driven.argtypes = [P, P, P, P, P, P, I, I, I, I, I, *geometry, P]
    lib.jss_rollout_driven.restype = I
    for fn in (lib.jss_rollout_free, lib.jss_rollout_free_i16):
        fn.argtypes = [P, P, P, P, ctypes.c_ulonglong, P, P, I, I, I, I, I, *geometry, P]
        fn.restype = I
    _check_built(lib, "rollout", None)
    _check_built(lib, "rollout", (slots,), dims=("jss_machine_slots",))
    for kernel in ("rollout_driven", "rollout_free", "rollout_free_i16"):
        LAUNCHES.setdefault(kernel + _rollout_key(slots), 0)
    return lib


def _check_built(lib: ctypes.CDLL, name: str, shape, lanes: Optional[str] = None,
                 dims: Tuple[str, str] = ("jss_static_j", "jss_static_m")) -> None:
    fns = [getattr(lib, d) for d in dims]
    for fn in fns:
        fn.argtypes, fn.restype = [], ctypes.c_int
    built = tuple(fn() for fn in fns)
    if built != (tuple(shape) if shape else (0, 0)):
        raise RuntimeError(f"the {name} library for shape {shape} was built for {built}")
    if lanes is not None:
        fn = getattr(lib, lanes)
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != STATIC_LANES:
            raise RuntimeError(f"the {name} library holds {fn()} lanes a block, not {STATIC_LANES}")


# The C signature of the register builds' free entry points (JSS_FREE_PARAMS
# of csrc/free_lane.cuh): the 12 input fields (_FREE_I32, _FREE_U8), tab,
# lanec, bits, seed, stats, ret, B, J, M, T, lane_offset, stream.
_FREE_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_ulonglong] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _free_lib(shape: Tuple[int, int]) -> ctypes.CDLL:
    """The built ``csrc/free_static.cu`` for ``shape`` with its C signature
    declared, built at its first use."""
    lib = _build.load("free_static", shape)
    lib.jss_free_static.argtypes, lib.jss_free_static.restype = _FREE_ARGTYPES, ctypes.c_int
    _check_built(lib, "free_static", shape, "jss_free_static_lanes")
    return lib


@functools.lru_cache(maxsize=None)
def _driven_lib(shape: Tuple[int, int]) -> ctypes.CDLL:
    """The built ``csrc/driven_static.cu`` for ``shape`` with its C signature
    declared, built at its first use."""
    lib = _build.load("driven_static", shape)
    P, I = ctypes.c_void_p, ctypes.c_int
    # the 17 input fields (_DRIVEN_I32, _DRIVEN_U8), tab, lanec, actions, out, out8
    lib.jss_driven_static.argtypes = [P] * 22 + [I, I, I, I, I, P]
    lib.jss_driven_static.restype = I
    _check_built(lib, "driven_static", shape, "jss_driven_static_lanes")
    return lib


@functools.lru_cache(maxsize=None)
def _general_lib(slots: Tuple[int, int]) -> ctypes.CDLL:
    """The built ``csrc/general_lane.cu`` (both kernels) for the slot class
    ``slots`` with its C signatures declared, built at its first use."""
    lib = _build.load("general_lane", None, slot_defines(slots))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.jss_driven_general.argtypes = [P] * 22 + [I, I, I, I, I, P]  # as jss_driven_static
    lib.jss_driven_general.restype = I
    lib.jss_free_general.argtypes, lib.jss_free_general.restype = _FREE_ARGTYPES, I
    _check_built(lib, "general_lane", slots, "jss_general_lanes", ("jss_slots_j", "jss_slots_m"))
    return lib


class Build(NamedTuple):
    """A build of the rollout kernels: ``kind`` ``"static"`` (``shape`` the
    unpadded (J, M): ``csrc/driven_static.cu``, ``csrc/free_static.cu``),
    ``"slots"`` (``shape`` the slot class (S, K): ``csrc/general_lane.cu``)
    or ``"rollout"`` (``csrc/rollout.cu``'s general build; ``shape`` None for
    its default two machine slots, at most 64 machines, else the
    machine-slot class K > 2, an int)."""

    kind: str
    shape: Optional[Union[Tuple[int, int], int]] = None


BUILDS = ("static", "slots", "rollout")


def _choose(state: EnvState, kind: Optional[str]) -> Build:
    """The build of ``kind`` for ``state``, or (``kind`` None) the one the
    batch takes: static where ``static_fits``, else its slot class where it
    has one, else ``rollout.cu``'s of its machine-slot class. Raises
    ``ValueError`` where the asked build cannot take the batch."""
    if kind not in (None, *BUILDS):
        raise ValueError(f"unknown build {kind!r}; one of {BUILDS}")
    shape = static_shape(state)
    slots = slot_class(state.jobs_pad, state.machines_pad)
    if kind is None:
        kind = "static" if static_fits(shape) else "slots" if slots else "rollout"
    if kind == "static":
        if not static_fits(shape):
            raise ValueError(f"the static build takes an unpadded batch of at most {STATIC_MAX_J} jobs and "
                             f"{STATIC_MAX_M} machines")
        return Build("static", shape)
    if kind == "slots":
        if slots is None:
            raise ValueError(f"the slot-class build takes at most {STATIC_MAX_J} jobs and {STATIC_MAX_M} machines, "
                             f"padded; got ({state.jobs_pad}, {state.machines_pad})")
        return Build("slots", slots)
    return rollout_build(state.machines_pad)


def rollout_build(M: int) -> Build:
    """``csrc/rollout.cu``'s build for M (padded) machines: its machine-slot
    class."""
    k = machine_slots(M)
    return Build("rollout", None if k == _MACHINE_SLOTS else k)


def driven_build(state: EnvState, kind: Optional[str] = None) -> Build:
    """The build a driven launch on ``state`` takes (``kind`` None), or the
    build of ``kind`` checked against the batch (the tests and the smoke run
    every build on one batch)."""
    return _choose(state, kind)


def free_build(state: EnvState, kind: Optional[str] = None) -> Build:
    """The same for a free launch: the free and the driven kernel have the
    same three builds and limits."""
    return _choose(state, kind)


def build_job(kernel: str, build: Build) -> tuple:
    """The ``_build`` job of ``build`` for ``kernel`` ("driven" or "free"):
    (source, shape) or (source, None, defines)."""
    if build.kind == "static":
        return f"{kernel}_static", tuple(build.shape)
    if build.kind == "slots":
        return "general_lane", None, slot_defines(build.shape)
    if build.shape is None:
        return "rollout", None
    return "rollout", None, rollout_defines(build.shape)


def kernel_jobs(shapes=(None,)):
    """The ``_build`` jobs that launches on the given batches need. Each
    entry is ``None`` (``rollout.cu``'s two-slot build), an unpadded shape
    (J, M) (both static builds where they take it, else ``rollout.cu``'s of
    its machine-slot class) or a ``Build`` (a padded batch's:
    ``driven_build(state)``)."""
    jobs = []
    for s in shapes:
        if s is None:
            s = Build("rollout")
        elif not isinstance(s, Build):
            s = Build("static", tuple(s)) if static_fits(tuple(s)) else rollout_build(s[1])
        jobs += [build_job("driven", s), build_job("free", s)]
    return list(dict.fromkeys(jobs))


def build_kernels(shapes=(None,)) -> None:
    """Build what launches on the given batches need (``kernel_jobs``) and
    is not built yet, every nvcc process started together, and load it."""
    jobs = kernel_jobs(shapes)
    _build.build_jobs(jobs)
    for name, s, *defines in jobs:
        if name == "rollout":
            _lib(int(defines[0][0].split("=")[1]) if defines else _MACHINE_SLOTS)
        elif name == "free_static":
            _free_lib(s)
        elif name == "driven_static":
            _driven_lib(s)
        else:
            _general_lib(tuple(int(d.split("=")[1]) for d in defines[0]))


def free_kernel_job(state: EnvState) -> tuple:
    """The ``_build`` job of the free kernel ``state`` launches."""
    return build_job("free", free_build(state))


def _tag(build: Build) -> str:
    """The build's suffix in a kernel's name."""
    if build.kind == "rollout":
        return "" if build.shape is None else f"<{build.shape} machine slots>"
    return f"<{build.kind} {build.shape[0]}x{build.shape[1]}>"


def _rollout_key(slots: int) -> str:
    """The ``LAUNCHES`` suffix of ``rollout.cu``'s machine-slot class."""
    return "" if slots == _MACHINE_SLOTS else f"_m{slots}"


def _key(build: Build) -> str:
    """The build's suffix in its ``LAUNCHES`` key."""
    if build.kind == "rollout":
        return _rollout_key(build.shape or _MACHINE_SLOTS)
    return "_" + build.kind


def _geometry_args(geo: Geometry):
    return geo.lanes, geo.state_stride, geo.scratch_stride, geo.shared_bytes


def _check_launch(err: int, name: str, geo) -> None:
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
    state: EnvState, buf, tab, lanec, actions, rewards, with_solution: bool, ends=None,
) -> None:
    """One launch of the general build's ``rollout_driven_kernel``
    (``csrc/rollout.cu``) on prepared buffers (``buf`` is updated in place,
    ``rewards`` (T, B) and, unless None, ``ends`` (T, B) written) on the
    current stream: the driven launch of a batch past the register lane's
    limits, or of any batch when a caller asks for the ``"rollout"`` build."""
    _check_kernel_inputs(state, buf, tab, lanec, actions, rewards, *(() if ends is None else (ends,)))
    T, B = actions.shape
    if rewards.shape != (T, B) or (ends is not None and ends.shape != (T, B)):
        raise ValueError(f"rewards and ends must be (T, B)=({T}, {B})")
    geo = launch_geometry(state.jobs_pad, state.machines_pad)  # refuses what cannot fit, before a build
    b = rollout_build(state.machines_pad)
    with torch.cuda.device(state.device):
        err = _lib(geo.machine_slots).jss_rollout_driven(
            buf.data_ptr(), tab.data_ptr(), lanec.data_ptr(), actions.data_ptr(),
            rewards.data_ptr(), None if ends is None else ends.data_ptr(), B, state.jobs_pad,
            state.machines_pad, T, int(with_solution), *_geometry_args(geo),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(err, "rollout_driven_kernel" + _tag(b), geo)
    LAUNCHES["rollout_driven" + _key(b)] += 1


# The driven register-lane builds' state fields, in the order of
# csrc/driven_lane.cuh's DrivenIO and Out / Out8: the int32 fields (the
# solution last, (B, 0, M) when light), then the masks (torch.bool, one byte
# each).
_DRIVEN_I32 = ("time", "nb_legal", "nb_machine_legal", "machine_busy_for", "job_busy_for", "next_op",
               "work_done", "needed_machine", "op_end_at", "idle_frozen", "idle_total_alloc", "wait4", "solution")
_DRIVEN_U8 = ("noop_legal", "legal", "noop_pin", "machine_legal")
# The free register-lane builds' (csrc/free_lane.cuh's FreeIO): the same
# order, less the fields no decision of a free step reads.
_FREE_I32 = ("time", "nb_legal", "nb_machine_legal", "machine_busy_for", "job_busy_for", "next_op", "work_done",
             "needed_machine")
_FREE_U8 = _DRIVEN_U8


def _field_inputs(state: EnvState, i32: Tuple[str, ...], u8: Tuple[str, ...]) -> list:
    """The state's fields ``i32`` then ``u8``, as a kernel reads them: each
    as it is when it is a contiguous int32 (bool) tensor on the state's
    device (a view too, such as a slice of the batch), else a contiguous
    copy of that dtype. Never written."""
    dev = state.device
    out = []
    for names, dtype in ((i32, _I32), (u8, torch.bool)):
        for name in names:
            t = getattr(state, name)
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, the state on {dev}")
            out.append(t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous())
    return out


def _driven_inputs(state: EnvState) -> list:
    """The driven register builds' inputs: ``_DRIVEN_I32`` then
    ``_DRIVEN_U8`` (``_field_inputs``)."""
    return _field_inputs(state, _DRIVEN_I32, _DRIVEN_U8)


def _free_inputs(state: EnvState) -> list:
    """The free register builds' inputs: ``_FREE_I32`` then ``_FREE_U8``
    (``_field_inputs``)."""
    return _field_inputs(state, _FREE_I32, _FREE_U8)


def _driven_outputs(state: EnvState, T: int):
    """The driven static and slot-class builds' outputs: one int32 allocation
    holding the
    new state's int32 fields (``_DRIVEN_I32``: the three (B,) counters, the
    (B, M) busy times, the eight (B, J) job rows, the solution), then the
    (T, B) rewards and the (T, B) ends, and one uint8 allocation holding its
    masks (``_DRIVEN_U8``). Returns (out, out8, new state, rewards, ends);
    the new state's dynamic fields are views of the two (its static ones are
    the input's), so it shares no written storage with ``state``. Fields of
    one shape come out of one ``unbind``: a view costs microseconds of host
    time, and a T=1 launch is tens."""
    B, J, M, dev = state.batch_size, state.jobs_pad, state.machines_pad, state.device
    JS = state.solution.shape[1]  # J, or 0 when light
    out = torch.empty((3 * B + B * M + 8 * B * J + B * JS * M + 2 * T * B,), dtype=_I32, device=dev)
    out8 = torch.empty((B + 2 * B * J + B * M,), dtype=torch.uint8, device=dev)
    lane, mbf, jobs, sol, steps = out.split([3 * B, B * M, 8 * B * J, B * JS * M, 2 * T * B])
    noop_legal, pins, ml = out8.view(torch.bool).split([B, 2 * B * J, B * M])
    new = dict(zip(_DRIVEN_I32, (*lane.view(3, B).unbind(), mbf.view(B, M), *jobs.view(8, B, J).unbind(),
                                 sol.view(B, JS, M))))
    new.update(zip(_DRIVEN_U8, (noop_legal, *pins.view(2, B, J).unbind(), ml.view(B, M))))
    rewards, ends = steps.view(2, T, B).unbind()
    return out, out8, state.replace(**new), rewards, ends


def launch_driven_static(state: EnvState, inputs, tab, lanec, actions, out, out8, with_solution: bool) -> None:
    """One ``driven_static_kernel`` launch (``csrc/driven_static.cu``, built
    for the batch's static shape) on the current stream: T steps on
    ``actions`` (T, B) from the state's fields ``inputs``
    (``_driven_inputs``, read only) into the allocations ``out`` and
    ``out8`` (``_driven_outputs``). Refuses a batch that the static build
    does not take."""
    _launch_driven_lane(driven_build(state, "static"), state, inputs, tab, lanec, actions, out, out8, with_solution)


def _launch_driven_lane(build: Build, state: EnvState, inputs, tab, lanec, actions, out, out8,
                        with_solution: bool) -> None:
    """``launch_driven_static``'s launch in ``build``, static or slot class
    (``driven_general_kernel`` of ``csrc/general_lane.cu``)."""
    _check_kernel_inputs(state, tab, lanec, actions, out)
    _check_kernel_inputs(state, out8, dtype=torch.uint8)
    T, B = actions.shape
    if build.kind == "static":
        fn, name = _driven_lib(build.shape).jss_driven_static, "driven_static_kernel"
    else:
        fn, name = _general_lib(build.shape).jss_driven_general, "driven_general_kernel"
    with torch.cuda.device(state.device):
        err = fn(
            *[t.data_ptr() for t in inputs], tab.data_ptr(), lanec.data_ptr(), actions.data_ptr(),
            out.data_ptr(), out8.data_ptr(), B, state.jobs_pad, state.machines_pad, T, int(with_solution),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(err, name + _tag(build), static_geometry(B))
    LAUNCHES["rollout_driven" + _key(build)] += 1


def launch_free(
    state: EnvState, buf, tab, lanec, bits, seed: int, stats, ret, T: int, vdt: torch.dtype = _I32,
    lane_offset: int = 0,
) -> None:
    """One launch of the general build's ``rollout_free_kernel``
    (``csrc/rollout.cu``) on a light ``buf`` (no solution rows), which it
    reads and does not write: per-lane stats (4, B) int64 and returns (B,)
    float32 written. ``vdt`` picks the instantiation (int32 or int16) and
    must be ``buf``'s dtype: a buffer is never converted here.
    ``lane_offset``: the global index of lane 0 in the Philox counter. The
    free launch of a batch past the register lane's limits, or of any batch
    when a caller asks for the ``"rollout"`` build."""
    if vdt not in (_I32, torch.int16):
        raise ValueError(f"the free kernel stores int32 or int16, not {vdt}")
    if buf.dtype != vdt:
        raise ValueError(f"the {vdt} free kernel needs a {vdt} state buffer, got {buf.dtype}")
    _check_kernel_inputs(state, buf, dtype=vdt)
    _check_free_args(state, tab, lanec, bits, stats, ret)
    i16 = vdt == torch.int16
    geo = launch_geometry(state.jobs_pad, state.machines_pad, vdt)  # refuses what cannot fit, before a build
    b = rollout_build(state.machines_pad)
    lib = _lib(geo.machine_slots)
    with torch.cuda.device(state.device):
        err = (lib.jss_rollout_free_i16 if i16 else lib.jss_rollout_free)(
            buf.data_ptr(), tab.data_ptr(), lanec.data_ptr(), None if bits is None else bits.data_ptr(),
            seed & (2**64 - 1), stats.data_ptr(), ret.data_ptr(), state.batch_size, state.jobs_pad,
            state.machines_pad, T, int(lane_offset), *_geometry_args(geo), torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(err, "rollout_free_kernel" + ("<int16>" if i16 else "") + _tag(b), geo)
    LAUNCHES[("rollout_free_i16" if i16 else "rollout_free") + _key(b)] += 1


def _check_free_args(state: EnvState, tab, lanec, bits, stats, ret) -> None:
    _check_kernel_inputs(state, tab, lanec, *(() if bits is None else (bits,)))
    if stats.dtype != torch.int64 or ret.dtype != torch.float32:
        raise ValueError("stats must be int64 and ret float32")


def _launch_free_lane(b: Build, state: EnvState, inputs, tab, lanec, bits, seed: int, stats, ret, T: int,
                      lane_offset: int = 0) -> None:
    """One free launch in the register build ``b`` on the current stream:
    ``free_static_kernel`` of ``csrc/free_static.cu`` built for the batch's
    static shape, or ``free_general_kernel`` of ``csrc/general_lane.cu``
    built for its slot class. It reads the state's fields ``inputs``
    (``_free_inputs``) and writes per-lane stats (4, B) int64 and returns
    (B,) float32; ``lane_offset`` as in ``launch_free``. The kernel
    indexes a lane's rows with int offsets: a batch of 2^31 or more job (or
    machine) rows is refused."""
    _check_free_args(state, tab, lanec, bits, stats, ret)
    if state.batch_size * max(state.jobs_pad, state.machines_pad) >= 2**31:
        raise ValueError(f"the register free builds take fewer than 2^31 rows a field; got B={state.batch_size}, "
                         f"J={state.jobs_pad}, M={state.machines_pad}")
    if b.kind == "static":
        fn, name = _free_lib(b.shape).jss_free_static, "free_static_kernel"
    else:
        fn, name = _general_lib(b.shape).jss_free_general, "free_general_kernel"
    with torch.cuda.device(state.device):
        err = fn(*[t.data_ptr() for t in inputs], tab.data_ptr(), lanec.data_ptr(),
                 None if bits is None else bits.data_ptr(), seed & (2**64 - 1), stats.data_ptr(), ret.data_ptr(),
                 state.batch_size, state.jobs_pad, state.machines_pad, T, int(lane_offset),
                 torch.cuda.current_stream().cuda_stream)
    _check_launch(err, name + _tag(b), static_geometry(state.batch_size))
    LAUNCHES["rollout_free" + _key(b)] += 1


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


def _driven_kernel(state: EnvState, actions: torch.Tensor, T: int, with_solution: bool, with_ends: bool,
                   build: Optional[str] = None):
    """One driven launch in ``driven_build(state, build)``: the static or
    slot-class build on the state's own tensors (a new state out), or
    ``rollout.cu``'s on the lane buffer."""
    tab, lanec = _lane_inputs(state)
    b = driven_build(state, build)
    if b.kind == "rollout":
        buf = _to_lanes(state, with_solution)
        rewards = torch.empty((T, state.batch_size), dtype=_I32, device=state.device)
        ends = torch.empty_like(rewards) if with_ends else None
        launch_driven(state, buf, tab, lanec, actions, rewards, with_solution, ends)
        new = _from_lanes(buf, state, with_solution)
    else:  # the kernel always writes the ends
        out, out8, new, rewards, ends = _driven_outputs(state, T)
        _launch_driven_lane(b, state, _driven_inputs(state), tab, lanec, actions, out, out8, with_solution)
    return (new, rewards, ends) if with_ends else (new, rewards)


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
    ``done``) and the stats, whose makespans come from the ends, exactly.
    The span ``env.step``."""
    with diagnostics.span("env.step"):
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
    """The call's six stats from the per-lane ones, each queued on the
    device: ``steps`` is a device fill, not a copy from the host (which
    would wait for the kernel)."""
    dev = lanes["episodes"].device
    return {
        "episodes": lanes["episodes"].sum(),
        "total_makespan": lanes["mk_sum"].sum(),
        "min_makespan": lanes["mk_min"].min().to(_I32),
        "steps": torch.full((), T * B, dtype=torch.int64, device=dev),
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
    (int64), ``ret`` (float32 sum of scaled rewards). Kernel on CUDA, twin
    on CPU; ``rollout_free`` reduces these. The stats never read the
    schedule, so both run on the light state (``vector.strip_solution``).
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
                 lane_offset: int = 0, build: Optional[str] = None):
    """One free-kernel launch in ``free_build(state, build)``. The static and
    slot-class builds read the state's own fields (``_free_inputs``; no
    storage dtype, ``vdt`` is not theirs). ``rollout.cu``'s build reads a
    lane buffer in the storage dtype ``vdt``: by default the batch's
    ``value_dtype``, cached with its lane inputs; an explicit int32 runs a
    batch that fits int16 in the int32 instantiation, to hold the two
    against each other. No host read once the lane inputs are cached. The
    spans ``env.launch`` and, on ``rollout.cu``'s build, ``env.value_dtype``
    and ``env.to_lanes``."""
    B, dev = state.batch_size, state.device
    tab, lanec, _, cached = _lane_entry(state)
    b = free_build(state, build)
    stats = torch.empty((4, B), dtype=torch.int64, device=dev)
    ret = torch.empty((B,), dtype=torch.float32, device=dev)
    if b.kind == "rollout":
        if vdt is None:
            with diagnostics.span("env.value_dtype"):
                vdt = cached
        with diagnostics.span("env.to_lanes"):
            buf = _to_lanes(state, with_solution=False, vdt=vdt)
        with diagnostics.span("env.launch"):
            launch_free(state, buf, tab, lanec, bits, int(seed), stats, ret, T, vdt, lane_offset)
    else:
        with diagnostics.span("env.launch"):
            _launch_free_lane(b, state, _free_inputs(state), tab, lanec, bits, int(seed), stats, ret, T, lane_offset)
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
    as in ``free_lane_stats``. The span ``env.free``."""
    with diagnostics.span("env.free"):
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


# ---------------------------------------------------------------------------
# the policy's inputs
# ---------------------------------------------------------------------------

# The fields observe_kernel reads, in ObserveIO's order (csrc/observe.cu):
# the (B, J) masks, the (B, J) int32 job rows, the (B,) int32 lane scalars.
_OBSERVE_U8 = ("legal", "noop_legal")
_OBSERVE_JOBS = ("job_busy_for", "next_op", "work_done", "needed_machine", "wait4", "op_end_at", "idle_frozen",
                 "idle_total_alloc")
_OBSERVE_LANE = ("time", "num_jobs", "num_machines", "max_time_op", "max_time_jobs", "sum_op")
_OBSERVE_COLS = 7


@functools.lru_cache(maxsize=None)
def _observe_lib() -> ctypes.CDLL:
    """The built ``csrc/observe.cu`` (one general build) with its C signature
    declared, built at its first use."""
    lib = _build.load("observe")
    P, I = ctypes.c_void_p, ctypes.c_int
    # the 16 fields (ObserveIO's order), obs, mask, valid, B, J, stream
    lib.jss_observe.argtypes = [P] * 19 + [I, I, P]
    lib.jss_observe.restype = I
    return lib


def _observe_inputs(state: EnvState) -> list:
    """The fields ``observe_kernel`` reads, in ``ObserveIO``'s order: each
    as it is when it is a contiguous bool (masks) or int32 tensor, else a
    contiguous copy of that dtype (``rollout.cu``'s build hands out
    transposed views), as ``_driven_inputs`` takes them. Never written. A
    field on another device or of another shape than (B, J) or (B,) is
    refused."""
    dev, B, J = state.device, state.batch_size, state.jobs_pad
    out = []
    for name in (*_OBSERVE_U8, *_OBSERVE_JOBS, *_OBSERVE_LANE):
        t = getattr(state, name)
        dtype = torch.bool if name in _OBSERVE_U8 else _I32
        shape = (B,) if name == "noop_legal" or name in _OBSERVE_LANE else (B, J)
        if t.device != dev or t.shape != shape:
            raise ValueError(f"observe: {name} must be {shape} on {dev}, got {tuple(t.shape)} on {t.device}")
        out.append(t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous())
    return out


def observe(state: EnvState) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The policy's inputs for ``state``: (``obs`` (B, J, 7) float32, the
    reference observation with column 0 set to the legal mask; ``mask``
    (B, J+1) bool, the jobs then the no-op slot; ``valid`` (B, J) bool, the
    rows that are real jobs).

    On a CUDA state one launch of ``observe_kernel`` (``csrc/observe.cu``)
    on the current stream, into new tensors on every call, bit-equal to the
    plain expressions (an empty batch launches nothing); a failed build or
    launch raises. On a CPU state the
    plain expressions themselves: ``observation()["real_obs"]``,
    ``action_mask()`` and ``job_valid``."""
    if state.device.type == "cpu":
        return state.observation()["real_obs"], state.action_mask(), state.job_valid
    inputs = _observe_inputs(state)
    B, J, dev = state.batch_size, state.jobs_pad, state.device
    obs = torch.empty((B, J, _OBSERVE_COLS), dtype=torch.float32, device=dev)
    mask = torch.empty((B, J + 1), dtype=torch.bool, device=dev)
    valid = torch.empty((B, J), dtype=torch.bool, device=dev)
    if B == 0:  # nothing to launch
        return obs, mask, valid
    with torch.cuda.device(dev):
        err = _observe_lib().jss_observe(*[t.data_ptr() for t in (*inputs, obs, mask, valid)], B, J,
                                         torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "observe_kernel", f"B={B}, J={J}")
    LAUNCHES["observe"] += 1
    return obs, mask, valid

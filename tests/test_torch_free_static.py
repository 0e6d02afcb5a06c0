"""The free kernel's static build (``csrc/free_static.cu``): its premise, its
dispatch and, on a card, its results.

* The premise: the free rollout's stats read none of ``op_end_at``,
  ``idle_frozen``, ``idle_total_alloc`` and ``wait4`` (the kernel keeps
  none of them), shown on the plain twin, which steps them.
* The dispatch: which build each of ``chip_smoke.py``'s FULL configurations,
  each of ``tools/bench_torch.py``'s and each shape at and past the limits
  takes, the launch's arguments and geometry (a stand-in library records
  the call), and the builds ``fused_rollout.build_kernels`` starts.
* On a card only (``-m cuda``): the kernel against the twin and the other
  builds (rollout.cu's in int16 and int32), batches that do not fill a
  block, starts in
  the middle of an episode (``driven_start``), a refused launch. Whether a
  card is present is decided inside the fixture."""

import contextlib
import ctypes
import importlib.util
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import diagnostics
from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.core import _build
from jssenv_tpu_torch.core import fused_rollout as fr
from jssenv_tpu_torch.core import state as ts

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEAD = ("op_end_at", "idle_frozen", "idle_total_alloc", "wait4")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    return torch.device("cuda")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driven_start(state, steps, seed):
    """``state`` (on the CPU) after ``steps`` driven steps of uniform random
    legal actions drawn from ``seed``, with auto-reset: lanes mid-episode,
    with running jobs, busy machines, work done and, after enough steps,
    no-op pins, which a fresh state has none of."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        state, _ = fr.rollout_driven(state, tv.random_legal_actions(g, state)[None], 1)
    return state


def _scrambled(state, seed):
    g = torch.Generator().manual_seed(seed)
    return state.replace(**{f: torch.randint(-(2**15), 2**15, getattr(state, f).shape, dtype=torch.int32,
                                             generator=g) for f in DEAD})


# ---------------------------------------------------------------------------
# the premise: the dead fields
# ---------------------------------------------------------------------------

# case -> (source, B, T, driven steps of the mid-episode start)
PREMISE = {
    "ta01": (lambda: ti.get_instance("ta01"), 4, 300, 150),
    "ta41": (lambda: ti.get_instance("ta41"), 2, 150, 300),
    "rand6x5": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 6, 200, 47),
}


@pytest.mark.parametrize("case", sorted(PREMISE))
def test_free_stats_read_no_dead_field(case):
    """The twin's stats, float32 return included, are the same from a start
    state whose dead fields are scrambled, mid-episode and across resets."""
    src, B, T, steps = PREMISE[case]
    state = tv.make_batch(src(), B, device="cpu")
    # steps in, so that the fields are live values, not zeros
    mid = driven_start(state, steps, 1)
    assert int((mid.job_busy_for > 0).sum()) > 0 and int(mid.noop_pin.sum()) > 0
    for start in (state, mid):
        want = fr.free_lane_stats_reference(start, T, seed=5, lane_offset=3)
        got = fr.free_lane_stats_reference(_scrambled(start, 2), T, seed=5, lane_offset=3)
        for f in want:
            assert torch.equal(got[f], want[f]), f
    assert case == "ta41" or int(want["episodes"].sum()) > 0


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    return _module(ROOT / "chip_smoke.py", "chip_smoke_for_tests")


def test_every_full_config_takes_its_build(smoke):
    """Every unpadded FULL config of the smoke runs the new kernel, each
    padded one the slot-class build, in the value dtype the smoke expects;
    each can be asked for rollout.cu's build."""
    for name, _, _ in smoke.FULL:
        src = smoke.source(ti, name)
        state = tv.make_batch(src, 2 * max(1, len(getattr(src, "names", [0]))), device="cpu")
        J, M = state.jobs_pad, state.machines_pad
        want = fr.Build("slots", (1, 1)) if name in smoke.PADDED else fr.Build("static", (J, M))
        assert fr.free_build(state) == want, name
        assert fr.free_build(state, "rollout") == fr.Build("rollout")
        assert fr.free_build(state, "slots") == fr.Build("slots", fr.slot_class(J, M))
        assert str(fr.value_dtype(state)).removeprefix("torch.") == smoke.FULL_DTYPE[name], name
        assert fr.free_kernel_job(state) == (("general_lane", None, ("JSS_SLOTS_J=1", "JSS_SLOTS_M=1"))
                                             if name in smoke.PADDED else ("free_static", (J, M)))
    assert all(fr.static_fits(s) for s in smoke.STATIC_SHAPES)


def test_every_bench_config_takes_the_new_kernel():
    bench = _module(ROOT / "tools" / "bench_torch.py", "bench_torch_for_tests")
    for spec in ["ta01"] + [s for s, _ in bench.EXTRA]:
        names = bench.parse_instances(spec)
        src = ti.get_instance(names[0]) if len(names) == 1 else ti.get_instance_set(names)
        state = tv.make_batch(src, len(names), device="cpu")
        assert fr.free_kernel_job(state) == ("free_static", (state.jobs_pad, state.machines_pad)), spec


def test_every_repo_instance_fits_the_new_kernel():
    shapes = {(ti.get_instance(n).num_jobs, ti.get_instance(n).num_machines) for n in ti.instance_names()}
    assert len(shapes) > 5 and all(fr.static_fits(s) for s in shapes)


@pytest.mark.parametrize("shape,fits", [((128, 64), True), ((1, 1), True), ((129, 5), False), ((6, 65), False),
                                        ((100, 20), True), ((200, 20), False)])
def test_shape_limits(shape, fits):
    assert fr.static_fits(shape) == fits
    jobs = fr.kernel_jobs([None, shape])
    # past 64 machines: rollout.cu's build of ceil(M/32) machine slots a thread
    wide = [("rollout", None, (f"JSS_MACHINE_SLOTS={-(-shape[1] // 32)}",))] if shape[1] > 64 else []
    assert jobs == [("rollout", None)] + ([("driven_static", shape), ("free_static", shape)] if fits else wide)


def test_a_static_batch_past_the_limits_runs_the_general_build():
    state = tv.make_batch(ti.random_instance(130, 3, (1, 9), seed=1), 2, device="cpu")
    assert fr.static_shape(state) == (130, 3) and fr.free_build(state) == fr.Build("rollout")
    assert fr.free_kernel_job(state) == ("rollout", None)
    for kind in ("static", "slots"):
        with pytest.raises(ValueError, match="at most 128 jobs"):
            fr.free_build(state, kind)


@pytest.mark.parametrize("B", [1, 4, 5, 37, 16384])
def test_free_static_geometry(B):
    geo = fr.static_geometry(B)
    assert geo.lanes == fr.STATIC_LANES == 4 and geo.threads == 128 and geo.shared_bytes == 0
    assert (geo.blocks - 1) * geo.lanes < B <= geo.blocks * geo.lanes


class _FakeLib:
    """Records each entry point's call and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if not name.startswith("jss_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """``fused_rollout._free_kernel`` on CPU tensors with stand-in
    libraries: the checks for a CUDA state and the stream are stubbed;
    nothing runs."""
    libs = types.SimpleNamespace(free=_FakeLib(), general=_FakeLib(), slots=_FakeLib(), classes=[])
    monkeypatch.setattr(fr, "_check_kernel_inputs", lambda *a, **k: None)
    monkeypatch.setattr(fr, "_free_lib", lambda shape: libs.free)
    monkeypatch.setattr(fr, "_lib", lambda slots=2: libs.general)
    monkeypatch.setattr(fr, "_general_lib", lambda slots: libs.classes.append(slots) or libs.slots)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=7))
    return libs


def _launch(state, vdt=None, build=None, lane_offset=0, T=9):
    """One free call's launch (``_free_kernel``) on the stand-in card."""
    return fr._free_kernel(state, T, 11, None, vdt, lane_offset=lane_offset, build=build)


def _field_ptrs(state):
    """The pointers of the state's fields in FreeIO's order."""
    return [getattr(state, f).data_ptr() for f in fr._FREE_I32 + fr._FREE_U8]


# value dtype of rollout.cu's lane buffer -> an unpadded batch that stores in it
UNPADDED = {"int32": "ta41", "int16": "ta01"}


@pytest.mark.parametrize("vdt", ["int32", "int16"])
def test_an_unpadded_launch_calls_the_new_kernel(fake_card, vdt):
    """An unpadded batch, whether or not its values fit int16, launches the
    one static entry point on its own fields, in FreeIO's order: no lane
    buffer, no storage dtype."""
    state = tv.make_batch(ti.get_instance(UNPADDED[vdt]), 37, device="cpu")
    assert str(fr.value_dtype(state)) == f"torch.{vdt}"
    fr.reset_launch_counts()
    built = diagnostics.COUNTS["lane_buffers_built"]
    out = _launch(state, lane_offset=64)
    (name, args), = fake_card.free.calls
    assert not fake_card.general.calls and not fake_card.slots.calls
    assert name == "jss_free_static"
    tab, lanec = fr._lane_inputs(state)
    # 12 fields, tab, lanec, bits, seed, stats, ret, B, J, M, T, lane_offset, stream
    assert list(args[:12]) == _field_ptrs(state)
    assert args[12:16] == (tab.data_ptr(), lanec.data_ptr(), None, 11)
    assert args[16:18] == (out["episodes"].data_ptr(), out["ret"].data_ptr())
    J, M = state.jobs_pad, state.machines_pad
    assert args[18:] == (37, J, M, 9, 64, 7)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rollout_free_static=1)
    assert diagnostics.COUNTS["lane_buffers_built"] == built


def test_padded_and_forced_launches_call_the_general_build(fake_card):
    """A padded batch launches its slot class's build on its fields, whether
    or not its values fit int16; the slot-class and rollout.cu builds run
    on any batch when asked for, rollout.cu's on a lane buffer in the
    batch's cached value dtype (or the one asked for)."""
    padded = tv.make_batch(ti.get_instance_set(["ta01", "ta41"]), 4, device="cpu")
    padded16 = tv.make_batch(ti.get_instance_set(["ta01", "ta11"]), 4, device="cpu")
    unpadded = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    fr.reset_launch_counts()
    _launch(padded, lane_offset=3)
    _launch(padded16)
    _launch(unpadded, build="slots")
    _launch(padded, build="rollout")
    _launch(unpadded, build="rollout")
    _launch(unpadded, torch.int32, build="rollout")
    assert not fake_card.free.calls and fake_card.classes == [(1, 1)] * 3
    assert [c[0] for c in fake_card.slots.calls] == ["jss_free_general"] * 3
    assert [list(c[1][:12]) for c in fake_card.slots.calls] == [_field_ptrs(s) for s in (padded, padded16, unpadded)]
    # 12 fields, tab, lanec, bits, seed, stats, ret, B, J, M, T, lane_offset, stream
    assert [c[1][18:] for c in fake_card.slots.calls] == [(4, 30, 20, 9, 3, 7), (4, 20, 15, 9, 0, 7),
                                                          (4, 15, 15, 9, 0, 7)]
    assert [c[0] for c in fake_card.general.calls] == ["jss_rollout_free", "jss_rollout_free_i16",
                                                       "jss_rollout_free"]
    geo = fr.launch_geometry(30, 20)
    # buf, tab, lanec, bits, seed, stats, ret, B, J, M, T, lane_offset, geometry, stream
    assert fake_card.general.calls[0][1][12:] == (geo.lanes, geo.state_stride, geo.scratch_stride,
                                                  geo.shared_bytes, 7)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rollout_free=2, rollout_free_i16=1,
                               rollout_free_slots=3)
    with pytest.raises(ValueError, match="unpadded batch"):
        _launch(padded, build="static")


def test_a_refused_launch_raises_and_counts_nothing(fake_card):
    fake_card.free.rc = fake_card.slots.rc = 1  # cudaErrorInvalidValue
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    padded = tv.make_batch(ti.get_instance_set(["ta01", "ta11"]), 4, device="cpu")
    fr.reset_launch_counts()
    with pytest.raises(RuntimeError, match=r"free_static_kernel<static 15x15>: CUDA launch refused or failed"):
        _launch(state)
    with pytest.raises(RuntimeError, match=r"free_general_kernel<slots 1x1>: CUDA launch refused or failed"):
        _launch(padded)
    assert not any(fr.LAUNCHES.values())


@pytest.mark.parametrize("cut", ["leading", "strided"])
def test_a_sliced_state_launches_on_its_views(fake_card, cut):
    """A state whose fields are views of a larger batch: a leading slice
    (contiguous at an offset, the form of the benchmark's half-batch fault)
    is read where it lies, a strided one from contiguous copies."""
    whole = tv.make_batch(ti.get_instance("ta01"), 8, device="cpu")
    part = slice(None, 4) if cut == "leading" else slice(None, None, 2)
    state = whole.replace(**{k: getattr(whole, k)[part] for k in vars(whole)})
    _launch(state)
    (_, args), = fake_card.free.calls
    assert args[18] == 4
    if cut == "leading":
        assert list(args[:12]) == _field_ptrs(state) and args[0] == whole.time.data_ptr()
    else:
        assert not set(args[:12]) & set(_field_ptrs(state))


@pytest.mark.parametrize("build", fr.BUILDS)
def test_a_warm_free_call_reads_nothing_back(fake_card, build):
    """A free call's host reads: the lane inputs' two (the tables, then the
    static shape and the value dtype together) when its batch is new, none
    once they are cached, on every build; only rollout.cu's build converts
    the state to a lane buffer, once a call."""
    state = tv.make_batch(ti.get_instance_set(["ta01", "ta02"]), 4, device="cpu")
    counts = diagnostics.COUNTS
    reads, built = counts["host_reads"], counts["lane_buffers_built"]
    _launch(state, build=build)
    assert counts["host_reads"] - reads == 2
    for _ in range(2):
        reads, built = counts["host_reads"], counts["lane_buffers_built"]
        _launch(state, build=build)
        assert counts["host_reads"] == reads
        assert counts["lane_buffers_built"] - built == (build == "rollout")


def test_reduce_stats_copies_nothing_from_the_host():
    """A free call's reductions are device work alone: every op of
    ``_reduce_stats`` stays on the lanes' device (``steps`` a fill, not a
    host tensor copied over, which would wait for the kernel), in the
    order sum, sum, min, sum, sum; the stats are the twin's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            kwargs = kwargs or {}
            devs = {a.device.type for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)}
            self.seen.append((func.overloadpacket.__name__, devs, str(kwargs.get("device", "meta"))))
            return func(*args, **kwargs)

    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    lanes = fr.free_lane_stats_reference(state, 30, seed=2)
    meta = {k: torch.empty_like(v, device="meta") for k, v in lanes.items()}
    with Ops() as ops:
        out = fr._reduce_stats(meta, 30, 4)
    names = [n for n, _, _ in ops.seen]
    assert "lift_fresh" not in names and "copy_" not in names and "_to_copy" in names
    assert [n for n in names if n in ("sum", "min")] == ["sum", "sum", "min", "sum", "sum"]
    assert all(devs <= {"meta"} and dev == "meta" for _, devs, dev in ops.seen), ops.seen
    assert all(v.device.type == "meta" for v in out.values())
    want = fr.rollout_free_reference(state, 30, seed=2)
    got = fr._reduce_stats(lanes, 30, 4)
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_the_kernels_build_together(tmp_path, monkeypatch):
    """``build_kernels`` starts the general build and both static builds of
    each shape within the limits in one batch of nvcc processes (a shape
    past them needs the general build only); an instrumented build is a
    library of its own."""
    started = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.cmd, self.returncode = cmd, 0

        def communicate(self, timeout=None):
            assert len(started) == 4  # every process started before the first is waited for
            Path(self.cmd[self.cmd.index("-o") + 1]).write_bytes(b"")
            return "ptxas info    : Used 40 registers\n", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(fr, "_lib", lambda slots=2: None)
    monkeypatch.setattr(fr, "_free_lib", lambda shape: None)
    monkeypatch.setattr(fr, "_driven_lib", lambda shape: None)
    monkeypatch.setattr(fr, "_general_lib", lambda slots: None)
    fr.build_kernels([None, (15, 15), (200, 5), fr.Build("slots", (2, 1))])
    got = sorted((Path(c[-1]).name, tuple(x for x in c if x.startswith(("-DJSS_STATIC", "-DJSS_SLOTS")))) for c in started)
    s15 = ("-DJSS_STATIC_J=15", "-DJSS_STATIC_M=15")
    assert got == sorted([("rollout.cu", ()), ("driven_static.cu", s15), ("free_static.cu", s15),
                          ("general_lane.cu", ("-DJSS_SLOTS_J=2", "-DJSS_SLOTS_M=1"))])
    slots = _build.library_path("general_lane", None, fr.slot_defines((2, 1)))
    assert slots.name.startswith("libgeneral_lane_slots_j2_slots_m1_")
    plain = _build.library_path("free_static", (15, 15))
    clocks = _build.library_path("free_static", (15, 15), ("JSS_PASS_CLOCKS",))
    assert plain != clocks and "_pass_clocks_" in clocks.name and plain.name.startswith("libfree_static_15x15_")
    assert _build.nvcc_flags((15, 15), ("JSS_PASS_CLOCKS",))[-1] == "-DJSS_PASS_CLOCKS"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# case -> (source, B, T, driven steps of a mid-episode start or 0)
CARD = {
    "ta01-B1": (lambda: ti.get_instance("ta01"), 1, 300, 0),
    "ta01-B5": (lambda: ti.get_instance("ta01"), 5, 300, 0),
    "rand6x5-B38": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 38, 300, 0),
    "rand40x3": (lambda: ti.random_instance(40, 3, (1, 9), seed=7), 9, 400, 0),
    "rand3x40": (lambda: ti.random_instance(3, 40, (1, 9), seed=8), 9, 400, 0),
    "rand128x2": (lambda: ti.random_instance(128, 2, (1, 9), seed=9), 6, 600, 0),
    "ta01-mid": (lambda: ti.get_instance("ta01"), 8, 300, 150),
    "ta41-mid": (lambda: ti.get_instance("ta41"), 6, 300, 450),
    "rand6x5-mid": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 38, 300, 47),
    # the benchmark's batches: ta01-ta10 (fits int16), ta41-ta50 (int32),
    # their mix padded to 30x20 (the slot-class build), mid-episode too
    "ta01-ta10": (lambda: ti.get_instance_set([f"ta{i:02d}" for i in range(1, 11)]), 40, 400, 0),
    "ta41-ta50": (lambda: ti.get_instance_set([f"ta{i}" for i in range(41, 51)]), 20, 900, 0),
    "ta01-ta10+ta41-ta50-mid": (lambda: ti.get_instance_set([f"ta{i:02d}" for i in (*range(1, 11), *range(41, 51))]),
                                40, 400, 300),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bits", "philox"])
@pytest.mark.parametrize("case", sorted(CARD))
def test_new_kernel_matches_twin_and_general_on_card(cuda_dev, case, mode):
    src, B, T, steps = CARD[case]
    state = tv.make_batch(src(), B, device="cpu")
    if steps:
        state = driven_start(state, steps, 0)
        assert int(state.noop_pin.sum()) > 0 and int(state.work_done.sum()) > 0
    state = ts.from_numpy(ts.to_numpy(state), device=cuda_dev)
    padded = fr.static_shape(state) is None
    assert fr.free_kernel_job(state)[0] == ("general_lane" if padded else "free_static")
    bits = None
    if mode == "bits":
        bits = torch.from_numpy(np.random.default_rng(4).integers(-(2**31), 2**31, size=(T, B)).astype(np.int32))
        bits = bits.to(cuda_dev)
    ref = fr.free_lane_stats_reference(state, T, 21, bits, lane_offset=B + 3)
    # the register builds on the state's fields; rollout.cu on its lane
    # buffer in each storage type the batch fits
    runs = [fr._free_kernel(state, T, 21, bits, lane_offset=B + 3, build=build)
            for build in (("slots",) if padded else ("static", "slots"))]
    for vdt in (torch.int32, torch.int16) if fr.value_dtype(state) == torch.int16 else (torch.int32,):
        runs.append(fr._free_kernel(state, T, 21, bits, vdt, lane_offset=B + 3, build="rollout"))
    torch.cuda.synchronize()
    for got in runs:
        for f in ref:
            assert torch.equal(got[f], ref[f]), f
    # a mid-episode start's first episode misses the rewards before it
    assert int(ref["episodes"].sum()) > 0 and (steps or int(ref["viol"].sum()) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cut", ["leading", "strided", "shard"])
@pytest.mark.parametrize("case", ["ta01-ta10", "ta41-ta50", "ta01-ta10+ta41-ta50-mid"])
def test_sliced_and_sharded_states_match_on_card(cuda_dev, case, cut):
    """A state whose fields are views of a larger batch (a leading slice, the
    benchmark's half-batch form, read where it lies; a strided one, copied)
    gives its lanes' stats in the whole batch's run on the same words; a
    shard (lanes [B/2, B), its own tensors) with its ``lane_offset`` the
    whole run's from its Philox words. Each equal to the twin; both
    register builds where they take the batch, and rollout.cu's."""
    src, B, T, steps = CARD[case]
    state = tv.make_batch(src(), B, device="cpu")
    if steps:
        state = driven_start(state, steps, 0)
    whole = ts.from_numpy(ts.to_numpy(state), device=cuda_dev)
    lanes = {"leading": slice(None, B // 2), "strided": slice(None, None, 2), "shard": slice(B // 2, None)}[cut]
    part = whole.replace(**{k: getattr(whole, k)[lanes] for k in vars(whole)})
    off = B // 2 if cut == "shard" else 0
    if cut == "shard":
        part = ts.from_numpy(ts.to_numpy(part), device=cuda_dev)
        want = fr._free_kernel(whole, T, 5, None)
    else:
        bits = torch.from_numpy(np.random.default_rng(6).integers(-(2**31), 2**31, size=(T, B)).astype(np.int32))
        want = fr._free_kernel(whole, T, 5, bits.to(cuda_dev))
    words = (None if cut == "shard" else bits[:, lanes].contiguous().to(cuda_dev))
    ref = fr.free_lane_stats_reference(part, T, 5, words, lane_offset=off)
    builds = [b for b in fr.BUILDS if b != "static" or fr.static_shape(part) is not None]
    for build in builds:
        got = fr._free_kernel(part, T, 5, words, lane_offset=off, build=build)
        for f in ref:
            assert torch.equal(got[f], ref[f]) and torch.equal(got[f], want[f][lanes]), (build, f)
    assert int(ref["episodes"].sum()) > 0


@pytest.mark.cuda
def test_new_kernel_reports_its_occupancy_on_card(cuda_dev):
    lib = fr._free_lib((15, 15))
    fn = lib.jss_free_static_blocks_per_sm
    fn.argtypes, fn.restype = [], ctypes.c_int
    assert fn() >= 1


@pytest.mark.cuda
def test_new_kernel_refuses_another_shape_on_card(cuda_dev, monkeypatch):
    """A library built for another shape refuses the batch before anything
    runs; the wrapper raises and counts nothing."""
    state = tv.make_batch(ti.get_instance("ta01"), 8, device=cuda_dev)
    other = fr._free_lib((6, 5))
    monkeypatch.setattr(fr, "_free_lib", lambda shape: other)
    before = dict(fr.LAUNCHES)
    with pytest.raises(RuntimeError, match="free_static_kernel<static 15x15>: CUDA launch refused"):
        fr.free_lane_stats(state, 4, seed=1)
    assert fr.LAUNCHES == before

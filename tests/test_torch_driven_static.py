"""The driven kernel's static build (``csrc/driven_static.cu``): its routing,
its host plumbing and, on a card, its results.

* The routing: which build each driven batch of ``chip_smoke.py`` and of
  the main paths takes, the shape limits, the launch's arguments (a
  stand-in library records the call), the slot-class build
  (``csrc/general_lane.cu``) for padded and mixed batches and the three
  builds on request, a refused launch, and the builds
  ``fused_rollout.build_kernels`` starts together.
* The plumbing: the new state's fields are views of two fresh allocations
  (nothing of the input is written or shared), the inputs as the kernel
  reads them, the ends dropped when not asked for.
* On a card only (``-m cuda``): the kernel against the twin and the other
  two builds, field by field, from fresh and mid-episode states, full and light,
  at T = 0, 1 and 40, with the input unchanged and the masks' bytes 0 or 1;
  a library of another shape refuses the batch. Whether a card is present
  is decided inside the fixture.

The kernel's source itself runs on the CPU in ``test_torch_kernel_shim.py``."""

import contextlib
import subprocess
import types
from pathlib import Path

import pytest
import torch

from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.core import _build
from jssenv_tpu_torch.core import fused_rollout as fr
from jssenv_tpu_torch.core import state as ts
from test_torch_free_static import _FakeLib, _module, driven_start

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    return torch.device("cuda")


def _actions(state, T, seed):
    """(T, B) int32 legal actions along the twin's own trajectory."""
    g = torch.Generator(device=state.device).manual_seed(seed)
    acts = []
    for _ in range(T):
        acts.append(tv.random_legal_actions(g, state).to(torch.int32))
        state, _ = fr.rollout_driven_reference(state, acts[-1][None], 1)
    return torch.stack(acts) if acts else torch.zeros((0, state.batch_size), dtype=torch.int32, device=state.device)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_every_driven_batch_of_the_smoke_takes_its_build():
    """The main paths' driven batches (the policy loop's ta01, the learner's
    light ta01, serving's and distillation's ta41) take the new kernel; the
    padded policy loop and the padded parity case the slot-class build; any
    of them rollout.cu's when asked for."""
    smoke = _module(ROOT / "chip_smoke.py", "chip_smoke_for_driven_tests")
    for name in ("ta01", "ta41", "ta41-ta50", "ta71", "rand6x5", smoke.PAD_LOOP[0]):
        state = tv.make_batch(smoke.source(ti, name), 20, device="cpu")
        J, M = state.jobs_pad, state.machines_pad
        want = fr.Build("slots", (1, 1)) if name == smoke.PAD_LOOP[0] else fr.Build("static", (J, M))
        assert fr.driven_build(state) == want, name
        assert fr.driven_build(tv.strip_solution(state)) == want, name
        assert fr.driven_build(state, "rollout") == fr.Build("rollout")
    padded = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu", jobs_pad=16, machines_pad=16)
    assert fr.driven_build(padded) == fr.Build("slots", (1, 1))
    assert all(fr.static_fits(s) for s in smoke.STATIC_SHAPES)


@pytest.mark.parametrize("shape,fits", [((128, 64), True), ((1, 2), True), ((129, 5), False), ((6, 65), False),
                                        ((100, 20), True), ((200, 20), False)])
def test_driven_shape_limits(shape, fits):
    state = tv.make_batch(ti.random_instance(*shape, (1, 9), seed=2), 2, device="cpu")
    assert fr.static_shape(state) == shape
    # past 64 machines: rollout.cu's build of ceil(M/32) machine slots a thread
    wide = -(-shape[1] // 32) if shape[1] > 64 else None
    assert fr.driven_build(state) == (fr.Build("static", shape) if fits else fr.Build("rollout", wide))
    assert fr.slot_class(*shape) == ((-(-shape[0] // 32), -(-shape[1] // 32)) if fits else None)


@pytest.fixture
def fake_card(monkeypatch):
    """The driven launchers on CPU tensors with stand-in libraries: the
    checks for a CUDA state and the stream are stubbed; nothing runs."""
    libs = types.SimpleNamespace(driven=_FakeLib(), general=_FakeLib(), slots=_FakeLib(), shapes=[], classes=[])
    monkeypatch.setattr(fr, "_check_kernel_inputs", lambda *a, **k: None)
    monkeypatch.setattr(fr, "_driven_lib", lambda shape: libs.shapes.append(shape) or libs.driven)
    monkeypatch.setattr(fr, "_lib", lambda slots=2: libs.general)
    monkeypatch.setattr(fr, "_general_lib", lambda slots: libs.classes.append(slots) or libs.slots)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=7))
    return libs


@pytest.mark.parametrize("light", [False, True], ids=["full", "light"])
def test_an_unpadded_launch_calls_the_new_kernel(fake_card, light):
    state = tv.make_batch(ti.get_instance("ta01"), 37, device="cpu")
    state = tv.strip_solution(state) if light else state
    acts = _actions(state, 3, 0)
    fr.reset_launch_counts()
    new, rewards, ends = fr._driven_kernel(state, acts, 3, not light, True)
    (name, args), = fake_card.driven.calls
    assert not fake_card.general.calls and not fake_card.slots.calls and fake_card.shapes == [(15, 15)]
    assert name == "jss_driven_static"
    inputs = fr._driven_inputs(state)
    tab, lanec = fr._lane_inputs(state)
    assert list(args[:17]) == [t.data_ptr() for t in inputs]
    assert args[17:20] == (tab.data_ptr(), lanec.data_ptr(), acts.data_ptr())
    # B, J, M, T, with_solution, stream
    assert args[22:] == (37, 15, 15, 3, int(not light), 7)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rollout_driven_static=1)
    # the new state and the rewards and ends live in the two allocations
    out, out8 = args[20], args[21]
    n32 = sum(getattr(state, f).numel() for f in fr._DRIVEN_I32) + 2 * 3 * 37
    n8 = sum(getattr(state, f).numel() for f in fr._DRIVEN_U8)
    i32 = {f: getattr(new, f) for f in fr._DRIVEN_I32} | {"rewards": rewards, "ends": ends}
    for f, t in i32.items():  # (a light state's empty solution has no address)
        assert t.dtype == torch.int32 and t.is_contiguous(), f
        assert t.numel() == 0 or out <= t.data_ptr() < out + 4 * n32, f
    for f in fr._DRIVEN_U8:
        t = getattr(new, f)
        assert t.dtype == torch.bool and t.shape == getattr(state, f).shape and out8 <= t.data_ptr() < out8 + n8, f
    assert rewards.shape == ends.shape == (3, 37)
    for f in ts.EnvState.STATIC_FIELDS:
        assert getattr(new, f) is getattr(state, f)


def test_the_new_state_shares_no_storage_with_the_input(fake_card):
    state = tv.make_batch(ti.get_instance("ta01"), 5, device="cpu")
    new, _ = fr._driven_kernel(state, _actions(state, 1, 1), 1, True, False)
    (_, args), = fake_card.driven.calls
    for f in fr._DRIVEN_I32 + fr._DRIVEN_U8:
        assert getattr(new, f).untyped_storage().data_ptr() in (args[20], args[21]), f
        assert getattr(new, f).untyped_storage().data_ptr() != getattr(state, f).untyped_storage().data_ptr(), f


def test_ends_are_dropped_unless_asked_for(fake_card):
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    acts = _actions(state, 2, 2)
    assert len(fr._driven_kernel(state, acts, 2, True, False)) == 2
    assert len(fr._driven_kernel(state, acts, 2, True, True)) == 3
    # the kernel writes the ends either way: both launches are the same call
    assert [c[1][22:] for c in fake_card.driven.calls] == [(4, 15, 15, 2, 1, 7)] * 2


def test_inputs_are_the_fields_or_contiguous_copies():
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    inputs = fr._driven_inputs(state)
    names = fr._DRIVEN_I32 + fr._DRIVEN_U8
    assert len(inputs) == 17 and all(t is getattr(state, n) for t, n in zip(inputs, names))
    # a transposed view, an int64 field and a uint8 mask are copied to the
    # kernel's layout and dtype; the state's own tensors stay as they were
    odd = state.replace(job_busy_for=state.job_busy_for.t().contiguous().t(), time=state.time.to(torch.int64),
                        legal=state.legal.to(torch.uint8))
    got = dict(zip(names, fr._driven_inputs(odd)))
    assert got["job_busy_for"].is_contiguous() and torch.equal(got["job_busy_for"], state.job_busy_for)
    assert got["time"].dtype == torch.int32 and got["legal"].dtype == torch.bool
    assert odd.time.dtype == torch.int64 and not odd.job_busy_for.is_contiguous()
    with pytest.raises(ValueError, match="meta"):
        fr._driven_inputs(state.replace(wait4=torch.empty((4, 15), dtype=torch.int32, device="meta")))


@pytest.mark.parametrize("pad", ["padded", "mixed", "forced"])
def test_padded_mixed_and_forced_launches_call_the_general_build(fake_card, pad, monkeypatch):
    """A padded or mixed batch launches its slot class's build on the
    state's own tensors (no lane buffer: ``_to_lanes`` is not called), as
    ``slots`` does on an unpadded one when asked for; ``rollout`` launches
    rollout.cu's general build on the lane buffer, on any batch."""
    if pad == "padded":
        state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu", jobs_pad=16, machines_pad=16)
    elif pad == "mixed":
        state = tv.make_batch(ti.get_instance_set(["ta01", "ta41"]), 4, device="cpu")
    else:
        state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    acts = _actions(state, 2, 3)
    J, M = state.jobs_pad, state.machines_pad
    fr.reset_launch_counts()
    real_to_lanes = fr._to_lanes
    monkeypatch.setattr(fr, "_to_lanes", lambda *a, **k: pytest.fail("the slot-class launch packed the state"))
    new, rewards, ends = fr._driven_kernel(state, acts, 2, True, True, build="slots" if pad == "forced" else None)
    (name, args), = fake_card.slots.calls
    assert name == "jss_driven_general" and fake_card.classes == [(1, 1)] and not fake_card.driven.calls
    inputs = fr._driven_inputs(state)
    assert list(args[:17]) == [t.data_ptr() for t in inputs]
    # B, J, M, T, with_solution, stream
    assert args[22:] == (4, J, M, 2, 1, 7)
    assert rewards.shape == ends.shape == (2, 4) and new.solution.shape == state.solution.shape
    monkeypatch.setattr(fr, "_to_lanes", real_to_lanes)
    fr._driven_kernel(state, acts, 2, True, True, build="rollout")
    assert [c[0] for c in fake_card.general.calls] == ["jss_rollout_driven"]
    geo = fr.launch_geometry(J, M)
    assert fake_card.general.calls[0][1][6:] == (4, J, M, 2, 1, geo.lanes, geo.state_stride, geo.scratch_stride,
                                                 geo.shared_bytes, 7)
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rollout_driven=1, rollout_driven_slots=1)
    if pad != "forced":
        with pytest.raises(ValueError, match="unpadded batch"):
            fr._driven_kernel(state, acts, 2, True, True, build="static")


def test_a_batch_past_the_limits_runs_the_general_build(fake_card):
    state = tv.make_batch(ti.random_instance(130, 3, (1, 9), seed=1), 2, device="cpu")
    fr.reset_launch_counts()
    fr._driven_kernel(state, _actions(state, 1, 4), 1, True, False)
    assert not fake_card.driven.calls and fr.LAUNCHES["rollout_driven"] == 1
    with pytest.raises(ValueError, match="unpadded batch of at most 128 jobs"):
        fr.launch_driven_static(state, *([None] * 7))
    with pytest.raises(ValueError, match="at most 128 jobs"):
        fr._driven_kernel(state, _actions(state, 1, 4), 1, True, False, build="slots")
    assert fr.LAUNCHES["rollout_driven_static"] == fr.LAUNCHES["rollout_driven_slots"] == 0


def test_a_refused_driven_launch_raises_and_counts_nothing(fake_card):
    fake_card.driven.rc = fake_card.slots.rc = 1  # cudaErrorInvalidValue
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    padded = tv.make_batch(ti.get_instance_set(["ta01", "ta11"]), 4, device="cpu")
    fr.reset_launch_counts()
    with pytest.raises(RuntimeError, match=r"driven_static_kernel<static 15x15>: CUDA launch refused or failed"):
        fr._driven_kernel(state, _actions(state, 1, 5), 1, True, True)
    with pytest.raises(RuntimeError, match=r"driven_general_kernel<slots 1x1>: CUDA launch refused or failed"):
        fr._driven_kernel(padded, _actions(padded, 1, 5), 1, True, True)
    assert not any(fr.LAUNCHES.values())


def test_the_driven_libraries_build_in_one_nvcc_batch(tmp_path, monkeypatch):
    """``build_kernels`` on the smoke's shapes starts the general build and
    each shape's driven and free static builds, every nvcc process before the
    first is waited for; the driven build's flags carry its shape."""
    smoke = _module(ROOT / "chip_smoke.py", "chip_smoke_for_driven_build")
    started = []
    want = 1 + 2 * len(smoke.STATIC_SHAPES)

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.cmd, self.returncode = cmd, 0

        def communicate(self, timeout=None):
            assert len(started) == want
            Path(self.cmd[self.cmd.index("-o") + 1]).write_bytes(b"")
            return "ptxas info    : Used 40 registers\n", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    for name in ("_lib", "_free_lib", "_driven_lib"):
        monkeypatch.setattr(fr, name, lambda *a: None)
    fr.build_kernels([None, *smoke.STATIC_SHAPES])
    driven = sorted(tuple(x for x in c if x.startswith("-DJSS_STATIC")) for c in started
                    if Path(c[-1]).name == "driven_static.cu")
    assert driven == sorted((f"-DJSS_STATIC_J={j}", f"-DJSS_STATIC_M={m}") for j, m in smoke.STATIC_SHAPES)
    assert sum(Path(c[-1]).name == "rollout.cu" for c in started) == 1
    # a header edit rebuilds: the library's name hashes the headers too
    assert _build.library_path("driven_static", (15, 15)).name.startswith("libdriven_static_15x15_")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# case -> (source, B, driven steps of a mid-episode start or 0)
CARD = {
    "ta01-B1": (lambda: ti.get_instance("ta01"), 1, 0),
    "ta01-B37": (lambda: ti.get_instance("ta01"), 37, 0),
    "ta01-mid": (lambda: ti.get_instance("ta01"), 64, 235),
    "rand6x5": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 101, 0),
    "ta41-mid": (lambda: ti.get_instance("ta41"), 16, 650),
    "rand40x3-mid": (lambda: ti.random_instance(40, 3, (1, 9), seed=7), 9, 105),
    "rand70x4-mid": (lambda: ti.random_instance(70, 4, (1, 9), seed=9), 9, 265),
    "rand128x2-mid": (lambda: ti.random_instance(128, 2, (1, 9), seed=12), 6, 235),
    "rand6x40-mid": (lambda: ti.random_instance(6, 40, (1, 9), seed=11), 9, 225),
    "rand33x64": (lambda: ti.random_instance(33, 64, (1, 9), seed=6), 8, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("light", [False, True], ids=["full", "light"])
@pytest.mark.parametrize("case", sorted(CARD))
def test_new_driven_kernel_matches_twin_and_general_on_card(cuda_dev, case, light):
    src, B, steps = CARD[case]
    state = tv.make_batch(src(), B, device="cpu")
    if steps:
        state = driven_start(state, steps, 0)
    state = ts.from_numpy(ts.to_numpy(state), device=cuda_dev)
    state = tv.strip_solution(state) if light else state
    assert fr.driven_build(state) == fr.Build("static", (state.jobs_pad, state.machines_pad))
    acts = _actions(state, 40, 9)
    for T in (0, 1, 40):
        a = acts[:T].contiguous()
        before = {k: v.clone() for k, v in state.dynamic_fields().items()}
        counts = dict(fr.LAUNCHES)
        new, raw, ends = fr._driven_kernel(state, a, T, not light, True)
        assert fr.LAUNCHES["rollout_driven_static"] == counts["rollout_driven_static"] + 1
        others = [fr._driven_kernel(state, a, T, not light, True, build=b) for b in ("rollout", "slots")]
        ref, r_raw, r_ends = fr.rollout_driven_reference(state, a, T, return_ends=True)
        torch.cuda.synchronize()
        assert torch.equal(raw, r_raw) and torch.equal(ends, r_ends)
        for gen, g_raw, g_ends in others:
            assert torch.equal(g_raw, raw) and torch.equal(g_ends, ends)
            for k in ts.FIELD_NAMES:
                assert torch.equal(getattr(gen, k), getattr(new, k)), (T, k)
        for k in ts.FIELD_NAMES:
            assert torch.equal(getattr(new, k), getattr(ref, k)), (T, k)
        for k, v in before.items():
            assert torch.equal(getattr(state, k), v), (T, k)
        for k in fr._DRIVEN_U8:
            assert not bool((getattr(new, k).view(torch.uint8) > 1).any()), (T, k)
    assert steps == 0 or int((r_ends > 0).sum()) > 0 or case == "rand128x2-mid"


@pytest.mark.cuda
def test_new_driven_kernel_refuses_another_shape_on_card(cuda_dev, monkeypatch):
    """A library built for another shape refuses the batch before anything
    runs; the wrapper raises and counts nothing."""
    state = tv.make_batch(ti.get_instance("ta01"), 8, device=cuda_dev)
    other = fr._driven_lib((6, 5))
    monkeypatch.setattr(fr, "_driven_lib", lambda shape: other)
    before = dict(fr.LAUNCHES)
    with pytest.raises(RuntimeError, match=r"driven_static_kernel<static 15x15>: CUDA launch refused"):
        fr.rollout_driven(state, torch.zeros((2, 8), dtype=torch.int32, device=cuda_dev), 2)
    assert fr.LAUNCHES == before


@pytest.mark.cuda
def test_new_driven_kernel_reports_its_occupancy_on_card(cuda_dev):
    import ctypes

    fn = fr._driven_lib((15, 15)).jss_driven_static_blocks_per_sm
    fn.argtypes, fn.restype = [], ctypes.c_int
    assert fn() >= 1

"""The slot-class build of both rollout kernels (``csrc/general_lane.cu``):
the routing of padded and mixed-shape batches and, on a card, its results.

* The routing: the slot class of a padded shape, the build every padded or
  mixed batch takes (a batch past 128 jobs or 64 machines keeps rollout.cu's
  build), the three builds on request, the library of each slot class
  keyed by its defines, and that a padded driven launch packs nothing
  (no ``_to_lanes`` / ``_from_lanes``).
* On a card only (``-m cuda``): the driven kernel against the twin and
  rollout.cu's build on padded and mixed batches of every slot class, full
  and light, fresh and mid-episode, at T = 0, 1 and 40 (input unchanged,
  mask bytes 0 or 1); the free kernel against the twin and rollout.cu's
  build in int32 and int16, Philox with a ``lane_offset`` and bits; a
  library of another slot class refuses the batch. Whether a card is
  present is decided inside the fixture.

The kernels' source itself runs on the CPU in ``test_torch_kernel_shim.py``,
whose padded and mixed sources (``MIXED``) these tests share."""

import ctypes

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.core import _build
from jssenv_tpu_torch.core import fused_rollout as fr
from jssenv_tpu_torch.core import state as ts
from test_torch_free_static import driven_start
from test_torch_kernel_shim import MIXED, SLOT_CLASSES

torch.set_num_threads(1)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("J,M,want", [(1, 1, (1, 1)), (32, 32, (1, 1)), (33, 32, (2, 1)), (20, 33, (1, 2)),
                                      (96, 64, (3, 2)), (97, 1, (4, 1)), (128, 64, (4, 2)), (129, 5, None),
                                      (5, 65, None), (0, 3, None)])
def test_slot_class_of_a_padded_shape(J, M, want):
    assert fr.slot_class(J, M) == want


@pytest.mark.parametrize("name", sorted(MIXED))
def test_padded_and_mixed_batches_take_their_slot_class(name):
    """Each padded or mixed source takes the slot-class build of its padded
    shape, full and light, in both kernels; the static build refuses it."""
    src, slots = MIXED[name]
    state = tv.make_batch(src(), 6, device="cpu")
    assert fr.static_shape(state) is None
    for s in (state, tv.strip_solution(state)):
        assert fr.driven_build(s) == fr.free_build(s) == fr.Build("slots", slots)
    assert fr.driven_build(state, "rollout") == fr.Build("rollout")
    with pytest.raises(ValueError, match="unpadded batch"):
        fr.free_build(state, "static")
    assert fr.free_kernel_job(state) == ("general_lane", None, (f"JSS_SLOTS_J={slots[0]}", f"JSS_SLOTS_M={slots[1]}"))


@pytest.mark.parametrize("pad", ["jobs", "machines", "mixed"])
def test_batches_past_the_lane_limits_take_rollout_cu(pad):
    """A padded batch of more than 128 jobs (or 64 machines) has no slot
    class: rollout.cu's general build, in both kernels."""
    if pad == "jobs":
        state = tv.make_batch(ti.get_instance("ta01"), 2, device="cpu", jobs_pad=130)
    elif pad == "machines":
        state = tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=1), 2, device="cpu", machines_pad=65)
    else:
        src = ti.stack_instances([ti.random_instance(130, 3, (1, 9), seed=1), ti.get_instance("ta01")])
        state = tv.make_batch(src, 4, device="cpu")
    # past 64 machines: rollout.cu's class of three machine slots a thread
    want = fr.Build("rollout", 3) if pad == "machines" else fr.Build("rollout")
    assert fr.driven_build(state) == fr.free_build(state) == want
    assert fr.kernel_jobs([fr.driven_build(state)]) == [
        ("rollout", None, ("JSS_MACHINE_SLOTS=3",)) if pad == "machines" else ("rollout", None)]
    with pytest.raises(ValueError, match="at most 128 jobs"):
        fr.driven_build(state, "slots")
    with pytest.raises(ValueError, match="unknown build"):
        fr.driven_build(state, "general")


def test_every_slot_class_is_a_library_of_its_own():
    """One library per slot class, named and hashed by its defines; each
    job is the same for the driven and the free kernel."""
    paths = set()
    for slots in SLOT_CLASSES:
        build = fr.Build("slots", slots)
        job = fr.build_job("driven", build)
        assert job == fr.build_job("free", build) == ("general_lane", None, fr.slot_defines(slots))
        assert _build.nvcc_flags(*job[1:])[-2:] == tuple(f"-D{d}" for d in fr.slot_defines(slots))
        path = _build.library_path(*job)
        assert path.name.startswith(f"libgeneral_lane_slots_j{slots[0]}_slots_m{slots[1]}_")
        paths.add(path)
    assert len(paths) == len(SLOT_CLASSES) == 8
    jobs = fr.kernel_jobs([fr.Build("slots", s) for s in SLOT_CLASSES] + [None, (15, 15)])
    assert len(jobs) == 8 + 3 and ("rollout", None) in jobs and ("driven_static", (15, 15)) in jobs


def test_the_smoke_runs_every_slot_class():
    from test_torch_free_static import ROOT, _module

    smoke = _module(ROOT / "chip_smoke.py", "chip_smoke_for_general_tests")
    assert smoke.SLOT_CLASSES == SLOT_CLASSES
    seen = {fr.driven_build(tv.make_batch(smoke.source(ti, n), 2, device="cpu")).shape for n in smoke.SLOT_CASES}
    padded = {fr.driven_build(tv.make_batch(smoke.source(ti, n), 2, device="cpu")).shape for n in smoke.PADDED}
    assert seen | padded == set(SLOT_CLASSES) and padded == {(1, 1)}
    for name, _, _ in smoke.LARGE:
        state = tv.make_batch(smoke.source(ti, name), 2, device="cpu")
        assert fr.driven_build(state) == fr.Build("rollout")
        assert str(fr.value_dtype(state)).removeprefix("torch.") == smoke.LARGE_DTYPE[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# case -> (source, B, driven steps of a mid-episode start or 0); every slot
# class, padded (ta01 to 16x16) and mixed
CARD = {
    "ta01+ta11": (MIXED["ta01+ta11"][0], 37, 0),
    "ta01+ta11-mid": (MIXED["ta01+ta11"][0], 64, 235),
    "ta01+ta41-mid": (lambda: ti.get_instance_set(["ta01", "ta41"]), 16, 250),
    "pad16": (MIXED["pad16"][0], 33, 0),
    **{f"{name}-mid": (MIXED[name][0], 9, 120) for name in MIXED if name.startswith("mix")},
}


def _actions(state, T, seed):
    """(T, B) int32 legal actions along the twin's own trajectory."""
    g = torch.Generator(device=state.device).manual_seed(seed)
    acts = []
    for _ in range(T):
        acts.append(tv.random_legal_actions(g, state).to(torch.int32))
        state, _ = fr.rollout_driven_reference(state, acts[-1][None], 1)
    return torch.stack(acts) if acts else torch.zeros((0, state.batch_size), dtype=torch.int32, device=state.device)


def _card_state(case, dev):
    src, B, steps = CARD[case]
    state = tv.make_batch(src(), B, device="cpu")
    if steps:
        state = driven_start(state, steps, 0)
    return ts.from_numpy(ts.to_numpy(state), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("light", [False, True], ids=["full", "light"])
@pytest.mark.parametrize("case", sorted(CARD))
def test_slot_class_driven_kernel_matches_twin_and_rollout_on_card(cuda_dev, case, light):
    state = _card_state(case, cuda_dev)
    state = tv.strip_solution(state) if light else state
    assert fr.driven_build(state).kind == "slots"
    acts = _actions(state, 40, 9)
    ended = 0
    for T in (0, 1, 40):
        a = acts[:T].contiguous()
        before = {k: v.clone() for k, v in state.dynamic_fields().items()}
        counts = dict(fr.LAUNCHES)
        new, raw, ends = fr.rollout_driven(state, a, T, return_ends=True)
        assert fr.LAUNCHES["rollout_driven_slots"] == counts["rollout_driven_slots"] + 1
        gen, g_raw, g_ends = fr._driven_kernel(state, a, T, not light, True, build="rollout")
        ref, r_raw, r_ends = fr.rollout_driven_reference(state, a, T, return_ends=True)
        torch.cuda.synchronize()
        assert torch.equal(raw, r_raw) and torch.equal(ends, r_ends)
        assert torch.equal(g_raw, raw) and torch.equal(g_ends, ends)
        for k in ts.FIELD_NAMES:
            assert torch.equal(getattr(new, k), getattr(ref, k)), (T, k)
            assert torch.equal(getattr(gen, k), getattr(new, k)), (T, k)
        for k, v in before.items():
            assert torch.equal(getattr(state, k), v), (T, k)
        for k in fr._DRIVEN_U8:
            assert not bool((getattr(new, k).view(torch.uint8) > 1).any()), (T, k)
        ended += int((r_ends > 0).sum())
    assert ended > 0 or CARD[case][2] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bits", "philox"])
@pytest.mark.parametrize("case", sorted(CARD))
def test_slot_class_free_kernel_matches_twin_and_rollout_on_card(cuda_dev, case, mode):
    state = _card_state(case, cuda_dev)
    B, T = state.batch_size, 300
    assert fr.free_build(state).kind == "slots"
    bits = None
    if mode == "bits":
        bits = torch.from_numpy(np.random.default_rng(5).integers(-(2**31), 2**31, size=(T, B)).astype(np.int32))
        bits = bits.to(cuda_dev)
    ref = fr.free_lane_stats_reference(state, T, 23, bits, lane_offset=B + 1)
    before = dict(fr.LAUNCHES)
    got = fr._free_kernel(state, T, 23, bits, lane_offset=B + 1)  # on the state's fields
    assert fr.LAUNCHES["rollout_free_slots"] == before["rollout_free_slots"] + 1
    for f in ref:
        assert torch.equal(got[f], ref[f]), f
    # rollout.cu's lane buffer in each storage type the batch fits
    for vdt in (torch.int32, torch.int16) if fr.value_dtype(state) == torch.int16 else (torch.int32,):
        gen = fr._free_kernel(state, T, 23, bits, vdt, lane_offset=B + 1, build="rollout")
        torch.cuda.synchronize()
        for f in ref:
            assert torch.equal(gen[f], got[f]), (vdt, f)
    assert int(ref["episodes"].sum()) > 0


@pytest.mark.cuda
def test_slot_class_library_refuses_another_class_on_card(cuda_dev, monkeypatch):
    """A library of another slot class refuses the batch before anything
    runs; the wrapper raises and counts nothing."""
    state = tv.make_batch(ti.get_instance_set(["ta01", "ta11"]), 8, device=cuda_dev)
    other = fr._general_lib((2, 1))
    monkeypatch.setattr(fr, "_general_lib", lambda slots: other)
    before = dict(fr.LAUNCHES)
    with pytest.raises(RuntimeError, match=r"driven_general_kernel<slots 1x1>: CUDA launch refused"):
        fr.rollout_driven(state, torch.zeros((2, 8), dtype=torch.int32, device=cuda_dev), 2)
    with pytest.raises(RuntimeError, match=r"free_general_kernel<slots 1x1>: CUDA launch refused"):
        fr.free_lane_stats(state, 4, seed=1)
    assert fr.LAUNCHES == before


@pytest.mark.cuda
def test_slot_class_kernels_report_their_occupancy_on_card(cuda_dev):
    lib = fr._general_lib((1, 1))
    lib.jss_driven_general_blocks_per_sm.argtypes, lib.jss_driven_general_blocks_per_sm.restype = [], ctypes.c_int
    lib.jss_free_general_blocks_per_sm.argtypes = []
    lib.jss_free_general_blocks_per_sm.restype = ctypes.c_int
    assert lib.jss_driven_general_blocks_per_sm() >= 1
    assert lib.jss_free_general_blocks_per_sm() >= 1

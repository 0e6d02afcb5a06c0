"""Host spans and counters of the port (``diagnostics.span``, ``COUNTS``)
and the benchmark's per-layer readers of them, on the CPU.

A span records only while a torch profiler runs or inside
``diagnostics.recording()``, and enters ``record_function`` only under a
profiler; the learner's update, its rollout and each env step, and a free
call, record the tree of spans that ``perfbench/metrics/`` reads."""

import json

import pytest
import torch

from jssenv_tpu_torch import diagnostics
from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.core import fused_rollout as fr
from jssenv_tpu_torch.parallel import learner as tl
from perfbench.lib import manifest
from perfbench.lib.trace import Trace

torch.set_num_threads(1)

UNROLL = 3
LEARNER_CHILDREN = ("learner.rollout", "learner.returns", "learner.loss", "learner.optimizer", "learner.metrics")
STEP_CHILDREN = ("policy.forward", "policy.sample", "env.step")


def _train_state():
    cfg = tl.LearnerConfig(unroll_steps=UNROLL, hidden=(8, 8))
    ts = tl.init_train_state(0, tv.make_batch(ti.get_instance("ta01"), 4, device="cpu"), cfg)
    return ts, tl.make_train_step(cfg)


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered")


def _names(spans):
    return [s.name for s in spans]


def test_no_span_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    ts, step = _train_state()
    diagnostics.reset_spans()
    step(ts)
    assert diagnostics.spans() == []
    assert diagnostics.span("a") is diagnostics.span("b")  # the one shared no-op: nothing allocated


def test_recording_keeps_spans_in_memory_without_annotations(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    ts, step = _train_state()
    diagnostics.reset_spans()
    with diagnostics.recording():
        step(ts)
    spans = diagnostics.spans()
    assert _names(spans).count("learner.update") == 1
    assert all(_names(spans).count(n) == UNROLL for n in STEP_CHILDREN)
    step(ts)  # outside the block again
    assert len(diagnostics.spans()) == len(spans)


def test_update_spans_nest_under_the_profiler_and_reach_the_chrome_trace(tmp_path):
    ts, step = _train_state()
    step(ts)  # warm: the lane inputs, Adam's state
    diagnostics.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(ts)
    spans = diagnostics.spans()
    names = _names(spans)
    assert names.count("learner.update") == 1 and names.count("learner.rollout") == 1
    assert "learner.allreduce" not in names  # one device: no mesh, no all-reduce
    update, rollout = names.index("learner.update"), names.index("learner.rollout")
    assert spans[update].parent == -1
    for n in LEARNER_CHILDREN:
        assert names.count(n) == 1 and spans[names.index(n)].parent == update, n
    for n in STEP_CHILDREN:
        assert names.count(n) == UNROLL, n
        assert all(s.parent == rollout for s in spans if s.name == n), n
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s.name, p.name)
    driven = [s.counts.get("host_reads", 0) for s in spans if s.name == "env.step"]
    assert driven == [0] * UNROLL  # a warm driven step reads nothing back
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(names) <= annotated
    train = Trace((0.0, 1.0), [], [], sizes={"mode": "train"})
    assert manifest.reader("rollout_host_ms_per_update").read(train) > 0
    assert manifest.reader("driven_call_host_us").read(train) > 0


def _recorded_update(features):
    """The spans of one warm REINFORCE update of a learner on ``features``,
    recorded under ``recording()``."""
    cfg = tl.LearnerConfig(unroll_steps=UNROLL, hidden=(8, 8), features=features, minibatches=1)
    ts = tl.init_train_state(0, tv.make_batch(ti.get_instance("ta01"), 4, device="cpu"), cfg)
    step = tl.make_train_step(cfg)
    ts, _ = step(ts)
    diagnostics.reset_spans()
    with diagnostics.recording():
        step(ts)
    return diagnostics.spans()


@pytest.mark.parametrize("features", ["reference", "rich"])
def test_policy_observe_nests_under_each_policy_forward(features):
    """A REINFORCE update's tree: ``learner.update`` > ``learner.rollout`` >
    ``policy.forward`` > ``policy.observe``, one of each a step; the
    observe span ends before the forward's net runs, and the reader of
    ``observe_host_ms_per_update`` sums them."""
    spans = _recorded_update(features)
    names = _names(spans)
    update, rollout = names.index("learner.update"), names.index("learner.rollout")
    assert spans[update].parent == -1 and spans[rollout].parent == update
    forwards = [i for i, n in enumerate(names) if n == "policy.forward"]
    observes = [s for s in spans if s.name == "policy.observe"]
    assert len(forwards) == len(observes) == UNROLL
    assert all(spans[i].parent == rollout for i in forwards)
    assert [s.parent for s in observes] == forwards
    for s in observes:
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    want = sum(s.end_ns - s.start_ns for s in observes) * 1e-6
    train = Trace((0.0, 1.0), [], [], sizes={"mode": "train"})
    assert manifest.reader("observe_host_ms_per_update").read(train, spans) == pytest.approx(want)


def test_rollout_free_records_env_free():
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    diagnostics.reset_spans()
    with diagnostics.recording():
        fr.rollout_free(state, 8, seed=3)
    spans = diagnostics.spans()
    assert _names(spans) == ["env.free"] and spans[0].parent == -1


def _free_call_spans(monkeypatch, build):
    """The spans of a warm ``rollout_free`` call on a CPU state through the
    CUDA path in ``build``, its launches stand-ins recording the storage
    dtype (``rollout.cu``'s) or the build's kind (a register build's)."""
    launched = []
    monkeypatch.setattr(fr, "launch_free", lambda *a, **k: launched.append(a[-2]))
    monkeypatch.setattr(fr, "_launch_free_lane", lambda b, *a, **k: launched.append(b.kind))
    monkeypatch.setattr(fr, "free_lane_stats_reference",
                        lambda state, T, seed, bits, lane_offset: fr._free_kernel(state, T, seed, bits,
                                                                                 lane_offset=lane_offset,
                                                                                 build=build))
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    fr.rollout_free(state, 8, seed=3)  # builds the lane inputs
    diagnostics.reset_spans()
    with diagnostics.recording():
        fr.rollout_free(state, 8, seed=4)
    return diagnostics.spans(), launched


def test_free_kernel_path_spans_read_the_dtype_once(monkeypatch):
    """The CUDA path of ``rollout_free`` on a CPU state, its launch a
    stand-in: the batch's static build on its fields. ``env.free`` holds
    ``env.launch`` alone, and a warm call reads nothing back to the host:
    the static shape and the value dtype were read once, with the batch's
    lane inputs, and no lane buffer is built."""
    spans, launched = _free_call_spans(monkeypatch, None)
    assert _names(spans) == ["env.free", "env.launch"] and [s.parent for s in spans] == [-1, 0]
    assert spans[0].counts == {} and spans[1].counts == {}
    assert launched == ["static", "static"]


def test_rollout_build_spans_hold_the_cached_dtype_and_one_lane_buffer(monkeypatch):
    """The same on ``rollout.cu``'s build: ``env.free`` holds
    ``env.value_dtype`` (the dtype cached with the lane inputs, no host
    read), ``env.to_lanes`` (one lane buffer a call) and ``env.launch``."""
    spans, launched = _free_call_spans(monkeypatch, "rollout")
    assert _names(spans) == ["env.free", "env.value_dtype", "env.to_lanes", "env.launch"]
    assert [s.parent for s in spans] == [-1, 0, 0, 0]
    assert spans[0].counts == spans[2].counts == {"lane_buffers_built": 1}
    assert spans[1].counts == spans[3].counts == {}
    assert launched == [torch.int16, torch.int16]


def test_host_reads_counts_each_value_dtype_call():
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    before = diagnostics.COUNTS["host_reads"]
    for _ in range(3):
        assert fr.value_dtype(state) == torch.int16
    assert diagnostics.COUNTS["host_reads"] - before == 3


def test_lane_inputs_built_once_per_batch():
    state = tv.make_batch(ti.get_instance_set(["ta01", "ta02"]), 4, device="cpu")
    before = diagnostics.COUNTS["lane_inputs_built"]
    fr._lane_inputs(state)
    assert diagnostics.COUNTS["lane_inputs_built"] - before == 1
    fr._lane_inputs(state)
    fr.static_shape(state)
    assert diagnostics.COUNTS["lane_inputs_built"] - before == 1


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

MS = 1_000_000  # ns


def _made_up_spans():
    """Two updates (10 and 14 ms, their rollouts 6 and 9 ms, two 1-ms and
    two 2-ms env steps) and two free calls (3 and 5 ms, reading 1 and 2
    values back)."""
    S = diagnostics.Span
    return [
        S("learner.update", -1, 0, 10 * MS, {}),
        S("learner.rollout", 0, 1 * MS, 7 * MS, {}),
        S("env.step", 1, 2 * MS, 3 * MS, {"rollout_driven_static": 1}),
        S("env.step", 1, 4 * MS, 5 * MS, {"rollout_driven_static": 1}),
        S("learner.loss", 0, 7 * MS, 9 * MS, {}),
        S("learner.update", -1, 20 * MS, 34 * MS, {}),
        S("learner.rollout", 5, 20 * MS, 29 * MS, {}),
        S("env.step", 6, 21 * MS, 23 * MS, {}),
        S("env.step", 6, 24 * MS, 26 * MS, {}),
        S("env.free", -1, 40 * MS, 43 * MS, {"host_reads": 1}),
        S("env.value_dtype", 9, 40 * MS, 41 * MS, {"host_reads": 1}),
        S("env.free", -1, 50 * MS, 55 * MS, {"host_reads": 2, "rollout_free_static": 1}),
    ]


READERS = [  # (metric, its cells' mode, the value of _made_up_spans)
    ("rollout_host_ms_per_update", "train", (6 + 9) / 2),
    ("learn_host_ms_per_update", "train", ((10 - 6) + (14 - 9)) / 2),
    ("driven_call_host_us", "train", (1 + 1 + 2 + 2) * 1e3 / 4),
    ("free_call_host_ms", "free", (3 + 5) / 2),
    ("host_reads_per_call", "free", (1 + 2) / 2),
]


def _trace(mode):
    return Trace((0.0, 1.0), [], [], units=2, sizes={"mode": mode})


@pytest.mark.parametrize("metric,mode,value", READERS)
def test_reader_sums_the_spans_of_its_mode(metric, mode, value):
    reader = manifest.reader(metric)
    spans = _made_up_spans()
    assert reader.read(_trace(mode), spans) == pytest.approx(value)
    assert reader.read(_trace("free" if mode == "train" else "train"), spans) is None
    assert reader.read(_trace(mode), []) is None
    assert reader.read(_trace(mode), [spans[10]]) is None  # an env.value_dtype span alone


@pytest.mark.parametrize("metric,mode,value", READERS)
def test_reader_reads_nothing_from_a_program_without_spans(monkeypatch, metric, mode, value):
    """The parent commit's port records no spans: each reader returns None
    and does not raise."""
    reader = manifest.reader(metric)
    diagnostics.reset_spans()
    with diagnostics.recording():
        fr.rollout_free(tv.make_batch(ti.get_instance("ta01"), 2, device="cpu"), 2)
    monkeypatch.delattr(diagnostics, "spans")
    assert reader.read(_trace(mode)) is None

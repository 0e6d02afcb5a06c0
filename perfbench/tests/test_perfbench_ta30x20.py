"""The ``ta30x20`` configuration: ta41-ta50 unpadded in int32, run by
``ta30x20.free`` alone; its free check, driven through ``run.execute`` on
the CPU at 8 lanes, passes the sound program and fails the int8-state
control and each fault a free cell can have; the reader of
``observe_host_ms_per_update``."""

import contextlib

import pytest
import torch

from perfbench import faults, run
from perfbench.lib import manifest
from perfbench.lib.trace import Trace

MAN = manifest.load()
SEED = 2**31 + 1919


def test_configuration_is_unpadded_30x20_in_int32_for_the_free_cell_alone():
    cfg = manifest.config(MAN, "ta30x20")
    assert (cfg["jobs"], cfg["machines"], cfg["value_dtype"]) == (30, 20, "int32")
    assert cfg["instances"] == [f"ta{i}" for i in range(41, 51)]
    assert cfg["batch"] == {"free": 10240} and "learner" not in cfg and list(cfg["limits"]) == ["free"]
    entry = next(c for c in MAN["configs"] if c["name"] == "ta30x20")
    assert entry["reduced"] == cfg["reduced"] == [] and entry["source"] == cfg["source"]
    assert [w["name"] for w in MAN["workloads"] if w["config"] == "ta30x20"] == ["ta30x20.free"]


CASES = [(None, None, True), (None, "int8", False), ("unchanged", None, False), ("half_batch", None, False),
         ("altered", None, False)]


@pytest.mark.parametrize("fault,control,expect", CASES, ids=[f"{f or ''}{k or ''}" or "sound" for f, k, _ in CASES])
def test_free_check_at_the_configuration_limits(fault, control, expect):
    cell = manifest.workload(MAN, "ta30x20.free")
    cfg, traffic = manifest.config(MAN, cell["config"]), manifest.traffic(cell["traffic"])
    cfg["batch"]["free"] = 8
    traffic.update(steps_per_call=320, trace_after=1, trace_calls=2)
    with faults.planted(fault) if fault else contextlib.nullcontext():
        res = run.execute(cell, cfg, traffic, SEED, 0.0, False, torch.device("cpu"), control=control)
    out = run.line(cell, MAN, res, False, "cpu", [])
    assert out["checks"]["return_rel_gap"]["limit"] == cfg["limits"]["free"]["return_rel_gap"]
    assert out["correct"] is expect, out["checks"]


MS = 1_000_000  # ns


def test_observe_reader_means_the_spans_over_the_updates():
    from jssenv_tpu_torch.diagnostics import Span

    spans = [Span("learner.update", -1, 0, 20 * MS, {}), Span("learner.rollout", 0, 0, 15 * MS, {}),
             Span("policy.forward", 1, 1 * MS, 4 * MS, {}), Span("policy.observe", 2, 1 * MS, 3 * MS, {}),
             Span("policy.forward", 1, 5 * MS, 9 * MS, {}), Span("policy.observe", 4, 5 * MS, 8 * MS, {}),
             Span("learner.update", -1, 30 * MS, 40 * MS, {}), Span("learner.rollout", 6, 30 * MS, 38 * MS, {}),
             Span("policy.forward", 7, 31 * MS, 33 * MS, {}), Span("policy.observe", 8, 31 * MS, 32 * MS, {})]
    reader = manifest.reader("observe_host_ms_per_update")
    train, free = (Trace((0.0, 1.0), [], [], sizes={"mode": m}) for m in ("train", "free"))
    assert reader.read(train, spans) == pytest.approx((2 + 3 + 1) / 2)
    assert reader.read(free, spans) is None
    assert reader.read(train, []) is None
    assert reader.read(train, [s for s in spans if s.name != "policy.observe"]) is None  # the parent's program
    assert reader.read(train, [None, *spans[6:]]) == pytest.approx(1.0)  # a span still open is skipped


def test_observe_reader_reads_nothing_from_a_program_without_spans(monkeypatch):
    from jssenv_tpu_torch import diagnostics

    monkeypatch.delattr(diagnostics, "spans")
    assert manifest.reader("observe_host_ms_per_update").read(Trace((0.0, 1.0), [], [], sizes={"mode": "train"})) \
        is None

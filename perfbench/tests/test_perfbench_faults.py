"""Each cell's check comes out false on its control and on every fault the
cell can have, and true on the sound program: the rest of a run, driven
here on the CPU at a small size with the look for a card skipped."""

import contextlib
import multiprocessing

import pytest
import torch

from perfbench import faults, run
from perfbench.lib import manifest

MAN = manifest.load()
SEED = 2**31 + 77


def _small(cell_name, perjob=False):
    """The cell at a size the CPU runs; ``perjob``: its learner swapped for
    the per-job net of width 128 on rich features over the padded
    ``ta15x15-30x20`` mix, computing in float32, by configuration keys
    alone (at 8 lanes in bfloat16 its sound runs read gaps over ``ta15x15``'s
    limits, which were set from the flat net at 8192 lanes)."""
    cell = manifest.workload(MAN, cell_name)
    cfg, traffic = manifest.config(MAN, cell["config"]), manifest.traffic(cell["traffic"])
    if perjob:
        cfg["instances"] = manifest.config(MAN, "ta15x15-30x20")["instances"]
        cfg["learner"].update(arch="perjob", features="rich", hidden=[128, 128], compute_dtype="float32")
    cfg["batch"] = {k: 8 for k in cfg["batch"]}
    traffic.update(steps_per_call=320, trace_after=1, trace_calls=2, trace_updates=1)
    if "learner" in cfg:
        cfg["learner"]["unroll_steps"] = 8
    return cell, cfg, traffic


def _correct(cell_name, fault=None, control=None, trace=False, perjob=False):
    cell, cfg, traffic = _small(cell_name, perjob)
    with faults.planted(fault) if fault else contextlib.nullcontext():
        res = run.execute(cell, cfg, traffic, SEED, 0.0, trace, torch.device("cpu"), control=control)
    out = run.line(cell, MAN, res, trace, "cpu", [])
    assert list(out)[-1] == "checks"
    return out["correct"]


CASES = [
    ("ta15x15.free", None, None, True),
    ("ta15x15.free", None, "int8", False),
    ("ta15x15.free", "unchanged", None, False),
    ("ta15x15.free", "half_batch", None, False),
    ("ta15x15.free", "altered", None, False),
    ("ta15x15-30x20.free", None, None, True),
    ("ta15x15-30x20.free", None, "int8", False),
    ("ta15x15-30x20.free", "unchanged", None, False),
    ("ta15x15-30x20.free", "half_batch", None, False),
    ("ta15x15-30x20.free", "altered", None, False),
    ("ta15x15.train", None, None, True),
    ("ta15x15.train", None, "float8", False),
    ("ta15x15.train", "unchanged", None, False),
    ("ta15x15.train", "half_batch", None, False),
    ("ta15x15.train", "altered", None, False),
]


@pytest.mark.parametrize("cell,fault,control,expect", CASES,
                         ids=[f"{c}-{f or ''}{k or ''}" or "sound" for c, f, k, _ in CASES])
def test_check_on_one_card(cell, fault, control, expect):
    assert _correct(cell, fault, control) is expect


PERJOB_CASES = [(None, None, True), ("padded_pool", None, False), (None, "float8", False),
                ("half_batch", None, False), ("unchanged", None, False), ("altered", None, False)]


@pytest.mark.parametrize("fault,control,expect", PERJOB_CASES,
                         ids=[f"{f or ''}{k or ''}" or "sound" for f, k, _ in PERJOB_CASES])
def test_perjob_check_on_the_padded_mix(fault, control, expect):
    """The per-job learner on rich features over the padded mix, held to
    ``ta15x15``'s limits: true when sound; false under the control, under
    each fault a training cell can have, and under pools that take in the
    padded job rows."""
    assert _correct("ta15x15.train", fault, control, perjob=True) is expect


def test_traced_run_reads_its_layers_and_checks_alike():
    assert _correct("ta15x15.train", trace=True) is True


def _rank(rank, world, port, fault, control, queue):
    torch.set_num_threads(1)
    cell, cfg, traffic = _small("ta15x15-dp4.train")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        res = run.execute(cell, cfg, traffic, SEED, 0.0, True, torch.device("cpu"), rank=rank, world=world,
                          port=port, backend="gloo", control=control)
    if rank == 0:
        queue.put(run.line(cell, MAN, res, True, "cpu", [])["correct"])


@pytest.mark.parametrize("fault,control,expect", [(None, None, True), ("exchange", None, False),
                                                  ("half_batch", None, False), (None, "float8", False)],
                         ids=["sound", "exchange", "half_batch", "float8"])
def test_check_on_a_mesh(fault, control, expect):
    """The four-card cell's path on two gloo ranks: the gradient exchange left
    out, half of the batch left out and the control fail the check."""
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), run.free_port()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, fault, control, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        assert queue.get(timeout=120) is expect
    finally:
        for p in procs:
            p.join(timeout=60)
    assert [p.exitcode for p in procs] == [0, 0]

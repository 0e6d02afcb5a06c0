"""Every cell, run on the card as the manifest's command runs it (a short window), prints
one correct result line; run with ``python -m pytest -m cuda
perfbench/tests`` on a machine with the cards the cell needs."""

import json
import subprocess
import sys

import pytest

from perfbench.lib import manifest

MAN = manifest.load()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch

    chips = manifest.workload(MAN, cell)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA card(s)")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 99),
                          "--seconds", "2", "--trace", str(trace)], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["count"] == chips
    wanted = manifest.per_layer(MAN, cell) if trace else manifest.end_to_end(MAN, cell)
    assert set(line["metrics"]) == {m["name"] for m in wanted}


def test_no_card_no_result():
    """Without the cards a cell needs, a run exits non-zero and prints
    nothing on standard output."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has the cards")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "ta15x15-dp4.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""

"""The manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name:

* ``configs/<config>.json`` (the path the manifest's ``file`` gives): the
  deployment, its sizes, guarantees and the limits of its checks;
* ``traffic/<traffic>.json``: the parameters of a traffic mix, with the
  ``mode`` whose runner runs it;
* ``modes/<mode>.py``: the window runner of one traffic mode;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(trace)`` that returns a number or None.

Adding a cell, a configuration, a traffic mix or a metric adds files and
manifest entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in the manifest; there are "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in the manifest")


def traffic(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode(name: str, bench: Path = BENCH) -> ModuleType:
    return _module(bench / "modes" / f"{name}.py", f"perfbench_mode_{name}")


def reader(metric: str, bench: Path = BENCH) -> ModuleType:
    return _module(bench / "metrics" / f"{metric}.py", "perfbench_metric_" + metric.replace(".", "_"))


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(manifest: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in manifest["end_to_end"] if _in_cell(m, cell)]


def per_layer(manifest: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell's traced run reads: those listing the
    cell, or, without a ``workloads`` key, those moving an end-to-end
    metric the cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]

"""The manifest keeps the benchmark's schema, and the harness finds each
configuration, traffic mix, mode and per-layer metric by its name."""

import json
import re
import shutil
from pathlib import Path
from typing import List

import pytest

from perfbench.lib import manifest

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def problems(man: dict, root: Path = manifest.ROOT) -> List[str]:
    """What in the manifest breaks the benchmark's schema: names, units,
    sources, each metric's cells and ``moves``, the files each entry needs,
    the share of four-chip cells."""
    out: List[str] = []
    bench = root / "perfbench"
    configs = {c["name"]: c for c in man.get("configs", [])}
    cells = {w["name"]: w for w in man.get("workloads", [])}
    e2e = {m["name"]: m for m in man.get("end_to_end", [])}
    layers = man.get("per_layer", [])
    names = list(configs) + list(cells) + list(e2e) + [m["name"] for m in layers]
    for n in names:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for group in (list(configs), list(cells), list(e2e) + [m["name"] for m in layers]):
        if len(set(group)) != len(group):
            out.append(f"duplicate names in {group}")
    for c in configs.values():
        if not (root / c["file"]).is_file():
            out.append(f"{c['name']}: no file {c['file']}")
        if not any(w["config"] == c["name"] for w in cells.values()):
            out.append(f"{c['name']}: no cell uses it")
    pairs = set()
    for w in cells.values():
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
        if not (bench / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"{w['name']}: no traffic file for {w['traffic']!r}")
        else:
            m = manifest.traffic(w["traffic"], bench)["mode"]
            if not (bench / "modes" / f"{m}.py").is_file():
                out.append(f"{w['name']}: no runner for mode {m!r}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"{w['name']}: config and traffic repeat another cell's")
        pairs.add((w["config"], w["traffic"]))
        if not manifest.end_to_end(man, w["name"]) or "setup_s" not in {m["name"] for m in manifest.end_to_end(man, w["name"])}:
            out.append(f"{w['name']}: reports no setup_s")
        if len(manifest.end_to_end(man, w["name"])) < 2:
            out.append(f"{w['name']}: reports no end-to-end metric besides setup_s")
        if not manifest.per_layer(man, w["name"]):
            out.append(f"{w['name']}: reports no per-layer metric")
    four = sum(w["chips"] == 4 for w in cells.values())
    if four > max(1, len(cells) // 4):
        out.append(f"{four} four-chip cells of {len(cells)}")
    for m in list(e2e.values()) + layers:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"{m['name']}: unknown cell {cell!r}")
    for m in e2e.values():
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: an end-to-end metric from {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in layers:
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']!r}")
        else:
            for cell in m.get("workloads", []):
                if cell in cells and m["moves"] not in {x["name"] for x in manifest.end_to_end(man, cell)}:
                    out.append(f"{m['name']}: {cell} does not report {m['moves']}")
        if not (bench / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader file")
        if "\n" in m["layer"] or not 1 <= len(m["layer"]) <= 200:
            out.append(f"{m['name']}: bad layer")
    return out

KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_manifest_has_no_problems():
    assert problems(MAN) == []


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_only_the_schema_keys(section, keys):
    for entry in MAN[section]:
        assert set(entry) <= keys, entry
        assert set(entry) >= keys - {"workloads"}, entry
        for text in [entry.get("why", "x"), entry.get("layer", "x"), entry.get("source", "x")]:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics_are_the_four():
    assert {m["name"] for m in MAN["end_to_end"]} == {"env_steps_per_s", "train_env_steps_per_s", "update_p95_ms",
                                                      "setup_s"}
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in MAN["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(MAN, cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = manifest.per_layer(MAN, cell["name"])
        assert layers and all(m["moves"] in e2e for m in layers)


def test_four_chip_cells_within_a_quarter():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)


def test_problems_are_found():
    bad = json.loads(json.dumps(MAN))
    bad["per_layer"][0]["moves"] = "no_such_metric"
    bad["workloads"][0]["name"] = "has space"
    bad["end_to_end"][0]["unit"] = "env steps per second"
    found = problems(bad)
    assert any("moves unknown" in p for p in found)
    assert any("bad name" in p for p in found)
    assert any("bad unit" in p for p in found)


def test_harness_finds_new_files_by_name(tmp_path):
    """A later PR adds a metric, a traffic mix and a configuration as files
    and manifest entries, and edits no file of the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    (root / "perfbench" / "metrics" / "dummy_count.py").write_text(
        "def read(trace):\n    return float(len(trace.device)) if trace.device else None\n")
    (root / "perfbench" / "traffic" / "free_short.json").write_text(json.dumps(
        {"mode": "free", "why": "short calls", "steps_per_call": 256, "trace_after": 5, "trace_calls": 10}))
    cfg = json.loads((root / "perfbench" / "configs" / "ta15x15.json").read_text())
    cfg.update(name="ta20x15", instances=[f"ta{i}" for i in range(11, 21)], jobs=20)
    (root / "perfbench" / "configs" / "ta20x15.json").write_text(json.dumps(cfg))
    man["configs"].append({"name": "ta20x15", "source": "Taillard 1993: JSSP 20x15 ta11-ta20",
                           "file": "perfbench/configs/ta20x15.json", "reduced": [], "why": "the 20x15 class"})
    man["workloads"].append({"name": "ta20x15.free_short", "config": "ta20x15", "traffic": "free_short", "chips": 1,
                             "why": "short free calls on the 20x15 class"})
    for m in man["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("ta20x15.free_short")
    man["per_layer"].append({"name": "dummy_count", "unit": "ops", "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "env_steps_per_s", "workloads": ["ta20x15.free_short"]})
    assert problems(man, root) == []
    bench = root / "perfbench"
    assert manifest.config(man, "ta20x15", root)["jobs"] == 20
    assert manifest.traffic("free_short", bench)["steps_per_call"] == 256
    assert manifest.mode(manifest.traffic("free_short", bench)["mode"], bench).run
    layers = [m["name"] for m in manifest.per_layer(man, "ta20x15.free_short")]
    assert layers == ["dummy_count"]
    assert manifest.reader("dummy_count", bench).read(type("T", (), {"device": [1, 2]})()) == 2.0

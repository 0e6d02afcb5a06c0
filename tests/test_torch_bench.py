"""The port's bench (``tools/bench_torch.py``) against ``bench.py``.

Its record carries ``bench.py``'s keys (read from bench.py's own source), its
``parse_instances`` is bench.py's, its stats are those of the free rollout's
plain twin at the same seed, an identity violation raises, and without CUDA
it exits non-zero and prints no JSON line unless asked for the CPU. On a card
(``-m cuda``) a short run goes through the kernel in the dtype
``value_dtype`` picks."""

import ast
import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.core import fused_rollout as fr

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "bench_torch.py"


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


bench_torch = _load(TOOL, "bench_torch")


def _bench_record_keys():
    """The keys of the record that bench.py's ``run_config`` returns."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "run_config":
            for ret in ast.walk(node):
                if isinstance(ret, ast.Return) and isinstance(ret.value, ast.Dict):
                    return {k.value for k in ret.value.keys}
    raise AssertionError("bench.py's run_config record not found")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    return torch.device("cuda")


def test_cpu_run_prints_one_json_line_with_bench_keys():
    out = subprocess.run(
        [sys.executable, str(TOOL), "--device", "cpu", "--batch", "64", "--steps", "64", "--repeats", "1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    want = _bench_record_keys()
    assert {"metric", "value", "unit", "vs_baseline", "backend", "engine", "batch", "steps", "warmup_s"} <= want
    assert want <= set(rec)
    assert rec["metric"] == "env-steps/s per chip, batched ta01, random policy"
    assert rec["unit"] == "env-steps/s" and rec["backend"] == "cpu" and rec["engine"] == "twin"
    assert (rec["batch"], rec["steps"]) == (64, 64) and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / bench_torch.REFERENCE_STEPS_PER_S["ta01"], 2)
    assert rec["gpu"] is None and rec["power_limit"] is None and "extra" not in rec
    assert [r["seed"] for r in rec["runs"]] == [1] and rec["runs"][0]["identity_violations"] == 0
    assert not any(rec["launches"].values())


@pytest.mark.parametrize("spec", ["ta01", "ta01,ta02", "ta41-ta50", "dmu16-dmu20", " ta01 , ta41-ta43"])
def test_parse_instances_is_bench_py_s(spec):
    bench = _load(ROOT / "bench.py", "bench_jax_cli")
    assert bench_torch.parse_instances(spec) == bench.parse_instances(spec)
    assert all(n in ti.instance_names() for n in bench_torch.parse_instances(spec))


@pytest.mark.parametrize("spec,batch", [("ta01", 24), ("ta01,ta02", 16)])
def test_run_stats_equal_the_plain_twin(spec, batch):
    steps, repeats = 300, 2
    rec = bench_torch.run_config(spec, batch, steps, repeats, torch.device("cpu"))
    names = bench_torch.parse_instances(spec)
    src = ti.get_instance(names[0]) if len(names) == 1 else ti.get_instance_set(names)
    state = tv.make_batch(src, batch, device="cpu")
    assert [r["seed"] for r in rec["runs"]] == [1, 2]
    for run in rec["runs"]:
        want = fr.rollout_free_reference(state, steps, seed=run["seed"])
        for key in ("episodes", "total_makespan", "min_makespan", "identity_violations"):
            assert run[key] == int(want[key]), key
    assert sum(r["episodes"] for r in rec["runs"]) > 0
    assert rec["value_dtype"] == "int32" and rec["engine"] == "twin"


def test_identity_violation_raises(monkeypatch, capsys):
    real = fr.rollout_free

    def violating(state, num_steps, seed=0, **kw):
        out = real(state, num_steps, seed=seed, **kw)
        out["identity_violations"] = out["identity_violations"] + 1
        return out

    monkeypatch.setattr(fr, "rollout_free", violating)
    with pytest.raises(RuntimeError, match="reward-identity violations: 1"):
        bench_torch.main(["--device", "cpu", "--batch", "8", "--steps", "16", "--repeats", "1"])
    assert "{" not in capsys.readouterr().out


def test_without_cuda_exits_nonzero_and_prints_no_record(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(["--batch", "8", "--steps", "16"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err
    assert bench_torch.main(["--device", "cuda:0", "--batch", "8", "--steps", "16"]) == 1
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_bench_runs_the_kernel_on_card(cuda_dev):
    rec = bench_torch.run_config("ta01", 1024, 512, 2, cuda_dev)
    assert rec["engine"] == "cuda" and rec["backend"] == "cuda" and rec["value_dtype"] == "int16"
    # ta01 is unpadded: the static build, on the state's fields
    assert rec["launches"] == dict.fromkeys(fr.LAUNCHES, 0) | {"rollout_free_static": 3}
    assert rec["gpu"] and rec["power_limit"].endswith("W")
    state = tv.make_batch(ti.get_instance("ta01"), 1024, device=cuda_dev)
    for run in rec["runs"]:
        want = fr.rollout_free_reference(state, 512, seed=run["seed"])
        for key in ("episodes", "total_makespan", "min_makespan", "identity_violations"):
            assert run[key] == int(want[key]), key
        assert run["device_ms"] > 0

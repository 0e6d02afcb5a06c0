"""The port's instance loader against the JAX package's, plus the port's
package-level rules: no JAX imports, and entry points that need a card
unless the CPU is asked for."""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

ji = pytest.importorskip("jssenv_tpu.instances")  # needs jax on the path

from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import engine as te  # noqa: E402
from jssenv_tpu_torch.core import state as ts  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _same_spec(a, b):
    assert (a.name, a.num_jobs, a.num_machines) == (b.name, b.num_jobs, b.num_machines)
    for k in ("op_machine", "op_dur"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert (a.max_time_op, a.max_time_jobs, a.sum_op, a.lower_bound()) == (
        b.max_time_op, b.max_time_jobs, b.sum_op, b.lower_bound())


def _same_set(a, b):
    assert a.names == b.names
    for k in ("num_jobs", "num_machines", "op_machine", "op_dur"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_bundled_instances_equal():
    """All 85 bundled instances: same names, same arrays."""
    assert ti.instance_names() == ji.instance_names()
    assert len(ti.instance_names()) == 85
    _same_set(ti.bundled_instances(), ji.bundled_instances())
    for name in ti.instance_names():
        _same_spec(ti.get_instance(name), ji.get_instance(name))


@pytest.mark.parametrize("shape,seed", [((6, 5), 0), ((15, 15), 1), ((30, 20), 7), ((10, 4), 42)])
def test_random_instance_equal(shape, seed):
    _same_spec(
        ti.random_instance(*shape, duration_range=(1, 99), seed=seed),
        ji.random_instance(*shape, duration_range=(1, 99), seed=seed),
    )
    _same_set(ti.random_instance_set(3, *shape, seed=seed), ji.random_instance_set(3, *shape, seed=seed))


def test_parse_stack_and_files_equal(tmp_path):
    spec = ti.get_instance("ta01")
    text = spec.to_text()
    assert text == ji.get_instance("ta01").to_text()
    _same_spec(ti.parse_taillard_text(text, "x"), ji.parse_taillard_text(text, "x"))
    path = tmp_path / "inst.txt"
    path.write_text(text)
    _same_spec(ti.load_instance_file(path), ji.load_instance_file(path))
    _same_spec(ti.get_instance(str(path)), ji.get_instance(str(path)))
    names = ["ta01", "ta41", "ta71"]
    _same_set(ti.get_instance_set(names), ji.get_instance_set(names))
    _same_set(
        ti.get_instance_set(names[:2], jobs_pad=32, machines_pad=24),
        ji.get_instance_set(names[:2], jobs_pad=32, machines_pad=24),
    )
    _same_spec(spec.padded(20, 18), ji.get_instance("ta01").padded(20, 18))
    iset = ti.get_instance_set(names)
    _same_spec(iset.spec("ta41"), ji.get_instance_set(names).spec("ta41"))
    _same_set(iset.subset(["ta71", "ta01"]), ji.get_instance_set(names).subset(["ta71", "ta01"]))
    ti.save_instance_set(tmp_path / "s.npz", iset)
    _same_set(ji.load_instance_set(tmp_path / "s.npz"), iset)


def test_instance_validation_matches():
    bad = np.array([[0, 0], [1, 0]], np.int32)
    for mod in (ti, ji):
        with pytest.raises(ValueError):
            mod.InstanceSpec("bad", 2, 2, bad, np.ones((2, 2), np.int32))
        with pytest.raises(FileNotFoundError):
            mod.get_instance("no_such_instance_xyz")


def _port_modules():
    files = sorted((ROOT / "jssenv_tpu_torch").rglob("*.py"))
    names = {str(f.relative_to(ROOT / "jssenv_tpu_torch")) for f in files}
    assert {"vector.py", "core/fused_rollout.py", "native/__init__.py", "replay.py",
            "rules/dispatching.py", "envs/gym_env.py", "envs/vec_env.py", "render/gantt.py",
            "utils.py", "models/policy.py", "checkpoint.py", "parallel/learner.py", "parallel/mesh.py",
            "parallel/multihost.py", "distill.py", "diagnostics.py"} <= names
    tools = sorted((ROOT / "tools").glob("*_torch.py"))
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert {"bench_torch.py", "solver_quality_torch.py", "distill_30x20_torch.py", "bench_scaling_torch.py",
            "gen_golden_torch.py"} <= {f.name for f in tools}
    assert {"torch_dispatching_rules_example.py", "torch_solve_instance.py", "torch_train_policy.py"} <= {
        f.name for f in examples}
    return files + tools + examples + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No module of the port, none of its tools (``tools/*_torch.py``) and
    examples (``examples/torch_*.py``), and not chip_smoke.py imports jax,
    flax, optax or the JAX package — not even its framework-free modules."""
    banned = ("jax", "jaxlib", "flax", "optax", "jssenv_tpu")
    for path in _port_modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in banned, f"{path.relative_to(ROOT)} imports {n}"


def test_bundled_data_is_a_copy():
    a = (ROOT / "jssenv_tpu_torch" / "data" / "instances.npz").read_bytes()
    b = (ROOT / "jssenv_tpu" / "data" / "instances.npz").read_bytes()
    assert a == b


def test_entry_points_need_a_card(monkeypatch):
    """Without a card the entry points raise unless device='cpu' is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ti.get_instance("ta01")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.make_batch(spec, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.make_batch(spec, 2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.state_from_spec(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.RolloutStats.zero()
    state = tv.make_batch(spec, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.from_numpy(ts.to_numpy(state))
    assert state.device.type == "cpu"
    assert ts.from_numpy(ts.to_numpy(state), device="cpu").device.type == "cpu"
    assert te.state_from_spec(spec, device="cpu").batch_size == 1


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    """The smoke script exits non-zero and prints no result without a card."""
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main() != 0
    assert '"ok"' not in capsys.readouterr().out
    assert os.path.basename(mod.SOURCE) == "rollout.cu"


def test_chip_smoke_alone_exits_1_with_its_reason(tmp_path):
    """Copied alone into an empty directory, the smoke script exits 1 before
    anything else, says which files of the checkout are missing, and prints
    no result."""
    import shutil
    import subprocess
    import sys

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 1 and out.stdout == ""
    assert "is not a checkout of the repo (no jssenv_tpu_torch, " in out.stderr

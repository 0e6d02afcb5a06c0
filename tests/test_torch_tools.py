"""The port's solver-quality and distillation tools against the JAX package's.

``tools/solver_quality_torch.py``: the JSON schema of
``docs/solver_quality.json``, every row's makespan at least its lower bound
and replayed on the native engine, ``lower_bound`` equal to the JAX
package's on every bundled instance. ``tools/distill_30x20_torch.py``:
``collect`` equal to the leading rows of the shipped
``models_data/distill_30x20_pairs.npz``, the float32 ``eval`` of
``ta41_distill`` equal to the JAX package's 2658, a one-epoch ``pretrain``
that writes a checkpoint both packages load, and ``models_data/`` untouched
by all of it (the last test)."""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import checkpoint as tck
from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import replay as trp
from jssenv_tpu_torch import solve as tsolve
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.parallel import learner as tl

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = ROOT / "models_data"
# what models_data/ holds before any test of this file runs
MODELS_BEFORE = {p.name: p.stat().st_mtime_ns for p in sorted(MODELS.iterdir())}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


sq = _load("solver_quality_torch")
dt = _load("distill_30x20_torch")


# ---------------------------------------------------------------------------
# solver quality
# ---------------------------------------------------------------------------


def test_solver_quality_schema_and_certified_rows(tmp_path, monkeypatch):
    solved = []
    real = tsolve.solve

    def recording(spec, **kw):
        res = real(spec, **kw)
        solved.append((spec, res))
        return res

    monkeypatch.setattr(tsolve, "solve", recording)
    out = tmp_path / "sq.json"
    argv = ["--instances", "ta01", "ta02", "--iters", "8", "--batch", "32", "--sweeps", "1", "--chains", "8",
            "--seeds", "0", "1", "--device", "cpu", "--out", str(out)]
    assert sq.main(argv) == 0
    got = json.loads(out.read_text())
    ref = json.loads((ROOT / "docs" / "solver_quality.json").read_text())
    assert set(got) == set(ref)
    assert all(set(r) == set(ref["rows"][0]) for r in got["rows"])
    assert set(got["rows"][0]["timings_seed0"]) == set(ref["rows"][0]["timings_seed0"])
    assert [r["instance"] for r in got["rows"]] == ["ta01", "ta02"]
    for row in got["rows"]:
        spec = ti.get_instance(row["instance"])
        assert row["lower_bound"] == spec.lower_bound() <= row["makespan"] <= row["makespan_seed0"]
        assert row["best_known"] == sq.BEST_KNOWN[row["instance"]] <= row["makespan"]
        assert row["seeds_run"] == [0, 1] and set(row["seconds_per_seed"]) == {"0", "1"}
    # the warm-up and two seeds of each instance, every result replayed
    assert len(solved) == 5
    for spec, res in solved:
        mk, _ = trp.replay_machine_order(spec, res.machine_order(), backend="native")
        assert mk == res.makespan
    assert got["compile_s"] >= 0 and "iters=8" in got["config"]
    # --out writes a new file only
    assert sq.main(argv) == 2


def test_lower_bound_equals_jax_on_every_bundled_instance():
    from jssenv_tpu import instances as ji

    names = ti.instance_names()
    assert len(names) == 85 and tuple(names) == tuple(ji.instance_names())
    for name in names:
        assert ti.get_instance(name).lower_bound() == ji.get_instance(name).lower_bound(), name


def test_solver_quality_without_cuda_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sq.main(["--instances", "ta01", "--iters", "8"]) == 1
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# distillation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("names", [["ta41"], ["ta41", "ta42"]])
def test_collect_equals_the_shipped_pairs(tmp_path, names):
    assert dt.main(["collect", "--instances", *names, "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    with np.load(tmp_path / dt.PAIRS) as z:
        got = {k: z[k] for k in z.files}
    with np.load(MODELS / dt.PAIRS) as z:
        n = len(got["action"])
        shipped = {k: z[k][:n] for k in z.files}
        total = len(z["action"])
    # one pair a decision: J*M for each instance's optimum, in order
    assert n == sum(ti.get_instance(x).num_jobs * ti.get_instance(x).num_machines for x in names) < total
    assert set(got) == set(shipped)
    assert float(np.abs(got["obs"] - shipped["obs"]).max()) <= 1e-6
    for k in ("mask", "valid", "action"):
        assert got[k].dtype == shipped[k].dtype and np.array_equal(got[k], shipped[k]), k


def _train_state_npz(path):
    params = tck.params_from_flax(MODELS / "ta41_distill.npz")
    env = tv.strip_solution(tv.make_batch(ti.get_instance("ta41"), 2, device="cpu"))
    tck.save_train_state(str(path), tl.init_train_state(0, env, dt.CFG, params))
    return path


@pytest.mark.parametrize("kind", ["flax", "train_state"])
def test_float32_eval_of_ta41_distill(tmp_path, capsys, kind):
    ckpt = MODELS / "ta41_distill.npz" if kind == "flax" else _train_state_npz(tmp_path / "ts.npz")
    argv = ["eval", str(ckpt), "--instances", "ta41", "--dtype", "float32", "--device", "cpu",
            "--out-dir", str(tmp_path)]
    assert dt.main(argv) == 0
    assert capsys.readouterr().out.splitlines() == ["ta41: greedy 2658"]


def test_one_epoch_pretrain_writes_a_loadable_checkpoint(tmp_path):
    with np.load(MODELS / dt.PAIRS) as z:
        np.savez_compressed(tmp_path / dt.PAIRS, **{k: z[k][:600] for k in z.files})
    dt.pretrain(dt.Paths(str(tmp_path)), torch.device("cpu"), epochs=1, eval_names=())
    params = dt.load_params(str(tmp_path / dt.PRE))
    model = tl.init_model(0, tv.make_batch(ti.get_instance("ta41"), 1, device="cpu"), dt.CFG)
    model.load_state_dict(params)
    start = tl.init_model(0, tv.make_batch(ti.get_instance("ta41"), 1, device="cpu"), dt.CFG).state_dict()
    assert all(torch.isfinite(v).all() for v in params.values())
    assert any(not torch.equal(params[k], start[k]) for k in start)
    named = tck.load(str(tmp_path / dt.PRE))
    assert all(k.startswith("['params']") for k in named)


def test_one_epoch_pretrain_loads_into_the_jax_package(tmp_path):
    pytest.importorskip("flax")
    import jax

    from jssenv_tpu import checkpoint as jck
    from jssenv_tpu import instances as ji
    from jssenv_tpu import vector as jv
    from jssenv_tpu.parallel import learner as jl

    with np.load(MODELS / dt.PAIRS) as z:
        np.savez_compressed(tmp_path / dt.PAIRS, **{k: z[k][:512] for k in z.files})
    dt.pretrain(dt.Paths(str(tmp_path)), torch.device("cpu"), epochs=1, eval_names=())
    cfg = jl.LearnerConfig(hidden=(128, 128), arch="perjob", features="rich", unroll_steps=640, loss_chunks=8)
    template = jl.init_train_state(jax.random.key(0), jv.make_batch(ji.get_instance("ta41"), 2), cfg).params
    loaded = jck.load(str(tmp_path / dt.PRE), template)
    want = dt.load_params(str(tmp_path / dt.PRE))
    got = tck.params_from_flax(jax.tree_util.tree_map(np.asarray, loaded))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_pipeline_steps_run_at_small_size(tmp_path, monkeypatch):
    """augment_solve, augment_collect, finetune and finetune_anchored end to
    end on the CPU, cut to size: unroll 4, one update a stage, a 32-lane
    solve of one sweep and 4 tabu iterations."""
    import dataclasses

    monkeypatch.setattr(dt, "CFG", dataclasses.replace(dt.CFG, unroll_steps=4, loss_chunks=1))
    real = tsolve.solve
    monkeypatch.setattr(tsolve, "solve", lambda spec, **kw: real(spec, **dict(kw, batch=32, sweeps=1)))
    paths, cpu = dt.Paths(str(tmp_path)), torch.device("cpu")
    with np.load(MODELS / dt.PAIRS) as z:
        np.savez_compressed(tmp_path / dt.PAIRS, **{k: z[k][:600] for k in z.files})
    dt.augment_solve(paths, cpu, seeds=(1, 2), iters=4)
    aug = json.loads((tmp_path / dt.AUG_ORDERS).read_text())
    spec = ti.get_instance("ta41")
    for rec in aug:
        assert trp.replay_machine_order(spec, rec["machine_order"], backend="native")[0] == rec["makespan"]
    dt.augment_collect(paths, cpu)
    with np.load(tmp_path / dt.PAIRS) as z, np.load(tmp_path / dt.PAIRS41) as z41:
        assert len(z["action"]) == 600 * (1 + len(aug)) and len(z41["action"]) == 600 * (1 + len(aug))
        assert np.array_equal(z41["action"][:600], z["action"][:600])
    dt.finetune(paths, cpu, stages=((2e-4, 3e-3, 1),), pre=str(MODELS / dt.PRE))
    dt.finetune_anchored(paths, cpu, rounds=1, rl_updates=1, anchor_epochs=1)
    params = dt.load_params(str(tmp_path / dt.FINAL))
    assert params.keys() == tck.params_from_flax(MODELS / dt.PRE).keys()
    assert all(torch.isfinite(v).all() for v in params.values())


def test_outputs_never_go_to_models_data(capsys):
    assert dt.main(["collect", "--device", "cpu", "--out-dir", str(MODELS)]) == 2
    assert dt.main(["collect", "--device", "cpu", "--out-dir", str(MODELS / "sub")]) == 2
    assert dt.main(["finetune", "a.npz", str(MODELS / dt.FINAL), "--device", "cpu"]) == 2
    assert "refusing" in capsys.readouterr().err


def test_distill_without_cuda_exits_nonzero(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dt.main(["eval", str(MODELS / "ta41_distill.npz"), "--out-dir", str(tmp_path)]) == 1


def test_models_data_unchanged():
    """Runs last: nothing above wrote to models_data/."""
    assert {p.name: p.stat().st_mtime_ns for p in sorted(MODELS.iterdir())} == MODELS_BEFORE

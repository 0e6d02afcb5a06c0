"""The port's sharded train step against its single-process step, and that
against the JAX package's.

Ranks are processes of this file (``python tests/test_torch_parallel.py
OUT PORT WORLD RANK DP MP``) joined over gloo on 127.0.0.1; each runs one
whole train step, rollout included, of every case from the same seed on
its part of the mesh and writes its actions, metrics and the gathered
parameters to an npz. The test process runs the same step on one process
and compares: actions and ``episodes`` exactly; at float32 the loss within
rel 1e-5 and the parameters within 1e-5 of the largest; at bfloat16 the
JAX test's bounds (tests/test_parallel.py:137-146). The single-process
step is held against the JAX package's train step on a recorded
trajectory, as tests/test_torch_learner.py does."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import fused_rollout as fr  # noqa: E402
from jssenv_tpu_torch.parallel import learner as tl  # noqa: E402
from jssenv_tpu_torch.parallel import mesh as tm  # noqa: E402
from jssenv_tpu_torch.parallel import multihost as th  # noqa: E402
from test_torch_learner import _close, _jax_grads, _port_grads, _recorded, jx  # noqa: E402,F401
from test_torch_multihost import spawn  # noqa: E402

SEED, B = 1, 16
# case -> LearnerConfig fields (ta01, B=16, 64x64); the meshes run the cases
# of their own
CASES = {
    "reinforce-f32": dict(algo="reinforce", unroll_steps=3, compute_dtype=torch.float32),
    "reinforce-bf16": dict(algo="reinforce", unroll_steps=3, compute_dtype=torch.bfloat16),
    "ppo-f32": dict(algo="ppo", unroll_steps=8, minibatches=2, ppo_epochs=2, compute_dtype=torch.float32),
    "ppo-bf16": dict(algo="ppo", unroll_steps=8, minibatches=2, ppo_epochs=2, compute_dtype=torch.bfloat16),
}
MESHES = {"dp2": (2, 1), "mp2": (1, 2), "dp2mp2": (2, 2)}
MESH_CASES = {"dp2": tuple(CASES), "mp2": tuple(CASES), "dp2mp2": ("reinforce-f32", "reinforce-bf16")}


def config(case):
    return tl.LearnerConfig(hidden=(64, 64), **CASES[case])


def run_step(case, mesh=None):
    """One train step of ``case`` from SEED on the CPU (this rank's part on
    a mesh): (actions (T, B_local) int64, metrics as floats, whole params)."""
    cfg = config(case)
    state = tv.strip_solution(tv.make_batch(ti.get_instance("ta01"), B, device="cpu"))
    ts = tl.init_train_state(SEED, state, cfg)
    if mesh is not None:
        ts = tl.shard_train_state(ts, mesh, mp_axis="mp" if mesh.mp > 1 else None)
    actions = []
    orig = fr.step_autoreset

    def recording(s, a, stats):
        actions.append(a.clone())
        return orig(s, a, stats)

    fr.step_autoreset = recording
    try:
        ts, m = tl.make_train_step(cfg, mesh)(ts)
    finally:
        fr.step_autoreset = orig
    params = tl.gather_params(ts.model, mesh)
    return torch.stack(actions), {k: float(v) for k, v in m.items()}, params


def _rank_main(out, port, world, rank, dp, mp):
    torch.set_num_threads(1)
    th.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = tm.make_mesh(dp=dp, mp=mp, device="cpu")
    assert (mesh.dp_rank, mesh.mp_rank) == divmod(rank, mp)
    tag = next(k for k, v in MESHES.items() if v == (dp, mp))
    for case in MESH_CASES[tag]:
        actions, metrics, params = run_step(case, mesh)
        np.savez(os.path.join(out, f"{case}_{rank}.npz"), actions=actions.numpy(),
                 offset=mesh.lanes(B)[0], **{f"m_{k}": v for k, v in metrics.items()},
                 **{f"p_{k}": v.numpy() for k, v in params.items()})
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's ranks run once: mesh tag -> its output directory."""
    dirs = {}
    for tag, (dp, mp) in MESHES.items():
        dirs[tag] = tmp_path_factory.mktemp(tag)
        spawn(os.path.abspath(__file__), dirs[tag], dp * mp, dp, mp)
    return dirs


@pytest.fixture(scope="module")
def single():
    return {case: run_step(case) for case in CASES}


@pytest.mark.parametrize("tag,case", [(t, c) for t in MESHES for c in MESH_CASES[t]])
def test_sharded_step_equals_single_process(ranks, single, tag, case):
    dp, mp = MESHES[tag]
    actions, metrics, params = single[case]
    runs = [dict(np.load(ranks[tag] / f"{case}_{r}.npz")) for r in range(dp * mp)]
    # every rank holds the whole params after gathering; the ranks of one
    # block of lanes take its actions, the blocks tile the batch
    got = np.concatenate([runs[d * mp]["actions"] for d in range(dp)], axis=1)
    assert [int(runs[d * mp]["offset"]) for d in range(dp)] == [d * B // dp for d in range(dp)]
    np.testing.assert_array_equal(got, actions.numpy())
    for r in runs:
        assert np.array_equal(r["actions"], runs[(int(r["offset"]) // (B // dp)) * mp]["actions"])
    f32 = CASES[case]["compute_dtype"] == torch.float32
    for r in runs:
        assert r["m_episodes"] == metrics["episodes"]
        assert r["m_min_makespan"] == metrics["min_makespan"]
        want = metrics["loss"]
        if f32:
            assert abs(float(r["m_loss"]) - want) <= 1e-5 * max(1.0, abs(want)), (r["m_loss"], want)
        else:
            assert float(r["m_loss"]) == pytest.approx(want, rel=5e-3)
        scale = max(float(v.abs().max()) for v in params.values())
        for k, v in params.items():
            p = r[f"p_{k}"]
            assert p.shape == tuple(v.shape), k
            if f32:
                assert float(np.abs(p - v.numpy()).max()) <= 1e-5 * scale, k
            else:
                np.testing.assert_allclose(p, v.numpy(), rtol=5e-2, atol=5e-3, err_msg=k)


@pytest.mark.parametrize("case", ["reinforce-f32", "ppo-f32"])
def test_single_process_step_matches_jax(jx, monkeypatch, case):
    """The chain reaches the reference: this configuration's single-process
    step against the JAX train step on one recorded trajectory (losses and
    gradients within rel 1e-5, PPO on one minibatch of one epoch)."""
    import dataclasses

    cfg = dataclasses.replace(config(case), minibatches=1, ppo_epochs=1)
    ts, rec = _recorded(cfg, B=B, seed=SEED)
    jmetrics, jgrads = _jax_grads(jx, monkeypatch, ts, rec, cfg)
    metrics, grads = _port_grads(monkeypatch, ts, rec, cfg)
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= 1e-5 * max(1.0, abs(want)), k
    _close(grads, jgrads)


def test_one_process_mesh_and_partition_errors():
    """Without a process group the mesh is the one-process mesh, on which
    the step is the single-device step; wrong shapes raise."""
    mesh = tm.make_mesh(device="cpu")
    assert (mesh.dp, mesh.mp, mesh.dp_group) == (1, 1, None)
    with pytest.raises(ValueError, match="process group"):
        tm.make_mesh(dp=2, device="cpu")
    a1, m1, p1 = run_step("ppo-f32")
    a2, m2, p2 = run_step("ppo-f32", mesh)
    assert torch.equal(a1, a2) and m1["episodes"] == m2["episodes"]
    assert m2["loss"] == pytest.approx(m1["loss"], rel=1e-5)
    state = tv.make_batch(ti.get_instance("ta01"), 2, device="cpu")
    model = tl.make_model(state, tl.LearnerConfig(hidden=(64,)))
    with pytest.raises(ValueError, match="two hidden layers"):
        tl.partition_params(model, mesh)
    with pytest.raises(ValueError, match="axis"):
        tl.shard_train_state(tl.init_train_state(0, state, tl.LearnerConfig(hidden=(8, 8))), mesh, dp_axis="x")


if __name__ == "__main__":
    _rank_main(sys.argv[1], *map(int, sys.argv[2:7]))

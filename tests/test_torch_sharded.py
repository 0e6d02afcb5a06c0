"""The port's sharded checkpoints (``checkpoint.save_sharded`` /
``load_sharded``, the counterpart of the JAX package's orbax backend).

In one process: the ``EnvState`` round trip of tests/test_aux.py:32-41 and
a TrainState round trip. Over gloo on 127.0.0.1: a dp2 x mp2 TrainState
saved by its four ranks and loaded into a fresh sharded template takes the
next update bit-equal to the uninterrupted run, and the same checkpoint
loaded into one process gathers to the sharded run's parameters. Ranks are
processes of this file (``python tests/test_torch_sharded.py OUT PORT WORLD
RANK DP MP``) started by ``test_torch_multihost.spawn``."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jssenv_tpu_torch import checkpoint as tck  # noqa: E402
from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import engine as te  # noqa: E402
from jssenv_tpu_torch.core import state as ts_mod  # noqa: E402
from jssenv_tpu_torch.parallel import learner as tl  # noqa: E402
from jssenv_tpu_torch.parallel import mesh as tm  # noqa: E402
from jssenv_tpu_torch.parallel import multihost as th  # noqa: E402
from test_torch_multihost import spawn  # noqa: E402

SEED, B = 1, 16
CONFIG = dict(algo="reinforce", unroll_steps=3, hidden=(64, 64), compute_dtype=torch.float32)


def _train_state(seed, mesh=None):
    state = tv.strip_solution(tv.make_batch(ti.get_instance("ta01"), B, device="cpu"))
    ts = tl.init_train_state(seed, state, tl.LearnerConfig(**CONFIG))
    if mesh is not None:
        ts = tl.shard_train_state(ts, mesh, mp_axis="mp" if mesh.mp > 1 else None)
    return ts


def _adam(ts):
    return {f"{leaf}/{k}": v.clone() for k, p in ts.model.named_parameters()
            for leaf, v in ts.optimizer.state.get(p, {}).items()}


def _same(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _rank_main(out, port, world, rank, dp, mp):
    torch.set_num_threads(1)
    th.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = tm.make_mesh(dp=dp, mp=mp, device="cpu")
    step = tl.make_train_step(tl.LearnerConfig(**CONFIG), mesh)
    ts, _ = step(_train_state(SEED, mesh))
    path = os.path.join(out, "ckpt")
    tck.save_sharded(path, ts, mesh)
    gathered, time = tl.gather_params(ts.model, mesh), ts.env_state.time.clone()
    local = ({k: v.clone() for k, v in ts.model.state_dict().items()}, _adam(ts))
    ts2, m = step(ts)  # the optimizer steps ts.model in place
    back = tck.load_sharded(path, _train_state(SEED + 1, mesh), mesh)
    loaded_equal = _same(back.model.state_dict(), local[0]) and _same(_adam(back), local[1])
    back2, m_back = step(back)
    bit_equal = ({k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m_back.items()}
                 and _same(ts2.model.state_dict(), back2.model.state_dict()) and _same(_adam(ts2), _adam(back2))
                 and all(torch.equal(getattr(ts2.env_state, k), getattr(back2.env_state, k))
                         for k in ts_mod.FIELD_NAMES) and back2.steps == ts2.steps == 2)
    np.savez(os.path.join(out, f"rank{rank}.npz"), bit_equal=bit_equal, loaded_equal=loaded_equal,
             time=time.numpy(), local=tuple(mesh.lanes(B)), **{f"p_{k}": v.numpy() for k, v in gathered.items()})
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def dp2mp2(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp2mp2")
    spawn(os.path.abspath(__file__), out, 4, 2, 2)
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def test_dp2mp2_resume_is_bit_equal(dp2mp2):
    _, runs = dp2mp2
    for r in runs:
        assert bool(r["bit_equal"]) and bool(r["loaded_equal"])


def test_dp2mp2_checkpoint_loads_into_one_process(dp2mp2):
    """Loaded into one process (the whole batch, an unpartitioned net), the
    checkpoint holds the sharded run's gathered parameters, its env lanes in
    dp order, and Adam's moments; the next update runs from it."""
    out, runs = dp2mp2
    back = tck.load_sharded(str(out / "ckpt"), _train_state(SEED + 2))
    got = tl.gather_params(back.model)
    for r in runs:
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), r[f"p_{k}"], err_msg=k)
    lanes = np.concatenate([runs[d * 2]["time"] for d in range(2)])
    assert [tuple(runs[d * 2]["local"]) for d in range(2)] == [(0, 8), (8, 8)]
    np.testing.assert_array_equal(back.env_state.time.numpy(), lanes)
    assert back.steps == 1 and len(_adam(back)) == 3 * len(got)
    _, m = tl.make_train_step(tl.LearnerConfig(**CONFIG))(back)
    assert np.isfinite(float(m["loss"]))


def test_env_state_round_trip(tmp_path):
    """tests/test_aux.py:32-41 on the port: save a stepped EnvState, load it
    into a fresh template, and both continue identically."""
    spec = ti.get_instance("ta01")
    state = te.state_from_spec(spec, device="cpu")
    for a in [0, 3, 7]:
        state, _ = te.step(state, torch.tensor([a], dtype=torch.int32))
    p = str(tmp_path / "sharded_state")
    tck.save_sharded(p, state)
    restored = tck.load_sharded(p, te.state_from_spec(spec, device="cpu"))
    for k in ts_mod.FIELD_NAMES:
        a, b = getattr(state, k), getattr(restored, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    a5 = torch.tensor([5], dtype=torch.int32)
    s1, t1 = te.step(state, a5)
    s2, t2 = te.step(restored, a5)
    assert int(t1.raw_reward) == int(t2.raw_reward) and int(s1.time) == int(s2.time)


def test_one_process_train_state_round_trip_and_mismatch(tmp_path):
    step = tl.make_train_step(tl.LearnerConfig(**CONFIG))
    ts, _ = step(_train_state(SEED))
    p = str(tmp_path / "ts")
    tck.save_sharded(p, ts)
    back = tck.load_sharded(p, _train_state(SEED + 1))
    ts2, m = step(ts)
    back2, m_back = step(back)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m_back.items()}
    assert _same(ts2.model.state_dict(), back2.model.state_dict()) and _same(_adam(ts2), _adam(back2))
    named = {"a": torch.arange(6).reshape(2, 3), "b": torch.ones(4, dtype=torch.bool)}
    tck.save_sharded(str(tmp_path / "named"), named)
    got = tck.load_sharded(str(tmp_path / "named"), {k: torch.zeros_like(v) for k, v in named.items()})
    assert _same(got, named)
    with pytest.raises(ValueError, match="mismatch"):
        tck.load_sharded(p, tl.init_train_state(0, _train_state(0).env_state,
                                                tl.LearnerConfig(**dict(CONFIG, hidden=(16, 16)))))
    with pytest.raises(ValueError, match="mismatch"):
        tck.load_sharded(str(tmp_path / "named"), {"a": torch.zeros(3, 2, dtype=torch.int64)})


if __name__ == "__main__":
    _rank_main(sys.argv[1], *map(int, sys.argv[2:7]))

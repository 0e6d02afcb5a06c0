"""Golden-solution replays through the port (``jssenv_tpu_torch.replay``):
every stored schedule reproduces its stored makespan, on the native engine
and on the torch engine (CPU here; the card in ``chip_smoke.py``), and the
torch replay's final state equals the JAX package's replay's."""

import json
import pathlib

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import native, replay
from jssenv_tpu_torch.core import engine as te
from jssenv_tpu_torch.core import state as ts

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "data" / "golden_solutions.json").read_text())
OPTIMA = sorted(k for k, v in GOLDEN.items() if "optimum" in v)


def _stored(name):
    entry = GOLDEN[name]
    return entry.get("optimum", entry.get("makespan"))


@pytest.fixture(scope="module")
def needs_native():
    if native.load() is None:
        pytest.skip("native engine unavailable (no g++)")


def test_golden_rows_native(needs_native):
    assert len(GOLDEN) >= 25 and len(OPTIMA) == 12
    for name in sorted(GOLDEN):
        spec = ti.get_instance(name)
        mk, st = replay.replay_machine_order(spec, GOLDEN[name]["machine_order"], backend="native")
        assert mk == _stored(name), name
        assert isinstance(st, replay.NativeReplayState)
        assert st.done and not st.any_busy and (st.solution >= 0).all(), name


@pytest.mark.parametrize("name", OPTIMA)
def test_published_optima_torch(name):
    spec = ti.get_instance(name)
    mk, state = replay.replay_machine_order(spec, GOLDEN[name]["machine_order"], device="cpu")
    assert mk == GOLDEN[name]["optimum"]
    assert state.device.type == "cpu" and state.batch_size == 1
    assert not bool(state.any_busy[0]) and bool(state.done[0])
    assert int(state.solution[0].min()) >= 0
    assert (state.next_op[0] == spec.num_machines).all()
    fresh = te.reset(state)
    assert int(fresh.time[0]) == 0 and int(fresh.nb_legal[0]) == spec.num_jobs


@pytest.mark.parametrize("name", ["ta01", "ta21"])
def test_native_and_torch_replays_agree(needs_native, name):
    spec = ti.get_instance(name)
    order = GOLDEN[name]["machine_order"]
    mk_t, st_t = replay.replay_machine_order(spec, order, backend="torch", device="cpu")
    mk_n, st_n = replay.replay_machine_order(spec, order, backend="native")
    mk_a, st_a = replay.replay_machine_order(spec, order, backend="auto")
    assert mk_t == mk_n == mk_a == _stored(name)
    assert np.array_equal(st_t.solution[0].numpy(), st_n.solution)
    assert np.array_equal(st_a.solution, st_n.solution)
    # an EnvState source: the same replay from its (reset) one-lane state
    state = te.state_from_spec(spec, device="cpu")
    assert replay.replay_machine_order(state, order, backend="native")[0] == mk_n
    assert replay.replay_machine_order(state, order)[0] == mk_t


def _deadlock_instance():
    # job 0: m0 then m1; job 1: m1 then m0 — the order below waits for job 1
    # on m0 and for job 0 on m1, so nothing can start
    return ti.InstanceSpec("cycle", 2, 2, np.array([[0, 1], [1, 0]], np.int32),
                           np.array([[3, 2], [4, 1]], np.int32))


@pytest.mark.parametrize("backend", ["torch", "native"])
def test_infeasible_order_raises(needs_native, backend):
    spec = _deadlock_instance()
    with pytest.raises(RuntimeError, match="infeasible"):
        replay.replay_machine_order(spec, [[1, 0], [0, 1]], backend=backend, device="cpu")
    mk, _ = replay.replay_machine_order(spec, [[1, 0], [0, 1]], strict=False, backend=backend,
                                        device="cpu")
    assert mk == 0
    # reversing one machine of ta01's optimum deadlocks or runs longer, on both
    order = GOLDEN["ta01"]["machine_order"]
    bad = [list(reversed(order[0]))] + [list(o) for o in order[1:]]
    try:
        mk, _ = replay.replay_machine_order(ti.get_instance("ta01"), bad, backend=backend, device="cpu")
        assert mk >= 1231
    except RuntimeError as e:
        assert "infeasible" in str(e)


@pytest.fixture(scope="module")
def jax_replay():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    from jssenv_tpu import instances as ji
    from jssenv_tpu import replay as jr

    return jax, ji, jr


@pytest.mark.parametrize("name", ["ta01", "ta21"])
def test_replay_matches_jax(jax_replay, name):
    """The same golden order through the JAX package's replay (its default
    "jax" backend) and the port's torch one: equal makespans and equal final
    states, field for field."""
    jax, ji, jr = jax_replay
    order = GOLDEN[name]["machine_order"]
    mk_j, st_j = jr.replay_machine_order(ji.get_instance(name), order)
    mk_t, st_t = replay.replay_machine_order(ti.get_instance(name), order, device="cpu")
    assert mk_t == mk_j == _stored(name)
    want = {k: np.asarray(v) for k, v in vars(jax.device_get(st_j)).items()}
    got = ts.to_numpy(st_t)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k][0], v), k


def test_infeasible_order_matches_jax(jax_replay):
    _, ji, jr = jax_replay
    order = [[1, 0], [0, 1]]
    spec_j = ji.InstanceSpec("cycle", 2, 2, np.array([[0, 1], [1, 0]], np.int32),
                             np.array([[3, 2], [4, 1]], np.int32))
    for fn, spec in ((jr.replay_machine_order, spec_j),
                     (lambda *a, **k: replay.replay_machine_order(*a, device="cpu", **k), _deadlock_instance())):
        with pytest.raises(RuntimeError, match="infeasible") as err:
            fn(spec, order)
        assert "progress per machine: [0, 0]" in str(err.value)
    mk_j, st_j = jr.replay_machine_order(spec_j, order, strict=False)
    mk_t, st_t = replay.replay_machine_order(_deadlock_instance(), order, strict=False, device="cpu")
    assert mk_t == mk_j == 0
    np.testing.assert_array_equal(st_t.solution[0].numpy(), np.asarray(st_j.solution))


def test_replay_arguments():
    spec = ti.get_instance("ta01")
    order = GOLDEN["ta01"]["machine_order"]
    with pytest.raises(ValueError, match="backend"):
        replay.replay_machine_order(spec, order, backend="jax")
    from jssenv_tpu_torch import vector

    with pytest.raises(ValueError, match="one-lane"):
        replay.replay_machine_order(vector.make_batch(spec, 2, device="cpu"), order)

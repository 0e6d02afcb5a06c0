"""The port's EnvState against the JAX package's: a JAX state carried across
with ``from_numpy`` must agree field for field and in every derived tensor
(ints exactly, floats within 1e-6, docs/DESIGN.md §5)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both

from jssenv_tpu import instances as ji  # noqa: E402
from jssenv_tpu import vector as jv  # noqa: E402
from jssenv_tpu.core.state import EnvState as JaxEnvState  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jssenv_tpu_torch import instances as tti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import state as ts  # noqa: E402

torch.set_num_threads(1)


def _jax_state(source, B, T, seed):
    """A JAX batch after T random-legal steps (no reset). The walk runs on
    the port's engine (held stepwise against JAX in test_torch_engine.py);
    T=0 keeps the JAX package's own fresh batch."""
    if T == 0:
        return jv.make_batch(source, B)
    port_set = tti.InstanceSet(
        source.names, source.num_jobs, source.num_machines, source.op_machine, source.op_dur
    )
    s = tv.make_batch(port_set, B, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for _ in range(T):
        s, _ = tv.vstep(s, tv.random_legal_actions(g, s))
    return JaxEnvState(**{k: jnp.asarray(v) for k, v in ts.to_numpy(s).items()})


def _np_fields(state):
    return {k: np.asarray(v) for k, v in vars(jax.device_get(state)).items()}


@jax.jit
def _jax_derived(state):
    def one(s):
        return {
            "action_mask": s.action_mask(),
            "pin": s.pin,
            "idle_since_op": s.idle_since_op,
            "idle_total": s.idle_total,
            "job_valid": s.job_valid,
            "machine_valid": s.machine_valid,
            "next_event_time": s.next_event_time,
            "done": s.done,
            "any_busy": s.any_busy,
            "obs": s.obs,
            "rich_obs": s.rich_obs,
            "real_obs": s.observation()["real_obs"],
        }

    return jax.vmap(one)(state)


CASES = {
    "fresh_ragged": lambda: _jax_state(ji.get_instance_set(["ta01", "ta41"]), 4, 0, 0),
    "ta01": lambda: _jax_state(ji.get_instance_set(["ta01"]), 4, 40, 0),
    "padded": lambda: _jax_state(
        ji.stack_instances([ji.random_instance(5, 4, (1, 9), seed=11)], jobs_pad=8, machines_pad=6),
        4, 12, 1),
    "ragged": lambda: _jax_state(ji.get_instance_set(["ta01", "ta41"]), 4, 30, 2),
    "rand_done": lambda: _jax_state(ji.stack_instances([ji.random_instance(6, 5, (1, 9), seed=3)]), 6, 45, 3),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request):
    js = CASES[request.param]()
    return js, ts.from_numpy(_np_fields(js), device="cpu")


def test_fields_carry_across(carried):
    js, tsb = carried
    want = _np_fields(js)
    got = ts.to_numpy(tsb)
    assert set(got) == set(want) == set(ts.FIELD_NAMES)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert ts.EnvState.STATIC_FIELDS == JaxEnvState.STATIC_FIELDS
    assert list(tsb.dynamic_fields()) == list(js.dynamic_fields())
    assert (tsb.jobs_pad, tsb.machines_pad, tsb.batch_size) == (
        js.jobs_pad, js.machines_pad, js.time.shape[0])


def test_derived_tensors_equal(carried):
    js, tsb = carried
    want = {k: np.asarray(v) for k, v in _jax_derived(js).items()}
    got = {
        "action_mask": tsb.action_mask(),
        "pin": tsb.pin,
        "idle_since_op": tsb.idle_since_op,
        "idle_total": tsb.idle_total,
        "job_valid": tsb.job_valid,
        "machine_valid": tsb.machine_valid,
        "next_event_time": tsb.next_event_time,
        "done": tsb.done,
        "any_busy": tsb.any_busy,
        "obs": tsb.obs,
        "rich_obs": tsb.rich_obs,
        "real_obs": tsb.observation()["real_obs"],
    }
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_array_equal(tsb.observation()["action_mask"].numpy(), want["action_mask"])


def test_some_lane_finished_in_done_case():
    js = CASES["rand_done"]()
    assert np.asarray(js.nb_legal == 0).any()


def test_numpy_round_trip_and_replace():
    js = CASES["ta01"]()
    fields = _np_fields(js)
    s = ts.from_numpy(fields, device="cpu")
    back = ts.to_numpy(s)
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k])
    s2 = s.replace(time=s.time + 1)
    assert torch.equal(s2.time, s.time + 1) and s2.op_dur is s.op_dur
    with pytest.raises(ValueError, match="missing"):
        ts.from_numpy({k: v for k, v in fields.items() if k != "wait4"}, device="cpu")
    with pytest.raises(ValueError, match="batched"):
        ts.from_numpy({k: v[0] for k, v in fields.items()}, device="cpu")

"""The port's engine and primitives against the JAX package's.

One recorded action stream (JAX's own random-legal policy, in a jitted scan)
is fed to ``jssenv_tpu.vector.vstep`` and to the port's ``vstep``; after every
step every field, the raw reward, the reward and ``done`` must be equal."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from jssenv_tpu import instances as ji  # noqa: E402
from jssenv_tpu import vector as jv  # noqa: E402
from jssenv_tpu.core import engine as je  # noqa: E402
from jssenv_tpu.core import ops as jo  # noqa: E402

from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import engine as te  # noqa: E402
from jssenv_tpu_torch.core import ops as to  # noqa: E402
from jssenv_tpu_torch.core import state as ts  # noqa: E402

torch.set_num_threads(1)


def _np(state):
    return {k: np.asarray(v) for k, v in vars(jax.device_get(state)).items()}


def _carry(state):
    return ts.from_numpy(_np(state), device="cpu")


@jax.jit
def _policy_step(rng, s):
    a = jv.random_legal_actions(rng, s)
    s, tr = jv.vstep(s, a)
    return s, (a, tr.raw_reward, tr.reward, tr.done, s.dynamic_fields())


@functools.lru_cache(maxsize=None)
def _scan(T):
    @jax.jit
    def run(s, rng):
        def body(carry, _):
            rng, s = carry
            rng, sub = jax.random.split(rng)
            s, out = _policy_step(sub, s)
            return (rng, s), out

        return jax.lax.scan(body, (rng, s), None, length=T)

    return run


def _record(state, T, seed):
    """JAX side in one jitted scan: per step the action, raw reward, reward,
    done and every dynamic field."""
    (_, final), out = _scan(T)(state, jax.random.key(seed))
    return final, jax.device_get(out)


def _set(specs, **pad):
    return ji.stack_instances(specs, **pad)


STREAMS = {
    "ta01": (lambda: _set([ji.get_instance("ta01")]), 8, 60),
    "ta41": (lambda: _set([ji.get_instance("ta41")]), 4, 40),
    "ta71": (lambda: _set([ji.get_instance("ta71")]), 2, 30),
    "padded": (lambda: _set([ji.random_instance(5, 4, (1, 9), seed=11)], jobs_pad=8, machines_pad=6), 4, 40),
    "ragged": (lambda: _set([ji.get_instance("ta01"), ji.get_instance("ta41")]), 4, 40),
    "episodes": (lambda: _set([ji.random_instance(6, 5, (1, 9), seed=3)]), 16, 60),
    "B1024": (lambda: _set([ji.get_instance("ta01")]), 1024, 24),
    # the other instance families of tests/test_parity_sweep.py:22-32
    "ta11": (lambda: _set([ji.get_instance("ta11")]), 4, 40),
    "ta21": (lambda: _set([ji.get_instance("ta21")]), 4, 40),
    "ta31": (lambda: _set([ji.get_instance("ta31")]), 4, 40),
    "ta51": (lambda: _set([ji.get_instance("ta51")]), 2, 40),
    "ta61": (lambda: _set([ji.get_instance("ta61")]), 2, 40),
    "dmu16": (lambda: _set([ji.get_instance("dmu16")]), 4, 40),
    "dmu16-B1024": (lambda: _set([ji.get_instance("dmu16")]), 1024, 16),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_step_stepwise_equal(case):
    make, B, T = STREAMS[case]
    js = jv.make_batch(make(), B)
    jfinal, (acts, raw, rew, done, fields) = _record(js, T, seed=len(case))
    s = _carry(js)
    statics = {k: getattr(s, k).clone() for k in ts.EnvState.STATIC_FIELDS}
    for t in range(T):
        s, tr = tv.vstep(s, torch.from_numpy(np.array(acts[t])))
        np.testing.assert_array_equal(tr.raw_reward.numpy(), raw[t], err_msg=f"raw t={t}")
        np.testing.assert_array_equal(tr.reward.numpy(), rew[t], err_msg=f"reward t={t}")
        np.testing.assert_array_equal(tr.done.numpy(), done[t], err_msg=f"done t={t}")
        for k, v in fields.items():
            got = getattr(s, k).numpy()
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v[t], err_msg=f"{k} t={t}")
    for k, v in statics.items():
        assert torch.equal(getattr(s, k), v), k
    want = _np(jfinal)
    for k, v in ts.to_numpy(s).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)

    # the episode identity: raw return == 2*sum_op - M*makespan at the first
    # episode end of every lane that finished
    raw = np.asarray(raw, np.int64)
    ended = 0
    for b in range(B):
        hits = np.flatnonzero(done[:, b])
        if hits.size:
            t = hits[0]
            mk = int(fields["time"][t, b])
            assert raw[: t + 1, b].sum() == 2 * int(want["sum_op"][b]) - int(want["num_machines"][b]) * mk
            ended += 1
    if case in ("episodes", "padded"):
        assert ended == B


def test_advance_time_direct_calls():
    """Repeated direct advance_time calls, down to an empty queue (a no-op)."""
    js = jv.make_batch(_set([ji.get_instance("ta01"), ji.get_instance("ta41")]), 4)
    js, _ = _record(js, 40, seed=1)
    jadv = jax.jit(jax.vmap(je.advance_time))
    s = _carry(js)
    idle_seen = False
    for i in range(40):
        js, jholes = jadv(js)
        s, holes = te.advance_time(s)
        np.testing.assert_array_equal(holes.numpy(), np.asarray(jholes), err_msg=f"holes {i}")
        for k, v in _np(js).items():
            np.testing.assert_array_equal(getattr(s, k).numpy(), v, err_msg=f"{k} call {i}")
        idle_seen |= bool((~s.any_busy).any())
    assert idle_seen


def test_epilogue_functions_equal():
    """fast_forward, prioritization_non_final and check_no_op on their own,
    on states along a recorded stream."""
    js = jv.make_batch(_set([ji.get_instance("ta01"), ji.get_instance("ta41")]), 4)
    jff = jax.jit(jax.vmap(je.fast_forward))
    jpr = jax.jit(jax.vmap(je.prioritization_non_final))
    jcn = jax.jit(jax.vmap(je.check_no_op))
    for t in range(3):
        js, _ = _record(js, 40, seed=t)
        s = _carry(js)
        # zero the machine-legal counter so the fast-forward is active
        js0, s0 = js.replace(nb_machine_legal=js.nb_machine_legal * 0), s.replace(
            nb_machine_legal=s.nb_machine_legal * 0)
        for jf, tf in ((jff, te.fast_forward), (jpr, te.prioritization_non_final), (jcn, te.check_no_op)):
            for ja, ta in ((js, s), (js0, s0)):
                jo_, to_ = jf(ja), tf(ta)
                if isinstance(jo_, tuple):
                    np.testing.assert_array_equal(to_[1].numpy(), np.asarray(jo_[1]))
                    jo_, to_ = jo_[0], to_[0]
                for k, v in _np(jo_).items():
                    np.testing.assert_array_equal(getattr(to_, k).numpy(), v, err_msg=f"{tf.__name__} {k}")


def test_construction_and_reset_equal():
    spec_j, spec_t = ji.get_instance("ta41"), ti.get_instance("ta41")
    want = _np(je.state_from_spec(spec_j))
    got = ts.to_numpy(te.state_from_spec(spec_t, device="cpu"))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k][0], v), k
    # wide durations keep int32 tables; narrow ones go to int16 / int8
    big_j = ji.random_instance(10, 10, (1, 5000), seed=2)
    big_t = ti.random_instance(10, 10, (1, 5000), seed=2)
    for pads in ((0, 0), (12, 130)):
        want = _np(je.state_from_spec(big_j, *pads))
        got = ts.to_numpy(te.state_from_spec(big_t, *pads, device="cpu"))
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k][0], v), k
    js = jv.make_batch(_set([ji.get_instance("ta01"), ji.get_instance("ta41")]), 4)
    js, _ = _record(js, 40, seed=3)
    want = _np(jax.jit(jax.vmap(je.reset))(js))
    got = ts.to_numpy(te.reset(_carry(js)))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    light = jv.strip_solution(js)
    want = _np(jax.jit(jax.vmap(je.reset))(light))
    got = ts.to_numpy(te.reset(_carry(light)))
    for k, v in want.items():
        assert got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# ops primitives
# ---------------------------------------------------------------------------

B, J, M, K = 5, 7, 6, 3


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("lowering", ["native", "onehot"])
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_ops_gathers_equal(monkeypatch, lowering, dtype):
    monkeypatch.setenv("JSS_ENGINE_LOWERING", lowering)
    r = _rng(int(np.dtype(dtype).itemsize) + (lowering == "onehot"))
    table = r.integers(-100, 100, size=(B, J, M)).astype(dtype)
    idx = r.integers(0, M, size=(B, J)).astype(np.int32)
    idx_k = r.integers(0, M, size=(B, J, K)).astype(np.int32)
    vec = r.integers(-1000, 1000, size=(B, M)).astype(dtype)
    bvec = r.integers(0, 2, size=(B, M)).astype(bool)
    mat = r.integers(-50, 50, size=(B, M, J)).astype(np.int32)
    bmat = r.integers(0, 2, size=(B, M, J)).astype(bool)
    T = torch.from_numpy
    cases = [
        (jax.vmap(jo.row_gather)(table, idx), to.row_gather(T(table), T(idx))),
        (jax.vmap(jo.rows_gather)(table, idx_k), to.rows_gather(T(table), T(idx_k))),
        (jax.vmap(jo.lookup)(vec, idx), to.lookup(T(vec), T(idx))),
        (jax.vmap(jo.lookup)(vec, idx_k), to.lookup(T(vec), T(idx_k))),
        (jax.vmap(jo.lookup)(bvec, idx), to.lookup(T(bvec), T(idx))),
        (jax.vmap(jo.lookup2d_col)(mat, idx), to.lookup2d_col(T(mat), T(idx))),
        (jax.vmap(jo.lookup2d_col)(bmat, idx), to.lookup2d_col(T(bmat), T(idx))),
    ]
    for i, (want, got) in enumerate(cases):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, (i, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(i))


@pytest.mark.parametrize("lowering", ["native", "onehot"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ops_segments_equal(monkeypatch, lowering, seed):
    monkeypatch.setenv("JSS_ENGINE_LOWERING", lowering)
    r = _rng(10 + seed)
    seg = r.integers(0, M, size=(B, J)).astype(np.int32)
    seg_k = r.integers(0, M, size=(B, J, K)).astype(np.int32)
    vals = r.integers(-500, 500, size=(B, J)).astype(np.int32)
    mask = r.random((B, J)) < 0.5
    mask_k = r.random((B, J, K)) < 0.3
    T = torch.from_numpy
    cases = [
        (jax.vmap(lambda s, v, m: jo.segment_min(s, v, m, M))(seg, vals, mask),
         to.segment_min(T(seg), T(vals), T(mask), M)),
        (jax.vmap(lambda s, m: jo.segment_any(s, m, M))(seg, mask),
         to.segment_any(T(seg), T(mask), M)),
        (jax.vmap(lambda s, m: jo.segment_any(s, m, M))(seg_k, mask_k),
         to.segment_any(T(seg_k), T(mask_k), M)),
    ]
    for i, (want, got) in enumerate(cases):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, i
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(i))
    # all-masked rows give INT32_MAX
    none = to.segment_min(T(seg), T(vals), torch.zeros((B, J), dtype=torch.bool), M)
    assert (none == np.iinfo(np.int32).max).all()
    np.testing.assert_array_equal(
        none.numpy(),
        np.asarray(jax.vmap(lambda s, v: jo.segment_min(s, v, jnp.zeros(J, bool), M))(seg, vals)),
    )

"""The port's batch layer against the JAX package's ``vector``: equal batches,
and equal auto-reset stats under action streams recorded from JAX. The
port's own sampler is held to legality and coverage (its bits differ from
``jax.random``'s)."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both

from jssenv_tpu import instances as ji  # noqa: E402
from jssenv_tpu import vector as jv  # noqa: E402

from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import state as ts  # noqa: E402

torch.set_num_threads(1)


def _np(state):
    return {k: np.asarray(v) for k, v in vars(jax.device_get(state)).items()}


def _same_state(port, jax_state):
    want = _np(jax_state)
    got = ts.to_numpy(port)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize(
    "build",
    [
        lambda m: (m.get_instance("ta01"), 3, {}),
        lambda m: (m.get_instance("ta01"), 2, {"jobs_pad": 16, "machines_pad": 17}),
        lambda m: (m.get_instance_set(["ta01", "ta41", "ta71"]), 5, {}),
        lambda m: (m.random_instance_set(3, 6, 5, (1, 9), seed=4), 7, {}),
    ],
    ids=["single", "padded", "ragged", "random_set"],
)
def test_make_batch_equal(build):
    src_j, B, pad = build(ji)
    src_t, _, _ = build(ti)
    _same_state(tv.make_batch(src_t, B, device="cpu", **pad), jv.make_batch(src_j, B, **pad))


@functools.lru_cache(maxsize=None)
def _autoreset_scan(T):
    @jax.jit
    def run(state, rng):
        def body(carry, _):
            rng, s, stats = carry
            rng, sub = jax.random.split(rng)
            a = jv.random_legal_actions(sub, s)
            s, tr, stats = jv.step_autoreset(s, a, stats)
            return (rng, s, stats), (a, tr.raw_reward, tr.done)

        return jax.lax.scan(body, (rng, state, jv.RolloutStats.zero()), None, length=T)

    return run


AUTORESET = {
    "episodes": (lambda m: m.random_instance(6, 5, (1, 9), seed=7), 8, 100),
    "ragged": (lambda m: m.stack_instances(
        [m.random_instance(6, 5, (1, 9), seed=3), m.random_instance(5, 4, (1, 9), seed=4)]), 8, 100),
    "B1024": (lambda m: m.random_instance(6, 5, (1, 9), seed=9), 1024, 40),
    "ta01": (lambda m: m.get_instance("ta01"), 4, 260),
}


@pytest.mark.parametrize("case", sorted(AUTORESET))
def test_step_autoreset_stats_equal(case):
    make, B, T = AUTORESET[case]
    js = jv.make_batch(make(ji), B)
    (_, jfinal, jstats), (acts, raws, dones) = _autoreset_scan(T)(js, jax.random.key(3))
    jstats = jax.device_get(jstats)
    s = tv.make_batch(make(ti), B, device="cpu")
    stats = tv.RolloutStats.zero("cpu")
    for t in range(T):
        s, tr, stats = tv.step_autoreset(s, torch.from_numpy(np.array(acts[t])), stats)
        np.testing.assert_array_equal(tr.raw_reward.numpy(), np.asarray(raws[t]), err_msg=f"t={t}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(dones[t]), err_msg=f"t={t}")
    _same_state(s, jfinal)
    assert int(stats.episodes) == int(jstats.episodes) > 0
    assert int(stats.total_makespan) == int(jstats.total_makespan)
    assert int(stats.min_makespan) == int(jstats.min_makespan)
    assert int(stats.steps) == int(jstats.steps) == T * B
    assert float(stats.total_return) == pytest.approx(float(jstats.total_return), rel=1e-5)
    assert stats.episodes.dtype == stats.total_makespan.dtype == torch.int64


def _state_with_noop():
    """A lane state where the no-op and at least one job are legal."""
    s = tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=3), 64, device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(200):
        hit = s.noop_legal & (s.nb_legal > 0)
        if hit.any():
            return s, int(torch.nonzero(hit)[0, 0])
        s, _, _ = tv.step_autoreset(s, tv.random_legal_actions(g, s), tv.RolloutStats.zero("cpu"))
    raise AssertionError("no state with a legal no-op found")


def test_random_legal_actions_legal_and_covering():
    s, lane = _state_with_noop()
    g = torch.Generator().manual_seed(1)
    nj = s.num_jobs
    seen = set()
    for _ in range(400):
        a = tv.random_legal_actions(g, s)
        assert a.dtype == torch.int32 and a.shape == (s.batch_size,)
        is_noop = a == nj
        job = a.clamp(0, s.jobs_pad - 1).long()
        legal_job = s.legal.gather(1, job[:, None])[:, 0]
        live = s.action_mask().any(dim=1)
        assert bool((~live | torch.where(is_noop, s.noop_legal, legal_job & (a < nj))).all())
        seen.add(int(a[lane]))
    want = {int(j) for j in torch.nonzero(s.legal[lane])[:, 0]} | {int(nj[lane])}
    assert seen == want and len(want) >= 2


def test_random_legal_actions_on_a_terminal_lane():
    s = tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=3), 4, device="cpu")
    s = s.replace(legal=torch.zeros_like(s.legal), nb_legal=torch.zeros_like(s.nb_legal))
    a = tv.random_legal_actions(torch.Generator().manual_seed(0), s)
    assert bool(((a >= 0) & (a <= s.num_jobs)).all())


def test_strip_solution_and_reset_lanes():
    src = ti.random_instance(6, 5, (1, 9), seed=7)
    full = tv.make_batch(src, 6, device="cpu")
    light = tv.strip_solution(full)
    assert light.solution.shape == (6, 0, 5)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    st1, st2 = tv.RolloutStats.zero("cpu"), tv.RolloutStats.zero("cpu")
    for _ in range(70):
        full, _, st1 = tv.step_autoreset(full, tv.random_legal_actions(g1, full), st1)
        light, _, st2 = tv.step_autoreset(light, tv.random_legal_actions(g2, light), st2)
    for k in ts.FIELD_NAMES:
        if k != "solution":
            assert torch.equal(getattr(full, k), getattr(light, k)), k
    assert light.solution.shape == (6, 0, 5)
    assert int(st1.episodes) == int(st2.episodes) > 0
    done = torch.tensor([True, False, True, False, False, True])
    fresh = tv.vreset(full)
    mixed = tv.reset_lanes(full, done)
    for k, v in mixed.dynamic_fields().items():
        assert torch.equal(v[done], getattr(fresh, k)[done]), k
        assert torch.equal(v[~done], getattr(full, k)[~done]), k
    picked = tv.select_lanes(done, fresh.dynamic_fields(), full.dynamic_fields())
    assert all(torch.equal(picked[k], getattr(mixed, k)) for k in picked)


def test_rollout_and_episode_makespans():
    spec = ti.get_instance("ta01")
    state, stats = tv.rollout(torch.Generator().manual_seed(0), tv.make_batch(spec, 8, device="cpu"), 300)
    assert int(stats.episodes) > 0 and int(stats.steps) == 300 * 8
    assert spec.lower_bound() <= 1231 <= int(stats.min_makespan)
    state, ms, ret = tv.episode_makespans(
        torch.Generator().manual_seed(1), tv.make_batch(spec, 8, device="cpu"), 600)
    assert bool((ms > 0).all())
    expected = (2 * spec.sum_op - spec.num_machines * ms.double()) / spec.max_time_op
    np.testing.assert_allclose(ret.double().numpy(), expected.numpy(), atol=2e-3)

"""The fused rollout: its plain twins against the JAX package's Pallas kernels
(interpret mode) and XLA engine, its host plumbing, its Philox words, and —
on a card only (``-m cuda``) — the CUDA kernels against the twins.

JAX is imported inside the tests that compare against it, so the card tests
of this file also run where JAX is not installed."""

import types

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.core import fused_rollout as fr
from jssenv_tpu_torch.core import state as ts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    from jssenv_tpu import instances, vector
    from jssenv_tpu.core import pallas_rollout

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, inst=instances, vector=vector, pallas=pallas_rollout)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    return torch.device("cuda")


def _np(state, jax):
    return {k: np.asarray(v) for k, v in vars(jax.device_get(state)).items()}


def _same_state(port, want):
    got = ts.to_numpy(port)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _port_actions(state, T, seed):
    """A legal (T, B) action stream from the port's own sampler."""
    g = torch.Generator(device=state.device).manual_seed(seed)
    stats = tv.RolloutStats.zero(state.device)
    acts = []
    for _ in range(T):
        a = tv.random_legal_actions(g, state)
        acts.append(a)
        state, _, stats = tv.step_autoreset(state, a, stats)
    return torch.stack(acts)


def _bits(T, B, seed):
    return np.random.default_rng(seed).integers(-(2**31), 2**31, size=(T, B), dtype=np.int64).astype(np.int32)


# the small cases of tests/test_pallas.py: (instance-set factory, B, T, tile)
DRIVEN = {
    "single_ta01": (lambda m: m.stack_instances([m.get_instance("ta01")]), 4, 32, 4),
    "episode_boundary": (lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=3)]), 4, 160, 4),
    "padded": (lambda m: m.stack_instances([m.random_instance(5, 4, (1, 9), seed=11)], jobs_pad=8,
                                           machines_pad=6), 4, 120, 4),
    "ragged": (lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=3),
                                            m.random_instance(5, 4, (1, 9), seed=4)]), 8, 100, 4),
    # past 64 machines (rollout.cu's three machine slots a thread on the card)
    "wide": (lambda m: m.stack_instances([m.random_instance(4, 70, (1, 9), seed=3)]), 4, 40, 4),
}


@pytest.mark.parametrize("case", sorted(DRIVEN))
def test_driven_twin_matches_pallas(jx, case):
    build, B, T, tile = DRIVEN[case]
    state = tv.make_batch(build(ti), B, device="cpu")
    acts = _port_actions(state, T, seed=len(case))
    js = jx.vector.make_batch(build(jx.inst), B)
    jfinal, jraw = jx.pallas.rollout_driven(js, jx.jnp.asarray(acts.numpy()), T, tile=tile, interpret=True)
    before = dict(fr.LAUNCHES)
    final, raw = fr.rollout_driven(state, acts, T)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    _same_state(final, _np(jfinal, jx.jax))
    assert fr.LAUNCHES == before  # CPU: the twin, no kernel


@pytest.mark.parametrize("case", sorted(DRIVEN) + ["ta41"])
def test_driven_twin_ends_are_jax_done_times_time(jx, case):
    """The twin's (T, B) ends: where JAX's step says done, the stepped
    state's time (the makespan), else 0; rewards and final state as
    ``rollout_driven`` without ends."""
    jax, jv = jx.jax, jx.vector
    if case == "ta41":  # long enough for a random-legal ta41 episode to end
        build, B, T = (lambda m: m.stack_instances([m.get_instance("ta41")])), 2, 700
    else:
        build, B, T, _ = DRIVEN[case]
    state = tv.make_batch(build(ti), B, device="cpu")
    acts = _port_actions(state, T, seed=len(case))
    final, raw, ends = fr.rollout_driven(state, acts, T, return_ends=True)
    final2, raw2 = fr.rollout_driven(state, acts, T)
    assert ends.dtype == torch.int32 and ends.shape == (T, B) and torch.equal(raw, raw2)
    _same_state(final, ts.to_numpy(final2))

    @jax.jit
    def step(s, a, stats):
        new, tr = jv.vstep(s, a)
        s, _, stats = jv.step_autoreset(s, a, stats)
        return s, stats, jx.jnp.where(tr.done, new.time, 0)

    js, stats, want = jv.make_batch(build(jx.inst), B), jv.RolloutStats.zero(), []
    for t in range(T):
        js, stats, e = step(js, jx.jnp.asarray(acts[t].numpy()), stats)
        want.append(np.asarray(e))
    np.testing.assert_array_equal(ends.numpy(), np.stack(want))
    assert int((ends > 0).sum()) == int(stats.episodes) and int(ends.sum()) == int(stats.total_makespan)
    assert case in ("single_ta01", "wide") or int(stats.episodes) > 0  # their T is shorter than an episode


FREE = {
    "single": (lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=7)]), 4, 200, 4),
    "ragged": (lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=3),
                                            m.random_instance(5, 4, (1, 9), seed=4)]), 8, 150, 4),
    # past 64 machines, caller bits; long enough for a 2x70 episode to end
    "wide": (lambda m: m.stack_instances([m.random_instance(2, 70, (1, 9), seed=7)]), 4, 200, 4),
}


@pytest.mark.parametrize("case", sorted(FREE))
def test_free_twin_matches_pallas(jx, case):
    build, B, T, tile = FREE[case]
    bits = _bits(T, B, seed=len(case))
    js = jx.vector.make_batch(build(jx.inst), B)
    want = jx.pallas.rollout_free(js, T, tile=tile, interpret=True, bits=jx.jnp.asarray(bits))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = fr.rollout_free(tv.make_batch(build(ti), B, device="cpu"), T, bits=torch.from_numpy(bits))
    assert int(got["identity_violations"]) == int(want["identity_violations"]) == 0
    assert int(got["episodes"]) == int(want["episodes"]) > 0
    for k in ("total_makespan", "min_makespan", "steps"):
        assert int(got[k]) == int(want[k]), k
    assert float(got["total_return"]) == pytest.approx(float(want["total_return"]), rel=1e-5)
    assert got["episodes"].dtype == got["total_makespan"].dtype == torch.int64
    assert got["min_makespan"].dtype == torch.int32


# the int16 value mode: the storage dtype is chosen by the JAX package's
# bound (asked there with its switch JSS_PALLAS_INT16=1 on, which the port
# does not read), and the stats do not depend on it
VALUE_DTYPE_CASES = {
    "ta01": (lambda m: m.stack_instances([m.get_instance("ta01")]), 2),
    "ta01-ta10": (lambda m: m.get_instance_set([f"ta{i:02d}" for i in range(1, 11)]), 10),
    "ta41": (lambda m: m.stack_instances([m.get_instance("ta41")]), 2),
    "ta01+ta41": (lambda m: m.get_instance_set(["ta01", "ta41"]), 2),
    "rand6x5": (lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=7)]), 3),
}


@pytest.fixture(scope="module")
def value_dtype_batches(jx):
    """(JAX batch, port batch) of each case, built once."""
    return {name: (jx.vector.make_batch(build(jx.inst), B), tv.make_batch(build(ti), B, device="cpu"))
            for name, (build, B) in VALUE_DTYPE_CASES.items()}


@pytest.mark.parametrize("switch", [None, "1", "0"])
def test_value_dtype_matches_jax(jx, value_dtype_batches, monkeypatch, switch):
    """The port's dtype equals the JAX package's with the JAX switch on,
    whatever the environment says when the port is asked."""
    want_i16 = {"ta01": True, "ta01-ta10": True, "ta41": False, "ta01+ta41": False, "rand6x5": True}
    for name, (js, state) in value_dtype_batches.items():
        monkeypatch.setenv("JSS_PALLAS_INT16", "1")
        want = jx.pallas.value_dtype(js)
        if switch is None:
            monkeypatch.delenv("JSS_PALLAS_INT16")
        else:
            monkeypatch.setenv("JSS_PALLAS_INT16", switch)
        got = fr.value_dtype(state)
        assert got in (torch.int16, torch.int32)
        assert (got == torch.int16) == (want == jx.jnp.int16) == want_i16[name], name


def test_free_twin_matches_pallas_int16(jx, monkeypatch):
    """The pattern of tests/test_pallas.py's int16 test: the JAX kernel in
    its int16 mode (interpret, the JAX switch on) and the port's twin give
    the same stats."""
    monkeypatch.setenv("JSS_PALLAS_INT16", "1")
    build = lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=7)])  # noqa: E731
    B, T = 4, 120
    bits = np.random.default_rng(1).integers(0, 2**31, size=(T, B), dtype=np.int32)
    js = jx.vector.make_batch(build(jx.inst), B)
    assert jx.pallas.value_dtype(js) == jx.jnp.int16
    want = jx.pallas.rollout_free(js, T, tile=B, interpret=True, bits=jx.jnp.asarray(bits))
    state = tv.make_batch(build(ti), B, device="cpu")
    assert fr.value_dtype(state) == torch.int16
    got = fr.rollout_free(state, T, bits=torch.from_numpy(bits))
    for k in ("episodes", "total_makespan", "min_makespan", "steps", "identity_violations"):
        assert int(got[k]) == int(np.asarray(want[k])), k
    assert int(got["episodes"]) > 0 and int(got["identity_violations"]) == 0
    assert float(got["total_return"]) == pytest.approx(float(np.asarray(want["total_return"])), rel=1e-5)


def test_driven_twin_matches_xla_engine_at_B1024(jx):
    """B >= 1024: the batch size at which a TPU miscompile once hid."""
    jax, jv = jx.jax, jx.vector
    B, T = 1024, 96
    js = jv.make_batch(jx.inst.random_instance(10, 8, (1, 9), seed=5), B)

    @jax.jit
    def run(s, rng):
        def body(carry, _):
            rng, s, stats = carry
            rng, sub = jax.random.split(rng)
            a = jv.random_legal_actions(sub, s)
            s, tr, stats = jv.step_autoreset(s, a, stats)
            return (rng, s, stats), (a, tr.raw_reward)

        return jax.lax.scan(body, (rng, s, jv.RolloutStats.zero()), None, length=T)

    (_, jfinal, jstats), (acts, raws) = run(js, jax.random.key(0))
    assert int(jstats.episodes) >= B  # every lane crossed an episode boundary
    state = tv.make_batch(ti.random_instance(10, 8, (1, 9), seed=5), B, device="cpu")
    final, raw = fr.rollout_driven(state, torch.from_numpy(np.asarray(acts)), T)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(raws))
    _same_state(final, _np(jfinal, jax))


# the other instance families of tests/test_parity_sweep.py:22-32: (B, T);
# 1.25 J*M + 16 steps, past every lane's first episode end (random-legal
# episodes with their no-ops take about 1.15 J*M), and one case at B=1024,
# where a TPU miscompile once dropped bool scatters
# (jssenv_tpu/core/engine.py:593-596)
FAMILIES = {"ta11": (4, 391), "ta21": (4, 516), "ta31": (4, 578), "ta51": (2, 953), "ta61": (2, 1266),
            "dmu16": (4, 766), "dmu16-B1024": (1024, 24)}


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_twins_match_xla_engine_on_families(jx, case):
    """One (T, B) stream of random words: the JAX package's ``vstep`` with
    auto-reset, sampling each action from the words by the kernels' rule,
    against the free twin on the same words (lane stats) and the driven twin
    on the actions JAX took (raw rewards, final state)."""
    jax, jnp, jv = jx.jax, jx.jnp, jx.vector
    B, T = FAMILIES[case]
    name = case.split("-")[0]
    bits = _bits(T, B, seed=len(case))

    @jax.jit
    def run(s, words):
        def body(carry, w):
            s, stats = carry
            k31 = jax.lax.shift_right_logical(w, 1)
            n = s.nb_legal + s.noop_legal.astype(jnp.int32)
            k = k31 % jnp.maximum(n, 1)
            chosen = s.legal & (jnp.cumsum(s.legal.astype(jnp.int32), axis=1) == (k + 1)[:, None])
            job = jnp.sum(jnp.where(chosen, jnp.arange(s.legal.shape[1], dtype=jnp.int32), 0), axis=1)
            a = jnp.where(k >= s.nb_legal, s.num_jobs, job)
            s, tr, stats = jv.step_autoreset(s, a, stats)
            return (s, stats), (a, tr.raw_reward)

        return jax.lax.scan(body, (s, jv.RolloutStats.zero()), words)

    (jfinal, jstats), (acts, raws) = run(jv.make_batch(jx.inst.get_instance(name), B), jnp.asarray(bits))
    state = tv.make_batch(ti.get_instance(name), B, device="cpu")
    final, raw = fr.rollout_driven(state, torch.from_numpy(np.asarray(acts)), T)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(raws))
    _same_state(final, _np(jfinal, jax))
    got = fr.rollout_free(state, T, bits=torch.from_numpy(bits))
    assert int(got["identity_violations"]) == 0
    for k in ("episodes", "total_makespan", "min_makespan", "steps"):
        assert int(got[k]) == int(getattr(jstats, k)), k
    assert float(got["total_return"]) == pytest.approx(float(jstats.total_return), rel=1e-5)
    assert B == 1024 or int(got["episodes"]) >= B


# ---------------------------------------------------------------------------
# random words and sampling
# ---------------------------------------------------------------------------


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors."""
    kats = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in kats:
        out = fr._philox4x32([torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
        assert tuple(int(w) for w in out) == want


def test_philox_bits_counter_and_key():
    seed = 0x1234_5678_9ABC_DEF0
    w = fr.philox_bits(seed, 7, 5, "cpu")
    assert w.dtype == torch.int32 and w.shape == (5,)
    for lane in range(5):
        c = [torch.tensor([x], dtype=torch.int64) for x in (7, lane, 0, 0)]
        want = int(fr._philox4x32(c, seed & 0xFFFFFFFF, seed >> 32)[0])
        assert int(w[lane]) & 0xFFFFFFFF == want
    assert not torch.equal(w, fr.philox_bits(seed, 8, 5, "cpu"))
    assert not torch.equal(w, fr.philox_bits(seed + 1, 7, 5, "cpu"))


def test_sample_from_bits_shifts_logically():
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")  # 15 legal jobs, no no-op
    bits = torch.tensor([-1, -(2**31), 2**31 - 1, 2], dtype=torch.int32)
    # k = (bits >>> 1) mod 15: 0x7FFFFFFF % 15 = 7, 0x40000000 % 15 = 4, 0x3FFFFFFF % 15 = 3, 1
    assert fr.sample_from_bits(bits, state).tolist() == [7, 4, 3, 1]
    noop = state.replace(noop_legal=torch.ones_like(state.noop_legal),
                         nb_legal=torch.zeros_like(state.nb_legal),
                         legal=torch.zeros_like(state.legal))
    assert fr.sample_from_bits(bits, noop).tolist() == [15] * 4


def test_uint32_bits_equal_int32_bits():
    state = tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=2), 4, device="cpu")
    b = _bits(60, 4, seed=1)
    a = fr.rollout_free(state, 60, bits=torch.from_numpy(b))
    u = fr.rollout_free(state, 60, bits=torch.from_numpy(b.view(np.uint32)))
    assert all(torch.equal(a[k], u[k]) for k in a)


# ---------------------------------------------------------------------------
# host plumbing and argument checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("light", [False, True])
def test_lane_layout_round_trip(light):
    state = tv.make_batch(ti.get_instance_set(["ta01", "ta41"]), 5, device="cpu")
    state, _ = fr.rollout_driven(state, _port_actions(state, 30, 0), 30)
    if light:
        state = tv.strip_solution(state)
    J, M = state.jobs_pad, state.machines_pad
    buf = fr._to_lanes(state, not light)
    assert buf.shape == (4 + 10 * J + 2 * M + (0 if light else J * M), 5)
    assert buf.dtype == torch.int32 and buf.is_contiguous()
    assert torch.equal(buf[0], state.time) and torch.equal(buf[4 + J + 2 * M:4 + 2 * J + 2 * M],
                                                           state.job_busy_for.t())
    back = fr._from_lanes(buf, state, not light)
    for k in ts.FIELD_NAMES:
        v, w = getattr(back, k), getattr(state, k)
        assert v.dtype == w.dtype and torch.equal(v, w), k


def test_int16_lane_layout_round_trip():
    state = tv.make_batch(ti.get_instance_set(["ta01", "ta02"]), 4, device="cpu")
    state, _ = fr.rollout_driven(state, _port_actions(state, 40, 2), 40)
    state = tv.strip_solution(state)
    buf = fr._to_lanes(state, False, torch.int16)
    assert buf.dtype == torch.int16 and buf.is_contiguous()
    assert torch.equal(buf.to(torch.int32), fr._to_lanes(state, False))
    back = fr._from_lanes(buf, state, False)
    for k in ts.FIELD_NAMES:
        v, w = getattr(back, k), getattr(state, k)
        assert v.dtype == w.dtype and torch.equal(v, w), k


def test_int16_launch_never_converts_its_buffer():
    state = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    tab, lanec = fr._lane_inputs(state)
    st, ret = torch.zeros((4, 4), dtype=torch.int64), torch.zeros(4)
    before = dict(fr.LAUNCHES)
    with pytest.raises(ValueError, match="int16 state buffer"):
        fr.launch_free(state, fr._to_lanes(state, False), tab, lanec, None, 0, st, ret, 1, torch.int16)
    with pytest.raises(ValueError, match="int32 or int16"):
        fr.launch_free(state, fr._to_lanes(state, False), tab, lanec, None, 0, st, ret, 1, torch.int64)
    assert fr.LAUNCHES == before


def _tables_of(state):
    return torch.stack([t.to(torch.int32) for t in (state.op_machine, state.op_dur, state.op_pos,
                                                    state.cum_before)], dim=1)


def test_lane_inputs_group_instances(monkeypatch):
    src = ti.get_instance_set(["ta01", "ta41", "ta01"], jobs_pad=30, machines_pad=20)
    state = tv.make_batch(src, 7, device="cpu")
    tab, lanec = fr._lane_inputs(state)
    assert tab.shape == (2, 4, 30, 20) and lanec.shape == (5, 7)
    assert tab.dtype == lanec.dtype == torch.int32
    assert torch.equal(tab[lanec[0].long()], _tables_of(state))
    for row, field in enumerate(("num_jobs", "num_machines", "max_time_op", "sum_op"), start=1):
        assert torch.equal(lanec[row], getattr(state, field)), field
    # later steps of the batch reuse the tables; an in-place write to a
    # table is seen
    stepped, _ = fr.rollout_driven(state, _port_actions(state, 3, 0), 3)
    again = fr._lane_inputs(stepped)
    assert again[0] is tab and again[1] is lanec
    state.op_dur[0, 0, 0] += 1
    tab2, lanec2 = fr._lane_inputs(state)
    assert tab2.shape[0] == 3 and torch.equal(tab2[lanec2[0].long()], _tables_of(state))
    # lanes whose tables are equal share one instance, whatever tensors hold them
    twin = state.replace(**{f: getattr(state, f).clone() for f in ("op_machine", "op_dur")})
    tab3, lanec3 = fr._lane_inputs(twin)
    assert tab3 is not tab2 and torch.equal(tab3, tab2) and torch.equal(lanec3, lanec2)
    # colliding keys split an instance, never merge two: still exact
    monkeypatch.setattr(fr, "_fingerprint", lambda flat: torch.zeros(flat.shape[0], dtype=torch.int64))
    fresh = tv.make_batch(src, 7, device="cpu")  # lanes A B A A B A A
    tab, lanec = fr._lane_inputs(fresh)
    assert tab.shape[0] == 5 and torch.equal(tab[lanec[0].long()], _tables_of(fresh))


def test_wrappers_check_their_arguments():
    state = tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=2), 4, device="cpu")
    with pytest.raises(ValueError, match=r"\(T, B\)"):
        fr.rollout_driven(state, torch.zeros((3, 5), dtype=torch.int32), 3)
    with pytest.raises(TypeError):
        fr.rollout_driven(state, torch.zeros((3, 4)), 3)
    with pytest.raises(TypeError):
        fr.rollout_driven(state, np.zeros((3, 4), np.int32), 3)
    with pytest.raises(ValueError, match=r"\(T, B\)"):
        fr.rollout_free(state, 3, bits=torch.zeros((4, 4), dtype=torch.int32))
    bad = state.replace(solution=state.solution[:, :2])
    with pytest.raises(ValueError, match="rows"):
        fr.rollout_driven(bad, torch.zeros((3, 4), dtype=torch.int32), 3)
    # the launchers refuse CPU tensors: a CPU state never reaches a kernel
    before = dict(fr.LAUNCHES)
    buf = fr._to_lanes(state, True)
    tab, lanec = fr._lane_inputs(state)
    with pytest.raises(ValueError, match="CUDA"):
        fr.launch_driven(state, buf, tab, lanec, torch.zeros((1, 4), dtype=torch.int32),
                         torch.zeros((1, 4), dtype=torch.int32), True)
    with pytest.raises(ValueError, match="CUDA"):
        fr.launch_free(state, fr._to_lanes(state, False), tab, lanec, None, 0,
                       torch.zeros((4, 4), dtype=torch.int64), torch.zeros(4), 1)
    assert fr.LAUNCHES == before


def test_free_options_on_the_twin():
    """Philox and bits words, with and without the solution: integer stats of
    the twin agree with its per-lane form, and the solution never matters."""
    state = tv.make_batch(ti.get_instance_set(["ta01"]), 3, device="cpu")
    a = fr.rollout_free(state, 260, seed=5)
    b = fr.rollout_free(state, 260, seed=5, with_solution=False)
    c = fr.rollout_free(tv.strip_solution(state), 260, seed=5)
    d = fr.rollout_free_reference(state, 260, seed=5)
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]) and torch.equal(a[k], d[k]), k
    assert int(a["episodes"]) == 3 and int(a["identity_violations"]) == 0
    assert int(a["steps"]) == 260 * 3
    lanes = fr.free_lane_stats(state, 260, seed=5)
    assert int(lanes["mk_sum"].sum()) == int(a["total_makespan"])
    assert not torch.equal(fr.rollout_free(state, 260, seed=6)["total_return"], a["total_return"])


def test_light_state_stays_light():
    state = tv.strip_solution(tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=2), 4, device="cpu"))
    final, raw = fr.rollout_driven(state, _port_actions(state, 40, 3), 40)
    assert final.solution.shape == (4, 0, 5) and raw.shape == (40, 4)


# (J, M) of ta01, ta41, ta71, padded ta01, the widest the two-slot build
# takes, and the smoke's wide shapes (3 and 4 machine slots a thread)
GEOMETRY_SHAPES = {"ta01": (15, 15), "ta41": (30, 20), "ta71": (100, 20), "ta01-padded": (16, 16),
                   "33x64": (33, 64), "20x100": (20, 100), "150x70": (150, 70), "12x70": (12, 70)}


@pytest.mark.parametrize("vdt", [torch.int16, torch.int32], ids=["int16", "int32"])
@pytest.mark.parametrize("shape", sorted(GEOMETRY_SHAPES))
def test_launch_geometry(shape, vdt):
    J, M = GEOMETRY_SHAPES[shape]
    geo = fr.launch_geometry(J, M, vdt)
    G, item = geo.group, torch.tensor([], dtype=vdt).element_size()
    assert G & (G - 1) == 0 and min(32, max(J, M)) <= G <= 32  # a power of two, one warp at most
    assert G == 32  # a warp per lane
    # job slots cover J; the machine slots cover M, at least the default two
    assert -(-J // G) * G >= J and geo.machine_slots == max(2, -(-M // G)) and geo.machine_slots * G >= M
    assert geo.threads == geo.lanes * G <= 256 and geo.lanes >= 1
    rows = 4 + 10 * J + 2 * M
    assert geo.state_stride >= rows and geo.state_stride * item % 4 == 0 and geo.scratch_stride >= 2 * M
    lane_words = geo.state_stride * item // 4
    assert geo.shared_bytes == geo.lanes * 4 * (lane_words + geo.scratch_stride) <= 232448
    # the lanes of a block start their rows on different banks
    starts = {(lane * lane_words) % 32 for lane in range(geo.lanes)}
    assert len(starts) == geo.lanes
    assert fr.launch_geometry(J, M, vdt) == geo


def test_launch_geometry_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="J=6000 jobs and M=20 machines"):
        fr.launch_geometry(6000, 20)
    fr.launch_geometry(6000, 20, torch.int16)  # half the bytes fit
    # past 64 machines: a class of more machine slots a thread, up to 32
    assert [fr.launch_geometry(J, M).machine_slots for J, M in ((10, 65), (20, 100), (150, 70), (3, 1024))] == [
        3, 4, 3, 32]
    with pytest.raises(ValueError, match="J=10 jobs and M=1025 machines"):
        fr.launch_geometry(10, 1025)
    with pytest.raises(ValueError, match="J=5600 jobs and M=1000 machines.*shared memory"):
        fr.launch_geometry(5600, 1000)
    fr.launch_geometry(5600, 1000, torch.int16)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against the twins
# ---------------------------------------------------------------------------


CARD_CASES = {
    "ta01": (lambda: ti.get_instance("ta01"), 64, 300, {}),
    "padded": (lambda: ti.get_instance("ta01"), 32, 260, {"jobs_pad": 16, "machines_pad": 16}),
    "ragged": (lambda: ti.get_instance_set(["ta01", "ta41", "ta71"]), 48, 120, {}),
    "episodes": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 100, 200, {}),
    # a second, nearly empty job slot (job 32), M at its limit (two machine slots)
    "33x64": (lambda: ti.random_instance(33, 64, (1, 9), seed=6), 8, 2300, {}),
    # B not a multiple of the 8 lanes of a ta01 block
    "ta01-B37": (lambda: ti.get_instance("ta01"), 37, 300, {}),
    # the warp larger than J: a 2x2 instance with a padded machine; ranks 2 to
    # 31 own no job, many episodes
    "2x2": (lambda: ti.random_instance(2, 2, (1, 9), seed=5), 37, 60, {"machines_pad": 3}),
}


def _launch_key(kernel, state):
    """The ``LAUNCHES`` key a launch on ``state`` counts under: the static
    build where every lane is unpadded, else the slot-class one."""
    return kernel + ("_static" if fr.static_shape(state) else "_slots")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_driven_kernel_matches_twin_on_card(cuda_dev, case):
    src, B, T, pad = CARD_CASES[case]
    state = tv.make_batch(src(), B, device=cuda_dev, **pad)
    acts = _port_actions(state, T, seed=1)
    key = _launch_key("rollout_driven", state)
    assert (key == "rollout_driven_slots") == (case in ("padded", "ragged", "2x2"))
    before = fr.LAUNCHES[key]
    final, raw = fr.rollout_driven(state, acts, T)
    assert fr.LAUNCHES[key] == before + 1
    ref, ref_raw = fr.rollout_driven_reference(state, acts, T)
    torch.cuda.synchronize()
    assert torch.equal(raw, ref_raw)
    for k in ts.FIELD_NAMES:
        assert torch.equal(getattr(final, k), getattr(ref, k)), k
    light = tv.strip_solution(state)
    lfinal, lraw = fr.rollout_driven(light, acts, T)
    assert torch.equal(lraw, ref_raw) and lfinal.solution.shape[1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_driven_kernel_ends_match_twin_on_card(cuda_dev, case):
    """The kernel's episode ends equal the twin's, on a full and a light
    state; asking for them changes neither the rewards nor the state."""
    src, B, T, pad = CARD_CASES[case]
    state = tv.make_batch(src(), B, device=cuda_dev, **pad)
    acts = _port_actions(state, T, seed=4)
    ref, ref_raw, ref_ends = fr.rollout_driven_reference(state, acts, T, return_ends=True)
    key = _launch_key("rollout_driven", state)
    for s in (state, tv.strip_solution(state)):
        before = fr.LAUNCHES[key]
        final, raw, ends = fr.rollout_driven(s, acts, T, return_ends=True)
        assert fr.LAUNCHES[key] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(ends, ref_ends) and torch.equal(raw, ref_raw)
        for k in ts.FIELD_NAMES:
            if k != "solution" or s is state:
                assert torch.equal(getattr(final, k), getattr(ref, k)), k
    assert int((ref_ends > 0).sum()) > 0 or case not in ("episodes", "2x2")  # the short-episode cases end


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("mode", ["bits", "philox"])
def test_free_kernel_matches_twin_on_card(cuda_dev, case, mode):
    src, B, T, pad = CARD_CASES[case]
    state = tv.make_batch(src(), B, device=cuda_dev, **pad)
    bits = torch.from_numpy(_bits(T, B, seed=2)).to(cuda_dev) if mode == "bits" else None
    # every case but the ragged one (ta41, ta71) fits int16; each runs a
    # register build on its fields, which has no storage type
    assert (fr.value_dtype(state) == torch.int32) == (case == "ragged")
    key = _launch_key("rollout_free", state)
    before = dict(fr.LAUNCHES)
    k = fr.free_lane_stats(state, T, seed=11, bits=bits)
    assert fr.LAUNCHES[key] == before[key] + 1 and sum(fr.LAUNCHES.values()) == sum(before.values()) + 1
    r = fr.free_lane_stats_reference(state, T, seed=11, bits=bits)
    for f in k:
        assert torch.equal(k[f], r[f]), f
    assert int(k["viol"].sum()) == 0


# batches whose values fit int16; "ragged" is two instances, with T long
# enough for ta01's 225 decisions
INT16_CARD_CASES = dict(CARD_CASES, ragged=(lambda: ti.get_instance_set(["ta01", "ta02"]), 48, 320, {}))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(INT16_CARD_CASES))
@pytest.mark.parametrize("mode", ["bits", "philox"])
def test_int16_kernel_matches_int32_kernel_on_card(cuda_dev, case, mode):
    """A batch whose values fit runs rollout.cu's int16 instantiation when
    that build is asked for (the dtype cached with its lane inputs); its
    per-lane stats equal the int32 instantiation's on the same batch, the
    register build's (the default) and the twin's."""
    src, B, T, pad = INT16_CARD_CASES[case]
    state = tv.make_batch(src(), B, device=cuda_dev, **pad)
    bits = torch.from_numpy(_bits(T, B, seed=3)).to(cuda_dev) if mode == "bits" else None
    assert fr.value_dtype(state) == torch.int16
    before = dict(fr.LAUNCHES)
    k = fr.free_lane_stats(state, T, seed=11, bits=bits)
    k16 = fr._free_kernel(state, T, 11, bits, build="rollout")
    k32 = fr._free_kernel(state, T, 11, bits, torch.int32, build="rollout")
    key = _launch_key("rollout_free", state)
    assert fr.LAUNCHES[key] == before[key] + 1
    assert fr.LAUNCHES["rollout_free_i16"] == before["rollout_free_i16"] + 1
    assert fr.LAUNCHES["rollout_free"] == before["rollout_free"] + 1
    r = fr.free_lane_stats_reference(state, T, seed=11, bits=bits)
    for k16_ in k16:
        assert torch.equal(k16[k16_], k32[k16_]) and torch.equal(k16[k16_], r[k16_]), k16_
        assert torch.equal(k[k16_], r[k16_]), k16_
    assert int(k16["viol"].sum()) == 0 and int(k16["episodes"].sum()) > 0


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs_on_card(cuda_dev):
    state = tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=2), 4, device=cuda_dev)
    with pytest.raises(ValueError, match="is on"):
        fr.rollout_driven(state, torch.zeros((2, 4), dtype=torch.int32), 2)
    with pytest.raises(TypeError):
        fr.rollout_free(state, 2, bits=torch.zeros((2, 4), device=cuda_dev))
    wide = tv.make_batch(ti.random_instance(6, 1025, (1, 9), seed=2), 4, device=cuda_dev)
    before = dict(fr.LAUNCHES)
    with pytest.raises(ValueError, match="J=6 jobs and M=1025 machines"):
        fr.rollout_free(wide, 2)
    with pytest.raises(ValueError, match="J=6 jobs and M=1025 machines"):
        fr.rollout_driven(wide, torch.zeros((2, 4), dtype=torch.int32, device=cuda_dev), 2)
    assert fr.LAUNCHES == before


# past 64 machines: rollout.cu's class of 4 machine slots a thread (20x100)
# and of 3 with five job slots (150x70), Taillard's durations (int32)
WIDE_CARD = {"wide20x100": (lambda: ti.random_instance(20, 100, (1, 99), seed=20), 256, 160, 4),
             "wide150x70": (lambda: ti.random_instance(150, 70, (1, 99), seed=150), 64, 160, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDE_CARD))
def test_wide_driven_kernel_matches_twin_on_card(cuda_dev, case):
    """The driven kernel past 64 machines, from a fresh and a mid-episode
    state, full and light, with ends: equal to the twin in every field, its
    input unchanged, one launch of its machine-slot class."""
    src, B, T, slots = WIDE_CARD[case]
    fresh = tv.make_batch(src(), B, device=cuda_dev)
    assert fr.driven_build(fresh) == fr.Build("rollout", slots)
    mid, _ = fr.rollout_driven_reference(fresh, _port_actions(fresh, T, seed=5), T)
    key = f"rollout_driven_m{slots}"
    for start in (fresh, mid):
        acts = _port_actions(start, T, seed=6).to(torch.int32)
        ref, ref_raw, ref_ends = fr.rollout_driven_reference(start, acts, T, return_ends=True)
        for s in (start, tv.strip_solution(start)):
            before = {k: v.clone() for k, v in s.dynamic_fields().items()}
            n = fr.LAUNCHES.get(key, 0)
            final, raw, ends = fr.rollout_driven(s, acts, T, return_ends=True)
            assert fr.LAUNCHES[key] == n + 1
            torch.cuda.synchronize()
            assert torch.equal(raw, ref_raw) and torch.equal(ends, ref_ends)
            for k in ts.FIELD_NAMES:
                if k != "solution" or s is start:
                    assert torch.equal(getattr(final, k), getattr(ref, k)), k
            assert all(torch.equal(getattr(s, k), v) for k, v in before.items())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDE_CARD))
@pytest.mark.parametrize("mode", ["bits", "philox"])
def test_wide_free_kernel_matches_twin_on_card(cuda_dev, case, mode):
    """The free kernel past 64 machines, Philox from a non-zero
    ``lane_offset`` or caller bits: per-lane stats equal to the twin's, one
    launch of its machine-slot class."""
    src, B, T, slots = WIDE_CARD[case]
    state = tv.make_batch(src(), B, device=cuda_dev)
    bits = torch.from_numpy(_bits(T, B, seed=8)).to(cuda_dev) if mode == "bits" else None
    assert fr.value_dtype(state) == torch.int32
    key = f"rollout_free_m{slots}"
    n = fr.LAUNCHES.get(key, 0)
    k = fr.free_lane_stats(state, T, seed=13, bits=bits, lane_offset=B + 3)
    assert fr.LAUNCHES[key] == n + 1
    r = fr.free_lane_stats_reference(state, T, seed=13, bits=bits, lane_offset=B + 3)
    for f in k:
        assert torch.equal(k[f], r[f]), f
    assert int(k["viol"].sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("refused", ["threads", "shared"])
def test_refused_launch_raises_on_card(cuda_dev, monkeypatch, refused):
    """A geometry the card refuses (too many threads a block, more shared
    memory than a block may have) raises; nothing runs in its place. Both
    halves run a padded batch in rollout.cu's general build: the static and
    slot-class builds (csrc/driven_static.cu, csrc/free_static.cu,
    csrc/general_lane.cu) have no shared memory and a block of their own, so
    no geometry of launch_geometry reaches them."""
    padded = tv.make_batch(ti.get_instance_set(["ta01", "ta41"]), 16, device=cuda_dev)
    plain = fr.launch_geometry

    def bad(*a, **k):
        geo = plain(*a, **k)
        if refused == "threads":
            return geo._replace(lanes=64, threads=64 * 32, shared_bytes=64 * geo.shared_bytes // geo.lanes)
        return geo._replace(shared_bytes=240000)

    monkeypatch.setattr(fr, "launch_geometry", bad)
    assert fr.free_build(padded, "rollout") == fr.driven_build(padded, "rollout") == fr.Build("rollout")
    before = dict(fr.LAUNCHES)
    with pytest.raises(RuntimeError, match="rollout_driven_kernel.*refused or failed"):
        fr._driven_kernel(padded, torch.zeros((2, 16), dtype=torch.int32, device=cuda_dev), 2, True, False,
                          build="rollout")
    with pytest.raises(RuntimeError, match="rollout_free_kernel.*refused or failed"):
        fr._free_kernel(padded, 2, 1, None, build="rollout")
    assert fr.LAUNCHES == before

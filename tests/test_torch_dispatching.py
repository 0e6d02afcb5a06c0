"""The port's dispatching rules (``jssenv_tpu_torch.rules.dispatching``)
against the JAX package's.

With the exploration coin off, every rule must choose the JAX rule's action
at every step of its greedy trajectory on ta01-ta10, with both engines fed
the same states (the pattern of tests/test_dispatching.py's trajectory
parity): the seven rules run side by side as one batch, lane ``r * 10 + i``
following rule ``r`` on instance ``i``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from jssenv_tpu import instances as ji  # noqa: E402
from jssenv_tpu import vector as jv  # noqa: E402
from jssenv_tpu.core.state import EnvState as JEnvState  # noqa: E402
from jssenv_tpu.rules import dispatching as jd  # noqa: E402

from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import state as ts  # noqa: E402
from jssenv_tpu_torch.rules import dispatching as td  # noqa: E402

torch.set_num_threads(1)

RULES = sorted(td.DISPATCHING_RULES)
TA01_10 = [f"ta{i:02d}" for i in range(1, 11)]


def _ties(mod):
    # every duration equal: SPT sees a tie among all legal jobs at every step
    return mod.stack_instances([mod.random_instance(6, 5, (4, 4), seed=0)])


def _suite(mod):
    return mod.get_instance_set(TA01_10)


def _lockstep(source, n_inst, max_steps=2000):
    """All seven greedy rules side by side, one lane per (rule, instance), on
    both packages; asserts equal actions at every step and equal final
    states. Returns the port's (actions, legal mask) before each step, and
    the final makespans and returns (numpy)."""
    B = len(RULES) * n_inst
    rule_of = np.arange(B) // n_inst
    jrules = [jd.get_rule(n) for n in RULES]

    @jax.jit
    def jstep(s):
        acts = jnp.stack([jax.vmap(lambda x, r=r: r.action(x, None))(s) for r in jrules])
        a = acts[jnp.asarray(rule_of), jnp.arange(B)]
        s2, tr = jv.vstep(s, a)
        return s2, a, tr.done, tr.reward

    js = jv.make_batch(source(ji), B)
    state = tv.make_batch(source(ti), B, device="cpu")
    rule_of_t = torch.from_numpy(rule_of)
    lanes = torch.arange(B)
    done_seen = np.zeros(B, bool)
    ms = np.zeros(B, np.int64)
    ret_t = torch.zeros(B, dtype=torch.float32)
    ret_j = np.zeros(B, np.float32)
    history = []
    for i in range(max_steps):
        if done_seen.all():
            break
        acts = torch.stack([td.get_rule(n).action(state, None) for n in RULES])
        a = acts[rule_of_t, lanes]
        js, ja, jdone, jrew = jstep(js)
        live = ~done_seen
        history.append((a.clone(), state.legal.clone()))
        np.testing.assert_array_equal(a.numpy()[live], np.asarray(ja)[live], err_msg=f"step {i}")
        state, tr = tv.vstep(state, a)
        assert np.array_equal(tr.done.numpy(), np.asarray(jdone)), f"step {i}: done"
        ret_t += torch.where(torch.from_numpy(live), tr.reward, 0.0)
        ret_j += np.where(live, np.asarray(jrew), 0.0).astype(np.float32)
        newly = live & tr.done.numpy()
        ms[newly] = state.time.numpy()[newly]
        done_seen |= tr.done.numpy()
    assert done_seen.all()
    got = ts.to_numpy(state)
    for k, v in vars(jax.device_get(js)).items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(ret_t.numpy(), ret_j)
    return history, ms, ret_t.numpy()


@pytest.fixture(scope="module")
def suite_run():
    return _lockstep(_suite, len(TA01_10))


def test_registry_and_lookup():
    assert set(td.DISPATCHING_RULES) == set(jd.DISPATCHING_RULES)
    for name, rule in td.DISPATCHING_RULES.items():
        ref = jd.DISPATCHING_RULES[name]
        assert rule.get_name() == name and rule.minimize == ref.minimize
        assert rule.get_description() == ref.get_description()
    with pytest.raises(ValueError, match="not found"):
        td.get_rule("NOT_A_RULE")


def test_rules_choose_the_jax_actions_on_ta01_ta10(suite_run):
    _, ms, _ = suite_run
    assert (ms >= 1175).all()  # no schedule beats the best known of ta01-ta10


def test_compare_rules_batched_equals_jax(suite_run):
    """The port's batched sweep against the JAX one, and both against the
    lockstep makespans."""
    _, ms, ret = suite_run
    n = len(TA01_10)
    got = td.compare_rules_batched(ti.get_instance_set(TA01_10), num_episodes=n, device="cpu")
    want = jd.compare_rules_batched(ji.get_instance_set(TA01_10), rules=["CR"], num_episodes=n)
    for r, name in enumerate(RULES):
        assert got[name]["avg_makespan"] == float(ms[r * n:(r + 1) * n].mean()), name
        assert got[name]["avg_reward"] == float(ret[r * n:(r + 1) * n].mean()), name
        if name in want:
            assert got[name] == want[name], name


def test_ties_go_to_the_lowest_index():
    history, ms, _ = _lockstep(_ties, 1)
    spt = RULES.index("SPT")
    for a, legal in history:
        lane_legal = legal[spt]
        if lane_legal.any():
            assert int(a[spt]) == int(lane_legal.nonzero()[0, 0])
    assert (ms > 0).all()


def test_priorities_match_jax():
    """The five priority functions on one mid-episode batch, equal to the
    JAX ones lane by lane (CR in float32, exactly)."""
    src = ti.get_instance_set(["ta01", "ta41"])
    state = tv.make_batch(src, 6, device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(40):
        state, _ = tv.vstep(state, tv.random_legal_actions(g, state))
    js = JEnvState(**{k: jnp.asarray(v) for k, v in ts.to_numpy(state).items()})
    fns = ["current_op_duration", "idle_since_last_op", "remaining_work", "remaining_ops", "critical_ratio"]
    for fn in fns:
        got = getattr(td, fn)(state).numpy()
        want = np.asarray(jax.vmap(getattr(jd, fn))(js))
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)


def test_exploration_is_legal_and_seeded():
    src = ti.get_instance("ta01")

    def run(seed):
        legal_ok = []
        rule_policy = td.get_rule("SPT").policy(explore_prob=0.5)

        def policy(gen, s):
            a = rule_policy(gen, s)
            mask = s.action_mask()
            slot = torch.where(a == s.num_jobs, s.jobs_pad, a).long()
            live = mask.any(dim=1)
            legal_ok.append(bool(mask.gather(1, slot[:, None])[:, 0][live].all()))
            return a

        state = tv.make_batch(src, 8, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        _, ms, ret = tv.episode_makespans(gen, state, max_steps=3000, policy=policy)
        assert all(legal_ok) and (ms > 0).all()
        return ms, ret

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    greedy = td.compare_rules_batched(src, rules=["SPT"], num_episodes=2, device="cpu")
    noisy = td.compare_rules_batched(src, rules=["SPT"], num_episodes=8, explore_prob=0.5,
                                     seed=3, device="cpu")
    assert noisy["SPT"]["avg_makespan"] != greedy["SPT"]["avg_makespan"]


def test_sweep_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.compare_rules_batched(ti.get_instance("ta01"), rules=["SPT"], num_episodes=1)

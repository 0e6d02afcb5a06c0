"""The port's actor-learner against the JAX package's.

Returns and GAE on random trajectories; the REINFORCE and PPO losses and
gradients of both packages on one recorded trajectory (the JAX train step
run with its rollout replaced by the recording and its optimizer by one that
keeps the gradients, its nets at float32); one Adam step against
``optax.adam``; chunked against one-shot gradients; the kernel-path env step
(``fused_rollout.step_autoreset``) against ``vector.step_autoreset``; short
training runs; and, on a card only (``-m cuda``), the learner's env steps in
the driven kernel."""

import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import checkpoint as tck
from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.core import fused_rollout as fr
from jssenv_tpu_torch.core import state as ts_mod
from jssenv_tpu_torch.parallel import learner as tl

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    optax = pytest.importorskip("optax")
    from jssenv_tpu import vector
    from jssenv_tpu.core.state import EnvState
    from jssenv_tpu.models import policy
    from jssenv_tpu.parallel import learner

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, optax=optax, vector=vector, EnvState=EnvState,
                                 policy=policy, learner=learner)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    return torch.device("cuda")


def _random_traj(T, B, seed):
    rng = np.random.default_rng(seed)
    return {
        "reward": rng.normal(size=(T, B)).astype(np.float32),
        "done": (rng.random((T, B)) < 0.2).astype(np.float32),
        "value": rng.normal(size=(T, B)).astype(np.float32),
    }, rng.normal(size=(B,)).astype(np.float32)


def test_returns_and_gae_match_jax(jx):
    cfg = tl.LearnerConfig(gamma=0.97, gae_lambda=0.9)
    jcfg = jx.learner.LearnerConfig(gamma=0.97, gae_lambda=0.9)
    for T, B, seed in ((7, 5, 0), (32, 64, 1)):
        traj, last = _random_traj(T, B, seed)
        got = tl._returns({k: torch.from_numpy(v) for k, v in traj.items()}, cfg).numpy()
        want = np.asarray(jx.learner._returns({k: jx.jnp.asarray(v) for k, v in traj.items()}, jcfg))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        got = tl._gae({k: torch.from_numpy(v) for k, v in traj.items()}, torch.from_numpy(last), cfg).numpy()
        want = np.asarray(jx.learner._gae({k: jx.jnp.asarray(v) for k, v in traj.items()},
                                          jx.jnp.asarray(last), jcfg))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _nested(flat):
    tree = {"params": {}}
    for name, arr in flat.items():
        _, layer, leaf = re.findall(r"\['([^']+)'\]", name)
        tree["params"].setdefault(layer, {})[leaf] = arr
    return tree


def _recorded(cfg, B=16, seed=5, names=("ta01",)):
    """A port train state at float32 and one trajectory recorded from it
    (with its final env state and stats), on the CPU."""
    state = tv.strip_solution(tv.make_batch(ti.get_instance_set(list(names)), B, device="cpu"))
    ts = tl.init_train_state(seed, state, cfg)
    env_state, stats, traj = tl._policy_rollout(ts.model, state, ts.generator, cfg)
    return ts, (env_state, stats, traj)


def _jax_grads(jx, monkeypatch, ts, rec, cfg):
    """Loss metrics and gradients of the JAX package's train step on the
    recorded trajectory, its nets at float32."""
    env_state, _, traj = rec
    jcfg = jx.learner.LearnerConfig(**{f.name: getattr(cfg, f.name)
                                       for f in dataclasses.fields(jx.learner.LearnerConfig)})
    jstate = jx.EnvState(**{k: jx.jnp.asarray(v) for k, v in ts_mod.to_numpy(env_state).items()})
    jtraj = {k: jx.jnp.asarray(v.numpy()) for k, v in traj.items()}
    jtraj["action"] = jtraj["action"].astype(jx.jnp.int32)
    jtraj["done"] = jtraj["done"].astype(bool)
    monkeypatch.setattr(jx.learner, "_policy_rollout",
                        lambda *a: (jstate, a[3], jx.vector.RolloutStats.zero(), jtraj))
    if cfg.arch == "perjob":
        net = jx.policy.PerJobPolicyNet(hidden=cfg.hidden[0], depth=len(cfg.hidden), compute_dtype=jx.jnp.float32)
    else:
        net = jx.policy.MaskedPolicyNet(num_actions=env_state.jobs_pad + 1, hidden=cfg.hidden,
                                        compute_dtype=jx.jnp.float32)
    monkeypatch.setattr(jx.learner, "make_model", lambda s, c: net)
    grads = []

    def update(g, state, params=None):
        jx.jax.debug.callback(grads.append, g)  # PPO's update runs inside a scan
        return jx.jax.tree.map(jx.jnp.zeros_like, g), state

    keep = jx.optax.GradientTransformation(lambda p: jx.optax.EmptyState(), update)
    monkeypatch.setattr(jx.learner, "make_optimizer", lambda c: keep)
    params = jx.jax.tree.map(jx.jnp.asarray, _nested(tck.params_to_flax(ts.model)))
    jts = jx.learner.TrainState(params=params, opt_state=keep.init(params), env_state=jstate,
                                rng=jx.jax.random.key(0), steps=jx.jnp.int32(0))
    _, metrics = jx.learner.make_train_step(jcfg)(jts)
    flat = tck.params_from_flax({"params": jx.jax.tree.map(np.asarray, grads[-1])["params"]})
    return metrics, flat


def _port_grads(monkeypatch, ts, rec, cfg):
    monkeypatch.setattr(tl, "_policy_rollout", lambda *a: rec)
    _, metrics = tl.make_train_step(cfg)(ts)
    return metrics, {k: p.grad.clone() for k, p in ts.model.named_parameters()}


def _close(got, want, rel=1e-5):
    """|got - want| <= rel * the largest |want| of all tensors: a gradient
    that cancels to about zero (a bias whose logits' softmax terms sum to
    zero) has no relative precision of its own."""
    scale = max(float(w.abs().max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= rel * scale, k


@pytest.mark.parametrize("algo,arch", [("reinforce", "flat"), ("reinforce", "perjob"), ("ppo", "flat")])
def test_loss_and_grads_match_jax(jx, monkeypatch, algo, arch):
    """float32, the same params and trajectory: loss terms and gradients
    within rel 1e-5 (PPO on one minibatch of the whole trajectory, one
    epoch)."""
    cfg = tl.LearnerConfig(unroll_steps=8, hidden=(32, 32), algo=algo, arch=arch, minibatches=1, ppo_epochs=1,
                           features="rich" if arch == "perjob" else "reference", compute_dtype=torch.float32)
    ts, rec = _recorded(cfg, names=("ta01", "ta41") if arch == "perjob" else ("ta01",))
    jmetrics, jgrads = _jax_grads(jx, monkeypatch, ts, rec, cfg)
    metrics, grads = _port_grads(monkeypatch, ts, rec, cfg)
    # rel 1e-5 of max(1, |value|): PPO's first-epoch surrogate is the mean of
    # normalised advantages at ratio 1, about 0 by construction
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= 1e-5 * max(1.0, abs(want)), k
    _close(grads, jgrads)


def test_one_adam_step_matches_optax(jx):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * s for s in (1.0, 1e-3, 30.0)]
    cfg = tl.LearnerConfig(learning_rate=3e-3)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tl.make_optimizer(cfg, [w])
    tx = jx.optax.adam(3e-3)
    jp = jx.jnp.asarray(p0)
    st = tx.init(jp)
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt.step()
        upd, st = tx.update(jx.jnp.asarray(g), st, jp)
        jp = jx.optax.apply_updates(jp, upd)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_loss_chunks_equal_one_shot_grads(monkeypatch):
    base = tl.LearnerConfig(unroll_steps=8, hidden=(32, 32), arch="perjob", compute_dtype=torch.float32)
    ts, rec = _recorded(base, B=8)
    m1, g1 = _port_grads(monkeypatch, ts, rec, base)
    ts2, _ = _recorded(base, B=8)
    m4, g4 = _port_grads(monkeypatch, ts2, rec, dataclasses.replace(base, loss_chunks=4))
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    _close(g4, g1)
    with pytest.raises(ValueError, match="must divide"):
        tl.make_train_step(tl.LearnerConfig(unroll_steps=6, loss_chunks=4))


def test_unknown_algo_arch_and_features_raise():
    with pytest.raises(ValueError, match="algo"):
        tl.make_train_step(tl.LearnerConfig(algo="a2c"))
    state = tv.make_batch(ti.get_instance("ta01"), 2, device="cpu")
    with pytest.raises(ValueError, match="arch"):
        tl.make_model(state, tl.LearnerConfig(arch="conv"))
    with pytest.raises(ValueError, match="features"):
        tl.make_model(state, tl.LearnerConfig(features="raw"))


@pytest.mark.parametrize("B,T,spec", [(8, 320, "ta01"), (1024, 40, "rand6x5")])
def test_fused_step_autoreset_equals_vector_on_cpu(B, T, spec):
    src = ti.get_instance(spec) if spec == "ta01" else ti.random_instance(6, 5, (1, 9), seed=3)
    s_v = s_f = tv.make_batch(src, B, device="cpu")
    st_v = st_f = tv.RolloutStats.zero("cpu")
    g = torch.Generator().manual_seed(B)
    before = dict(fr.LAUNCHES)
    for _ in range(T):
        a = tv.random_legal_actions(g, s_v)
        s_v, tr_v, st_v = tv.step_autoreset(s_v, a, st_v)
        s_f, tr_f, st_f = fr.step_autoreset(s_f, a, st_f)
        for k in ("reward", "raw_reward", "done"):
            x, y = getattr(tr_f, k), getattr(tr_v, k)
            assert x.dtype == y.dtype and torch.equal(x, y), k
        for k in ts_mod.FIELD_NAMES:
            assert torch.equal(getattr(s_f, k), getattr(s_v, k)), k
    for f in dataclasses.fields(tv.RolloutStats):
        x, y = getattr(st_f, f.name), getattr(st_v, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name
    assert int(st_v.episodes) > 0 and fr.LAUNCHES == before


@pytest.mark.parametrize("algo", ["reinforce", "ppo"])
def test_short_training_run_learns(algo):
    """The JAX package's short runs (ta01, B=64, hidden (64, 64)): at least
    64 episodes, and the last window's average makespan in [1231, 1900]
    (the random policy averages about 1830)."""
    extra = dict(algo="ppo", minibatches=2, ppo_epochs=2) if algo == "ppo" else {}
    config = tl.LearnerConfig(unroll_steps=16, hidden=(64, 64), learning_rate=1e-3, **extra)
    ts, history = tl.train(ti.get_instance("ta01"), batch_size=64, num_updates=36 if algo == "ppo" else 40,
                           config=config, seed=3, log_every=18 if algo == "ppo" else 20, log_fn=lambda *_: None,
                           device="cpu")
    assert sum(h["episodes"] for h in history) >= 64
    assert 1231 <= history[-1]["avg_makespan"] <= 1900
    assert ts.steps == (36 if algo == "ppo" else 40)
    assert all(np.isfinite(h["loss"]) for h in history)


def test_evaluate_policy_greedy_and_sampled():
    """Repeatable greedy makespan; sampled lanes report best <= average."""
    spec = ti.get_instance("ta01")
    cfg = tl.LearnerConfig(unroll_steps=4, hidden=(32, 32))
    params = tl.init_train_state(0, tv.make_batch(spec, 4, device="cpu"), cfg).model.state_dict()
    r1 = tl.evaluate_policy(params, spec, cfg, device="cpu")
    r2 = tl.evaluate_policy(params, spec, cfg, device="cpu")
    assert r1 == r2 and r1["greedy_makespan"] > 0
    r3 = tl.evaluate_policy(params, spec, cfg, stochastic_lanes=7, device="cpu")
    assert r3["greedy_makespan"] == r1["greedy_makespan"]
    assert 0 < r3["best_sampled_makespan"] <= r3["avg_sampled_makespan"]


def test_learner_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ti.get_instance("ta01")
    cfg = tl.LearnerConfig(hidden=(8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.train(spec, batch_size=2, num_updates=1, config=cfg)
    params = tl.init_train_state(0, tv.make_batch(spec, 2, device="cpu"), cfg).model.state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.evaluate_policy(params, spec, cfg)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["reinforce", "ppo"])
def test_learner_steps_envs_in_the_driven_kernel_on_card(cuda_dev, algo):
    """Every env step of an update is one driven-kernel launch on the light
    state; then a longer rollout, replayed action for action through the
    plain twin, gives the same env trajectory: every state field, the
    rewards, the dones and the stats from the twin's episode ends."""
    cfg = tl.LearnerConfig(unroll_steps=8, hidden=(32, 32), algo=algo, minibatches=2, ppo_epochs=1)
    state = tv.strip_solution(tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=3), 64, device=cuda_dev))
    ts = tl.init_train_state(0, state, cfg)
    step = tl.make_train_step(cfg)
    fr.reset_launch_counts()
    for _ in range(3):
        ts, m = step(ts)
        assert np.isfinite(float(m["loss"]))
    assert fr.LAUNCHES == {"rollout_driven": 3 * cfg.unroll_steps, "rollout_free": 0, "rollout_free_i16": 0}
    assert ts.env_state.device.type == "cuda" and ts.env_state.solution.shape[1] == 0

    long_cfg = dataclasses.replace(cfg, unroll_steps=64)  # long enough for 6x5 episodes to end
    s0 = ts.env_state
    s1, stats, traj = tl._policy_rollout(ts.model, s0, ts.generator, long_cfg)
    acts = torch.where(traj["action"] == s0.jobs_pad, s0.num_jobs, traj["action"])
    ref, raw, ends = fr.rollout_driven_reference(s0, acts, long_cfg.unroll_steps, return_ends=True)
    for k in ts_mod.FIELD_NAMES:
        assert torch.equal(getattr(s1, k), getattr(ref, k)), k
    assert torch.equal(traj["reward"], raw.to(torch.float32) / s0.max_time_op.to(torch.float32))
    assert torch.equal(traj["done"], (ends > 0).to(torch.float32))
    assert int(stats.episodes) == int((ends > 0).sum()) > 0
    assert int(stats.total_makespan) == int(ends.sum(dtype=torch.int64))


@pytest.mark.cuda
def test_fused_step_autoreset_on_card_equals_vector(cuda_dev):
    s_v = s_f = tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=3), 1024, device=cuda_dev)
    st_v = st_f = tv.RolloutStats.zero(cuda_dev)
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    before = fr.LAUNCHES["rollout_driven"]
    for _ in range(40):
        a = tv.random_legal_actions(g, s_v)
        s_v, tr_v, st_v = tv.step_autoreset(s_v, a, st_v)
        s_f, tr_f, st_f = fr.step_autoreset(s_f, a, st_f)
        assert all(torch.equal(getattr(tr_f, k), getattr(tr_v, k)) for k in ("reward", "raw_reward", "done"))
        assert all(torch.equal(getattr(s_f, k), getattr(s_v, k)) for k in ts_mod.FIELD_NAMES)
    assert fr.LAUNCHES["rollout_driven"] == before + 40
    for f in dataclasses.fields(tv.RolloutStats):
        assert torch.equal(getattr(st_f, f.name), getattr(st_v, f.name)), f.name
    assert int(st_v.episodes) > 0

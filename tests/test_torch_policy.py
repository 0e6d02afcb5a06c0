"""The port's policy nets and checkpoint format against the JAX package's.

Every shipped checkpoint (``models_data``) is loaded into both packages; the
same observations, taken from real port states stepped with numpy-chosen
legal actions, go through the flax net and the port net. Then greedy
evaluations: at float32 the port's makespan equals the JAX package's, at
bfloat16 the JAX package's test bounds hold."""

import pathlib
import re
import types

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import checkpoint as tck
from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.models import policy as tp
from jssenv_tpu_torch.parallel import learner as tl

torch.set_num_threads(1)

MODELS = pathlib.Path(__file__).resolve().parents[1] / "models_data"

# checkpoint -> (arch, hidden, features, the instance set its observations come from)
CHECKPOINTS = {
    "ta01_policy": ("flat", (256, 256), "reference", ("ta01",)),
    "ta01_policy_rich": ("flat", (256, 256), "rich", ("ta01",)),
    "ta_set_policy": ("flat", (256, 256), "rich", ("ta01",)),
    "ta41_policy_rich": ("flat", (256, 256), "rich", ("ta41",)),
    "ta_cross_policy": ("perjob", (128, 128), "rich", ("ta01", "ta41")),
    "ta41_distill": ("perjob", (128, 128), "rich", ("ta41",)),
    "ta41_distill_sm": ("perjob", (128, 128), "rich", ("ta01",)),
    "ta41_distill_pre": ("perjob", (128, 128), "rich", ("ta41",)),
    "ta41_distill_pre_sm": ("perjob", (128, 128), "rich", ("ta01", "ta41")),
}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    from jssenv_tpu import checkpoint, instances, vector
    from jssenv_tpu.models import policy
    from jssenv_tpu.parallel import learner

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ckpt=checkpoint, inst=instances, vector=vector,
                                 policy=policy, learner=learner)


def _config(name, dtype=torch.bfloat16):
    arch, hidden, features, _ = CHECKPOINTS[name]
    return tl.LearnerConfig(arch=arch, hidden=hidden, features=features, compute_dtype=dtype)


def _jax_net(jx, name, dtype):
    arch, hidden, _, _ = CHECKPOINTS[name]
    if arch == "perjob":
        return jx.policy.PerJobPolicyNet(hidden=hidden[0], depth=len(hidden), compute_dtype=dtype)
    W = tck.load(MODELS / f"{name}.npz")["['params']['policy_head']['bias']"].shape[0]
    return jx.policy.MaskedPolicyNet(num_actions=W, hidden=hidden, compute_dtype=dtype)


def _jax_params(jx, path):
    """A flax params tree from the npz, through the JAX package's loader."""
    flat = tck.load(path)
    tree = {"params": {}}
    for name, arr in flat.items():
        _, layer, leaf = re.findall(r"\['([^']+)'\]", name)
        tree["params"].setdefault(layer, {})[leaf] = np.zeros_like(arr)
    return jx.ckpt.load(str(path), jx.jax.tree.map(jx.jnp.asarray, tree))


def _observations(names, features, seed=0, B=48, snaps=(0, 30, 90, 160)):
    """(obs, mask, valid) numpy arrays of real port states: B lanes of the
    instance set, stepped with numpy-chosen legal actions, taken at each
    step count in ``snaps``."""
    src = ti.get_instance_set(list(names))
    state = tv.strip_solution(tv.make_batch(src, B, device="cpu"))
    cfg = tl.LearnerConfig(features=features)
    rng = np.random.default_rng(seed)
    stats = tv.RolloutStats.zero("cpu")
    out = []
    for t in range(max(snaps) + 1):
        if t in snaps:
            out.append((tl.obs_batch(state, cfg).numpy(), state.action_mask().numpy(),
                        tl.valid_batch(state).numpy()))
        mask = state.action_mask().numpy().astype(np.float64)
        p = mask / mask.sum(axis=1, keepdims=True)
        a = np.array([rng.choice(mask.shape[1], p=row) for row in p])
        a = np.where(a == state.jobs_pad, state.num_jobs.numpy(), a)
        state, _, stats = tv.step_autoreset(state, torch.from_numpy(a), stats)
    return tuple(np.concatenate(x) for x in zip(*out))


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_checkpoint_logits_match_jax(jx, name):
    """float32: |logits, value - JAX| <= 1e-5 max(1, max|ref|); bfloat16:
    <= 2^-6 max(1, |ref|) elementwise; the -inf positions and the all-dead
    rows identical."""
    path = MODELS / f"{name}.npz"
    params = tck.params_from_flax(path)
    jparams = _jax_params(jx, path)
    obs, mask, valid = _observations(CHECKPOINTS[name][3], CHECKPOINTS[name][2], seed=len(name))
    mask[:3] = False  # all-dead rows
    for dt, jdt in ((torch.float32, jx.jnp.float32), (torch.bfloat16, jx.jnp.bfloat16)):
        cfg = _config(name, dt)
        net = tl.make_model(tv.make_batch(ti.get_instance_set(list(CHECKPOINTS[name][3])), 1, device="cpu"), cfg)
        net.load_state_dict(params)
        with torch.no_grad():
            lg, val = net(torch.from_numpy(obs), torch.from_numpy(mask), torch.from_numpy(valid))
        jlg, jval = _jax_net(jx, name, jdt).apply(jparams, obs, mask, valid)
        jlg, jval, lg, val = np.asarray(jlg), np.asarray(jval), lg.numpy(), val.numpy()
        assert lg.dtype == val.dtype == np.float32
        np.testing.assert_array_equal(np.isneginf(lg), np.isneginf(jlg))
        np.testing.assert_array_equal(np.isneginf(lg), ~mask & mask.any(axis=1, keepdims=True))
        assert (lg[:3] == 0).all() and (jlg[:3] == 0).all()
        fin = np.isfinite(jlg)
        for got, ref in ((lg[fin], jlg[fin]), (val, jval)):
            err = np.abs(got.astype(np.float64) - ref)
            if dt == torch.float32:
                assert err.max() <= 1e-5 * max(1.0, np.abs(ref).max()), (name, err.max())
            else:
                assert (err <= 2.0**-6 * np.maximum(1.0, np.abs(ref))).all(), (name, err.max())


def test_params_round_trip_through_the_jax_loader(jx, tmp_path):
    """port -> flax npz (port's save) -> the JAX package's checkpoint.load ->
    flax net; and back into the port: the same weights and logits."""
    state = tv.make_batch(ti.get_instance_set(["ta01", "ta41"]), 1, device="cpu")
    for cfg in (tl.LearnerConfig(hidden=(32, 48), compute_dtype=torch.float32),
                tl.LearnerConfig(hidden=(32, 32), arch="perjob", features="rich", compute_dtype=torch.float32)):
        ts = tl.init_train_state(3, state, cfg)
        path = tmp_path / f"{cfg.arch}.npz"
        tck.save(str(path), tck.params_to_flax(ts.model))
        flat = tck.load(str(path))
        assert list(flat) == list(tck.params_to_flax(ts.model.state_dict()))
        # the JAX package restores it into its own template unchanged
        if cfg.arch == "perjob":
            jnet = jx.policy.PerJobPolicyNet(hidden=32, depth=2, compute_dtype=jx.jnp.float32)
        else:
            jnet = jx.policy.MaskedPolicyNet(num_actions=31, hidden=(32, 48), compute_dtype=jx.jnp.float32)
        obs, mask, valid = _observations(("ta01", "ta41"), cfg.features, B=8, snaps=(0, 20))
        template = jnet.init(jx.jax.random.key(0), obs[:1], mask[:1], valid[:1])
        jparams = jx.ckpt.load(str(path), template)
        jlg, _ = jnet.apply(jparams, obs, mask, valid)
        back = tl.make_model(state, cfg)
        back.load_state_dict(tck.params_from_flax(str(path)))
        for k, v in ts.model.state_dict().items():
            assert torch.equal(back.state_dict()[k], v), k
        with torch.no_grad():
            lg, _ = back(torch.from_numpy(obs), torch.from_numpy(mask), torch.from_numpy(valid))
        fin = np.isfinite(np.asarray(jlg))
        np.testing.assert_allclose(lg.numpy()[fin], np.asarray(jlg)[fin], rtol=1e-5, atol=1e-5)
        # the nested flax tree is accepted too
        nested = jx.jax.tree.map(np.asarray, jparams)
        assert all(torch.equal(tck.params_from_flax(nested)[k], v) for k, v in ts.model.state_dict().items())


def test_checkpoint_save_is_atomic_and_normalises_the_path(tmp_path, monkeypatch):
    named = {"['a']": np.arange(3, dtype=np.int32), "['b']": torch.ones(2, 2)}
    tck.save(str(tmp_path / "c"), named)
    got = tck.load(str(tmp_path / "c"))
    assert list(got) == list(named) and got["['a']"].tolist() == [0, 1, 2]
    assert got["['b']"].dtype == np.float32
    # a failing write leaves the old file and no temp file
    monkeypatch.setattr(np, "savez_compressed", lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(OSError):
        tck.save(str(tmp_path / "c.npz"), {"['x']": np.zeros(1)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.npz"]
    assert list(tck.load(str(tmp_path / "c.npz"))) == list(named)


def test_params_from_flax_refuses_other_arrays():
    with pytest.raises(ValueError, match="flax Dense"):
        tck.params_from_flax({"['params']['trunk_0']['scale']": np.zeros(3)})
    with pytest.raises(ValueError, match="2-d"):
        tck.params_from_flax({"['params']['trunk_0']['kernel']": np.zeros(3)})
    with pytest.raises(ValueError, match="Dense parameter"):
        tck.params_to_flax({"a.b.weight": torch.zeros(2, 2)})


def test_sample_action_is_legal_and_covers_the_mask():
    g = torch.Generator().manual_seed(0)
    mask = torch.tensor([[True, False, True, False], [False, False, False, True]])
    logits = torch.where(mask, torch.zeros(2, 4), -torch.inf)
    seen = set()
    for _ in range(200):
        a, logp = tp.sample_action(g, logits)
        assert mask[torch.arange(2), a].all()
        assert torch.allclose(logp, torch.log(1.0 / mask.sum(1).float()))
        seen.add(int(a[0]))
    assert seen == {0, 2}


def _jax_greedy_makespan(jx, name, spec_name, max_steps):
    """The JAX package's float32 greedy makespan: its own episode_makespans
    under a float32 net (its evaluate_policy fixes bfloat16)."""
    cfg = jx.learner.LearnerConfig(arch=CHECKPOINTS[name][0], hidden=CHECKPOINTS[name][1],
                                   features=CHECKPOINTS[name][2])
    params = _jax_params(jx, MODELS / f"{name}.npz")
    state = jx.vector.strip_solution(jx.vector.make_batch(jx.inst.get_instance(spec_name), 1))
    net = _jax_net(jx, name, jx.jnp.float32)
    jp = state.jobs_pad

    def policy(rng, s):
        del rng
        from jssenv_tpu.core.state import EnvState

        logits, _ = net.apply(params, jx.learner.obs_batch(s, cfg), jx.jax.vmap(EnvState.action_mask)(s),
                              jx.learner.valid_batch(s))
        a = jx.jnp.argmax(logits, axis=-1).astype(jx.jnp.int32)
        return jx.jnp.where(a == jp, s.num_jobs, a)

    _, ms, _ = jx.vector.episode_makespans(jx.jax.random.key(0), state, max_steps, policy)
    return int(np.asarray(ms)[0])


@pytest.mark.parametrize("name,spec,want", [("ta01_policy_rich", "ta01", 1347), ("ta41_distill", "ta41", 2658)])
def test_float32_greedy_makespan_equals_jax(jx, name, spec, want):
    params = tck.params_from_flax(MODELS / f"{name}.npz")
    got = tl.evaluate_policy(params, ti.get_instance(spec), _config(name, torch.float32), max_steps=4096,
                             device="cpu")
    assert got["greedy_makespan"] == _jax_greedy_makespan(jx, name, spec, 4096) == want


# the JAX package's bounds (tests/test_parallel.py); ta41_distill's is <= 2514
@pytest.mark.parametrize("name,spec,bound", [("ta01_policy", "ta01", 1500), ("ta01_policy_rich", "ta01", 1400),
                                             ("ta41_policy_rich", "ta41", 2499), ("ta_cross_policy", "ta09", 1541),
                                             ("ta41_distill", "ta41", 2515)])
def test_bfloat16_greedy_makespan_meets_the_jax_bound(name, spec, bound):
    params = tck.params_from_flax(MODELS / f"{name}.npz")
    got = tl.evaluate_policy(params, ti.get_instance(spec), _config(name), max_steps=4096, device="cpu")
    assert 0 < got["greedy_makespan"] < bound
    assert got["steps"] >= ti.get_instance(spec).num_jobs * ti.get_instance(spec).num_machines

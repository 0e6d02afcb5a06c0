"""The plain reference against the port's plain twins, at small sizes on
the CPU (a test may call the port; the reference may not)."""

import pytest
import torch

from perfbench import run
from perfbench.lib import compare, manifest
from perfbench.reference import env as ref_env
from perfbench.reference import free as ref_free

PACK = manifest.ROOT / "jssenv_tpu_torch" / "data" / "instances.npz"
TA15 = [f"ta{i:02d}" for i in range(1, 11)]
MIX = TA15 + [f"ta{i:02d}" for i in range(41, 51)]


def _port_batch(names, B):
    from jssenv_tpu_torch import instances, vector

    return vector.make_batch(instances.get_instance_set(names), B, device="cpu")


@pytest.mark.parametrize("names", [TA15, MIX], ids=["ta15x15", "ta15x15-30x20"])
def test_env_steps_like_the_port(names):
    from jssenv_tpu_torch import vector

    B = 24
    port = vector.strip_solution(_port_batch(names, B))
    ref = ref_env.batch(ref_env.load_tables(PACK, names), torch.arange(B), "cpu")
    stats = vector.RolloutStats.zero("cpu")
    g = torch.Generator().manual_seed(3)
    for _ in range(400):
        assert torch.equal(ref_env.action_mask(ref), port.action_mask())
        assert torch.equal(ref_env.observation(ref), port.observation()["real_obs"])
        actions = vector.random_legal_actions(g, port)
        port, tr, stats = vector.step_autoreset(port, actions, stats)
        ref, raw, done = ref_env.step_autoreset(ref, actions)
        assert torch.equal(raw, tr.raw_reward) and torch.equal(done, tr.done)
        for k in ref_env.DYNAMIC:
            assert torch.equal(ref[k].to(torch.int32), getattr(port, k).to(torch.int32)), k
    assert int(stats.episodes) > 0


@pytest.mark.parametrize("names,seed", [(TA15, 0), (MIX, 2**31 + 12345)], ids=["ta15x15", "ta15x15-30x20"])
def test_free_stats_like_the_port(names, seed):
    from jssenv_tpu_torch.core import fused_rollout

    B, T = 12, 320
    port = fused_rollout.rollout_free(_port_batch(names, B), T, seed=seed)
    ref = ref_free.stats(ref_env.batch(ref_env.load_tables(PACK, names), torch.arange(B), "cpu"), T, seed)
    assert ref["episodes"] > 0
    for k in ("episodes", "total_makespan", "min_makespan", "identity_violations"):
        assert ref[k] == int(port[k]), k
    assert ref["total_return"] == pytest.approx(float(port["total_return"]), rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("names,store", [(TA15, None), (MIX, None), (MIX, torch.int8)],
                         ids=["ta15x15", "ta15x15-30x20", "ta15x15-30x20-int8"])
def test_free_stats_replayed_on_card_like_the_loop(names, store):
    """On a card the reference's steps replay one captured step: the same
    summary as the eager loop on the CPU, and the batch handed in unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    B, T, seed = 64, 300, 2**31 + 4321
    tables = ref_env.load_tables(PACK, names)
    s = ref_env.batch(tables, torch.arange(B), torch.device("cuda"))
    before = {k: v.clone() for k, v in s.items()}
    card = ref_free.stats(s, T, seed, store_dtype=store)
    cpu = ref_free.stats(ref_env.batch(tables, torch.arange(B), "cpu"), T, seed, store_dtype=store)
    assert cpu["episodes"] > 0
    for k in ("episodes", "total_makespan", "min_makespan", "identity_violations"):
        assert card[k] == cpu[k], k
    assert card["total_return"] == pytest.approx(cpu["total_return"], rel=1e-6)
    assert all(torch.equal(before[k], v) for k, v in s.items())


def test_philox_words_like_the_port():
    from jssenv_tpu_torch.core import fused_rollout

    for seed, t, off in [(0, 0, 0), (2**40 + 7, 1000, 5), (2**64 - 1, 2**32 - 1, 2**31)]:
        assert torch.equal(ref_free.philox_word(seed, t, 64, "cpu", off),
                           fused_rollout.philox_bits(seed, t, 64, "cpu", off))


def test_learner_like_the_port_in_float32():
    """The port's learner computing in float32 agrees with the reference to
    float32 rounding: the bfloat16 gap the check allows is bfloat16's."""
    man = manifest.load()
    cell = manifest.workload(man, "ta15x15.train")
    cfg, traffic = manifest.config(man, "ta15x15"), manifest.traffic("train")
    cfg["batch"] = {"train": 16}
    cfg["learner"].update(unroll_steps=8, compute_dtype="float32")
    res = run.execute(cell, cfg, traffic, 2**33 + 1, 0.0, False, torch.device("cpu"))
    checks = {name: value for name, value, _ in res.checks}
    assert checks["env_mismatches"] == 0
    assert checks["loss_rel_gap"] < 1e-5
    assert checks["grad_norm_gap"] < 1e-5
    assert checks["update_norm_gap"] < 1e-4
    assert checks["logit_rel_gap"] < 1e-5


TA30X20 = [f"ta{i:02d}" for i in range(41, 51)]
PERJOB = dict(arch="perjob", features="rich", hidden=[128, 128])


def _perjob_config(names, **learner):
    """``ta15x15``'s configuration with the per-job net on rich features over
    ``names``: configuration keys alone, the harness unchanged."""
    man = manifest.load()
    cfg = manifest.config(man, "ta15x15")
    cfg.update(name="perjob", instances=list(names))
    cfg["learner"].update(PERJOB, **learner)
    return manifest.workload(man, "ta15x15.train"), cfg, manifest.traffic("train")


def _mid_episode(names, B, steps, seed):
    """The port's batch and the reference's, ``steps`` random legal steps in
    (episodes end and restart on the way)."""
    from jssenv_tpu_torch import vector

    port = vector.strip_solution(_port_batch(names, B))
    ref = ref_env.batch(ref_env.load_tables(PACK, names), torch.arange(B), "cpu")
    stats, g = vector.RolloutStats.zero("cpu"), torch.Generator().manual_seed(seed)
    for _ in range(steps):
        actions = vector.random_legal_actions(g, port)
        port, _, stats = vector.step_autoreset(port, actions, stats)
        ref, _, _ = ref_env.step_autoreset(ref, actions)
    return port, ref


@pytest.mark.parametrize("names", [TA30X20, MIX], ids=["ta30x20", "ta15x15-30x20"])
def test_rich_observation_like_the_port(names):
    """The reference's 13 rich columns equal the learner's ``obs_batch`` to
    1e-6, on fresh and mid-episode states, padded rows included."""
    from jssenv_tpu_torch import vector
    from jssenv_tpu_torch.parallel import learner

    config = learner.LearnerConfig(features="rich")
    port, ref = _mid_episode(names, 24, 0, 5)
    stats, g = vector.RolloutStats.zero("cpu"), torch.Generator().manual_seed(11)
    seen = 0
    for step in range(700):
        if step % 7 == 0:
            got = ref_env.rich_observation(ref)
            assert got.shape == (24, 30, 13)
            torch.testing.assert_close(got, learner.obs_batch(port, config), rtol=0, atol=1e-6)
            seen += int((got[..., 7:] != 0).any(dim=-1).sum())
        actions = vector.random_legal_actions(g, port)
        port, _, stats = vector.step_autoreset(port, actions, stats)
        ref, _, _ = ref_env.step_autoreset(ref, actions)
    assert int(stats.episodes) > 0 and seen > 0


@pytest.mark.parametrize("names", [TA30X20, MIX], ids=["ta30x20", "ta15x15-30x20"])
@pytest.mark.parametrize("biases", [False, True], ids=["harness", "biased"])
def test_perjob_forward_like_the_port(names, biases):
    """The reference's per-job net on the harness's weights matches
    ``PerJobPolicyNet`` loaded with them (``init_train_state(params=...)``)
    at float32 compute within 1e-5, on every job row's score (padded rows
    included, under a mask that keeps every action) and under the env's
    mask. ``biased``: every bias drawn too, so that padded rows embed to
    something other than 0 and a pool that took them in would show."""
    from jssenv_tpu_torch.parallel import learner
    from perfbench.lib import weights
    from perfbench.reference import learner as ref_learner

    port, ref = _mid_episode(names, 24, 150, 7)
    params = weights.make(2**31 + 5, 30, 13, PERJOB["hidden"], "cpu", "perjob")
    if biases:
        g = torch.Generator().manual_seed(3)
        params = {k: torch.randn(v.shape, generator=g) * 0.5 if k.endswith("bias") else v for k, v in params.items()}
    config = learner.LearnerConfig(arch="perjob", features="rich", hidden=(128, 128), compute_dtype=torch.float32)
    net = learner.init_train_state(1, port, config, params=params).model
    obs, valid = learner.obs_batch(port, config), learner.valid_batch(port)
    assert bool(valid.all()) == (names == TA30X20)
    for mask in (torch.ones_like(port.action_mask()), port.action_mask()):
        with torch.no_grad():
            want_logits, want_value = net(obs, mask, valid)
        logits, value = ref_learner.forward(params, ref_env.rich_observation(ref), mask, ref_env.job_valid(ref), PERJOB)
        torch.testing.assert_close(logits, want_logits, rtol=0, atol=1e-5)
        torch.testing.assert_close(value, want_value, rtol=0, atol=1e-5)


@pytest.mark.parametrize("names", [TA30X20, MIX], ids=["ta30x20", "ta15x15-30x20"])
def test_perjob_learner_like_the_port_in_float32(names):
    """A per-job REINFORCE configuration on rich features, set by
    configuration keys alone, runs through the harness; the port's learner
    computing in float32 agrees with the reference (loss, first gradient,
    parameters after the updates, logits) to float32 rounding, over two
    T-chunks on both sides."""
    cell, cfg, traffic = _perjob_config(names, unroll_steps=8, loss_chunks=2, compute_dtype="float32")
    cfg["batch"] = {"train": 16}
    res = run.execute(cell, cfg, traffic, 2**33 + 3, 0.0, False, torch.device("cpu"))
    checks = {name: value for name, value, _ in res.checks}
    assert checks["env_mismatches"] == 0
    assert checks["loss_rel_gap"] < 1e-5
    assert checks["grad_norm_gap"] < 1e-5
    assert checks["update_norm_gap"] < 1e-4
    assert checks["logit_rel_gap"] < 1e-5


def _random_steps(ref, T, seed):
    """One update's records of ``T`` uniform legal steps from ``ref``, as
    the harness records a program's: the mask before the step, the action
    ids, the raw rewards and the ends."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(T):
        mask = ref_env.action_mask(ref)
        idx = torch.multinomial(torch.where(mask.any(dim=1, keepdim=True), mask, True).float(), 1, generator=g)[:, 0]
        actions = torch.where(idx == mask.shape[1] - 1, ref["num_jobs"], idx.to(torch.int32))
        nxt, raw, done = ref_env.step_autoreset(ref, actions)
        out.append({"mask": mask, "actions": actions, "raw": raw, "done": done})
        ref = nxt
    return out


@pytest.mark.parametrize("arch", ["flat", "perjob"])
def test_chunked_reference_loss_equals_one_shot(arch):
    """The reference's loss and gradient summed over T-chunks, each its
    share of the update's means, equal the one-shot ones to float32
    rounding; so do the parameters after two updates."""
    from perfbench.lib import weights
    from perfbench.reference import learner as ref_learner

    cfg = _perjob_config(MIX)[1]["learner"]
    if arch == "flat":
        cfg.update(arch="flat", features="reference", hidden=[64, 64])
    C = ref_env.features(cfg["features"])[0]
    start = ref_env.batch(ref_env.load_tables(PACK, MIX), torch.arange(12), "cpu")
    steps = [_random_steps(start, 8, 1)]
    steps.append(_random_steps(ref_learner.follow(start, weights.make(9, 30, C, cfg["hidden"], "cpu", arch), steps,
                                                  cfg)["state"], 8, 2))
    params = weights.make(9, 30, C, cfg["hidden"], "cpu", arch)
    one = ref_learner.follow(start, dict(params), steps, {**cfg, "loss_chunks": 1})
    four = ref_learner.follow(start, dict(params), steps, {**cfg, "loss_chunks": 4})
    assert one["mismatches"] == four["mismatches"] == 0
    assert four["losses"] == pytest.approx(one["losses"], rel=1e-5)
    torch.testing.assert_close(four["logits"], one["logits"], rtol=0, atol=1e-6)
    for k in params:
        scale = float(one["grads"][k].norm()) + 1e-12
        assert float((four["grads"][k] - one["grads"][k]).norm()) <= 1e-5 * scale, k
    delta = lambda p: {k: p[k] - params[k] for k in params}  # noqa: E731
    assert max(compare.leaf_gaps(delta(four["params"]), delta(one["params"]))) < 1e-4


@pytest.mark.parametrize("key,value", [("arch", "conv"), ("features", "raw")])
def test_unknown_net_or_features_is_named(key, value):
    cell, cfg, traffic = _perjob_config(TA30X20, **{key: value})
    with pytest.raises(ValueError, match=f"unknown .*'{value}'"):
        run.execute(cell, cfg, traffic, 1, 0.0, False, torch.device("cpu"))

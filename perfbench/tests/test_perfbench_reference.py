"""The plain reference against the port's plain twins, at small sizes on
the CPU (a test may call the port; the reference may not)."""

import pytest
import torch

from perfbench import run
from perfbench.lib import manifest
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

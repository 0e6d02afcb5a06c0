"""The port's Gym wrappers (``jssenv_tpu_torch.envs``), registry and config
utilities, against the JAX package's.

A ta01 SPT episode runs through four wrappers at once — the port's
``"native"`` and ``"torch"`` engines and the JAX package's ``"native"`` and
``"jax"`` engines. After every step every public attribute of the port's
wrappers must equal the JAX native wrapper's (the float observation to 1e-6,
everything else exactly); the JAX engine's wrapper, whose host attributes
are slow to derive, is compared after reset and at the episode's end."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
gym = pytest.importorskip("gymnasium")

import jssenv_tpu  # noqa: E402,F401 - registers jss-v1
from jssenv_tpu.envs.gym_env import JssEnv as JaxEnv  # noqa: E402
from jssenv_tpu.envs.vec_env import JssVectorEnv as JaxVectorEnv  # noqa: E402
from jssenv_tpu.rules import dispatching as jd  # noqa: E402

import jssenv_tpu_torch  # noqa: E402 - registers jss-torch-v1
from jssenv_tpu_torch import native, replay  # noqa: E402
from jssenv_tpu_torch.envs import gym_env as tg  # noqa: E402
from jssenv_tpu_torch.envs.vec_env import JssVectorEnv  # noqa: E402
from jssenv_tpu_torch.rules import dispatching as td  # noqa: E402
from jssenv_tpu_torch.utils import RunSettings, assign_env_config, create_env  # noqa: E402

torch.set_num_threads(1)

# colors are random and start_timestamp is the wall clock, in both packages
COMPARED = [a for a in tg.PUBLIC_ATTRIBUTES if a not in ("colors", "start_timestamp")]


@pytest.fixture(scope="module", autouse=True)
def _needs_compiler():
    if native.load() is None:
        pytest.skip("native engine unavailable (no g++)")


def _torch_env(engine, **cfg):
    return tg.JssEnv({"instance_path": "ta01", "engine": engine, "device": "cpu", **cfg})


def _same_attributes(got, want, ctx):
    for name in COMPARED:
        a, b = getattr(got, name), getattr(want, name)
        if name == "state":
            assert a.dtype == b.dtype, f"{ctx}: {name}"
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f"{ctx}: {name}")
        elif isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f"{ctx}: {name}"
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: {name}")
        else:
            assert type(a) is type(b) and a == b, f"{ctx}: {name} {a!r} != {b!r}"
    assert len(got.colors) == len(want.colors) == got.machines


def test_spt_episode_attributes_equal_jax_on_both_engines():
    envs = {
        "torch-native": _torch_env("native"),
        "torch-torch": _torch_env("torch"),
        "jax-native": JaxEnv({"instance_path": "ta01", "engine": "native"}),
        "jax-jax": JaxEnv({"instance_path": "ta01", "engine": "jax"}),
    }
    assert [e.uses_native_engine for e in envs.values()] == [True, False, True, False]
    obs = {k: e.reset() for k, e in envs.items()}
    ref = envs["jax-native"]
    for k, e in envs.items():
        _same_attributes(e, ref, f"reset {k}")
        np.testing.assert_array_equal(obs[k]["action_mask"], obs["jax-native"]["action_mask"])
    t_rule, j_rule = td.get_rule("SPT"), jd.get_rule("SPT")
    done, i = False, 0
    while not done:
        acts = {k: (t_rule if k.startswith("torch") else j_rule)(e) for k, e in envs.items()}
        assert len(set(acts.values())) == 1, f"step {i}: {acts}"
        out = {k: e.step(acts[k]) for k, e in envs.items()}
        want = out["jax-native"]
        for k, (o, r, d, trunc, info) in out.items():
            assert (r, d, trunc, info) == want[1:], f"step {i} {k}"
            np.testing.assert_array_equal(o["action_mask"], want[0]["action_mask"])
            np.testing.assert_allclose(o["real_obs"], want[0]["real_obs"], atol=1e-6, rtol=0)
        for k in ("torch-native", "torch-torch"):
            _same_attributes(envs[k], ref, f"step {i} {k}")
        done = want[2]
        i += 1
        assert i < 5000
    for k, e in envs.items():
        _same_attributes(e, ref, f"end {k}")
    assert ref.last_time_step == ref.current_time_step >= 1231


def test_engine_selection_and_engine_state():
    default = tg.JssEnv({"instance_path": "ta01", "device": "cpu"})
    assert not default.uses_native_engine and default.engine_state.device.type == "cpu"
    assert _torch_env("auto").uses_native_engine  # the JAX package's default meaning
    assert RunSettings().engine == "torch"
    with pytest.raises(ValueError, match="engine"):
        _torch_env("jax")
    env_n, env_t = _torch_env("native"), _torch_env("torch")
    rng = np.random.default_rng(5)
    env_n.reset(), env_t.reset()
    for _ in range(70):
        mask = env_t.get_legal_actions().astype(np.float64)
        a = int(rng.choice(len(mask), p=mask / mask.sum()))
        env_n.step(a), env_t.step(a)
    # native buffers -> an EnvState whose derived attributes are the torch env's
    mirror = _torch_env("torch")
    mirror.engine_state = env_n.engine_state
    _same_attributes(mirror, env_t, "engine_state round trip")
    assert mirror.engine_state.device.type == "cpu" and mirror.engine_state.batch_size == 1
    with pytest.raises(AttributeError):
        env_n.engine_state = env_t.engine_state
    # increase_time_step on both engines
    while env_t.next_time_step:
        assert env_n.increase_time_step() == env_t.increase_time_step()
        _same_attributes(env_n, env_t, "advance")


def test_rules_on_wrapper_both_engines():
    for name in sorted(td.DISPATCHING_RULES):
        rule = td.get_rule(name)
        ms = {e: rule.run_episode(_torch_env(e)) for e in ("native", "torch")}
        assert ms["native"] == ms["torch"], name
    env = _torch_env("native")
    res = td.compare_rules(env, rules=["SPT", "LOR"], num_episodes=1)
    assert res["SPT"]["avg_makespan"] == td.get_rule("SPT").run_episode(env)[1]
    # the seeded exploration coin: one stream, the same on both engines
    runs = [td.get_rule("SPT").run_episode(_torch_env(e, rule_seed=7))
            for e in ("native", "torch", "native")]
    assert runs[0] == runs[1] == runs[2]


def test_golden_replay_through_wrapper_and_render():
    import json
    import pathlib

    entry = json.loads((pathlib.Path(__file__).parent / "data" / "golden_solutions.json")
                       .read_text())["ta01"]
    env = _torch_env("torch")
    env.reset()
    mk, st = replay.replay_machine_order(env.engine_state, entry["machine_order"])
    env.engine_state = st
    assert mk == env.current_time_step == entry["optimum"]
    assert env.render() is not None
    assert _torch_env("native").render() is None  # nothing scheduled yet


def test_vector_env_matches_jax():
    B = 4
    env = JssVectorEnv(jssenv_tpu_torch.instances.random_instance(6, 5, (1, 9), seed=3), B,
                       device="cpu")
    ref = JaxVectorEnv(jssenv_tpu.instances.random_instance(6, 5, (1, 9), seed=3), B)
    o, r = env.reset(), ref.reset()
    rng = np.random.default_rng(0)
    finished = 0
    for i in range(80):
        mask = o["action_mask"]
        np.testing.assert_array_equal(mask, r["action_mask"])
        acts = np.array([rng.choice(np.flatnonzero(m)) for m in mask])
        o, rew, done, info = env.step(acts)
        r, rew_j, done_j, info_j = ref.step(acts)
        np.testing.assert_allclose(o["real_obs"], r["real_obs"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(rew, rew_j)
        np.testing.assert_array_equal(done, done_j)
        for k in info_j:
            np.testing.assert_array_equal(info[k], info_j[k], err_msg=f"step {i}: {k}")
        finished += int(done.sum())
    assert finished >= B  # every lane crossed an episode end and was reset
    assert env.sample_legal_actions(3).shape == (B,)
    lazy = JssVectorEnv("ta01", 2, to_numpy=False, device="cpu")
    assert isinstance(lazy.reset()["action_mask"], torch.Tensor)


def test_registry_and_config_utils():
    assert "jss-torch-v1" in gym.registry and "jss-v1" in gym.registry
    env = gym.make("jss-torch-v1", env_config={"instance_path": "ta01", "engine": "native"})
    assert isinstance(env.unwrapped, tg.JssEnv)
    assert create_env("jss-torch-v1") is tg.JssEnv
    assert create_env({"env": "jss-torch-vec-v1"}) is JssVectorEnv
    with pytest.raises(NotImplementedError):
        create_env("jss-v1")  # the JAX package's id is not the port's

    class Obj:
        pass

    o = Obj()
    o.x = 1
    o.env_config = {"x": "5", "y": [1, 2]}
    assign_env_config(o, {"z": 3})
    assert o.z == 3 and o.x == 5 and o.y == [1, 2]
    rs = RunSettings.from_mapping({"instance": "ta02", "engine": "torch", "rule_seed": 4, "junk": 1})
    assert rs.env_config() == {"instance_path": "ta02", "engine": "torch", "rule_seed": 4}


def test_torch_engine_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.JssEnv({"instance_path": "ta01", "engine": "torch"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.JssEnv({"instance_path": "ta01"})  # the default engine is the torch one, on the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gym.make("jss-torch-v1", env_config={"instance_path": "ta01"})
    env = tg.JssEnv({"instance_path": "ta01", "engine": "native"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        env.engine_state  # noqa: B018 - built on the card by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JssVectorEnv("ta01", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay.replay_machine_order(jssenv_tpu_torch.get_instance("ta01"), [[0]] * 15)

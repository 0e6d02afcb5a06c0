"""The port's native C++ engine (``jssenv_tpu_torch.native``): stepwise
against the port's torch engine, its build location, and a golden replay
through the raw engine."""

import json
import pathlib

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import native
from jssenv_tpu_torch.core import engine as te

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "data" / "golden_solutions.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _needs_compiler():
    if native.load() is None:
        pytest.skip("native engine unavailable (no g++)")


def _same(ne, state, ctx):
    """Every native buffer equals the one-lane torch state (obs to 1e-6)."""
    s = {k: v[0].numpy() for k, v in vars(state).items()}
    assert ne.time == int(s["time"]), ctx
    assert ne.nb_legal == int(s["nb_legal"]), ctx
    assert ne.nb_machine_legal == int(s["nb_machine_legal"]), ctx
    assert ne.noop_legal == bool(s["noop_legal"]), ctx
    pairs = {
        "legal": (ne.legal.astype(bool), s["legal"]),
        "machine_legal": (ne.machine_legal.astype(bool), s["machine_legal"]),
        "mbf": (ne.machine_busy_for, s["machine_busy_for"]),
        "jbf": (ne.job_busy_for, s["job_busy_for"]),
        "next_op": (ne.next_op, s["next_op"]),
        "work_done": (ne.work_done, s["work_done"]),
        "needed": (ne.needed_machine, s["needed_machine"]),
        "idle_total": (ne.idle_total, state.idle_total[0].numpy()),
        "idle_since": (ne.idle_since_op, state.idle_since_op[0].numpy()),
        "pin": (ne.pin.astype(bool), state.pin[0].numpy()),
        "noop_pin": (ne.noop_pin.astype(bool), s["noop_pin"]),
        "solution": (ne.solution, s["solution"]),
    }
    for key, (a, b) in pairs.items():
        assert np.array_equal(a, b), f"{ctx}: {key}"
    np.testing.assert_allclose(ne.obs, state.obs[0].numpy(), atol=1e-6, rtol=0, err_msg=f"{ctx}: obs")


@pytest.mark.parametrize("name,seed", [("ta01", 0), ("ta41", 1)])
def test_native_vs_torch_stepwise(name, seed):
    spec = ti.get_instance(name)
    ne = native.NativeEngine(spec.op_machine, spec.op_dur)
    state = te.state_from_spec(spec, device="cpu")
    rng = np.random.default_rng(seed)
    _same(ne, state, "reset")
    done, i = False, 0
    while not done:
        mask = np.concatenate([ne.legal.astype(bool), [ne.noop_legal]])
        a = int(rng.choice(len(mask), p=mask / mask.sum()))
        raw_n, done_n = ne.step(a)
        state, tr = te.step(state, torch.tensor([a], dtype=torch.int32))
        assert raw_n == int(tr.raw_reward[0]), f"step {i}: reward"
        assert np.float32(raw_n) / np.float32(ne.max_time_op) == tr.reward[0].item(), f"step {i}"
        assert done_n == bool(tr.done[0]), f"step {i}: done"
        done = done_n
        _same(ne, state, f"step {i}")
        i += 1
        assert i < 5000
    assert ne.time >= spec.lower_bound()


def test_native_advance_time_matches_torch():
    spec = ti.random_instance(6, 5, (1, 9), seed=4)
    ne = native.NativeEngine(spec.op_machine, spec.op_dur)
    state = te.state_from_spec(spec, device="cpu")
    for a in (0, 1, 2):
        ne.step(a)
        state, _ = te.step(state, torch.tensor([a], dtype=torch.int32))
    for _ in range(3):
        holes = ne.advance_time()
        state, th = te.advance_time(state)
        assert holes == int(th[0])
        _same(ne, state, "advance")


def test_native_builds_into_the_port_build_dir():
    path = native.library_path()
    assert path.parent == ROOT / "jssenv_tpu_torch" / "build" and path.exists()
    assert not list((ROOT / "jssenv_tpu_torch" / "native").glob("*.so"))
    src = (ROOT / "jssenv_tpu_torch" / "native" / "jss_engine.cpp").read_text()
    ref = (ROOT / "jssenv_tpu" / "native" / "jss_engine.cpp").read_text()
    body = lambda s: s[s.index("#include"):]  # noqa: E731 - past the header comment
    assert body(src) == body(ref)


def test_native_golden_replay_and_reset():
    entry = GOLDEN["ta01"]
    spec = ti.get_instance("ta01")
    ne = native.NativeEngine(spec.op_machine, spec.op_dur)
    seq, idx, done = entry["machine_order"], [0] * spec.num_machines, False
    while not done:
        acted = False
        for m in range(spec.num_machines):
            if done:
                break
            if ne.machine_legal[m] and idx[m] < spec.num_jobs:
                a = seq[m][idx[m]]
                if ne.needed_machine[a] == m and ne.legal[a]:
                    _, done = ne.step(a)
                    idx[m] += 1
                    acted = True
        if not acted and not done:
            assert ne.advance_time() >= 0
    assert ne.time == entry["optimum"]
    ne.reset()
    assert ne.time == 0 and ne.nb_legal == spec.num_jobs

"""The observation kernel, ``csrc/observe.cu``, and ``fused_rollout.observe``.

On the CPU the kernel's device part is compiled as C++ against the CUDA shim
of ``test_torch_kernel_shim`` (``SHIM``: every CUDA thread a fiber of one host
thread) and launched on the pointers ``fused_rollout._observe_inputs`` hands
the card's launch, in its order. Each case holds the three outputs (``obs``,
``mask``, ``valid``) bit for bit against the plain expressions
(``EnvState.observation()["real_obs"]``, ``action_mask()``, ``job_valid``)
and against the JAX package's (``jssenv_tpu/core/state.py``: the same
expressions of its ``EnvState``, per lane under ``jax.vmap``, on the same
fields): fresh states, states a few hundred driven steps into an episode
(running jobs, no-op pins, finished jobs, busy machines), padded and
mixed-shape batches, a light state, and states of random integers
(differences and sums that wrap, rows past ``num_jobs``, every lane's
divisors its own). Then ``observe`` on a CPU state: the plain expressions,
and no launch.

On the card (``cuda``, skipped without one): ``observe`` against the plain
expressions on the same states (which the CPU cases hold against the JAX
package; the card's machine has no JAX), ``_policy_rollout`` against the
plain inputs from the same generator seed, and the launches a
``learner.rollout`` span counts."""

import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from jssenv_tpu_torch import diagnostics  # noqa: E402
from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import fused_rollout as fr  # noqa: E402
from jssenv_tpu_torch.core import state as ts  # noqa: E402
from jssenv_tpu_torch.parallel import learner as tl  # noqa: E402
from test_torch_free_static import driven_start  # noqa: E402
from test_torch_kernel_shim import CSRC, SHIM  # noqa: E402

ENTRY = r"""
extern "C" int shim_observe(const void* const* p, int B, int J) {
  const ObserveIO io{(const uint8_t*)p[0], (const uint8_t*)p[1], (const int*)p[2], (const int*)p[3],
                     (const int*)p[4], (const int*)p[5], (const int*)p[6], (const int*)p[7], (const int*)p[8],
                     (const int*)p[9], (const int*)p[10], (const int*)p[11], (const int*)p[12],
                     (const int*)p[13], (const int*)p[14], (const int*)p[15], (float*)p[16], (uint8_t*)p[17],
                     (uint8_t*)p[18], B, J};
  const long long threads = (long long)B * (J + 1);
  launch((int)((threads + kObserveThreads - 1) / kObserveThreads), kObserveThreads, [=] { observe_kernel(io); });
  return 0;
}
"""


def _mixed(*names):
    return lambda: ti.get_instance_set(list(names))


def _random_shapes():
    return ti.stack_instances([ti.random_instance(100, 3, (1, 9), seed=20), ti.random_instance(2, 40, (1, 9),
                                                                                                seed=21)])


# case -> (instance source, B, driven steps before it (0: fresh), their seed,
# light)
CASES = {
    "ta01": (lambda: ti.get_instance("ta01"), 8, 0, 0, False),
    "ta01-mid": (lambda: ti.get_instance("ta01"), 8, 150, 0, False),
    "ta01-light-mid": (lambda: ti.get_instance("ta01"), 8, 235, 1, True),
    "ta01-ta10-mid": (lambda: ti.get_instance_set([f"ta{i:02d}" for i in range(1, 11)]), 10, 180, 2, True),
    "ta41-mid": (lambda: ti.get_instance("ta41"), 4, 450, 3, False),
    "rand6x5-mid": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 8, 47, 4, False),
    "ta01+ta11": (_mixed("ta01", "ta11"), 8, 0, 0, False),
    "ta01+ta11-mid": (_mixed("ta01", "ta11"), 8, 150, 5, True),
    "ta01+ta41": (_mixed("ta01", "ta41"), 4, 0, 0, False),
    "ta01+ta41-mid": (_mixed("ta01", "ta41"), 4, 250, 6, False),
    "mix100x3+2x40-mid": (_random_shapes, 4, 160, 7, True),
}
# case -> seed of a state of random integers on ta01+ta41's shapes
RANDOM = {"random-0": 0, "random-1": 1, "random-2": 2}


def case_state(case):
    """The case's state, on the CPU."""
    if case in RANDOM:
        return random_state(RANDOM[case])
    src, B, steps, seed, light = CASES[case]
    state = tv.make_batch(src(), B, device="cpu")
    if steps:
        state = driven_start(state, steps, seed)
    return tv.strip_solution(state) if light else state


def random_state(seed):
    """A ta01+ta41 batch whose every field ``observe`` reads holds random
    values: job rows of the whole int32 range (so ``time - op_end_at`` and
    ``idle_total_alloc + span`` wrap), random masks, ``needed_machine`` -1
    on about a fifth of the jobs, ``num_jobs`` from -1 to J + 1 and nonzero
    divisors of either sign."""
    state = tv.make_batch(ti.get_instance_set(["ta01", "ta41"]), 6, device="cpu")
    B, J, M = state.batch_size, state.jobs_pad, state.machines_pad
    g = torch.Generator().manual_seed(seed)

    def ints(shape, lo=-(2**31), hi=2**31 - 1):
        return torch.randint(lo, hi, shape, dtype=torch.int32, generator=g)

    def divisor():
        d = ints((B,), -(2**20), 2**20)
        return torch.where(d == 0, 7, d)

    needed = ints((B, J), 0, M)
    needed = torch.where(ints((B, J), 0, 5) == 0, -1, needed)
    return state.replace(
        legal=ints((B, J), 0, 2).bool(), noop_legal=ints((B,), 0, 2).bool(), needed_machine=needed,
        time=ints((B,)), num_jobs=ints((B,), -1, J + 2), num_machines=divisor(), max_time_op=divisor(),
        max_time_jobs=divisor(), sum_op=divisor(),
        next_op=torch.where(ints((B, J), 0, 3) == 0, ints((B, J), 0, M + 2), ints((B, J))),
        job_busy_for=torch.where(ints((B, J), 0, 2) == 0, 0, ints((B, J))),
        **{f: ints((B, J)) for f in ("work_done", "wait4", "op_end_at", "idle_frozen", "idle_total_alloc")})


def _plain(state):
    return state.observation()["real_obs"], state.action_mask(), state.job_valid


def _assert_bit_equal(got, want, tag):
    names = ("obs", "mask", "valid")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{tag}: {name} {g.dtype} {g.shape} != {w.dtype} {w.shape}"
        if g.dtype == torch.float32:  # bit for bit, -0.0 too
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g.cpu(), w.cpu()), f"{tag}: {name} differs at {(g.cpu() != w.cpu()).nonzero()[:8].tolist()}"


@pytest.fixture(scope="module")
def jax_inputs():
    """state -> the JAX package's (``observation()["real_obs"]``,
    ``action_mask()``, ``job_valid``) of the same fields, as CPU tensors."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")  # the JAX package needs both
    from jssenv_tpu.core.state import EnvState as JaxEnvState

    @jax.jit
    def derived(js):
        return jax.vmap(lambda s: (s.observation()["real_obs"], s.action_mask(), s.job_valid))(js)

    def inputs(state):
        js = JaxEnvState(**{k: jax.numpy.asarray(v) for k, v in ts.to_numpy(state).items()})
        return tuple(torch.from_numpy(np.array(x)) for x in derived(js))

    return inputs


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("observe_shim")
    (d / "shim.h").write_text(SHIM)
    text = (CSRC / "observe.cu").read_text().split("// ---- host side")[0]
    cpp, lib = d / "observe.cpp", d / "libobserve.so"
    cpp.write_text(text.replace("#include <cuda_runtime.h>", '#include "shim.h"') + ENTRY)
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-o", str(lib), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
    fn = ctypes.CDLL(str(lib)).shim_observe
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn


def _run_shim(fn, state):
    """The kernel's outputs on the wrapper's inputs, in fresh tensors filled
    with a byte pattern, so a value the kernel leaves unwritten shows."""
    B, J = state.batch_size, state.jobs_pad
    obs = torch.full((B, J, 7), float("nan"), dtype=torch.float32)
    mask = torch.full((B, J + 1), 0xAB, dtype=torch.uint8)
    valid = torch.full((B, J), 0xAB, dtype=torch.uint8)
    tensors = [*fr._observe_inputs(state), obs, mask, valid]
    ptrs = [t.data_ptr() for t in tensors]
    fn((ctypes.c_void_p * len(ptrs))(*ptrs), B, J)
    assert int(mask.max()) <= 1 and int(valid.max()) <= 1, "a mask byte other than 0 and 1"
    return obs, mask.view(torch.bool), valid.view(torch.bool)


@pytest.mark.parametrize("case", [*CASES, *RANDOM])
def test_observe_kernel_source_matches_plain_expressions_on_cpu(shim_lib, case):
    state = case_state(case)
    before = {k: v.clone() for k, v in state.dynamic_fields().items()}
    _assert_bit_equal(_run_shim(shim_lib, state), _plain(state), case)
    assert all(torch.equal(getattr(state, k), v) for k, v in before.items()), f"{case}: the input changed"


@pytest.mark.parametrize("case", [*CASES, *RANDOM])
def test_observe_kernel_source_matches_jax_on_cpu(shim_lib, jax_inputs, case):
    """The kernel and the port's plain expressions, each against the JAX
    package's on the same fields."""
    state = case_state(case)
    want = jax_inputs(state)
    _assert_bit_equal(_run_shim(shim_lib, state), want, f"{case} (kernel vs JAX)")
    _assert_bit_equal(_plain(state), want, f"{case} (plain vs JAX)")


def test_the_cases_meet_what_the_columns_branch_on():
    """Between them the states hold running, waiting and finished jobs,
    padded rows, legal jobs and no-op pins, and random states wrap."""
    states = [case_state(c) for c in CASES]
    assert any(bool((s.job_busy_for > 0).any()) for s in states)
    assert any(bool((s.needed_machine == -1).any()) for s in states)
    assert any(bool((s.next_op >= s.num_machines[:, None]).any()) for s in states)
    assert any(bool((~s.job_valid).any()) for s in states)
    assert any(bool(s.noop_pin.any()) for s in states)
    assert any(bool(s.legal.any()) for s in states)
    s = case_state("random-0")
    wide = s.time[:, None].to(torch.int64) - s.op_end_at.to(torch.int64)
    assert bool(((wide > 2**31 - 1) | (wide < -(2**31))).any())


def test_observe_on_a_cpu_state_is_the_plain_expressions_and_launches_nothing():
    state = case_state("ta01+ta11-mid")
    before = dict(fr.LAUNCHES)
    got = fr.observe(state)
    assert fr.LAUNCHES == before
    _assert_bit_equal(got, _plain(state), "cpu")


@pytest.mark.parametrize("features", ["reference", "rich"])
def test_policy_inputs_follow_the_features_on_cpu(features):
    """Reference features: ``observe``; rich: ``obs_batch``, the mask and
    the valid rows, as before."""
    cfg = tl.LearnerConfig(features=features)
    state = case_state("ta01-mid")
    want = (tl.obs_batch(state, cfg), state.action_mask(), tl.valid_batch(state))
    _assert_bit_equal(tl.policy_inputs(state, cfg), want, features)
    assert want[0].shape[-1] == (7 if features == "reference" else 13)


def test_observe_refuses_a_field_of_another_shape():
    state = case_state("ta01")
    with pytest.raises(ValueError, match="wait4"):
        fr._observe_inputs(state.replace(wait4=state.wait4[:, :-1]))


def test_observe_takes_transposed_fields_as_contiguous_copies():
    state = case_state("ta01-mid")
    t = state.next_op.t().contiguous().t()  # the (B, J) values, column-major
    inputs = fr._observe_inputs(state.replace(next_op=t, num_jobs=state.num_jobs.to(torch.int64)))
    assert all(x.is_contiguous() for x in inputs)
    assert torch.equal(inputs[3], state.next_op) and inputs[11].dtype == torch.int32
    assert inputs[2] is state.job_busy_for  # a field as it is when it fits


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, *RANDOM])
def test_observe_matches_plain_expressions_on_card(cuda_dev, case):
    """One launch, bit-equal to the plain expressions on the card and on the
    CPU."""
    state = case_state(case)
    card = ts.from_numpy(ts.to_numpy(state), cuda_dev)
    before = fr.LAUNCHES["observe"]
    got = fr.observe(card)
    assert fr.LAUNCHES["observe"] == before + 1
    assert all(t.device.type == "cuda" for t in got)
    _assert_bit_equal(got, _plain(state), f"{case} (CPU plain)")
    _assert_bit_equal(got, _plain(card), f"{case} (card plain)")


@pytest.mark.cuda
def test_observe_at_the_learner_width_on_card(cuda_dev):
    """B = 8192 on ta01-ta10 after 40 driven steps: each call new tensors,
    bit-equal to the plain expressions."""
    state = tv.strip_solution(tv.make_batch(ti.get_instance_set([f"ta{i:02d}" for i in range(1, 11)]), 8192,
                                            device=cuda_dev))
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    for _ in range(40):
        state, _ = fr.rollout_driven(state, tv.random_legal_actions(g, state)[None], 1)
    a, b = fr.observe(state), fr.observe(state)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, b))
    _assert_bit_equal(a, _plain(state), "B=8192")


@pytest.mark.cuda
def test_observe_on_an_empty_batch_launches_nothing_on_card(cuda_dev):
    fields = {k: v[:0] for k, v in ts.to_numpy(case_state("ta01")).items()}
    card = ts.from_numpy(fields, cuda_dev)
    before = dict(fr.LAUNCHES)
    obs, mask, valid = fr.observe(card)
    assert fr.LAUNCHES == before
    assert obs.shape == (0, 15, 7) and mask.shape == (0, 16) and valid.shape == (0, 15)


def _rollout(model, state, seed, cfg):
    logits = []
    handle = model.register_forward_hook(lambda m, args, out: logits.append(out[0].clone()))
    try:
        gen = torch.Generator(device=state.device).manual_seed(seed)
        out = tl._policy_rollout(model, state, gen, cfg)
    finally:
        handle.remove()
    return out, logits


@pytest.mark.cuda
def test_policy_rollout_equals_the_plain_inputs_on_card(cuda_dev, monkeypatch):
    """``_policy_rollout`` at B = 512 on ta01-ta10: the same trajectory,
    logits, stats and final state through the kernel as through the plain
    expressions, from the same generator seed."""
    cfg = tl.LearnerConfig(unroll_steps=16)
    state = tv.strip_solution(tv.make_batch(ti.get_instance_set([f"ta{i:02d}" for i in range(1, 11)]), 512,
                                            device=cuda_dev))
    model = tl.init_model(0, state, cfg)
    fr.reset_launch_counts()
    (s1, st1, tr1), lg1 = _rollout(model, state, 3, cfg)
    assert fr.LAUNCHES["observe"] == cfg.unroll_steps
    monkeypatch.setattr(fr, "observe", _plain)
    (s2, st2, tr2), lg2 = _rollout(model, state, 3, cfg)
    assert fr.LAUNCHES["observe"] == cfg.unroll_steps
    assert tr1.keys() == tr2.keys() and all(torch.equal(tr1[k], tr2[k]) for k in tr1)
    assert len(lg1) == len(lg2) == cfg.unroll_steps and all(torch.equal(a, b) for a, b in zip(lg1, lg2))
    for f in dataclasses.fields(st1):
        assert torch.equal(getattr(st1, f.name), getattr(st2, f.name)), f.name
    for k, v in s1.dynamic_fields().items():
        assert torch.equal(v, getattr(s2, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["reinforce", "ppo"])
def test_each_rollout_span_counts_one_observe_launch_a_step_on_card(cuda_dev, algo):
    """Under ``diagnostics.recording()``: each ``learner.rollout`` span
    counts ``unroll_steps`` observe launches; PPO's bootstrap value one more
    an update, outside it."""
    cfg = tl.LearnerConfig(unroll_steps=8, hidden=(32, 32), algo=algo, minibatches=2, ppo_epochs=1)
    state = tv.strip_solution(tv.make_batch(ti.get_instance("ta01"), 256, device=cuda_dev))
    train = tl.init_train_state(0, state, cfg)
    step = tl.make_train_step(cfg)
    fr.reset_launch_counts()
    diagnostics.reset_spans()
    with diagnostics.recording():
        for _ in range(3):
            train, _ = step(train)
    rollouts = [s for s in diagnostics.spans() if s.name == "learner.rollout"]
    assert len(rollouts) == 3 and all(s.counts.get("observe") == cfg.unroll_steps for s in rollouts)
    assert fr.LAUNCHES["observe"] == 3 * (cfg.unroll_steps + (algo == "ppo"))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [0, 3])
def test_evaluation_launches_one_observe_a_step_on_card(cuda_dev, lanes):
    """Greedy evaluation, alone or beside sampled lanes: one observe launch
    and one driven launch a step."""
    cfg = tl.LearnerConfig(hidden=(32, 32))
    spec = ti.random_instance(6, 5, (1, 9), seed=3)
    params = tl.init_model(0, tv.make_batch(spec, 1, device="cpu"), cfg).state_dict()
    fr.reset_launch_counts()
    res = tl.evaluate_policy(params, spec, cfg, stochastic_lanes=lanes, device=cuda_dev)
    assert res["greedy_makespan"] > 0
    assert fr.LAUNCHES["observe"] == res["steps"] == fr.LAUNCHES["rollout_driven_static"]

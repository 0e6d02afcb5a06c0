"""The rollout kernels' static-shape build and the last two ported tools.

* The port's choice of the static build (``fused_rollout.static_shape``)
  against the JAX package's ``_static_lane``, and the JAX kernels' static
  path (interpret mode, ``_fresh_static``) against the port's twins.
* The build of one library per static shape (``core/_build``), checked with
  a stand-in for ``nvcc``.
* ``tools/bench_scaling_torch.py`` over gloo ranks on the CPU and
  ``tools/gen_golden_torch.py`` on a copy of the golden file.
* On a card only (``-m cuda``): every static kernel bit-equal to its twin and
  to the general kernel on the same batch.

JAX is imported inside the tests that compare against it."""

import hashlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.core import _build
from jssenv_tpu_torch.core import fused_rollout as fr
from jssenv_tpu_torch.core import state as ts
from jssenv_tpu_torch.parallel import mesh as meshlib

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "golden_solutions.json"
GOLDEN_SHA = hashlib.sha256(GOLDEN.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    from jssenv_tpu import instances, replay, vector
    from jssenv_tpu.core import pallas_rollout

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, inst=instances, vector=vector, pallas=pallas_rollout,
                                 replay=replay)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    return torch.device("cuda")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _bits(T, B, seed):
    return np.random.default_rng(seed).integers(-(2**31), 2**31, size=(T, B), dtype=np.int64).astype(np.int32)


def _port_actions(state, T, seed):
    g = torch.Generator(device=state.device).manual_seed(seed)
    stats = tv.RolloutStats.zero(state.device)
    acts = []
    for _ in range(T):
        a = tv.random_legal_actions(g, state)
        acts.append(a)
        state, _, stats = tv.step_autoreset(state, a, stats)
    return torch.stack(acts)


# ---------------------------------------------------------------------------
# which build a batch takes
# ---------------------------------------------------------------------------

# (instance-set factory, B, pad, the port's static shape); lane 0 is unpadded
# only where the whole batch is, so the JAX package's answer for one group
# (``_static_lane(state, 1)``, which reads lane 0) is the port's wherever it
# makes one, except for a same-shape set: JAX asks for one instance, the
# port's lanes index a table stack
CHOICE = {
    "ta01": (lambda m: m.stack_instances([m.get_instance("ta01")]), 4, {}, (15, 15)),
    "rand6x5": (lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=3)]), 3, {}, (6, 5)),
    "rand6x5-padded": (lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=3)], jobs_pad=8), 3, {},
                       None),
    "ta01-padded": (lambda m: m.stack_instances([m.get_instance("ta01")], jobs_pad=16, machines_pad=16), 2, {},
                    None),
    "ta41+ta42": (lambda m: m.get_instance_set(["ta41", "ta42"]), 4, {}, (30, 20)),
    "ta01+ta41": (lambda m: m.get_instance_set(["ta01", "ta41"]), 4, {}, None),
}


@pytest.mark.parametrize("case", sorted(CHOICE))
def test_static_choice_matches_jax_static_lane(jx, case):
    build, B, pad, want = CHOICE[case]
    state = tv.make_batch(build(ti), B, device="cpu", **pad)
    assert fr.static_shape(state) == want
    js = jx.vector.make_batch(build(jx.inst), B, **pad)
    slane = jx.pallas._static_lane(js, 1)
    assert (slane is None) == (want is None)
    if slane is not None:
        slane = dict(slane)
        assert (slane["nj"], slane["nm"]) == want == (state.jobs_pad, state.machines_pad)
    # the JAX package itself runs a multi-instance batch as several groups,
    # never static; the port takes its static build for one shape
    if case == "ta41+ta42":
        _, n_groups = jx.pallas._group_lanes(js, 2)
        assert n_groups == 2 and jx.pallas._static_lane(js, n_groups) is None


def test_static_shape_is_computed_once_per_batch(monkeypatch):
    calls = []
    real = fr._batch_meta_uncached
    monkeypatch.setattr(fr, "_batch_meta_uncached", lambda s: calls.append(1) or real(s))
    state = tv.make_batch(ti.random_instance(7, 4, (1, 9), seed=9), 5, device="cpu")
    assert fr.static_shape(state) == (7, 4) and len(calls) == 1
    # a stepped state shares its static tensors: a cache hit, no host read
    stepped, _ = fr.rollout_driven(state, _port_actions(state, 3, 0), 3)
    assert fr.static_shape(stepped) == (7, 4) and fr._lane_inputs(stepped)[0] is fr._lane_inputs(state)[0]
    assert len(calls) == 1
    # the launchers' build choice: the static one unless another is asked for
    assert fr.driven_build(state) == fr.Build("static", (7, 4)) == fr.free_build(state, "static")
    assert fr.driven_build(state, "rollout") == fr.Build("rollout")
    assert fr.free_build(state, "slots") == fr.Build("slots", (1, 1))
    # an in-place write to a bound is a new batch
    state.num_jobs[0] -= 1
    assert fr.static_shape(state) is None and len(calls) == 2


# ---------------------------------------------------------------------------
# the JAX kernels' static path against the port's twins
# ---------------------------------------------------------------------------

# unpadded single-instance batches: (factory, B, T); the step counts are this
# file's own, so the JAX kernel is traced (and its reset taken) anew here
STATIC_JAX = {
    "ta01": (lambda m: m.stack_instances([m.get_instance("ta01")]), 4, 301),
    "rand6x5": (lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=3)]), 4, 163),
}


def _count_fresh_static(jx, monkeypatch):
    calls = []
    real = jx.pallas._fresh_static
    monkeypatch.setattr(jx.pallas, "_fresh_static", lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("case", sorted(STATIC_JAX))
def test_jax_static_driven_kernel_matches_port_twin(jx, monkeypatch, case):
    build, B, T = STATIC_JAX[case]
    calls = _count_fresh_static(jx, monkeypatch)
    state = tv.make_batch(build(ti), B, device="cpu")
    assert fr.static_shape(state) is not None
    acts = _port_actions(state, T, seed=5)
    js = jx.vector.make_batch(build(jx.inst), B)
    assert jx.pallas._static_lane(js, 1) is not None
    jfinal, jraw = jx.pallas.rollout_driven(js, jx.jnp.asarray(acts.numpy()), T, tile=B, interpret=True)
    assert calls, "the JAX kernel did not take its static reset"
    final, raw, ends = fr.rollout_driven(state, acts, T, return_ends=True)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    got = ts.to_numpy(final)
    for k, v in vars(jx.jax.device_get(jfinal)).items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert int((ends > 0).sum()) > 0  # the static reset ran in both


# the free kernel's cases; at ta01 T=253 the JAX static kernel's return is
# one float32 ulp off its own general kernel's (see below)
FREE_JAX = {
    "ta01": (STATIC_JAX["ta01"][0], 4, 253),
    "rand6x5": (STATIC_JAX["rand6x5"][0], 4, 163),
}


@pytest.mark.parametrize("int16", [False, True], ids=["int32", "int16"])
@pytest.mark.parametrize("case", sorted(FREE_JAX))
def test_jax_static_free_kernel_matches_port_twin(jx, monkeypatch, case, int16):
    """Exact on every integer stat against the JAX static kernel. The
    float32 return: the port's per-lane returns, summed by the JAX kernel's
    own reduction, equal the JAX general kernel's total bit for bit (both
    divide by the lane's max_time_op read at run time), and the JAX static
    kernel's within the tolerance of ``test_torch_rollout.py``'s free-kernel
    comparison: there the divisor is a compile-time constant, and XLA turns
    the division into a multiplication by its reciprocal. The port divides
    in both builds, so its static and general kernels agree bit for bit."""
    build, B, T = FREE_JAX[case]
    if int16:
        monkeypatch.setenv("JSS_PALLAS_INT16", "1")
    calls = _count_fresh_static(jx, monkeypatch)
    bits = jx.jnp.asarray(_bits(T, B, seed=T))
    js = jx.vector.make_batch(build(jx.inst), B)
    assert (jx.pallas.value_dtype(js) == jx.jnp.int16) == int16
    want = jx.pallas.rollout_free(js, T, tile=B, interpret=True, bits=bits)
    assert calls, "the JAX kernel did not take its static reset"
    with monkeypatch.context() as m:
        m.setattr(jx.pallas, "_static_lane", lambda state, n_groups: None)
        general = jx.pallas.rollout_free(js, T, tile=B, interpret=True, bits=bits)
    state = tv.make_batch(build(ti), B, device="cpu")
    lanes = fr.free_lane_stats(state, T, bits=torch.from_numpy(np.asarray(bits)))
    got = fr._reduce_stats(lanes, T, B)
    for k in ("episodes", "total_makespan", "min_makespan", "steps", "identity_violations"):
        assert int(got[k]) == int(np.asarray(want[k])) == int(np.asarray(general[k])), k
    assert int(got["episodes"]) > 0
    total = np.float32(jx.jnp.sum(jx.jnp.asarray(lanes["ret"].numpy()).reshape(1, B)))
    assert total == np.float32(np.asarray(general["total_return"]))
    assert float(total) == pytest.approx(float(np.asarray(want["total_return"])), rel=1e-5)


# ---------------------------------------------------------------------------
# one library per static shape
# ---------------------------------------------------------------------------


def test_library_path_differs_by_shape_and_is_stable():
    general = _build.library_path("rollout")
    ta01 = _build.library_path("rollout", (15, 15))
    ta41 = _build.library_path("rollout", (30, 20))
    assert len({general, ta01, ta41}) == 3
    assert ta01 == _build.library_path("rollout", (15, 15)) and general == _build.library_path("rollout", None)
    assert ta01.name.startswith("librollout_15x15_") and general.name.startswith("librollout_")
    assert all(p.parent == _build.BUILD_DIR and p.suffix == ".so" for p in (general, ta01, ta41))
    assert _build.nvcc_flags((15, 15))[-2:] == ("-DJSS_STATIC_J=15", "-DJSS_STATIC_M=15")
    assert _build.nvcc_flags(None) == _build.NVCC_FLAGS
    with pytest.raises(ValueError):
        _build.nvcc_flags((0, 5))


class _FakeNvcc:
    """Stands in for ``subprocess.Popen`` of nvcc: records the command,
    writes the output file, and exits with ``rc``."""

    started, waited = [], []

    def __init__(self, cmd, rc=0, **kw):
        self.cmd, self.returncode = cmd, None
        self.rc = rc
        _FakeNvcc.started.append(cmd)

    def communicate(self, timeout=None):
        _FakeNvcc.waited.append(self.cmd)
        out = pathlib.Path(self.cmd[self.cmd.index("-o") + 1])
        if self.rc == 0:
            out.write_bytes(b"")
        self.returncode = self.rc
        return ("ptxas info    : Used 40 registers\nptxas info    : 0 bytes spill stores\n" if self.rc == 0
                else "rollout.cu(1): error: no such shape", None)


def test_nvcc_commands_carry_the_shape_and_start_together(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(_FakeNvcc, "started", [])
    monkeypatch.setattr(_FakeNvcc, "waited", [])
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    shapes = [None, (15, 15), (30, 20), (15, 15)]
    out = _build.build(["rollout"], shapes)
    assert set(out) == {("rollout", None), ("rollout", (15, 15)), ("rollout", (30, 20))}
    assert len(_FakeNvcc.started) == 3 and _FakeNvcc.waited == _FakeNvcc.started  # all started, then waited
    flags = {s: [c for c in cmd if c.startswith("-DJSS_STATIC")] for s, cmd in zip(dict.fromkeys(shapes),
                                                                                  _FakeNvcc.started)}
    assert flags == {None: [], (15, 15): ["-DJSS_STATIC_J=15", "-DJSS_STATIC_M=15"],
                     (30, 20): ["-DJSS_STATIC_J=30", "-DJSS_STATIC_M=20"]}
    for (name, shape), path in out.items():
        assert path == _build.library_path(name, shape) and path.exists()
        assert "registers" in _build.ptxas_report(name, shape)
    assert not list(tmp_path.glob("*.tmp"))  # every temporary file renamed into place
    # built libraries are not built again
    _build.build(["rollout"], shapes)
    assert len(_FakeNvcc.started) == 3


def test_a_failed_static_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(subprocess, "Popen", lambda cmd, **kw: _FakeNvcc(cmd, rc=2))
    with pytest.raises(RuntimeError, match=r"static shape \(6, 5\):\nrollout.cu\(1\): error"):
        _build.build(["rollout"], [(6, 5)])
    assert not _build.library_path("rollout", (6, 5)).exists()


# ---------------------------------------------------------------------------
# tools/bench_scaling_torch.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [8, 280])
def test_bench_scaling_over_gloo_ranks(steps):
    """Rows for 1 and 2 gloo ranks at 16 lanes a rank: the JAX tool's keys,
    and each row's episodes the sum of its ranks' own ``rollout_shard``
    stats, recomputed here one shard at a time (280 steps: episodes end)."""
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "bench_scaling_torch.py"), "16", str(steps),
                           "--device", "cpu"], capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"weak_scaling", "speedup_at_max", "gpu", "power_limit"} and rec["gpu"] is None
    rows = rec["weak_scaling"]
    assert [r["devices"] for r in rows] == [1, 2]
    for row in rows:
        assert set(row) == {"devices", "batch", "steps_per_s", "step_us", "episodes"}
        n, B = row["devices"], row["batch"]
        assert B == 16 * n
        assert row["steps_per_s"] * row["step_us"] / 1e6 == pytest.approx(B, rel=1e-3)
        state = tv.make_batch(ti.get_instance("ta01"), B, device="cpu")
        one = meshlib.make_mesh(device="cpu")  # no process group: the one-process mesh
        shards = [meshlib.rollout_shard(one, 3, state.replace(**{k: getattr(state, k)[16 * r:16 * (r + 1)]
                                                                  for k in ts.FIELD_NAMES}),
                                        steps, tv.random_legal_actions) for r in range(n)]
        assert sum(int(s["steps"]) for s in shards) == B * steps
        assert row["episodes"] == sum(int(s["episodes"]) for s in shards)
        assert steps == 8 or row["episodes"] > 0
    assert rec["speedup_at_max"] == round(rows[-1]["steps_per_s"] / rows[0]["steps_per_s"], 2)
    assert proc.stderr.splitlines()[-1].startswith("kernel launches: ")


# ---------------------------------------------------------------------------
# tools/gen_golden_torch.py
# ---------------------------------------------------------------------------


def test_gen_golden_certifies_a_new_entry_and_never_touches_optima(jx, tmp_path, monkeypatch, capsys):
    gg = _load("gen_golden_torch")
    data = tmp_path / "golden_solutions.json"
    before = GOLDEN.read_text()
    data.write_text(before)
    monkeypatch.setattr(gg, "DATA", str(data))
    assert "ta12" not in json.loads(before)
    budget = ["--batch", "32", "--sweeps", "1", "--refine", "8", "--device", "cpu"]
    assert gg.main(["ta12", *budget]) == 0
    after = json.loads(data.read_text())
    entry = after["ta12"]
    assert set(entry) == {"makespan", "source", "machine_order"} and entry["source"] == "solve+anneal"
    from jssenv_tpu_torch import replay

    mk_port, _ = replay.replay_machine_order(ti.get_instance("ta12"), entry["machine_order"], device="cpu")
    mk_jax, _ = jx.replay.replay_machine_order(jx.inst.get_instance("ta12"), entry["machine_order"])
    assert entry["makespan"] == mk_port == int(mk_jax)
    # every other entry keeps its bytes: the file is the old one with ta12 added
    rest = {k: v for k, v in after.items() if k != "ta12"}
    assert json.dumps(rest, indent=1, sort_keys=True) == before
    # --update: the optima are never re-solved, a solver-derived entry only
    # gives way to a lower certified makespan
    text = data.read_text()
    optima = {k: json.dumps(v, indent=1, sort_keys=True) for k, v in after.items() if "optimum" in v}
    assert gg.main(["ta01", "ta12", "--update", "--seed", "1", *budget]) == 0
    out = capsys.readouterr().out
    assert "ta01: published optimum entry, never updated" in out
    final = json.loads(data.read_text())
    assert {k: json.dumps(final[k], indent=1, sort_keys=True) for k in optima} == optima
    assert final["ta12"]["makespan"] <= entry["makespan"]
    if final["ta12"] == entry:
        assert data.read_text() == text
    assert hashlib.sha256(GOLDEN.read_bytes()).hexdigest() == GOLDEN_SHA


def test_the_repo_golden_file_is_unchanged():
    assert hashlib.sha256(GOLDEN.read_bytes()).hexdigest() == GOLDEN_SHA
    proc = subprocess.run(["git", "diff", "--quiet", "--", str(GOLDEN)], cwd=ROOT)
    assert proc.returncode in (0, 128)  # 128: not a git checkout


@pytest.mark.parametrize("tool", ["bench_scaling_torch", "gen_golden_torch"])
def test_tools_without_cuda_exit_nonzero(monkeypatch, capsys, tool):
    mod = _load(tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if tool == "gen_golden_torch":
        monkeypatch.setattr(mod, "DATA", "/nonexistent/golden.json")  # nothing may be read or written
    assert mod.main(["ta12"] if tool == "gen_golden_torch" else []) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


# ---------------------------------------------------------------------------
# on the card: the static kernels against the twins and the general kernels
# ---------------------------------------------------------------------------

# unpadded batches, each of one shape: (factory, B, T)
STATIC_CARD = {
    "ta01": (lambda: ti.get_instance("ta01"), 64, 300),
    "ta01-B37": (lambda: ti.get_instance("ta01"), 37, 300),
    "rand6x5": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 100, 200),
    "ta41+ta42": (lambda: ti.get_instance_set(["ta41", "ta42"]), 16, 700),
    "ta71": (lambda: ti.get_instance("ta71"), 16, 400),
    "2x2": (lambda: ti.random_instance(2, 2, (1, 9), seed=5), 37, 60),
    "33x64": (lambda: ti.random_instance(33, 64, (1, 9), seed=6), 8, 2300),
}


def _delta(before):
    return {k: v - before[k] for k, v in fr.LAUNCHES.items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("ends", [False, True], ids=["no-ends", "ends"])
@pytest.mark.parametrize("case", sorted(STATIC_CARD))
def test_static_driven_kernel_matches_twin_and_general_on_card(cuda_dev, case, ends):
    src, B, T = STATIC_CARD[case]
    state = tv.make_batch(src(), B, device=cuda_dev)
    assert fr.static_shape(state) == (state.jobs_pad, state.machines_pad)
    acts = _port_actions(state, T, seed=6)
    ref = fr.rollout_driven_reference(state, acts, T, return_ends=True)
    for s in (state, tv.strip_solution(state)):
        before = dict(fr.LAUNCHES)
        static = fr._driven_kernel(s, acts, T, fr._solution_mode(s), ends)
        general = fr._driven_kernel(s, acts, T, fr._solution_mode(s), ends, build="rollout")
        slots = fr._driven_kernel(s, acts, T, fr._solution_mode(s), ends, build="slots")
        assert _delta(before) == {"rollout_driven_static": 1, "rollout_driven": 1, "rollout_driven_slots": 1}
        torch.cuda.synchronize()
        assert torch.equal(static[1], ref[1]) and torch.equal(general[1], ref[1]) and torch.equal(slots[1], ref[1])
        if ends:
            assert torch.equal(static[2], ref[2]) and torch.equal(general[2], ref[2])
            assert torch.equal(slots[2], ref[2])
        for k in ts.FIELD_NAMES:
            if k != "solution" or s is state:
                assert torch.equal(getattr(static[0], k), getattr(ref[0], k)), k
                assert torch.equal(getattr(general[0], k), getattr(static[0], k)), k
                assert torch.equal(getattr(slots[0], k), getattr(static[0], k)), k
    assert int((ref[2] > 0).sum()) > 0 or case in ("ta71", "33x64")


@pytest.mark.cuda
@pytest.mark.parametrize("vdt", [torch.int32, torch.int16], ids=["int32", "int16"])
@pytest.mark.parametrize("mode", ["bits", "philox"])
@pytest.mark.parametrize("case", sorted(STATIC_CARD))
def test_static_free_kernel_matches_twin_and_general_on_card(cuda_dev, case, mode, vdt):
    src, B, T = STATIC_CARD[case]
    state = tv.make_batch(src(), B, device=cuda_dev)
    if vdt == torch.int16 and fr.value_dtype(state) != torch.int16:
        vdt = torch.int32  # ta41, ta71: their values need int32; the case runs it twice
    bits = torch.from_numpy(_bits(T, B, seed=7)).to(cuda_dev) if mode == "bits" else None
    # ``vdt`` is rollout.cu's storage type; the register builds read the
    # state's fields
    key = "rollout_free_i16" if vdt == torch.int16 else "rollout_free"
    before = dict(fr.LAUNCHES)
    static = fr._free_kernel(state, T, 13, bits, lane_offset=B)
    general = fr._free_kernel(state, T, 13, bits, vdt, lane_offset=B, build="rollout")
    slots = fr._free_kernel(state, T, 13, bits, lane_offset=B, build="slots")
    assert _delta(before) == {"rollout_free_static": 1, key: 1, "rollout_free_slots": 1}
    ref = fr.free_lane_stats_reference(state, T, 13, bits, lane_offset=B)
    for f in ref:
        assert torch.equal(static[f], ref[f]), f
        assert torch.equal(general[f], static[f]), f
        assert torch.equal(slots[f], static[f]), f
    assert int(static["viol"].sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pad", ["padded", "mixed"])
def test_padded_batches_keep_the_general_kernel_on_card(cuda_dev, pad):
    if pad == "padded":
        state = tv.make_batch(ti.get_instance("ta01"), 32, device=cuda_dev, jobs_pad=16, machines_pad=16)
    else:
        state = tv.make_batch(ti.get_instance_set(["ta01", "ta41"]), 32, device=cuda_dev)
    assert fr.static_shape(state) is None
    T = 300
    acts = _port_actions(state, T, seed=8)
    before = dict(fr.LAUNCHES)
    final, raw, ends = fr.rollout_driven(state, acts, T, return_ends=True)
    lanes = fr.free_lane_stats(state, T, seed=3)
    assert _delta(before) == {"rollout_driven_slots": 1, "rollout_free_slots": 1}
    ref, ref_raw, ref_ends = fr.rollout_driven_reference(state, acts, T, return_ends=True)
    assert torch.equal(raw, ref_raw) and torch.equal(ends, ref_ends)
    for k in ts.FIELD_NAMES:
        assert torch.equal(getattr(final, k), getattr(ref, k)), k
    twin = fr.free_lane_stats_reference(state, T, seed=3)
    for f in twin:
        assert torch.equal(lanes[f], twin[f]), f


@pytest.mark.cuda
def test_a_static_build_refuses_another_shape_on_card(cuda_dev, monkeypatch):
    """The static build of one shape launched on a batch of another is
    refused (its compile-time shape and strides are checked); nothing runs
    in its place."""
    state = tv.make_batch(ti.random_instance(6, 5, (1, 9), seed=3), 8, device=cuda_dev)
    fr.build_kernels([(7, 5)])
    monkeypatch.setattr(fr, "static_shape", lambda s: (7, 5))
    before = dict(fr.LAUNCHES)
    with pytest.raises(RuntimeError, match="refused or failed"):
        fr.rollout_driven(state, torch.zeros((2, 8), dtype=torch.int32, device=cuda_dev), 2)
    with pytest.raises(RuntimeError, match="refused or failed"):
        fr.free_lane_stats(state, 2, seed=1)
    assert fr.LAUNCHES == before

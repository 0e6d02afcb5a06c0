"""The port's diagnostics and whole-TrainState checkpoints.

``invariant_errors`` bit for bit against the JAX package's (vmapped) on
valid and corrupted batches, padded and ragged; the host-side checker; the
meter; the profiler window; a TrainState round trip whose next update is
bit-equal to the uninterrupted one; and the kill-and-resume test of
tests/test_aux.py:102-158 on the port. Its child is this file run as a
script (``python tests/test_torch_aux.py CKPT UPDATES [ack]``): a short
deterministic training run on the CPU that checkpoints after every update
and resumes from the checkpoint when there is one."""

import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jssenv_tpu_torch import checkpoint as tck  # noqa: E402
from jssenv_tpu_torch import diagnostics as tdg  # noqa: E402
from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import state as ts_mod  # noqa: E402
from jssenv_tpu_torch.parallel import learner as tl  # noqa: E402

CHILD_CONFIG = dict(unroll_steps=4, hidden=(32, 32))


def _stepped_batches():
    """A ragged ta01+ta41 batch and a padded ta01 one, after 40 random steps."""
    g = torch.Generator().manual_seed(0)
    out = []
    for src, pad in ((ti.get_instance_set(["ta01", "ta41"]), {}),
                     (ti.get_instance("ta01"), {"jobs_pad": 18, "machines_pad": 17})):
        s = tv.make_batch(src, 8, device="cpu", **pad)
        for _ in range(40):
            s, _ = tv.vstep(s, tv.random_legal_actions(g, s))
        out.append(s)
    return out


def _corrupted(s):
    """(state, the bit it must set) for each invariant, on lanes 1-4."""
    legal = s.legal.clone()
    legal[4, s.jobs_pad - 1] = True  # lane 4 has fewer jobs than jobs_pad
    busy = s.job_busy_for.clone()
    busy[1, 0] = 10 * int(s.max_time_op[1])
    nb, nbm = s.nb_legal.clone(), s.nb_machine_legal.clone()
    nb[2] += 1
    nbm[3] += 1
    return [(s.replace(job_busy_for=busy), 1), (s.replace(nb_legal=nb), 2),
            (s.replace(nb_machine_legal=nbm), 4), (s.replace(legal=legal), 8)]


def test_invariant_errors_equal_jax_bit_for_bit():
    jax = pytest.importorskip("jax")
    from jssenv_tpu import diagnostics as jd
    from jssenv_tpu.core.state import EnvState

    for s in _stepped_batches():
        assert s.num_jobs[4] < s.jobs_pad
        cases = [(s, 0)] + _corrupted(s)
        for st, bit in cases:
            got = tdg.invariant_errors(st)
            js = EnvState(**{k: jax.numpy.asarray(v) for k, v in ts_mod.to_numpy(st).items()})
            want = np.asarray(jax.vmap(jd.invariant_errors)(js))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            if bit:
                assert int(got[[1, 2, 3, 4][[1, 2, 4, 8].index(bit)]]) & bit
            else:
                assert not got.any()


def test_check_state_invariants_accepts_and_flags():
    for s in _stepped_batches():
        tdg.check_state_invariants(s)
        for bad, bit in _corrupted(s):
            with pytest.raises(AssertionError):
                tdg.check_state_invariants(bad)


def test_trace_writes_a_chrome_trace(tmp_path):
    s = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    with tdg.trace(str(tmp_path / "t")):
        tv.vstep(s, tv.random_legal_actions(torch.Generator().manual_seed(0), s))
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_trace_defaults_to_the_temp_directory(tmp_path, monkeypatch):
    """``trace()`` takes no argument, as the JAX package's does: its default
    is ``jssenv_tpu_trace`` in the temp directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    s = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    with tdg.trace():
        tv.vstep(s, tv.random_legal_actions(torch.Generator().manual_seed(0), s))
    events = json.loads((tmp_path / "jssenv_tpu_trace" / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def _fresh(config, B=8):
    state = tv.strip_solution(tv.make_batch(ti.get_instance("ta01"), B, device="cpu"))
    return tl.init_train_state(0, state, tl.LearnerConfig(**config))


@pytest.mark.parametrize("algo", ["reinforce", "ppo"])
def test_train_state_round_trip_resumes_bit_equal(tmp_path, algo):
    config = dict(CHILD_CONFIG, algo=algo, minibatches=2, ppo_epochs=1)
    step = tl.make_train_step(tl.LearnerConfig(**config))
    ts, _ = step(_fresh(config))
    p = str(tmp_path / "ts")
    tck.save_train_state(p, ts)
    back = tck.load_train_state(p, _fresh(config))
    assert back.steps == ts.steps == 1
    for k in ts_mod.FIELD_NAMES:
        assert torch.equal(getattr(back.env_state, k), getattr(ts.env_state, k)), k
    ts2, m = step(ts)
    back2, m_back = step(back)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m_back.items()}
    sd, sd_back = ts2.model.state_dict(), back2.model.state_dict()
    assert all(torch.equal(sd[k], sd_back[k]) for k in sd)
    # a state saved before its first update has no Adam entries, and loads
    tck.save_train_state(p, _fresh(config))
    assert tck.load_train_state(p, _fresh(config)).optimizer.state == {}


def test_train_state_structure_mismatch_raises(tmp_path):
    p = str(tmp_path / "ts")
    tck.save_train_state(p, _fresh(CHILD_CONFIG))
    with pytest.raises(ValueError, match="mismatch"):
        tck.load_train_state(p, _fresh(dict(CHILD_CONFIG, hidden=(16, 16))))
    with pytest.raises(ValueError, match="mismatch"):
        tck.load_train_state(p, _fresh(CHILD_CONFIG, B=4))


def test_kill_and_resume_gives_the_uninterrupted_params(tmp_path):
    """SIGKILL a training run after its 2nd update's checkpoint, run the same
    command again, and require the final parameters' sha256 to equal an
    uninterrupted run's. The child blocks on stdin after each "upd" line
    in ack mode, so the kill lands while it is alive."""
    me, n_updates = os.path.abspath(__file__), 6

    def run_to_completion(ckpt):
        out = subprocess.run([sys.executable, me, ckpt, str(n_updates)], capture_output=True, text=True,
                             timeout=240)
        assert out.returncode == 0, out.stderr
        return [ln.split()[1] for ln in out.stdout.splitlines() if ln.startswith("digest ")][-1]

    ref = run_to_completion(str(tmp_path / "ref.npz"))
    ckpt = str(tmp_path / "faulted.npz")
    proc = subprocess.Popen([sys.executable, me, ckpt, str(n_updates), "ack"], stdout=subprocess.PIPE,
                            stdin=subprocess.PIPE, text=True)
    seen = 0
    try:
        for line in proc.stdout:
            if line.startswith("upd "):
                seen = int(line.split()[1])
                if seen >= 2:
                    proc.send_signal(signal.SIGKILL)  # no cleanup, no atexit
                    break
                proc.stdin.write("go\n")
                proc.stdin.flush()
        proc.wait(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == -signal.SIGKILL and seen == 2
    assert run_to_completion(ckpt) == ref


def _child(ckpt, n_updates, ack):
    torch.set_num_threads(1)
    ts = _fresh(CHILD_CONFIG)
    if os.path.exists(ckpt):
        ts = tck.load_train_state(ckpt, ts)
    step = tl.make_train_step(tl.LearnerConfig(**CHILD_CONFIG))
    for i in range(ts.steps, n_updates):
        ts, _ = step(ts)
        tck.save_train_state(ckpt, ts)
        print(f"upd {i + 1}", flush=True)
        if ack:
            sys.stdin.readline()
    h = hashlib.sha256()
    for v in ts.model.state_dict().values():
        h.update(v.numpy().tobytes())
    print(f"digest {h.hexdigest()}", flush=True)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), sys.argv[3:] == ["ack"])

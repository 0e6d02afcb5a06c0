"""Diagnostics: a profiler window, a throughput meter and state invariant checks.

The PyTorch counterpart of ``jssenv_tpu/diagnostics.py``:

* ``trace`` — a ``torch.profiler`` window (CPU, and the card's kernels
  where there is one) written as a Chrome trace;
* ``Throughput`` — a wall-clock env-steps/s meter;
* ``check_state_invariants`` — the reference test-suite's state invariants
  (obs bounds, counter coherence, pad-lane inertness; reference
  tests/test_state.py:22-76) as a host-side assertion pass over a batch;
* ``invariant_errors`` — the coherence checks as a (B,) bitmask computed on
  the state's device, cheap enough to run between steps.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import numpy as np
import torch

from jssenv_tpu_torch.core.state import EnvState, to_numpy


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block; on exit write the Chrome trace
    to ``log_dir/trace.json``; by default ``log_dir`` is
    ``jssenv_tpu_trace`` in the temp directory (``/tmp/jssenv_tpu_trace``
    unless ``TMPDIR`` names another, the JAX package's default). The card's
    activity is traced where ``torch.cuda.is_available()``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "jssenv_tpu_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Simple env-steps/s meter: meter.update(steps) after each chunk."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def update(self, n: int) -> None:
        self.steps += int(n)

    @property
    def steps_per_s(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else float("nan")


def check_state_invariants(state: EnvState) -> None:
    """Raise AssertionError naming the first lane and invariant violated."""
    host = to_numpy(state)
    obs_all = state.obs.detach().cpu().numpy()
    for i in range(state.batch_size):
        nj, nm = int(host["num_jobs"][i]), int(host["num_machines"][i])
        obs = obs_all[i]
        assert obs.min() >= -1e-9 and obs.max() <= 1.0 + 1e-9, f"lane {i}: obs bounds"
        assert np.isfinite(obs).all(), f"lane {i}: NaN/Inf in obs"
        legal, needed = host["legal"][i], host["needed_machine"][i]
        assert int(host["nb_legal"][i]) == int(legal[:nj].sum()), f"lane {i}: nb_legal incoherent"
        avail = set(int(m) for m in needed[:nj][legal[:nj]])
        assert len(avail) == int(host["nb_machine_legal"][i]), f"lane {i}: nb_machine_legal incoherent"
        assert not legal[nj:].any(), f"lane {i}: padded job marked legal"
        assert (host["machine_busy_for"][i][nm:] == 0).all(), f"lane {i}: padded machine busy"
        todo = host["next_op"][i]
        assert (todo[:nj] <= nm).all() and (todo[:nj] >= 0).all(), f"lane {i}: next_op out of range"
        assert int(host["time"][i]) >= 0, f"lane {i}: negative clock"


def invariant_errors(state: EnvState) -> torch.Tensor:
    """(B,) int32 bitmask of violated invariants per lane, on the state's
    device. Bit 0: obs out of [0, 1] or non-finite; bit 1: ``nb_legal``
    incoherent; bit 2: ``nb_machine_legal`` incoherent; bit 3: a padded job
    marked legal."""
    obs = state.obs.flatten(1)
    obs_ok = (torch.isfinite(obs) & (obs >= -1e-9) & (obs <= 1.0 + 1e-9)).all(dim=1)
    legal = state.legal
    nb_ok = state.nb_legal == legal.sum(dim=1, dtype=torch.int32)
    m_of = state.needed_machine.clamp(0, state.machines_pad - 1).long()
    have = torch.zeros(m_of.shape[0], state.machines_pad, dtype=torch.int32, device=state.device)
    have = have.scatter_reduce(1, m_of, legal.to(torch.int32), reduce="amax") > 0
    nbm_ok = state.nb_machine_legal == have.sum(dim=1, dtype=torch.int32)
    pad_ok = ~(legal & ~state.job_valid).any(dim=1)
    bits = [(~ok).to(torch.int32) << k for k, ok in enumerate((obs_ok, nb_ok, nbm_ok, pad_ok))]
    return bits[0] | bits[1] | bits[2] | bits[3]

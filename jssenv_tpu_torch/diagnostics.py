"""Diagnostics: a profiler window, host spans and counters, and state invariant checks.

The PyTorch counterpart of ``jssenv_tpu/diagnostics.py``:

* ``trace`` — a ``torch.profiler`` window (CPU, and the card's kernels
  where there is one) written as a Chrome trace;
* ``span`` — a named stretch of host work inside the port (the learner's
  update and its parts, an env step, a free call), recorded while a
  profiler runs or inside ``recording()``, and read back by ``spans()``;
* ``COUNTS`` — counters of the host plumbing, counted always;
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
from typing import Dict, Iterator, List, NamedTuple, Optional

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


# Host-plumbing counters, counted always (``fused_rollout.LAUNCHES``' form):
# "host_reads" where the port reads a device value back to the host (the
# host waits for the device there), "lane_inputs_built" where
# ``fused_rollout._lane_entry`` builds a batch's lane inputs (a cache miss),
# "lane_buffers_built" where ``fused_rollout._to_lanes`` converts a state to
# ``rollout.cu``'s lane buffer.
COUNTS: Dict[str, int] = {"host_reads": 0, "lane_inputs_built": 0, "lane_buffers_built": 0}


class Span(NamedTuple):
    """One recorded span: its ``parent``'s index in ``spans()`` (-1 at the
    top), its host clock (``time.perf_counter_ns``) at entry and exit, and
    the changes of ``COUNTS`` and ``fused_rollout.LAUNCHES`` over it (keys
    that did not change left out)."""

    name: str
    parent: int
    start_ns: int
    end_ns: int
    counts: Dict[str, int]


_SPANS: List[Optional[Span]] = []
_OPEN: List[int] = []  # indices of the spans entered and not yet left, innermost last
_recording = 0  # depth of recording() blocks
_OFF = contextlib.nullcontext()


def _counts() -> Dict[str, int]:
    from jssenv_tpu_torch.core import fused_rollout  # which imports this module

    return {**COUNTS, **fused_rollout.LAUNCHES}


class _Span:
    __slots__ = ("name", "index", "before", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = len(_SPANS)
        _SPANS.append(None)
        _OPEN.append(self.index)
        self.before = _counts()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        after = _counts()
        _OPEN.pop()
        moved = {k: v - self.before.get(k, 0) for k, v in after.items() if v != self.before.get(k, 0)}
        _SPANS[self.index] = Span(self.name, _OPEN[-1] if _OPEN else -1, self.start, end, moved)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


def span(name: str):
    """``with span("env.step"): ...`` records the block as a ``Span`` while
    a torch profiler is active or inside ``recording()``; otherwise it costs
    one check and records nothing. Under a profiler the block is also a
    ``record_function`` annotation, so it lands in the Chrome trace (a
    ``user_annotation``) on the clock of the kernels it launched."""
    if not (_recording or torch.autograd._profiler_enabled()):
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block without a profiler: the host clock
    alone, close to the cost of the untraced path."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> List[Optional[Span]]:
    """The spans recorded since the last ``reset_spans()``, in the order
    they were entered; a span still open reads None."""
    return list(_SPANS)


def reset_spans() -> None:
    """Forget the recorded spans; call it outside any span."""
    _SPANS.clear()


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

"""A profiled stretch of a run's window, and what the device trace says.

``Stretch`` runs ``torch.profiler`` (host and device activity) over a short
steady part of the window, marked by a ``perfbench.stretch`` annotation,
writes the Chrome trace to the run's temporary directory, reads it back and
deletes it. ``Trace`` holds the stretch's device operations (kernels,
copies, sets) and host operations on one clock, what the traffic mode
records beside them (``units`` done in the stretch, the cell's
``sizes``) and what the per-layer readers need: device busy
time, the window's length, kernel times by name, the breakdown.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "perfbench.stretch"


@dataclasses.dataclass
class Event:
    name: str
    ts: float  # microseconds
    dur: float


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]  # microseconds, the stretch's annotation
    device: List[Event]
    host: List[Event]
    units: int = 0  # calls or updates inside the stretch
    sizes: Dict[str, float] = dataclasses.field(default_factory=dict)
    busy: Optional[float] = None  # seconds; set to the mean over ranks on a mesh
    span: Optional[float] = None

    @property
    def window_s(self) -> float:
        return self.span if self.span is not None else (self.window[1] - self.window[0]) * 1e-6

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the window,
        sorted, in microseconds."""
        lo, hi = self.window
        spans = sorted((max(e.ts, lo), min(e.ts + e.dur, hi)) for e in self.device if e.ts < hi and e.ts + e.dur > lo)
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        if self.busy is not None:
            return self.busy
        return sum(b - a for a, b in self.intervals()) * 1e-6

    def kernels(self, *parts: str) -> List[Event]:
        """The device operations whose name holds any of ``parts``."""
        return [e for e in self.device if any(p in e.name for p in parts)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's idle
        time grouped by the innermost host operation running at the middle
        of each gap ("python" where none was), seconds each."""
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device:
            ops[e.name] += e.dur * 1e-6
        gaps: Dict[str, float] = defaultdict(float)
        edges = [self.window[0]] + [x for iv in self.intervals() for x in iv] + [self.window[1]]
        host = sorted(self.host, key=lambda e: e.ts)
        starts = [e.ts for e in host]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid, name = (a + b) / 2, "python"
            # the latest-started host operation still running at mid: host
            # operations nest, so that is the innermost; a parent that
            # started more than 64 operations earlier counts as none
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(last - 64, -1), -1):
                if host[i].ts + host[i].dur >= mid:
                    name = host[i].name
                    break
            gaps[name] += (b - a) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def parse(path: str) -> Trace:
    """The device and host operations of a Chrome trace that
    ``torch.profiler`` exported, and the window its stretch mark spans."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        ev = Event(str(e.get("name", "")), float(e["ts"]), float(e.get("dur", 0.0)))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat == "user_annotation" and ev.name == MARK:
            window = (ev.ts, ev.ts + ev.dur)
        elif cat == "cpu_op":
            host.append(ev)
    if window is None:
        raise RuntimeError(f"the trace holds no {MARK} mark")
    return Trace(window, device, host)


class Stretch:
    """Profile the block: ``with Stretch(device) as st: ...``; then
    ``st.trace``."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts)
        self.mark = torch.profiler.record_function(MARK)
        self.trace: Optional[Trace] = None

    def __enter__(self) -> "Stretch":
        self.prof.__enter__()
        self.mark.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.mark.__exit__(*exc)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.trace = parse(path)
        finally:
            os.remove(path)

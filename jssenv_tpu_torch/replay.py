"""Schedule replay: drive the simulator with a fixed machine-order schedule.

The PyTorch counterpart of ``jssenv_tpu/replay.py``. A job-shop *solution* is
fully described by, for every machine, the order in which it processes jobs.
Replaying such an order through the simulator yields the schedule's makespan
under the engine's timing semantics — the replay loop of the reference's
golden-solution tests: repeatedly allocate the next job of any legal machine
whose turn matches the order, otherwise advance time.

Two engines: ``"torch"`` (the default) steps ``core.engine`` on the state's
device — the card unless ``device="cpu"`` is given — and ``"native"`` steps
the scalar C++ engine (``jssenv_tpu_torch.native``) on the host; ``"auto"``
takes native when its library builds and loads, else torch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from jssenv_tpu_torch.core import engine
from jssenv_tpu_torch.core.state import Device, EnvState
from jssenv_tpu_torch.instances import InstanceSpec


@dataclasses.dataclass
class NativeReplayState:
    """Final-state shim of the native-engine replay path: the EnvState
    attributes replay consumers read (solution/time/done/any_busy)."""

    solution: np.ndarray  # (J, M) op start times
    time: int
    done: bool
    any_busy: bool


def _replay_native(op_machine, op_dur, machine_order, strict):
    """Replay through the scalar C++ engine twin (native/jss_engine.cpp) —
    microseconds per step and no device traffic, where the torch path costs
    device round-trips per step. Same semantics: the native engine is
    differentially tested stepwise against core.engine
    (tests/test_torch_native.py)."""
    from jssenv_tpu_torch import native

    eng = native.NativeEngine(op_machine, op_dur)
    nm = eng.machines
    idx = [0] * nm
    order = [list(machine_order[m]) for m in range(nm)]
    done = False
    while not done:
        acted = False
        for m in range(nm):
            if done:
                break
            if eng.machine_legal[m] and idx[m] < len(order[m]):
                job = order[m][idx[m]]
                if eng.needed_machine[job] == m and eng.legal[job]:
                    _, done = eng.step(job)
                    idx[m] += 1
                    acted = True
        if not acted and not done:
            if not eng.machine_busy_for.any():
                if strict:
                    raise RuntimeError(
                        "replay deadlocked: machine order is infeasible "
                        f"(progress per machine: {idx})"
                    )
                break
            prev = eng.time
            eng.advance_time()
            if eng.time <= prev:  # pragma: no cover - defensive
                raise RuntimeError("time failed to advance during replay")
    mk = int(eng.time)
    final = NativeReplayState(
        solution=eng.solution.copy(),
        time=mk,
        done=bool(done),
        any_busy=bool(eng.machine_busy_for.any()),
    )
    return mk, final


class _Rows:
    """Host copy of what one replay decision reads: the three legality rows
    (machine_legal, legal, needed_machine) of lane 0, with its clock and the
    done / any-busy flags, brought over in one transfer."""

    def __init__(self, state: EnvState):
        J, M = state.jobs_pad, state.machines_pad
        flat = torch.cat(
            [
                state.time[:1],
                state.done[:1].to(torch.int32),
                state.any_busy[:1].to(torch.int32),
                state.machine_legal[0].to(torch.int32),
                state.legal[0].to(torch.int32),
                state.needed_machine[0],
            ]
        ).cpu().numpy()
        self.time, self.done, self.any_busy = int(flat[0]), bool(flat[1]), bool(flat[2])
        self.machine_legal = flat[3 : 3 + M]
        self.legal = flat[3 + M : 3 + M + J]
        self.needed = flat[3 + M + J :]


def replay_machine_order(
    source: Union[EnvState, InstanceSpec],
    machine_order: Sequence[Sequence[int]],
    strict: bool = True,
    backend: str = "torch",
    device: Device = None,
) -> Tuple[int, Union[EnvState, NativeReplayState]]:
    """Replay a per-machine job-order schedule; returns (makespan, final state).

    Args:
      source: a fresh one-lane EnvState or an InstanceSpec to build one from.
      machine_order: ``machine_order[m]`` lists the jobs machine ``m`` processes
        in order (one entry per job for a full schedule).
      strict: if True, raise if the replay deadlocks (order infeasible).
      backend: "torch" (default: ``core.engine`` on the state's device),
        "native" (scalar C++ twin; no device traffic), or "auto" (native when
        the library loads, else torch). With "native"/"auto"-native the final
        state is a :class:`NativeReplayState` shim, not a full EnvState.
      device: where an InstanceSpec's state is built for the torch backend
        (the card unless "cpu" is given); an EnvState keeps its own device.
    """
    if backend not in ("torch", "native", "auto"):
        raise ValueError(f"bad replay backend {backend!r}")
    if isinstance(source, EnvState) and source.batch_size != 1:
        raise ValueError(f"replay takes a one-lane state, got {source.batch_size} lanes")
    if backend in ("native", "auto"):
        if isinstance(source, InstanceSpec):
            om, od = source.op_machine, source.op_dur
        else:
            nj, nm_ = int(source.num_jobs[0]), int(source.num_machines[0])
            om = source.op_machine[0, :nj, :nm_].cpu().numpy()
            od = source.op_dur[0, :nj, :nm_].cpu().numpy()
        from jssenv_tpu_torch.native import NativeUnavailableError

        try:
            return _replay_native(om, od, machine_order, strict)
        except NativeUnavailableError:
            if backend == "native":
                raise
            # native lib unavailable — fall through to the torch path; any
            # other native RuntimeError (deadlock, time-advance failure)
            # propagates so real engine bugs are never masked
    if isinstance(source, InstanceSpec):
        state = engine.state_from_spec(source, device=device)
    else:
        state = engine.reset(source)

    nm = int(state.num_machines[0])
    idx = [0] * nm
    order = [list(machine_order[m]) for m in range(nm)]
    host = _Rows(state)
    while not host.done:
        acted = False
        for m in range(nm):
            if host.done:
                break
            if host.machine_legal[m] and idx[m] < len(order[m]):
                job = order[m][idx[m]]
                if host.needed[job] == m and host.legal[job]:
                    action = torch.full((1,), job, dtype=torch.int32, device=state.device)
                    state, _ = engine.step(state, action)
                    idx[m] += 1
                    acted = True
                    host = _Rows(state)
        if not acted and not host.done:
            if not host.any_busy:
                if strict:
                    raise RuntimeError(
                        "replay deadlocked: machine order is infeasible "
                        f"(progress per machine: {idx})"
                    )
                break
            prev = host.time
            state = engine.advance_time(state)[0]
            host = _Rows(state)
            if host.time <= prev:  # pragma: no cover - defensive
                raise RuntimeError("time failed to advance during replay")
    return host.time, state

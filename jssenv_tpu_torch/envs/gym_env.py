"""Gym-compatible single-env wrapper around the torch engine or the native one.

The PyTorch counterpart of ``jssenv_tpu/envs/gym_env.py``: the public surface
of the reference env (JSSEnv ``JssEnv``) — same constructor config, same
old-gym-style ``reset()`` returning only the observation dict, same 5-tuple
``step``, same public attributes that dispatching rules and downstream code
read (``PUBLIC_ATTRIBUTES``) — while the simulation runs in ``core.engine``
on a one-lane batch (``"torch"``, the default, on the card unless
``env_config["device"] = "cpu"``) or, where the caller asks for the host, in
the scalar C++ engine (``"native"``).

Host mirroring of the torch state is lazy: one host copy per step feeds every
attribute. The reference's sorted event-queue list is reconstructed from the
busy-machine timers, byte-identical to the original including deduplication.
"""

from __future__ import annotations

import datetime
import random
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

try:
    import gymnasium as gym

    _BASE = gym.Env
except ImportError:  # pragma: no cover - gymnasium is an optional dep
    gym = None
    _BASE = object

from jssenv_tpu_torch import instances as inst
from jssenv_tpu_torch.core import engine
from jssenv_tpu_torch.core.state import FIELD_NAMES, EnvState

# The reference env's public attributes (docs/MIGRATION.md), in its order.
PUBLIC_ATTRIBUTES = (
    "jobs", "machines", "instance_matrix", "jobs_length", "max_time_op",
    "max_time_jobs", "sum_op", "current_time_step", "legal_actions",
    "nb_legal_actions", "nb_machine_legal", "machine_legal",
    "needed_machine_jobs", "todo_time_step_job", "time_until_available_machine",
    "time_until_finish_current_op_jobs", "total_perform_op_time_jobs",
    "total_idle_time_jobs", "idle_time_jobs_last_op", "illegal_actions",
    "action_illegal_no_op", "solution", "last_solution", "last_time_step",
    "next_time_step", "state", "colors", "start_timestamp",
)


class KeySequence:
    """Seeded stream for the rules' exploration coin: one CPU
    ``torch.Generator``; each ``next_key()`` hands it to a rule, which draws
    its coin from it and so advances the stream."""

    def __init__(self, seed: int = 0):
        self.generator = torch.Generator().manual_seed(seed)

    def next_key(self) -> torch.Generator:
        return self.generator


def _host_view(state: EnvState):
    """Lane 0 of a one-lane state as numpy arrays: every field, plus the
    derived ``idle_since_op``, ``idle_total``, ``pin`` and ``obs`` — the names
    the native engine exposes, so one snapshot object serves both engines."""
    host = EnvState(**{k: getattr(state, k).cpu() for k in FIELD_NAMES})
    view = {k: getattr(host, k)[0].numpy() for k in FIELD_NAMES}
    for k in ("idle_since_op", "idle_total", "pin", "obs"):
        view[k] = getattr(host, k)[0].numpy()
    return types.SimpleNamespace(**view)


class JssEnv(_BASE):
    """Job Shop Scheduling environment (reference-compatible API).

    Config keys (``env_config``):
      instance_path: bundled instance name (e.g. ``"ta01"``) or a filesystem
                     path in Taillard format. Default: bundled ``ta80``.
      rule_seed:     optional int; enables the 10% exploratory no-op coin for
                     dispatching rules, deterministically.
      engine:        "torch" (default) | "native" | "auto". The torch
                     engine is ``core.engine`` on a one-lane batch on the
                     card. "native" opts in to the host: the scalar C++
                     engine, which steps one env faster than the card's
                     eager step. "auto" is the JAX package's default: native
                     when the shared library builds/loads, else torch. Both
                     engines are bit-identical (tests/test_torch_native.py).
      device:        where the torch engine's state lives (and where
                     ``engine_state`` is built in native mode): the card by
                     default; "cpu" to run without one.
    """

    metadata = {"render_modes": ["human"]}

    def __init__(self, env_config: Optional[Dict[str, Any]] = None):
        if env_config is None:
            env_config = {"instance_path": "ta80"}
        self.instance_path = env_config.get("instance_path", "ta80")
        self._spec = inst.get_instance(self.instance_path)

        self.jobs = self._spec.num_jobs
        self.machines = self._spec.num_machines
        # the reference exposes instance_matrix with dtype (int, 2): [..., 0]
        # is the machine id, [..., 1] the duration
        self.instance_matrix = np.stack(
            [self._spec.op_machine, self._spec.op_dur], axis=-1
        ).astype(np.int64)
        self.jobs_length = self._spec.jobs_length.astype(np.int64)
        self.max_time_op = self._spec.max_time_op
        self.max_time_jobs = self._spec.max_time_jobs
        self.sum_op = self._spec.sum_op

        self.start_timestamp = datetime.datetime.now().timestamp()
        self.colors = [
            tuple(random.random() for _ in range(3)) for _ in range(self.machines)
        ]
        seed = env_config.get("rule_seed")
        self.rule_rng = KeySequence(seed) if seed is not None else None
        self._device = env_config.get("device")

        engine_kind = env_config.get("engine", "torch")
        if engine_kind not in ("auto", "native", "torch"):
            raise ValueError(f"unknown engine {engine_kind!r}")
        self._native = None
        if engine_kind in ("auto", "native"):
            try:
                from jssenv_tpu_torch.native import NativeEngine

                self._native = NativeEngine(self._spec.op_machine, self._spec.op_dur)
            except (RuntimeError, OSError):
                if engine_kind == "native":
                    raise

        if gym is not None:
            self.action_space = gym.spaces.Discrete(self.jobs + 1)
            self.observation_space = gym.spaces.Dict(
                {
                    "action_mask": gym.spaces.Box(0, 1, shape=(self.jobs + 1,)),
                    "real_obs": gym.spaces.Box(
                        low=0.0, high=1.0, shape=(self.jobs, 7), dtype=float
                    ),
                }
            )

        self._engine_state = (
            None
            if self._native is not None
            else engine.state_from_spec(self._spec, device=self._device)
        )
        self._host = None
        self.last_time_step = float("inf")
        self.last_solution = None

    @property
    def engine_state(self) -> EnvState:
        """The one-lane EnvState. In native mode it is materialized on demand
        from the native buffers (for checkpointing or moving a single env
        onto the card)."""
        if self._native is not None:
            return self._native_to_envstate()
        return self._engine_state

    @engine_state.setter
    def engine_state(self, value):
        if self._native is not None:
            raise AttributeError("cannot set engine_state on a native-engine env")
        self._engine_state = value
        self._invalidate()

    def _native_to_envstate(self) -> EnvState:
        n = self._native
        base = engine.state_from_spec(self._spec, device=self._device)
        dev = base.device

        def t(x, dtype=torch.int32):
            return torch.as_tensor(np.asarray(x), device=dev).to(dtype)[None]

        return base.replace(
            time=t(n.time),
            legal=t(n.legal, torch.bool),
            noop_legal=t(n.noop_legal, torch.bool),
            nb_legal=t(n.nb_legal),
            nb_machine_legal=t(n.nb_machine_legal),
            machine_legal=t(n.machine_legal, torch.bool),
            solution=t(n.solution),
            machine_busy_for=t(n.machine_busy_for),
            job_busy_for=t(n.job_busy_for),
            next_op=t(n.next_op),
            work_done=t(n.work_done),
            needed_machine=t(n.needed_machine),
            # invert the lazy idle accounting (EnvState.idle_since_op docs):
            # waiting jobs satisfy since == time - op_end_at and
            # total == idle_total_alloc + since; running/finished jobs read the
            # frozen values directly (their op_end_at is dead until overwritten
            # at the next completion, so time - since is a safe stand-in).
            op_end_at=t((np.int32(n.time) - n.idle_since_op).astype(np.int32)),
            idle_frozen=t(n.idle_since_op),
            idle_total_alloc=t(
                np.where(
                    (n.job_busy_for > 0) | (n.next_op >= self._spec.num_machines),
                    n.idle_total,
                    n.idle_total - n.idle_since_op,
                ).astype(np.int32)
            ),
            noop_pin=t(n.noop_pin, torch.bool),
            # the native engine stores the normalized float obs; EnvState keeps
            # only the integer behind column 4 (wait-until-machine-free at last
            # op completion) and derives the rest. The round-trip is exact:
            # wait4 < max_time_op << 2^23.
            wait4=t(np.rint(n.obs[:, 4] * self._spec.max_time_op).astype(np.int32)),
        )

    # ------------------------------------------------------------------
    # host snapshot plumbing — the native engine exposes the same attribute
    # names as the host view of the torch state, so one snapshot object
    # serves both engines
    # ------------------------------------------------------------------
    @property
    def uses_native_engine(self) -> bool:
        return self._native is not None

    def _snapshot(self):
        if self._native is not None:
            return self._native
        if self._host is None:
            self._host = _host_view(self._engine_state)
        return self._host

    def _invalidate(self):
        self._host = None

    # --- dynamic attributes (reference names) ---
    @property
    def current_time_step(self) -> int:
        return int(self._snapshot().time)

    @property
    def legal_actions(self) -> np.ndarray:
        s = self._snapshot()
        return np.concatenate(
            [np.asarray(s.legal)[: self.jobs].astype(bool), [bool(s.noop_legal)]]
        )

    @property
    def nb_legal_actions(self) -> int:
        return int(self._snapshot().nb_legal)

    @property
    def nb_machine_legal(self) -> int:
        return int(self._snapshot().nb_machine_legal)

    @property
    def machine_legal(self) -> np.ndarray:
        return np.asarray(self._snapshot().machine_legal)[: self.machines].astype(bool)

    @property
    def needed_machine_jobs(self) -> np.ndarray:
        return np.asarray(self._snapshot().needed_machine)[: self.jobs]

    @property
    def todo_time_step_job(self) -> np.ndarray:
        return np.asarray(self._snapshot().next_op)[: self.jobs]

    @property
    def time_until_available_machine(self) -> np.ndarray:
        return np.asarray(self._snapshot().machine_busy_for)[: self.machines]

    @property
    def time_until_finish_current_op_jobs(self) -> np.ndarray:
        return np.asarray(self._snapshot().job_busy_for)[: self.jobs]

    @property
    def total_perform_op_time_jobs(self) -> np.ndarray:
        return np.asarray(self._snapshot().work_done)[: self.jobs]

    @property
    def total_idle_time_jobs(self) -> np.ndarray:
        return np.asarray(self._snapshot().idle_total)[: self.jobs]

    @property
    def idle_time_jobs_last_op(self) -> np.ndarray:
        return np.asarray(self._snapshot().idle_since_op)[: self.jobs]

    @property
    def illegal_actions(self) -> np.ndarray:
        return np.asarray(self._snapshot().pin)[: self.machines, : self.jobs].astype(
            bool
        )

    @property
    def action_illegal_no_op(self) -> np.ndarray:
        return np.asarray(self._snapshot().noop_pin)[: self.jobs].astype(bool)

    @property
    def solution(self) -> np.ndarray:
        return np.asarray(self._snapshot().solution)[: self.jobs, : self.machines]

    @property
    def state(self) -> np.ndarray:
        """The normalized real_obs matrix (col 0 assembled lazily, as in the
        reference's _get_current_state_representation)."""
        s = self._snapshot()
        obs = np.array(np.asarray(s.obs)[: self.jobs], dtype=float)
        obs[:, 0] = np.asarray(s.legal)[: self.jobs].astype(bool).astype(float)
        return obs

    @property
    def next_time_step(self) -> list:
        """Sorted deduplicated future completion events, reconstructed from the
        busy-machine timers (identical to the reference's queue contents)."""
        s = self._snapshot()
        busy = np.asarray(s.machine_busy_for)[: self.machines]
        t = int(s.time)
        return sorted({t + int(x) for x in busy[busy > 0]})

    # ------------------------------------------------------------------
    # env API
    # ------------------------------------------------------------------
    def _observation(self) -> Dict[str, np.ndarray]:
        return {"real_obs": self.state, "action_mask": self.legal_actions}

    def get_legal_actions(self) -> np.ndarray:
        return self.legal_actions

    def reset(self, seed=None, options=None) -> Dict[str, np.ndarray]:
        """Old-gym-style reset: returns the observation dict only (reference
        parity). ``seed``/``options`` are accepted so gymnasium's wrapper
        stack (gym.make's passive checker) can call this, and ignored: the
        env has no stochasticity to seed."""
        if self._native is not None:
            self._native.reset()
        else:
            self._engine_state = engine.reset(self._engine_state)
        self._invalidate()
        return self._observation()

    def step(
        self, action: int
    ) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict]:
        if self._native is not None:
            raw, done = self._native.step(int(action))
            # scale in float32, exactly as the torch engine does, so rewards
            # are bit-identical between the two engines
            reward = float(np.float32(raw) / np.float32(self._native.max_time_op))
        else:
            s = self._engine_state
            a = torch.full((1,), int(action), dtype=torch.int32, device=s.device)
            self._engine_state, tr = engine.step(s, a)
            # one transfer for both (a float32 holds the done flag exactly)
            reward, done = torch.stack([tr.reward, tr.done.to(torch.float32)])[:, 0].tolist()
            done = bool(done)
        self._invalidate()
        if done:
            self.last_time_step = self.current_time_step
            self.last_solution = self.solution
        return self._observation(), float(reward), done, False, {}

    def increase_time_step(self) -> int:
        """Advance the clock to the next completion event; returns the machine
        idle time ("holes") accrued. Public because golden-solution replay
        loops call it directly."""
        if self._native is not None:
            return self._native.advance_time()
        self._engine_state, holes = engine.advance_time(self._engine_state)
        self._invalidate()
        return int(holes[0])

    def _is_done(self) -> bool:
        return self.nb_legal_actions == 0

    def render(self, mode: str = "human"):
        """Gantt chart of the scheduled ops so far; returns a plotly Figure if
        plotly is installed, else a matplotlib Figure; None when nothing is
        scheduled yet."""
        from jssenv_tpu_torch.render import gantt

        return gantt.render_schedule(
            solution=self.solution,
            op_machine=self._spec.op_machine,
            op_dur=self._spec.op_dur,
            colors=self.colors,
            start_timestamp=self.start_timestamp,
        )

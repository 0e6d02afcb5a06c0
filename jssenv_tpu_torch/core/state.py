"""EnvState: the full simulator state of a batch of envs as batch-first tensors.

The PyTorch counterpart of ``jssenv_tpu/core/state.py``. The fields, their
meaning and their dtypes are the JAX package's (see its docstring for the
reference citations); the difference is that a port state is ALWAYS batched:
every field carries a leading batch axis ``B``, and every derived property
returns that axis too, so no vmap is needed anywhere.

Shapes, with ``J``/``M`` the padded job/machine counts:

* static tables ``op_machine``/``op_pos`` (B, J, M) int8 (int32 when
  ``M > 126``), ``op_dur``/``cum_before`` (B, J, M) int16 (int32 when a job's
  total work exceeds int16) — see ``engine.compact_static_tables``;
* static scalars ``num_jobs``, ``num_machines``, ``max_time_op``,
  ``max_time_jobs``, ``sum_op``: (B,) int32;
* dynamic ``time``, ``nb_legal``, ``nb_machine_legal`` (B,) int32,
  ``noop_legal`` (B,) bool, ``legal``/``noop_pin`` (B, J) bool,
  ``machine_legal`` (B, M) bool, ``machine_busy_for`` (B, M) int32,
  ``solution`` (B, J, M) int32 (``(B, 0, M)`` for a light state), and the
  per-job int32 fields ``job_busy_for``, ``next_op``, ``work_done``,
  ``needed_machine``, ``op_end_at``, ``idle_frozen``, ``idle_total_alloc``,
  ``wait4`` (B, J).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

I32_MAX = int(np.iinfo(np.int32).max)

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point places its tensors on: CUDA unless the caller
    names another. Raises when CUDA is asked for (or defaulted to) and no card
    is present — the port never silently falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass
class EnvState:
    """State of a batch of job-shop envs (batch-first tensors, one device)."""

    # static instance data
    op_machine: torch.Tensor
    op_dur: torch.Tensor
    op_pos: torch.Tensor
    cum_before: torch.Tensor
    num_jobs: torch.Tensor
    num_machines: torch.Tensor
    max_time_op: torch.Tensor
    max_time_jobs: torch.Tensor
    sum_op: torch.Tensor
    # dynamic simulation state
    time: torch.Tensor
    legal: torch.Tensor
    noop_legal: torch.Tensor
    nb_legal: torch.Tensor
    nb_machine_legal: torch.Tensor
    machine_legal: torch.Tensor
    solution: torch.Tensor
    machine_busy_for: torch.Tensor
    job_busy_for: torch.Tensor
    next_op: torch.Tensor
    work_done: torch.Tensor
    needed_machine: torch.Tensor
    op_end_at: torch.Tensor
    idle_frozen: torch.Tensor
    idle_total_alloc: torch.Tensor
    noop_pin: torch.Tensor
    wait4: torch.Tensor

    # Fields that never change after init_state; auto-reset selects skip them.
    STATIC_FIELDS = (
        "op_machine",
        "op_dur",
        "op_pos",
        "cum_before",
        "num_jobs",
        "num_machines",
        "max_time_op",
        "max_time_jobs",
        "sum_op",
    )

    def dynamic_fields(self) -> dict:
        """The non-static fields as a dict (the mutable simulation state)."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in self.STATIC_FIELDS
        }

    def replace(self, **updates) -> "EnvState":
        return dataclasses.replace(self, **updates)

    # --- conveniences -----------------------------------------------------
    @property
    def batch_size(self) -> int:
        return self.time.shape[0]

    @property
    def device(self) -> torch.device:
        return self.time.device

    @property
    def jobs_pad(self) -> int:
        return self.op_machine.shape[-2]

    @property
    def machines_pad(self) -> int:
        return self.op_machine.shape[-1]

    @property
    def job_valid(self) -> torch.Tensor:
        """(B, J) bool — which job lanes are real (not padding)."""
        j = torch.arange(self.jobs_pad, dtype=torch.int32, device=self.device)
        return j < self.num_jobs[:, None]

    @property
    def machine_valid(self) -> torch.Tensor:
        """(B, M) bool — which machine lanes are real (not padding)."""
        m = torch.arange(self.machines_pad, dtype=torch.int32, device=self.device)
        return m < self.num_machines[:, None]

    @property
    def pin(self) -> torch.Tensor:
        """(B, M, J) bool — the reference's ``illegal_actions`` pin table,
        derived: ``pin[m, j] == noop_pin[j] & (needed_machine[j] == m)``."""
        m = torch.arange(self.machines_pad, dtype=torch.int32, device=self.device)
        return self.noop_pin[:, None, :] & (
            self.needed_machine[:, None, :] == m[None, :, None]
        )

    @property
    def any_busy(self) -> torch.Tensor:
        """(B,) bool — event queue non-empty ⇔ some machine still busy."""
        return (self.machine_busy_for > 0).any(dim=-1)

    @property
    def next_event_time(self) -> torch.Tensor:
        """(B,) int32 — earliest future completion event (undefined, and
        wrapped like the JAX package's int32, where no machine is busy)."""
        busy = self.machine_busy_for > 0
        gap = torch.where(busy, self.machine_busy_for, I32_MAX).amin(dim=-1)
        return self.time + gap

    @property
    def done(self) -> torch.Tensor:
        """(B,) bool — episode over (reference _is_done: nb_legal_actions == 0)."""
        return self.nb_legal == 0

    def action_mask(self) -> torch.Tensor:
        """(B, J+1) bool mask in reference layout: jobs then the no-op slot.
        The no-op slot sits at padded index J; its action id is ``num_jobs``."""
        return torch.cat([self.legal, self.noop_legal[:, None]], dim=-1)

    def _waiting_span(self):
        running = self.job_busy_for > 0
        finished = self.next_op >= self.num_machines[:, None]
        span = self.time[:, None] - self.op_end_at
        return running, finished, span

    @property
    def idle_since_op(self) -> torch.Tensor:
        """(B, J) int32 — the reference's ``idle_time_jobs_last_op``, derived:
        waiting jobs ``time - op_end_at``, running jobs frozen at allocation,
        finished jobs 0."""
        running, finished, span = self._waiting_span()
        zero = torch.zeros_like(span)
        return torch.where(
            running, self.idle_frozen, torch.where(finished, zero, span)
        ).to(torch.int32)

    @property
    def idle_total(self) -> torch.Tensor:
        """(B, J) int32 — the reference's ``total_idle_time_jobs``, derived:
        cumulative idle at last allocation plus the current waiting span."""
        running, finished, span = self._waiting_span()
        extra = torch.where(running | finished, torch.zeros_like(span), span)
        return (self.idle_total_alloc + extra).to(torch.int32)

    @property
    def obs(self) -> torch.Tensor:
        """(B, J, 7) float32 — the reference's normalized ``state`` matrix,
        derived from the integer state; column 0 is left 0 here and filled in
        ``observation()`` (see the JAX package's ``EnvState.obs``)."""
        f32 = torch.float32
        max_op = self.max_time_op[:, None].to(f32)
        max_jobs = self.max_time_jobs[:, None].to(f32)
        sum_op = self.sum_op[:, None].to(f32)
        nm = self.num_machines[:, None].to(f32)
        finished = self.needed_machine == -1
        one = torch.ones((), dtype=f32, device=self.device)
        cols = torch.stack(
            [
                torch.zeros_like(self.job_busy_for, dtype=f32),
                self.job_busy_for.to(f32) / max_op,
                self.next_op.to(f32) / nm,
                self.work_done.to(f32) / max_jobs,
                torch.where(finished, one, self.wait4.to(f32) / max_op),
                self.idle_since_op.to(f32) / sum_op,
                self.idle_total.to(f32) / sum_op,
            ],
            dim=-1,
        )
        return torch.where(self.job_valid[..., None], cols, 0.0)

    def observation(self) -> dict:
        """Reference-shaped observation dict (jss_env.py:121-134)."""
        obs = self.obs.clone()
        obs[..., 0] = self.legal.to(obs.dtype)
        return {"real_obs": obs, "action_mask": self.action_mask()}

    @property
    def rich_obs(self) -> torch.Tensor:
        """(B, J, 13) float32 — the 7 reference columns plus the 6
        dispatching-rule-aligned channels of the JAX package's ``rich_obs``:
        current-op duration, remaining work, remaining ops, critical ratio,
        busy time left on the needed machine, legal-job contention."""
        f32 = torch.float32
        base = self.obs
        mp = self.op_dur.shape[-1]
        pos = torch.arange(mp, dtype=torch.int32, device=self.device)
        next_op = self.next_op
        dur = self.op_dur.to(torch.int32)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        not_started = pos >= next_op[..., None]
        rem_work = torch.where(not_started, dur, zero).sum(dim=-1).to(f32)
        cur_oh = pos == next_op.clamp(0, mp - 1)[..., None]
        cur_dur = torch.where(cur_oh, dur, zero).sum(dim=-1).to(f32)
        nm = self.num_machines[:, None].to(f32)
        nj = self.num_jobs[:, None].to(f32)
        max_op = self.max_time_op[:, None].to(f32)
        max_jobs = self.max_time_jobs[:, None].to(f32)
        total = dur.sum(dim=-1).to(f32)
        t = self.time[:, None].to(f32)
        cr = torch.clamp(
            (1.5 * total - t) / torch.clamp(rem_work, min=1.0), 0.0, 4.0
        ) / 4.0
        finished = next_op >= self.num_machines[:, None]
        rem_ops = torch.where(
            finished,
            torch.zeros((), dtype=f32, device=self.device),
            (nm - next_op.to(f32)) / nm,
        )
        needed = self.needed_machine
        m_idx = torch.arange(self.machines_pad, dtype=torch.int32, device=self.device)
        ohm = needed[..., None] == m_idx
        busy = self.machine_busy_for[:, None, :]
        needed_busy = torch.where(ohm, busy, zero).sum(dim=-1).to(f32)
        same = (needed[:, :, None] == needed[:, None, :]) & (needed[:, None, :] >= 0)
        contention = (same & self.legal[:, None, :]).sum(dim=-1).to(f32)
        extra = torch.stack(
            [
                cur_dur / max_op,
                rem_work / max_jobs,
                rem_ops,
                cr,
                needed_busy / max_op,
                contention / nj,
            ],
            dim=-1,
        )
        extra = torch.where(self.job_valid[..., None], extra, 0.0)
        return torch.cat([base, extra], dim=-1)


FIELD_NAMES = tuple(f.name for f in dataclasses.fields(EnvState))


def from_numpy(fields: dict, device: Device = None) -> EnvState:
    """Build a port state from a dict of numpy arrays, one per field, with a
    leading batch axis — e.g. a host copy of a JAX ``EnvState``
    (``{k: np.asarray(v) for k, v in vars(jax.device_get(s)).items()}``).
    Dtypes carry over as they are (bool, int8, int16, int32)."""
    dev = resolve_device(device)
    missing = [k for k in FIELD_NAMES if k not in fields]
    if missing:
        raise ValueError(f"missing EnvState fields: {missing}")
    if np.ndim(fields["time"]) != 1:
        raise ValueError("from_numpy needs a batched state: time must be (B,)")
    return EnvState(
        **{
            k: torch.from_numpy(np.array(fields[k])).to(dev)
            for k in FIELD_NAMES
        }
    )


def to_numpy(state: EnvState) -> dict:
    """Field name -> numpy array (host copy), the inverse of ``from_numpy``."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in FIELD_NAMES}

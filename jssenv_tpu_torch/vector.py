"""Batched envs in lockstep: auto-reset, random-legal policy, rollout stats.

The PyTorch counterpart of ``jssenv_tpu/vector.py``. A batch is one
``EnvState`` of batch-first tensors, so ``vstep``/``vreset`` are the engine
functions themselves. ``rollout`` here is an eager Python loop that takes any
policy — the plain path; the fused single-launch rollout on the card is
``core.fused_rollout``.

Random numbers come from an explicit ``torch.Generator`` on the state's
device. They differ from ``jax.random``'s, so tests hold the two packages
against each other with recorded action streams.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from jssenv_tpu_torch import diagnostics
from jssenv_tpu_torch.core import engine
from jssenv_tpu_torch.core.state import I32_MAX, Device, EnvState, resolve_device
from jssenv_tpu_torch.instances import InstanceSet, InstanceSpec, stack_instances

Policy = Callable[[Optional[torch.Generator], EnvState], torch.Tensor]

vstep = engine.step
vreset = engine.reset


def select_lanes(pred: torch.Tensor, on_true: dict, on_false: dict) -> dict:
    """Per-lane select between two dicts of batch-first tensors: where
    ``pred`` (B,) is True take the lane from ``on_true``, else ``on_false``."""
    return {
        k: torch.where(pred.reshape((-1,) + (1,) * (v.dim() - 1)), on_true[k], v)
        for k, v in on_false.items()
    }


@dataclasses.dataclass
class RolloutStats:
    """Accumulated statistics of an auto-resetting rollout window.

    ``total_return`` sums every step's scaled reward over all lanes in the
    window, partial episodes included. Counters are int64 (the JAX package
    keeps int32, which a full-width window can overflow); they equal its
    values wherever it does not overflow.
    """

    episodes: torch.Tensor  # () int64
    total_makespan: torch.Tensor  # () int64
    min_makespan: torch.Tensor  # () int32
    total_return: torch.Tensor  # () float32
    steps: torch.Tensor  # () int64

    @classmethod
    def zero(cls, device: Device = None) -> "RolloutStats":
        device = resolve_device(device)
        z = lambda dt: torch.zeros((), dtype=dt, device=device)  # noqa: E731
        return cls(
            episodes=z(torch.int64),
            total_makespan=z(torch.int64),
            min_makespan=torch.full((), I32_MAX, dtype=torch.int32, device=device),
            total_return=z(torch.float32),
            steps=z(torch.int64),
        )


def make_batch(
    source: Union[InstanceSpec, InstanceSet],
    batch_size: int,
    jobs_pad: int = 0,
    machines_pad: int = 0,
    device: Device = None,
) -> EnvState:
    """B fresh envs on ``device`` (CUDA by default). For an InstanceSet,
    instances tile round-robin over the lanes."""
    if isinstance(source, InstanceSpec):
        source = stack_instances(
            [source], jobs_pad=jobs_pad or None, machines_pad=machines_pad or None
        )
    return make_lanes(source, torch.arange(batch_size), device)


def make_lanes(source: InstanceSet, lanes: torch.Tensor, device: Device = None) -> EnvState:
    """Fresh envs for the given global lane indices of a round-robin batch
    of ``source``: lane ``i`` runs instance ``i % len(source)``, so a rank
    that builds only its own lanes (``parallel.multihost``) holds exactly
    those lanes of ``make_batch``'s batch."""
    dev = resolve_device(device)
    idx = lanes.to(torch.int64) % len(source)
    take = lambda x: torch.as_tensor(np.asarray(x))[idx].to(dev)  # noqa: E731
    state = engine.init_state(
        take(source.op_machine),
        take(source.op_dur),
        take(source.num_jobs),
        take(source.num_machines),
    )
    max_job_length = int(np.asarray(source.op_dur).sum(axis=2).max())
    return engine.compact_static_tables(state, max_job_length=max_job_length)


def strip_solution(state: EnvState) -> EnvState:
    """A "light" state whose solution matrix has zero job rows: the (B, J, M)
    start-time matrix is only needed for the schedule itself, and every step
    and reset handles the zero-row shape."""
    return state.replace(solution=state.solution[:, :0, :])


def random_legal_actions(
    generator: Optional[torch.Generator], state: EnvState
) -> torch.Tensor:
    """Uniform sample over each lane's legal-action mask, on the state's
    device. The no-op slot (mask index ``jobs_pad``) maps to action id
    ``num_jobs``; a terminal lane (empty mask) samples uniformly over all
    slots — its action is ignored by the auto-reset."""
    mask = state.action_mask()
    safe = torch.where(mask.any(dim=1, keepdim=True), mask, True)
    a = torch.multinomial(safe.to(torch.float32), 1, generator=generator)[:, 0]
    a = a.to(torch.int32)
    return torch.where(a == state.jobs_pad, state.num_jobs, a)


def reset_lanes(state: EnvState, done: torch.Tensor) -> EnvState:
    """Fresh dynamic fields on the lanes where ``done``; static tables are
    shared by both sides and not selected."""
    fresh = vreset(state)
    return state.replace(
        **select_lanes(done, fresh.dynamic_fields(), state.dynamic_fields())
    )


def step_autoreset(
    state: EnvState, actions: torch.Tensor, stats: RolloutStats
) -> Tuple[EnvState, engine.Transition, RolloutStats]:
    """Step every lane, accumulate the finished lanes' makespans once, then
    reset the finished lanes."""
    new_state, tr = vstep(state, actions)
    finished = tr.done
    stats = RolloutStats(
        episodes=stats.episodes + finished.sum(),
        total_makespan=stats.total_makespan
        + torch.where(finished, new_state.time, 0).sum(dtype=torch.int64),
        min_makespan=torch.minimum(
            stats.min_makespan,
            torch.where(finished, new_state.time, I32_MAX).amin(),
        ),
        total_return=stats.total_return + tr.reward.sum(),
        steps=stats.steps + actions.shape[0],
    )
    return reset_lanes(new_state, finished), tr, stats


def rollout(
    generator: Optional[torch.Generator],
    state: EnvState,
    num_steps: int,
    policy: Policy = random_legal_actions,
) -> Tuple[EnvState, RolloutStats]:
    """``num_steps`` policy steps with auto-reset (eager loop)."""
    stats = RolloutStats.zero(state.device)
    for _ in range(int(num_steps)):
        state, _, stats = step_autoreset(state, policy(generator, state), stats)
    return state, stats


def episode_makespans(
    generator: Optional[torch.Generator],
    state: EnvState,
    max_steps: int,
    policy: Policy = random_legal_actions,
) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
    """Run every lane to its FIRST episode end (no reset); returns
    (final_state, makespans (B,) int32, returns (B,) float32). Finished lanes
    are frozen; the loop stops once every lane is done or at ``max_steps``."""
    b = state.batch_size
    done_seen = torch.zeros((b,), dtype=torch.bool, device=state.device)
    ms = torch.zeros((b,), dtype=torch.int32, device=state.device)
    ret = torch.zeros((b,), dtype=torch.float32, device=state.device)
    for _ in range(int(max_steps)):
        diagnostics.COUNTS["host_reads"] += 1
        if bool(done_seen.all()):
            break
        new_state, tr = vstep(state, policy(generator, state))
        keep = done_seen
        state = new_state.replace(
            **select_lanes(keep, state.dynamic_fields(), new_state.dynamic_fields())
        )
        ms = torch.where(~keep & tr.done, new_state.time, ms)
        ret = ret + torch.where(keep, 0.0, tr.reward)
        done_seen = keep | tr.done
    return state, ms, ret

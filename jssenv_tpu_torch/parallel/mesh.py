"""Process meshes over ``torch.distributed``: env lanes split over ``dp``.

The PyTorch counterpart of ``jssenv_tpu/parallel/mesh.py``. There a mesh is a
grid of devices and sharding is data placement that XLA turns into
collectives. Here one process drives one device (``multihost.initialize``),
and a ``Mesh`` is this rank's place in a ``dp x mp`` grid of processes (rank
``= dp_rank * mp + mp_rank``) with the process groups the collectives run in:

* ``dp_group``: the ranks that hold the same ``mp`` shard of the policy and
  different env lanes; the learner's gradients and every statistic over the
  global batch are summed (or, for ``min_makespan``, minimised) here;
* ``mp_group``: the ranks that hold the same env lanes and different shards
  of the policy's hidden width (``learner.partition_params``).

Without an initialised process group, ``make_mesh()`` is the one-process
mesh (``dp = mp = 1``, no groups) and every collective is the identity. With
one, every collective runs through the backend, even over a single rank.

The env batch is split into equal contiguous blocks of lanes, block
``dp_rank`` on this rank (``shard_batch``). A rollout on a shard with no
policy is the free kernel with the shard's ``lane_offset``: each lane draws
the Philox words it draws in the whole batch, so the integer stats do not
depend on how many ranks share the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from jssenv_tpu_torch import vector
from jssenv_tpu_torch.core import fused_rollout
from jssenv_tpu_torch.core.state import FIELD_NAMES, Device, EnvState, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``dp x mp`` process grid (see the module
    docstring); ``device`` is where its tensors live."""

    dp: int
    mp: int
    dp_rank: int
    mp_rank: int
    device: torch.device
    dp_group: Optional[dist.ProcessGroup] = None
    mp_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.dp * self.mp

    def lanes(self, global_batch: int) -> Tuple[int, int]:
        """(offset, count) of this rank's block of a ``global_batch``-lane
        batch; raises ``ValueError`` unless ``dp`` divides it."""
        if global_batch % self.dp != 0:
            raise ValueError(f"batch size {global_batch} not divisible by mesh size {self.dp}")
        local = global_batch // self.dp
        return self.dp_rank * local, local


def make_mesh(dp: Optional[int] = None, mp: int = 1, device: Device = None) -> Mesh:
    """The ``dp x mp`` mesh over every rank of the process group (``dp``
    defaults to world size / ``mp``). Every rank must call it, in the same
    order as its other group creations. ``device``: this rank's device; by
    default the card the NCCL backend uses, or, under another backend, the
    card (``device="cpu"`` asks for the CPU). Without a process group it is
    the one-process mesh; ``dp`` and ``mp`` must then be 1."""
    if not dist.is_initialized():
        if (dp or 1) != 1 or mp != 1:
            raise ValueError(f"a {dp}x{mp} mesh needs an initialised process group (multihost.initialize)")
        return Mesh(1, 1, 0, 0, resolve_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    dp = world // mp if dp is None else dp
    if dp * mp != world:
        raise ValueError(f"a {dp}x{mp} mesh does not cover the {world} ranks")
    if device is None and dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    dev = resolve_device(device)
    # new_group is collective: every rank creates every group, in one order
    dp_groups = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
    mp_groups = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
    dp_rank, mp_rank = divmod(rank, mp)
    return Mesh(dp, mp, dp_rank, mp_rank, dev, dp_groups[mp_rank], mp_groups[dp_rank])


def all_reduce(t: torch.Tensor, group: Optional[dist.ProcessGroup], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (the identity without a group)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def shard_batch(state: EnvState, mesh: Mesh) -> EnvState:
    """This rank's contiguous block of lanes of a batch, on the mesh's
    device. Raises ``ValueError`` unless the mesh's ``dp`` divides B."""
    off, n = mesh.lanes(state.batch_size)
    return state.replace(**{k: getattr(state, k)[off:off + n].to(mesh.device) for k in FIELD_NAMES})


def rollout_shard(
    mesh: Mesh, seed: int, state: EnvState, num_steps: int, policy: Optional[vector.Policy] = None
) -> Dict[str, torch.Tensor]:
    """A rollout of this rank's lanes ``state`` (block ``dp_rank`` of equal
    blocks), its stats reduced over the global batch.

    With ``policy=None``: the free rollout (``fused_rollout.rollout_free``,
    the kernel on the card) with the block's ``lane_offset``, so the integer
    stats equal the unsplit batch's at every world size; keys as
    ``rollout_free``'s. With a policy: ``policy(generator, state)`` on this
    rank's lanes, each env step ``fused_rollout.step_autoreset`` (the driven
    kernel on the card), the generator seeded with ``seed``; keys
    ``episodes``, ``total_makespan``, ``min_makespan``, ``total_return``,
    ``steps``. Counters are summed over ``dp`` and ``min_makespan``
    minimised; ``steps`` is T times the global batch."""
    T, B = int(num_steps), state.batch_size
    if policy is None:
        off = mesh.dp_rank * B
        out = fused_rollout.rollout_free(state, T, seed=seed, lane_offset=off)
    else:
        gen = torch.Generator(device=state.device).manual_seed(seed)
        stats = vector.RolloutStats.zero(state.device)
        for _ in range(T):
            state, _, stats = fused_rollout.step_autoreset(state, policy(gen, state), stats)
        out = {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)}
    sums = [k for k in ("episodes", "total_makespan", "identity_violations") if k in out]
    packed = all_reduce(torch.stack([out[k] for k in sums]), mesh.dp_group)
    out.update(zip(sums, packed))
    out["min_makespan"] = all_reduce(out["min_makespan"].clone(), mesh.dp_group, dist.ReduceOp.MIN)
    out["total_return"] = all_reduce(out["total_return"].clone(), mesh.dp_group)
    out["steps"] = torch.tensor(T * B * mesh.dp, dtype=torch.int64, device=state.device)
    return out


def sharded_rollout(
    mesh: Mesh, seed: int, state: EnvState, num_steps: int, policy: Optional[vector.Policy] = None
) -> Dict[str, torch.Tensor]:
    """``rollout_shard`` on this rank's block of the global batch ``state``
    (``shard_batch``): the same stats as one process running the whole
    batch, placement being the only difference."""
    return rollout_shard(mesh, seed, shard_batch(state, mesh), num_steps, policy)

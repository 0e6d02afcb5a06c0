"""Multi-process scale-out: one process per card, each building its own lanes.

The PyTorch counterpart of ``jssenv_tpu/parallel/multihost.py``. The JAX
package joins hosts with ``jax.distributed.initialize`` and assembles one
global array from per-host lanes; here each process joins a
``torch.distributed`` process group, builds only the lanes of the global env
batch that it steps (``host_sharded_batch``), and every statistic over the
global batch is an explicit all-reduce (``mesh.rollout_shard``).

The backend is stated, never guessed: NCCL by default, each rank on the card
``LOCAL_RANK`` names; gloo only when asked for by name (CPU runs, or several
ranks on one card, which NCCL refuses). A failing init raises: nothing falls
back to another backend or to the CPU. With nothing configured, every
helper is the one-process behaviour, so one training script runs anywhere.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from jssenv_tpu_torch import vector
from jssenv_tpu_torch.core.state import Device, EnvState, resolve_device
from jssenv_tpu_torch.instances import InstanceSet, InstanceSpec, stack_instances
from jssenv_tpu_torch.parallel import mesh as meshlib


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group: ``init_process_group`` at
    ``coordinator_address`` (``host:port``) with ``num_processes`` ranks,
    this one ``process_id``, or, where those are not given, at torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` with its ``RANK`` and ``WORLD_SIZE``.

    A no-op when nothing is configured (no argument, no ``MASTER_ADDR`` or
    ``WORLD_SIZE`` in the environment) and on a second call. ``backend``:
    ``"nccl"`` by default, which first makes card ``LOCAL_RANK`` (else the
    rank) this process's device; ``"gloo"`` only by name."""
    configured = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
        or "MASTER_ADDR" in os.environ
        or "WORLD_SIZE" in os.environ
    )
    if not configured or dist.is_initialized():
        return
    backend = backend or "nccl"
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if backend == "nccl":
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}")
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev  # connect now: a failing NCCL init raises here
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world, rank=rank, **kwargs)


def global_mesh(device: Device = None) -> meshlib.Mesh:
    """The 1-D ``dp`` mesh over every rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return meshlib.make_mesh(dp=world, mp=1, device=device)


def host_sharded_batch(
    source: Union[InstanceSpec, InstanceSet],
    global_batch: int,
    mesh: Optional[meshlib.Mesh] = None,
) -> EnvState:
    """This rank's lanes of a ``global_batch``-lane batch, built here and
    nowhere else, on the mesh's device (``global_mesh()`` by default): block
    ``dp_rank`` of equal contiguous blocks, lane ``i`` of the global batch
    running instance ``i % len(source)`` (round-robin over the GLOBAL index,
    so the instance mix is the same at every world size). Raises
    ``ValueError`` unless ``dp`` divides ``global_batch``."""
    mesh = mesh or global_mesh()
    off, n = mesh.lanes(global_batch)
    if isinstance(source, InstanceSpec):
        source = stack_instances([source])
    return vector.make_lanes(source, torch.arange(off, off + n), mesh.device)


def multihost_rollout(
    seed: int,
    state: EnvState,
    num_steps: int,
    policy: Optional[vector.Policy] = None,
    mesh: Optional[meshlib.Mesh] = None,
) -> Dict[str, torch.Tensor]:
    """A rollout of this rank's lanes (``host_sharded_batch``) whose stats
    come back reduced over the global batch, the same on every rank
    (``mesh.rollout_shard``; ``global_mesh()`` by default)."""
    mesh = mesh or global_mesh(state.device)
    return meshlib.rollout_shard(mesh, seed, state, num_steps, policy)

"""Batch-first gather and segment-reduce primitives of the engine.

The PyTorch counterparts of ``jssenv_tpu/core/ops.py``. Every input carries a
leading batch axis ``B``; gathers are ``torch.gather`` and the per-machine
segment reductions are ``scatter_reduce``. There is one lowering only: the JAX
package's one-hot alternative exists for the TPU's vector unit and has no use
here. Integer results are int32 whatever the (possibly narrowed) table dtype.
"""

from __future__ import annotations

import torch

from jssenv_tpu_torch.core.state import I32_MAX


def _widen(x: torch.Tensor) -> torch.Tensor:
    """Promote narrow integer results to int32 (tables may be int8/int16)."""
    if not x.dtype.is_floating_point and x.dtype != torch.bool and x.element_size() < 4:
        return x.to(torch.int32)
    return x


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, J, M); idx (B, J) in [0, M) -> (B, J) ``table[b, j, idx[b, j]]``."""
    return _widen(torch.gather(table, 2, idx.long()[..., None])[..., 0])


def lookup(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec (B, M); idx (B, ...) in [0, M) -> ``vec[b, idx[b, ...]]``."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return _widen(torch.gather(vec, 1, flat).reshape(idx.shape))


def lookup2d_col(mat: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """mat (B, M, J); row_idx (B, J) in [0, M) -> (B, J) ``mat[b, row_idx[b, j], j]``."""
    return torch.gather(mat, 1, row_idx.long()[:, None, :])[:, 0, :]


def rows_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, J, M); idx (B, J, K) in [0, M) -> (B, J, K) ``table[b, j, idx[b, j, k]]``."""
    return _widen(torch.gather(table, 2, idx.long()))


def segment_min(
    seg: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """(B, J) seg/values/mask -> (B, num_segments) int32: min over j with
    ``seg[b, j] == m`` and ``mask[b, j]`` of ``values[b, j]``, else INT32_MAX.
    ``seg`` entries are caller-clipped into range."""
    vals = torch.where(mask, values.to(torch.int32), I32_MAX)
    out = torch.full(
        (seg.shape[0], num_segments), I32_MAX, dtype=torch.int32, device=seg.device
    )
    return out.scatter_reduce(1, seg.long(), vals, reduce="amin", include_self=True)


def segment_any(seg: torch.Tensor, mask: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, ...) seg/mask -> (B, num_segments) bool: any(seg == m and mask),
    the non-batch axes flattened."""
    b = seg.shape[0]
    out = torch.zeros((b, num_segments), dtype=torch.int32, device=seg.device)
    out = out.scatter_reduce(
        1,
        seg.reshape(b, -1).long(),
        mask.reshape(b, -1).to(torch.int32),
        reduce="amax",
        include_self=True,
    )
    return out > 0

"""Masked policy/value networks for scheduling agents.

The PyTorch counterpart of ``jssenv_tpu/models/policy.py``. Both nets are
``nn.Module``s with float32 parameters that compute in ``compute_dtype``
(bfloat16 by default), as flax ``Dense(dtype=bf16)`` does: each layer casts
its input, weight and bias to that dtype, multiplies, then adds the bias.
Module names are the flax names (``trunk_0``, ``policy_head``, ``job_0``,
``score_0``, ``ctx_0``, ``noop_head``, ``value_head``...), so a flax
checkpoint maps onto them layer by layer (``checkpoint.params_from_flax``).

* The action mask enters as ``-inf`` logits, so illegal actions carry exactly
  zero probability; a row with no legal action (a terminal state) gets all
  zero logits, so ``log_softmax`` stays NaN-free there.
* Logits and value come out float32.

A float32 product on the card runs in full float32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays at its default, False; the
port never sets it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` computed like flax ``Dense(dtype=compute_dtype)``:
    float32 parameters, input, weight and bias cast to ``compute_dtype``, the
    product rounded to it before the bias is added. Initialised as flax's
    default: LeCun normal (truncated at two standard deviations) weight,
    zero bias."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype, device=None):
        self.compute_dtype = compute_dtype
        super().__init__(in_features, out_features, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # flax variance_scaling(1, "fan_in", "truncated_normal"): the std of
        # the normal truncated to [-2, 2] divided by its own std
        std = math.sqrt(1.0 / self.in_features) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def _mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logits = torch.where(mask, logits, -torch.inf)
    all_dead = ~mask.any(dim=-1, keepdim=True)
    return torch.where(all_dead, 0.0, logits)


class MaskedPolicyNet(nn.Module):
    """MLP over the flattened (J, C) observation -> (J+1) masked logits + value.

    ``obs_width`` is J * C, the flattened input width (flax infers it from
    the first call)."""

    def __init__(
        self,
        num_actions: int,
        obs_width: int,
        hidden: Sequence[int] = (256, 256),
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.num_actions, self.hidden, self.compute_dtype = num_actions, tuple(hidden), compute_dtype
        widths = (obs_width,) + self.hidden
        for i in range(len(self.hidden)):
            self.add_module(f"trunk_{i}", Dense(widths[i], widths[i + 1], compute_dtype))
        self.policy_head = Dense(widths[-1], num_actions, compute_dtype)
        self.value_head = Dense(widths[-1], 1, compute_dtype)

    def forward(
        self, obs: torch.Tensor, mask: torch.Tensor, valid: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs: (..., J, C) float32; mask: (..., J+1) bool; ``valid`` is
        accepted and ignored, so both nets share one call signature.

        Returns (logits (..., J+1) float32 with -inf on illegal actions,
        value (...,) float32)."""
        del valid
        x = obs.reshape(obs.shape[:-2] + (-1,))
        for i in range(len(self.hidden)):
            x = F.relu(getattr(self, f"trunk_{i}")(x))
        logits = self.policy_head(x).float()
        value = self.value_head(x).float()[..., 0]
        return _mask_logits(logits, mask), value


class PerJobPolicyNet(nn.Module):
    """Size- and permutation-invariant policy: a shared per-job scorer.

    A shared MLP embeds each job's C features; a masked mean and max pool
    over the present jobs (``valid``) gives a context vector; each job's
    logit comes from [its embedding, the context], the no-op logit and the
    value from the context alone. One checkpoint runs any (J, M), ragged
    batches included."""

    def __init__(
        self,
        in_features: int,
        hidden: int = 128,
        depth: int = 2,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.hidden, self.depth, self.compute_dtype = hidden, depth, compute_dtype
        for i in range(depth):
            self.add_module(f"job_{i}", Dense(in_features if i == 0 else hidden, hidden, compute_dtype))
        self.score_0 = Dense(3 * hidden, hidden, compute_dtype)
        self.score_head = Dense(hidden, 1, compute_dtype)
        self.ctx_0 = Dense(2 * hidden, hidden, compute_dtype)
        self.noop_head = Dense(hidden, 1, compute_dtype)
        self.value_head = Dense(hidden, 1, compute_dtype)

    def forward(
        self, obs: torch.Tensor, mask: torch.Tensor, valid: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs: (..., J, C) float32; mask: (..., J+1) bool; valid: (..., J)
        bool, which job rows exist (all when None).

        Returns (logits (..., J+1) float32 with -inf on illegal actions,
        value (...,) float32)."""
        dt = self.compute_dtype
        if valid is None:
            valid = torch.ones(obs.shape[:-1], dtype=torch.bool, device=obs.device)
        x = obs.to(dt)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"job_{i}")(x))
        v3 = valid[..., None]
        n = valid.sum(dim=-1, keepdim=True).clamp(min=1)
        mean = torch.where(v3, x, 0).sum(dim=-2) / n.to(dt)
        mx = torch.where(v3, x, torch.tensor(-1e4, dtype=dt, device=x.device)).amax(dim=-2)
        ctx = torch.cat([mean, mx], dim=-1)  # (..., 2H)
        xc = torch.cat([x, ctx[..., None, :].expand(x.shape[:-1] + (2 * self.hidden,))], dim=-1)
        job_logit = self.score_head(F.relu(self.score_0(xc)))[..., 0]
        g = F.relu(self.ctx_0(ctx))
        logits = torch.cat([job_logit, self.noop_head(g)], dim=-1).float()
        value = self.value_head(g).float()[..., 0]
        return _mask_logits(logits, mask), value


def sample_action(
    generator: Optional[torch.Generator], logits: torch.Tensor, lanes: Optional[Tuple[int, int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample from masked logits by Gumbel-max on ``generator`` (on the
    logits' device); returns (action int64, log_prob float32). The draws
    differ from ``jax.random.categorical``'s.

    ``lanes = (offset, global_batch)``: the (B, A) logits are rows
    [offset, offset + B) of a batch of ``global_batch`` rows split over
    ranks (``parallel.mesh``). The noise is drawn for the whole batch and
    these rows kept, so a row's action does not depend on the split; at
    (0, B) it is the draw without ``lanes``."""
    shape = logits.shape if lanes is None else (lanes[1],) + tuple(logits.shape[1:])
    u = torch.rand(shape, generator=generator, device=logits.device)
    if lanes is not None:
        u = u[lanes[0]:lanes[0] + logits.shape[0]]
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    action = torch.argmax(logits + gumbel, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, action[..., None])[..., 0]
    return action, logp

"""Floating-point operations of the learner's policy nets, counted from
their shapes: the port's ``models.policy.MaskedPolicyNet`` (``flat``: a
Dense trunk over the flattened (J, C) observation, a J+1 policy head and a
value head; frozen at the benchmark's first version) and
``PerJobPolicyNet`` (``perjob``: a job MLP shared by the J rows, a scorer
over [a row, the two pools] on every row, and the no-op and value heads over
the pools)."""

from __future__ import annotations

from typing import Sequence


def masked_net_macs(J: int, C: int, hidden: Sequence[int]) -> int:
    """Multiply-adds of one sample's forward pass: every Dense layer's in x
    out (the biases, ReLU, mask and softmax are left out)."""
    widths = [J * C, *hidden]
    trunk = sum(a * b for a, b in zip(widths, widths[1:]))
    return trunk + widths[-1] * (J + 1) + widths[-1]


def perjob_net_macs(J: int, C: int, hidden: Sequence[int]) -> int:
    """Multiply-adds of one sample's forward pass of the per-job net of
    width H = hidden[0] and depth len(hidden): on each of the J rows
    (padded ones too, as the net runs them) the job MLP (C*H, then H*H a
    layer), ``score_0`` (3H*H) and ``score_head`` (H); once a sample
    ``ctx_0`` (2H*H) and the no-op and value heads (H each). The pools, the
    biases, ReLU, mask and softmax are left out."""
    H, depth = hidden[0], len(hidden)
    return J * (C * H + (depth - 1) * H * H + 3 * H * H + H) + 2 * H * H + 2 * H


NETS = {"flat": masked_net_macs, "perjob": perjob_net_macs}


def reinforce_update_flops(J: int, C: int, hidden: Sequence[int], B: int, T: int, arch: str = "flat") -> int:
    """One REINFORCE update on B lanes over T steps with the ``arch`` net:
    the forward pass over the B*T rollout samples, then forward and
    backward over them in the loss (3x a forward), two FLOPs a
    multiply-add."""
    if arch not in NETS:
        raise ValueError(f"unknown arch {arch!r}; one of {sorted(NETS)}")
    return 2 * NETS[arch](J, C, hidden) * B * T * (1 + 3)

"""Floating-point operations of the learner's policy net, counted from its
shapes (the port's ``models.policy.MaskedPolicyNet``: a Dense trunk over the
flattened (J, C) observation, a J+1 policy head and a value head; frozen at
the benchmark's first version)."""

from __future__ import annotations

from typing import Sequence


def masked_net_macs(J: int, C: int, hidden: Sequence[int]) -> int:
    """Multiply-adds of one sample's forward pass: every Dense layer's in x
    out (the biases, ReLU, mask and softmax are left out)."""
    widths = [J * C, *hidden]
    trunk = sum(a * b for a, b in zip(widths, widths[1:]))
    return trunk + widths[-1] * (J + 1) + widths[-1]


def reinforce_update_flops(J: int, C: int, hidden: Sequence[int], B: int, T: int) -> int:
    """One REINFORCE update on B lanes over T steps: the forward pass over
    the B*T rollout samples, then forward and backward over them in the loss
    (3x a forward), two FLOPs a multiply-add."""
    return 2 * masked_net_macs(J, C, hidden) * B * T * (1 + 3)

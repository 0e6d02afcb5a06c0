"""The numbers that decide ``correct``, each held against its limit.

A check is (name, number, limit) and passes where the number is at most the
limit. Exact comparisons have the limit 0. The training gaps of the
gradient and the update are the rule: per leaf, the gap between the
program's norm and the reference's, over the larger of the reference's norm
of that leaf and of the median leaf; the worst leaf counts. The policy's
logits on the first update's sampled steps, where both nets hold the same
weights, are compared entry by entry (``logit_rel_gap``): a gap first
order in the nets' rounding, which gaps of norms and of the loss average
away over many samples.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

Check = Tuple[str, float, float]


def passed(checks: List[Check]) -> bool:
    return all(value <= limit for _, value, limit in checks)


def free(prog: Dict[str, float], ref: Dict[str, float], violations: int, limits: dict) -> List[Check]:
    """One free call's stats against the reference's; ``violations``: the
    program's reward-identity violations over every call of the window."""
    return [
        ("episodes_gap", abs(prog["episodes"] - ref["episodes"]), 0),
        ("makespan_sum_gap", abs(prog["total_makespan"] - ref["total_makespan"]), 0),
        ("makespan_min_gap", abs(prog["min_makespan"] - ref["min_makespan"]), 0),
        ("identity_violations", violations + ref["identity_violations"], 0),
        ("return_rel_gap", abs(prog["total_return"] - ref["total_return"]) / max(abs(ref["total_return"]), 1e-30),
         limits["return_rel_gap"]),
    ]


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> List[float]:
    """Each leaf's gap of norms, over max(its reference norm, the median
    leaf's reference norm)."""
    p, r = _norms({k: prog[k] for k in ref}), _norms(ref)
    med = statistics.median(r.values())
    return [abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in ref]


def moved(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's norm."""
    n = _norms(grads)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= 1e-3 * med]


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The norm of the logits' gap over the norm of the reference's, over
    every sampled step, on the legal actions (the reference's finite
    logits). ``prog``, ``ref``: (T, B, J+1)."""
    legal = torch.isfinite(ref)
    gap = torch.where(legal, prog.double() - ref.double(), 0.0)
    return float(torch.linalg.vector_norm(gap) / torch.linalg.vector_norm(torch.where(legal, ref.double(), 0.0)))


def train(prog: dict, ref: dict, params0: Dict[str, torch.Tensor], limits: dict) -> List[Check]:
    """Updates of the program against the reference's: ``losses`` (one per
    update), ``grads`` (the first update's gradient per leaf), ``params``
    after the last update, starting from ``params0``, ``logits`` (the
    first update's, on its sampled steps); ``mismatches``: the
    env entries that differ (masks, rewards, ends, the final state)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    keep = moved(ref["grads"])
    delta = lambda params: {k: params[k].double() - params0[k].double() for k in keep}  # noqa: E731
    return [
        ("env_mismatches", prog["mismatches"] + ref["mismatches"], 0),
        ("loss_rel_gap", loss_gap, limits["loss_rel_gap"]),
        ("grad_norm_gap", max(leaf_gaps(prog["grads"], ref["grads"])), limits["grad_norm_gap"]),
        ("update_norm_gap", max(leaf_gaps(delta(prog["params"]), delta(ref["params"]))), limits["update_norm_gap"]),
        ("logit_rel_gap", logit_gap(prog["logits"], ref["logits"]), limits["logit_rel_gap"]),
    ]


def worst(*phases: List[Check]) -> List[Check]:
    """The checks of several phases of one run as one list: each number
    the worst over the phases (the sum, for an exact count)."""
    out = []
    for name, value, limit in phases[0]:
        values = [v for phase in phases for n, v, _ in phase if n == name]
        out.append((name, sum(values) if limit == 0 else max(values), limit))
    return out

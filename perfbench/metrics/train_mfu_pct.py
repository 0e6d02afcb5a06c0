"""The whole update's share of the cards' bfloat16 peak, in %: the policy
net's FLOPs of one update on a card (``counts/policy.py``, for the net the
run's ``arch`` names: the rollout's forward over B*T samples, forward and
backward in the loss) over the median host time of the window's untraced
updates times the dense bfloat16 peak (``counts/peaks.py``). Every card does
the same work in the same time, so the share is one card's."""

from perfbench.counts.peaks import BF16_DENSE_FLOPS
from perfbench.counts.policy import reinforce_update_flops


def read(trace):
    s = trace.sizes
    if s.get("mode") != "train" or not s.get("update_s"):
        return None
    flops = reinforce_update_flops(s["J"], s["C"], s["hidden"], s["B"], s["unroll"], s["arch"])
    return 100.0 * flops / (s["update_s"] * BF16_DENSE_FLOPS)

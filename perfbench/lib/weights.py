"""The learner's policy weights, made by the benchmark from the seed.

Both sides get these: the program as the ``params`` of its train state, the
plain reference as its starting point. Made on the run's device by one
``torch.Generator`` seeded with the run's seed, in two large calls: a LeCun
normal truncated at two standard deviations for every weight, zero biases
(flax's ``Dense`` defaults), float32 (the program's parameter type).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def layers(J: int, C: int, hidden: Sequence[int]) -> List[Tuple[str, int, int]]:
    """(name, in, out) of each Dense layer of the flat policy net."""
    widths = [J * C, *hidden]
    out = [(f"trunk_{i}", a, b) for i, (a, b) in enumerate(zip(widths, widths[1:]))]
    return out + [("policy_head", widths[-1], J + 1), ("value_head", widths[-1], 1)]


def make(seed: int, J: int, C: int, hidden: Sequence[int], device) -> Dict[str, torch.Tensor]:
    spec = layers(J, C, hidden)
    g = torch.Generator(device=device).manual_seed(int(seed) & (2**64 - 1))
    w = torch.randn(sum(i * o for _, i, o in spec), generator=g, device=device).clamp_(-2.0, 2.0)
    b = torch.zeros(sum(o for _, _, o in spec), device=device)
    params, wi, bi = {}, 0, 0
    for name, i, o in spec:
        params[f"{name}.weight"] = w[wi:wi + i * o].view(o, i) * ((1.0 / i) ** 0.5 / 0.87962566103423978)
        params[f"{name}.bias"] = b[bi:bi + o]
        wi, bi = wi + i * o, bi + o
    return params

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


def layers(J: int, C: int, hidden: Sequence[int], arch: str = "flat") -> List[Tuple[str, int, int]]:
    """(name, in, out) of each Dense layer of the configured policy net,
    in the order of the draw.

    * ``flat``: a trunk over the flattened (J, C) observation, a J+1
      policy head and a value head;
    * ``perjob``: a job MLP shared by the J rows (``job_i``, one width, as
      deep as ``hidden`` is long), a scorer over [a row's embedding, the
      mean and max pools] (``score_0``, ``score_head``), and the no-op and
      value heads over the pools (``ctx_0``, ``noop_head``, ``value_head``).
    """
    if arch == "flat":
        widths = [J * C, *hidden]
        out = [(f"trunk_{i}", a, b) for i, (a, b) in enumerate(zip(widths, widths[1:]))]
        return out + [("policy_head", widths[-1], J + 1), ("value_head", widths[-1], 1)]
    if arch != "perjob":
        raise ValueError(f"unknown arch {arch!r}; one of 'flat', 'perjob'")
    H = hidden[0]
    if any(h != H for h in hidden):
        raise ValueError(f"the perjob net has one width, not {list(hidden)}")
    out = [(f"job_{i}", C if i == 0 else H, H) for i in range(len(hidden))]
    return out + [("score_0", 3 * H, H), ("score_head", H, 1), ("ctx_0", 2 * H, H), ("noop_head", H, 1),
                  ("value_head", H, 1)]


def make(seed: int, J: int, C: int, hidden: Sequence[int], device, arch: str = "flat") -> Dict[str, torch.Tensor]:
    spec = layers(J, C, hidden, arch)
    g = torch.Generator(device=device).manual_seed(int(seed) & (2**64 - 1))
    w = torch.randn(sum(i * o for _, i, o in spec), generator=g, device=device).clamp_(-2.0, 2.0)
    b = torch.zeros(sum(o for _, _, o in spec), device=device)
    params, wi, bi = {}, 0, 0
    for name, i, o in spec:
        params[f"{name}.weight"] = w[wi:wi + i * o].view(o, i) * ((1.0 / i) ** 0.5 / 0.87962566103423978)
        params[f"{name}.bias"] = b[bi:bi + o]
        wi, bi = wi + i * o, bi + o
    return params

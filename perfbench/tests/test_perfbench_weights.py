"""The harness's policy weights: the flat net's draw is the one the
benchmark has made since its first version, and the per-job net's loads into
the port's ``PerJobPolicyNet``."""

from typing import Dict, List, Sequence, Tuple

import pytest
import torch

from perfbench.lib import weights


def frozen_layers(J: int, C: int, hidden: Sequence[int]) -> List[Tuple[str, int, int]]:
    """The flat net's layers as the benchmark's first version listed them."""
    widths = [J * C, *hidden]
    out = [(f"trunk_{i}", a, b) for i, (a, b) in enumerate(zip(widths, widths[1:]))]
    return out + [("policy_head", widths[-1], J + 1), ("value_head", widths[-1], 1)]


def frozen_make(seed: int, J: int, C: int, hidden: Sequence[int], device) -> Dict[str, torch.Tensor]:
    """``weights.make`` as the benchmark's first version drew the flat net."""
    spec = frozen_layers(J, C, hidden)
    g = torch.Generator(device=device).manual_seed(int(seed) & (2**64 - 1))
    w = torch.randn(sum(i * o for _, i, o in spec), generator=g, device=device).clamp_(-2.0, 2.0)
    b = torch.zeros(sum(o for _, _, o in spec), device=device)
    params, wi, bi = {}, 0, 0
    for name, i, o in spec:
        params[f"{name}.weight"] = w[wi:wi + i * o].view(o, i) * ((1.0 / i) ** 0.5 / 0.87962566103423978)
        params[f"{name}.bias"] = b[bi:bi + o]
        wi, bi = wi + i * o, bi + o
    return params


@pytest.mark.parametrize("seed", [0, 2**31 + 77, 2**33 + 1, 2**64 - 1])
@pytest.mark.parametrize("J,C,hidden", [(15, 7, (256, 256)), (30, 7, [64, 32])])
def test_flat_weights_bit_for_bit(seed, J, C, hidden):
    want = frozen_make(seed, J, C, hidden, "cpu")
    for got in (weights.make(seed, J, C, hidden, "cpu"), weights.make(seed, J, C, hidden, "cpu", "flat")):
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_perjob_weights_load_into_the_port_s_net(depth):
    from jssenv_tpu_torch.models.policy import PerJobPolicyNet

    net = PerJobPolicyNet(13, hidden=128, depth=depth)
    params = weights.make(2**31 + 1, 30, 13, [128] * depth, "cpu", "perjob")
    assert {k: tuple(v.shape) for k, v in params.items()} == {k: tuple(v.shape) for k, v in net.state_dict().items()}
    net.load_state_dict(params)
    for name, i, _ in weights.layers(30, 13, [128] * depth, "perjob"):  # LeCun's scale, zero biases
        w = params[f"{name}.weight"]
        assert float(w.abs().max()) <= 2.0 * (1.0 / i) ** 0.5 / 0.87962566103423978 + 1e-6
        assert not params[f"{name}.bias"].any()


@pytest.mark.parametrize("arch,hidden,match", [("conv", [128, 128], "'conv'"), ("perjob", [128, 64], "one width")])
def test_unknown_nets_are_named(arch, hidden, match):
    with pytest.raises(ValueError, match=match):
        weights.make(1, 30, 13, hidden, "cpu", arch)

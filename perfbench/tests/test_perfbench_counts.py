"""The frozen counts against values worked out by hand, and the per-layer
readers on a made-up trace."""

import pytest

from perfbench.counts import peaks, policy, rollout
from perfbench.lib import manifest
from perfbench.lib.trace import Event, Trace


def test_free_bound_ta01_is_its_operations():
    # 16384 lanes x 1024 steps x (5*15 + 2*15 + 100) int32 operations
    ops = 16384 * 1024 * 205
    assert ops == 3_439_329_280
    # (4 + 150 + 30) int16 rows a lane, the table of one instance, 5 + 8 + 1
    # int32 words a lane of constants, stats and return
    nbytes = 184 * 16384 * 2 + 4 * (900 + 14 * 16384)
    assert nbytes == 6_950_416
    assert rollout.free_bound_s(16384, 1024, 15, 15, 2, 1) == pytest.approx(ops / 16.75e12)
    assert ops / 16.75e12 == pytest.approx(2.0533e-4, rel=1e-4)


def test_free_bound_of_the_30x20_mix():
    # ta01-ta10 with ta41-ta50 padded to 30x20, 10240 lanes, int32
    assert rollout.free_bound_s(10240, 1024, 30, 20, 4, 20) == pytest.approx(1024 * 10240 * 290 / 16.75e12)
    assert rollout.free_bound_s(10240, 1024, 30, 20, 4, 20) == pytest.approx(1.81545e-4, rel=1e-4)


def test_driven_bound_at_the_learner_s_step_is_its_bytes():
    assert rollout.light_state_bytes(15, 15) == 598
    nbytes = 2 * 598 * 8192 + 4 * 10 * 4 * 225 + 3 * 4 * 8192
    assert nbytes == 9_931_936
    assert rollout.driven_bound_s(8192, 1, 15, 15, 10) == pytest.approx(nbytes / 3.35e12)
    assert rollout.driven_bound_s(8192, 1, 15, 15, 10) == pytest.approx(2.9648e-6, rel=1e-4)


def test_light_state_bytes_match_the_port_s_state():
    import torch

    from jssenv_tpu_torch import instances, vector

    state = vector.strip_solution(vector.make_batch(instances.get_instance("ta01"), 4, device="cpu"))
    per_lane = sum(t.numel() * t.element_size() for t in state.dynamic_fields().values()) // 4
    assert per_lane == rollout.light_state_bytes(15, 15)
    assert state.time.dtype == torch.int32


def test_policy_flops():
    assert policy.masked_net_macs(15, 7, (256, 256)) == 105 * 256 + 256 * 256 + 256 * 16 + 256 == 96_768
    assert policy.reinforce_update_flops(15, 7, (256, 256), 8192, 32) == 2 * 96_768 * 8192 * 32 * 4
    assert policy.reinforce_update_flops(15, 7, (256, 256), 8192, 32) == 202_937_204_736


def test_policy_macs_match_the_port_s_net():
    from jssenv_tpu_torch.models.policy import MaskedPolicyNet

    net = MaskedPolicyNet(16, 105)
    weights = sum(p.numel() for n, p in net.named_parameters() if n.endswith("weight"))
    assert weights == policy.masked_net_macs(15, 7, (256, 256))


def test_flat_update_flops_unchanged():
    """The flat count, named or by default, is the value the benchmark has
    read since its first version."""
    assert policy.reinforce_update_flops(15, 7, (256, 256), 8192, 32, "flat") == 202_937_204_736
    assert policy.reinforce_update_flops(15, 7, [256, 256], 8192, 32) == 202_937_204_736


def test_perjob_flops():
    # J (C H + (depth - 1) H^2 + 3 H^2 + H) + 2 H^2 + 2 H at J=30, C=13, H=128, depth 2
    assert policy.perjob_net_macs(30, 13, (128, 128)) == 30 * (1664 + 16384 + 49152 + 128) + 32768 + 256 == 2_052_864
    assert policy.reinforce_update_flops(30, 13, (128, 128), 8192, 32, "perjob") == 2 * 2_052_864 * 8192 * 32 * 4
    with pytest.raises(ValueError, match="'conv'"):
        policy.reinforce_update_flops(30, 13, (128, 128), 8192, 32, "conv")


@pytest.mark.parametrize("J,depth", [(30, 2), (15, 3)])
def test_perjob_macs_match_the_port_s_net(J, depth):
    """Each row runs the job MLP and the scorer; each sample the context
    layer and the two heads over the pools."""
    from jssenv_tpu_torch.models.policy import PerJobPolicyNet

    net = PerJobPolicyNet(13, hidden=64, depth=depth)
    w = {n.split(".")[0]: p.numel() for n, p in net.named_parameters() if n.endswith("weight")}
    rows = sum(v for k, v in w.items() if k.startswith(("job_", "score_")))
    assert J * rows + w["ctx_0"] + w["noop_head"] + w["value_head"] == policy.perjob_net_macs(J, 13, [64] * depth)


def _trace(mode="train"):
    dev = [Event("driven_static_kernel", 10.0, 10.0), Event("driven_static_kernel", 50.0, 10.0),
           Event("ncclDevKernel_AllReduce", 70.0, 20.0), Event("Memcpy DtoH", 85.0, 10.0)]
    host = [Event("aten::mm", 20.0, 30.0), Event("aten::add", 25.0, 5.0)]
    sizes = dict(mode=mode, B=8192, unroll=32, J=15, M=15, C=7, hidden=[256, 256], arch="flat", features="reference",
                 instances=10, update_s=0.08, T=1024, value_bytes=2)
    return Trace((0.0, 100.0), dev, host, units=2, sizes=sizes)


def test_trace_busy_idle_and_breakdown():
    tr = _trace()
    assert tr.intervals() == [(10.0, 20.0), (50.0, 60.0), (70.0, 95.0)]
    assert tr.busy_s == pytest.approx(45e-6) and tr.window_s == pytest.approx(100e-6)
    br = tr.breakdown()
    assert br["device_ops"][0] == ["driven_static_kernel", pytest.approx(20e-6)]
    gaps = dict((k, v) for k, v in br["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(30e-6)  # 20-50, the innermost at its middle
    assert gaps["python"] == pytest.approx(25e-6)  # 0-10, 60-70, 95-100


@pytest.mark.parametrize("name,expect", [
    ("device_idle_pct.train", 55.0),
    ("device_ops_per_update", 2.0),
    ("allreduce_ms_per_update", 0.01),
    ("driven_kernel_roofline", 100 * 2.9648e-6 / 10e-6),
    ("train_mfu_pct", 100 * 202_937_204_736 / (0.08 * peaks.BF16_DENSE_FLOPS)),
    ("device_idle_pct.free", None),
    ("free_kernel_roofline", None),
])
def test_readers(name, expect):
    value = manifest.reader(name).read(_trace())
    if expect is None:
        assert value is None
    else:
        assert value == pytest.approx(expect, rel=1e-4)


def test_readers_find_nothing_without_device_events():
    tr = _trace("free")
    tr.device = []
    for name in ("free_kernel_roofline", "device_idle_pct.free"):
        assert manifest.reader(name).read(tr) is None

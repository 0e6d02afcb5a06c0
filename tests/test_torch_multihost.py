"""The port's multi-process rollouts: ranks over gloo against one process.

Ranks are processes of this file (``python tests/test_torch_multihost.py
OUT PORT WORLD RANK``) joined over gloo on 127.0.0.1. Each builds only its
own lanes (``multihost.host_sharded_batch``), runs the free rollout (the
plain twin on the CPU, with its block's ``lane_offset``) and a dispatching
rule's driven rollout with all-reduced stats, and a ``sharded_rollout`` of a
whole batch, and writes what it saw to an npz. The test process holds every
rank's global stats against one process's run of the whole batch: integer
stats equal, the return within rel 1e-5 (tests/test_parallel.py:34-54 and
tests/test_multihost_2proc.py for the JAX package)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import fused_rollout as fr  # noqa: E402
from jssenv_tpu_torch.parallel import mesh as tm  # noqa: E402
from jssenv_tpu_torch.parallel import multihost as th  # noqa: E402
from jssenv_tpu_torch.rules import dispatching as dsp  # noqa: E402

GLOBAL_B, STEPS, SEED = 64, 256, 0
SHARDED_STEPS, SHARDED_SEED = 288, 7
RULE_STEPS = 240  # the SPT episodes on ta01 end at step 225
INTS = ("episodes", "total_makespan", "min_makespan", "steps")


def runs():
    """(name, stats) of every rollout a rank runs; the same calls on one
    process (no process group) are the reference."""
    mesh = th.global_mesh(device="cpu")
    spec = ti.get_instance("ta01")
    local = th.host_sharded_batch(spec, GLOBAL_B, mesh)
    out = {"free": th.multihost_rollout(SEED, local, STEPS),
           "rule": th.multihost_rollout(SEED, local, RULE_STEPS, policy=dsp.get_rule("SPT").policy()),
           "sharded": tm.sharded_rollout(mesh, SHARDED_SEED, tv.make_batch(spec, GLOBAL_B, device="cpu"),
                                         SHARDED_STEPS)}
    return {k: {n: v.item() for n, v in s.items()} for k, s in out.items()}


def _rank_main(out, port, world, rank):
    torch.set_num_threads(1)
    th.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    th.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")  # a second call is a no-op
    mesh = th.global_mesh(device="cpu")
    assert (mesh.dp, mesh.dp_rank, mesh.mp) == (world, rank, 1)
    res = runs()
    ragged = th.host_sharded_batch(ti.get_instance_set(["ta01", "ta41"]), 8, mesh)
    try:
        tm.shard_batch(tv.make_batch(ti.get_instance("ta01"), 30, device="cpu"), mesh)
        raised = False
    except ValueError:
        raised = True
    np.savez(os.path.join(out, f"rank{rank}.npz"), raised=raised, num_jobs=ragged.num_jobs.numpy(),
             **{f"{k}_{n}": v for k, s in res.items() for n, v in s.items()})
    torch.distributed.destroy_process_group()


def spawn(script, out, world, *args, timeout=240):
    """Run ``world`` ranks of ``script`` (``script OUT PORT WORLD RANK
    *args``) joined over gloo on 127.0.0.1; retries on a fresh port where
    the bind-then-close port was taken. Every rank is waited for (or killed
    at ``timeout``), and a failing rank fails the test with its output."""
    for _ in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
        procs = [subprocess.Popen([sys.executable, script, str(out), str(port), str(world), str(r), *map(str, args)],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return outs
        if not any("address already in use" in o.lower() for o in outs):
            break
    pytest.fail("a rank failed:\n" + "\n---\n".join(outs))


@pytest.fixture(scope="module")
def single():
    return runs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    got = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"world{world}")
        spawn(os.path.abspath(__file__), d, world)
        got[world] = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    return got


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("run", ["free", "rule", "sharded"])
def test_ranks_report_the_single_process_stats(ranks, single, world, run):
    want = single[run]
    assert want["episodes"] > 0
    if run != "rule":
        assert want["identity_violations"] == 0
    for r in ranks[world]:
        for k in INTS + (("identity_violations",) if run != "rule" else ()):
            assert int(r[f"{run}_{k}"]) == want[k], (run, k)
        assert float(r[f"{run}_total_return"]) == pytest.approx(want["total_return"], rel=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_tile_the_global_batch(ranks, world):
    """Round-robin over the GLOBAL lane index, whatever the split; and
    shard_batch raises where the world does not divide B (30 % 4)."""
    jobs = np.concatenate([r["num_jobs"] for r in ranks[world]])
    assert list(jobs) == [15, 30] * 4
    assert [bool(r["raised"]) for r in ranks[world]] == [30 % world != 0] * world


def test_one_process_helpers(monkeypatch):
    """No process group configured: ``initialize`` is a no-op, the mesh has
    one rank, and the ragged tiling is round-robin (tests/test_aux.py:96)."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    th.initialize()
    assert not torch.distributed.is_initialized()
    mesh = th.global_mesh(device="cpu")
    assert (mesh.dp, mesh.mp, mesh.dp_rank) == (1, 1, 0)
    state = th.host_sharded_batch(ti.get_instance_set(["ta01", "ta41"]), 8, mesh)
    assert state.num_jobs.tolist() == [15, 30] * 4
    with pytest.raises(ValueError, match="not divisible"):
        tm.Mesh(4, 1, 0, 0, torch.device("cpu")).lanes(30)


def test_nccl_init_without_a_card_raises(monkeypatch):
    """The default backend is NCCL on the rank's card; without one it
    raises and joins no group (no gloo, no CPU rank in its place)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.initialize("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("offset", [0, 16, 40])
def test_twin_lane_offset_draws_the_global_lanes(offset):
    """A block of lanes run with its ``lane_offset`` gives, lane for lane,
    the stats of those lanes in the whole batch's run."""
    src = ti.stack_instances([ti.get_instance("ta01")])
    whole = fr.free_lane_stats(tv.make_lanes(src, torch.arange(64), "cpu"), 288, seed=3)
    part = fr.free_lane_stats(tv.make_lanes(src, torch.arange(offset, offset + 24), "cpu"), 288, seed=3,
                              lane_offset=offset)
    for k in ("episodes", "mk_sum", "mk_min", "viol", "ret"):
        assert torch.equal(part[k], whole[k][offset:offset + 24]), k
    assert int(whole["episodes"].sum()) > 0
    w = fr.philox_bits(3, 5, 24, "cpu", lane_offset=offset)
    assert torch.equal(w, fr.philox_bits(3, 5, 64, "cpu")[offset:offset + 24])


@pytest.mark.cuda
@pytest.mark.parametrize("name,vdt", [("ta41", torch.int32), ("ta01", torch.int32), ("ta01", torch.int16)])
def test_offset_kernel_on_card(name, vdt):
    """The free kernel on the second half of a batch with its
    ``lane_offset``: every per-lane stat equal to the twin's on that half
    and to the whole batch's kernel run, in the static build on the
    state's fields and in rollout.cu's build in both instantiations."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run `pytest -m cuda tests/test_torch_*.py` on the card")
    dev = torch.device("cuda")
    src = ti.stack_instances([ti.get_instance(name)])
    T = 700 if name == "ta41" else 300
    whole = tv.make_lanes(src, torch.arange(512), dev)
    half = tv.make_lanes(src, torch.arange(256, 512), dev)
    k = fr._free_kernel(half, T, 9, None, lane_offset=256)
    w = fr._free_kernel(whole, T, 9, None)
    g = fr._free_kernel(half, T, 9, None, vdt, lane_offset=256, build="rollout")
    t = fr.free_lane_stats_reference(half, T, 9, lane_offset=256)
    for key in ("episodes", "mk_sum", "mk_min", "viol", "ret"):
        assert torch.equal(k[key], w[key][256:]) and torch.equal(g[key], k[key]), key
        if key != "ret":
            assert torch.equal(k[key], t[key]), key
    assert float((k["ret"] - t["ret"]).abs().max()) <= 1e-3 and int(k["episodes"].sum()) > 0


if __name__ == "__main__":
    _rank_main(sys.argv[1], *map(int, sys.argv[2:5]))

#!/usr/bin/env python
"""Multi-card weak-scaling curve of the sharded rollout, on the PyTorch/CUDA
port. The counterpart of ``tools/bench_scaling.py``.

Runs ``parallel.mesh.sharded_rollout`` on 1/2/4/8 cards (cut at the cards
there are, as the JAX tool cuts at its devices) with the global batch scaled
with them (weak scaling: ``lanes_per_device`` lanes a card), ta01, under
the uniform-over-legal policy (``vector.random_legal_actions``), each env
step one launch of the driven kernel (``fused_rollout.step_autoreset``).
Each card count is one process per card, joined over NCCL
(``parallel.multihost.initialize`` at ``tcp://127.0.0.1:<free port>``,
``parallel.mesh.make_mesh``); rank 0 reports. A warm-up of 8 steps, then the
best of 3 repeats at seeds 1, 2, 3, each timed on the host clock from a
barrier to the stats reduced over the ranks. ``step_us``, the wall time of
one vectorized env step, should stay near flat as cards double: the env
batch needs no communication until the final stats reduction.

Prints the JAX tool's record as ONE JSON line on stdout,
``{"weak_scaling": [{"devices", "batch", "steps_per_s", "step_us",
"episodes"}, ...], "speedup_at_max": x}``, plus the card's name and power
limit (``gpu``, ``power_limit``); diagnostics on stderr, the ranks' summed
kernel launches last (``kernel launches: {...}``). ``episodes`` is the last
repeat's (seed 3), summed over the ranks.

Without a card it exits 1; ``--device cpu`` runs the 1- and 2-rank rows on
the CPU over gloo, where the numbers time PyTorch's CPU kernels and say
nothing of a card.

Usage:
    python tools/bench_scaling_torch.py [lanes_per_device] [steps] [--device cuda|cpu]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

INSTANCE = "ta01"
COUNTS = (1, 2, 4, 8)
CPU_RANKS = 2  # the largest gloo row of a --device cpu run
WARMUP_STEPS = 8
REPEATS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rank(rank: int, world: int, port: int, lanes: int, steps: int, device: str = "cuda") -> dict:
    """One rank of a ``world``-card row: joins the group (NCCL on the card,
    gloo on the CPU), runs the warm-up and the repeats on its shard of the
    ``lanes * world``-lane batch, and returns the row (the same on every
    rank) with this rank's launches."""
    import torch
    import torch.distributed as dist

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import fused_rollout
    from jssenv_tpu_torch.parallel import mesh as meshlib, multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="nccl" if device == "cuda" else "gloo")
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
        mesh = meshlib.make_mesh(device=dev)
        batch = lanes * world
        state = vector.make_batch(instances.get_instance(INSTANCE), batch, device=dev)
        policy = vector.random_legal_actions
        fused_rollout.reset_launch_counts()
        meshlib.sharded_rollout(mesh, 0, state, WARMUP_STEPS, policy)["episodes"].item()
        best, st = 0.0, None
        for r in range(REPEATS):
            dist.barrier()
            t0 = time.perf_counter()
            st = meshlib.sharded_rollout(mesh, r + 1, state, steps, policy)
            episodes = int(st["episodes"])  # the one readback, as the JAX tool's device_get
            best = max(best, batch * steps / (time.perf_counter() - t0))
        # wall-clock per vectorized env step = batch / best: flat under
        # perfect weak scaling
        return {"devices": world, "batch": batch, "steps_per_s": round(best), "step_us": round(1e6 * batch / best, 2),
                "episodes": episodes, "launches": dict(fused_rollout.LAUNCHES)}
    finally:
        dist.destroy_process_group()


def run_row(world: int, lanes: int, steps: int, device: str, timeout: int = 900) -> dict:
    """``world`` rank processes of this tool; every child is waited for or
    killed, and a failing rank raises with its output. Returns rank 0's row
    with the launches summed over the ranks."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        outs = [Path(tmp) / f"rank{r}.json" for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), str(world), str(port), str(outs[r]),
             str(lanes), str(steps), "--device", device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks of the {world}-card row exited {codes}:\n" + "\n---\n".join(logs))
        rows = [json.loads(o.read_text()) for o in outs]
    row = rows[0]
    row["launches"] = {k: sum(r["launches"][k] for r in rows) for k in row["launches"]}
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("lanes_per_device", nargs="?", type=int, default=256)
    p.add_argument("steps", nargs="?", type=int, default=128)
    p.add_argument("--device", default="cuda", help="cuda (the default: NCCL, a card a rank) or cpu (gloo)")
    p.add_argument("--rank", nargs=4, metavar=("RANK", "WORLD", "PORT", "OUT"), default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("bench_scaling_torch: no CUDA device is available; pass --device cpu to run gloo ranks on the CPU")
        return 1
    if args.rank:
        rank, world, port, out = args.rank
        row = run_rank(int(rank), int(world), int(port), args.lanes_per_device, args.steps, args.device)
        Path(out).write_text(json.dumps(row))
        return 0

    n_avail = torch.cuda.device_count() if args.device == "cuda" else CPU_RANKS
    card = {"gpu": None, "power_limit": None}
    if args.device == "cuda":
        sys.path.insert(0, str(ROOT / "tools"))
        from bench_torch import card as read_card

        card = read_card(torch.device("cuda", 0))
    rows, launches = [], {}
    for n in COUNTS:
        if n > n_avail:
            break
        row = run_row(n, args.lanes_per_device, args.steps, args.device)
        for k, v in row.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        rows.append(row)
        log(f"devices={n} batch={row['batch']}: {row['steps_per_s']:,} steps/s, {row['step_us']} us a step "
            f"({row['episodes']} episodes)" + (f" ({card['gpu']}, {card['power_limit']})" if card["gpu"] else ""))
    scale = rows[-1]["steps_per_s"] / rows[0]["steps_per_s"] if rows else 0
    print(json.dumps({"weak_scaling": rows, "speedup_at_max": round(scale, 2), **card}), flush=True)
    log(f"kernel launches: {json.dumps(launches)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

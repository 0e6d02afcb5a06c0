#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``jssenv_tpu_torch`` on NVIDIA cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names its configuration (a file under ``perfbench/configs/``), its traffic
mix (``perfbench/traffic/<traffic>.json``, whose ``mode`` names the window
runner ``perfbench/modes/<mode>.py``) and the cards it needs. The run sets
up, warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference (``perfbench/reference/``) and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``; with ``--trace 1`` its per-layer metrics, each read by
``perfbench/metrics/<metric>.py`` from a profiled stretch of the window),
``device`` and, traced, ``breakdown``; last, ``checks``: each number that
decided ``correct`` with its limit, which also close standard error.

A cell of several cards runs one process a card, joined over NCCL at
``tcp://127.0.0.1:<free port>``; this process is rank 0 and reports. The run
exits non-zero and prints no result where the cards are missing, where a
rank fails, or where the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "jssenv_tpu")


def loaded_forbidden() -> list:
    """Modules loaded in this process whose top-level name is one of
    ``FORBIDDEN``, compared as a whole (``jssenv_tpu_torch`` is not
    ``jssenv_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    # calibration of the check only: the reference in a narrower dtype judged
    # in the program's place, or a fault of faults.py planted in the program
    p.add_argument("--control", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def execute(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
            rank: int = 0, world: int = 1, port: int = 0, backend: str = "nccl", control=None):
    """Run the cell's traffic on ``device`` and return the mode's result
    (``attempted``, ``failed``, ``metrics``, ``checks``,
    ``memory_peak_bytes``, ``trace``) with ``setup_s`` set. ``control``: the
    narrower dtype whose reference the check judges in the program's place
    (calibration only)."""
    from perfbench.lib import manifest

    def mark(stage: str) -> None:  # where the time of a run goes, on standard error
        print(f"perfbench: rank {rank} {stage} at {time.monotonic() - T_START:.3f} s", file=sys.stderr, flush=True)

    ctx = SimpleNamespace(cell=cell, config=config, traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                          device=device, rank=rank, world=world, port=port, backend=backend, control=control,
                          root=ROOT, t_start=T_START, setup_s=None, mark=mark)
    result = manifest.mode(traffic["mode"]).run(ctx)
    result.setup_s = ctx.setup_s
    return result


def line(cell: dict, man: dict, result, trace: bool, kind: str, limits: list) -> dict:
    """The result's JSON object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, traced ``breakdown``, and ``checks`` last."""
    from perfbench.lib import compare, manifest

    metrics = {}
    if trace:
        for m in manifest.per_layer(man, cell["name"]):
            value = manifest.reader(m["name"]).read(result.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**result.metrics, "setup_s": result.setup_s}
        for m in manifest.end_to_end(man, cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"], "memory_peak_bytes": result.memory_peak_bytes,
              "power_limit": limits}
    out = {"correct": compare.passed(result.checks), "attempted": result.attempted, "failed": result.failed,
           "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=result.trace.busy_s, window_s=result.trace.window_s)
        out["breakdown"] = result.trace.breakdown()
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in result.checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench.lib import card, manifest

    man = manifest.load()
    cell = manifest.workload(man, args.workload)
    config, traffic = manifest.config(man, cell["config"]), manifest.traffic(cell["traffic"])
    world = int(cell["chips"])
    workers = []
    if world > 1 and args.rank == 0:  # the other ranks start first: each checks for its card itself
        args.port = free_port()
        base = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace), "--port", str(args.port)]
        base += ["--fault", args.fault] if args.fault else []
        workers = [subprocess.Popen(base + ["--rank", str(r)], stdout=subprocess.DEVNULL) for r in range(1, world)]
    try:
        why = card.missing(world)
        if why:
            print(f"perfbench: {why}; no result", file=sys.stderr)
            return 2
        import torch

        limits = card.power_limits(world) if args.rank == 0 else []
        plant = contextlib.nullcontext()
        if args.fault:
            from perfbench import faults

            plant = faults.planted(args.fault)
        with plant:
            result = execute(cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", args.rank), rank=args.rank, world=world, port=args.port,
                             control=args.control)
    finally:
        codes = [w.wait() for w in workers]
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"perfbench: a rank exited with {codes}; no result", file=sys.stderr)
        return 4
    out = line(cell, man, result, bool(args.trace), torch.cuda.get_device_name(0), limits)
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

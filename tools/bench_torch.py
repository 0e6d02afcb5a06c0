#!/usr/bin/env python
"""Throughput benchmark of the PyTorch/CUDA port: batched random-policy env
stepping on one NVIDIA GPU. The counterpart of ``bench.py``.

Prints ONE JSON line on stdout, with ``bench.py``'s fields:

  {"metric": "...", "value": N, "unit": "env-steps/s", "vs_baseline": N,
   "backend": "cuda", "engine": "cuda", "batch": B, "steps": T, "warmup_s": s,
   "value_dtype": "int16", "gpu": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
   "runs": [...], "launches": {...}, "extra": [...]}

and nothing else; diagnostics go to stderr. ``value`` is the best repeat's
env-steps/s, B*T over the host-clock seconds from the launch to the stats
read back on the host (as ``bench.py`` times its runs). ``vs_baseline``
divides it by the reference env's single-core throughput (BASELINE.md).

Each config runs ``fused_rollout.rollout_free`` (on a CUDA state the free
kernel in the build ``fused_rollout.free_build`` picks, on the state's own
fields: ``core/csrc/free_static.cu`` for an unpadded batch of its shape, as
every config here is, ``core/csrc/general_lane.cu`` for a padded or mixed
one; its plain twin on a CPU state; ``value_dtype`` reports the storage
type ``core/csrc/rollout.cu``'s build would take): a warm-up at the full step
count (seed 0, which also builds the kernel with nvcc on first use;
``cold_build`` says whether it did), then ``--repeats`` runs at seeds 1, 2,
..., each from the same freshly reset batch, built before the clock starts.
``runs`` holds each repeat's integer stats (the port's int64 counters), its
host-clock seconds and the device time of the call between two CUDA events
(the kernel and its reductions; null on the CPU); ``launches``
counts the kernel launches of the config. Any reward-identity violation
raises. For ``--instance ta01`` on the card, unless ``--no-extra``,
``extra`` holds the records of ragged ta41-ta50 at B=10240 and ta71 at
B=8192, at the same step count.

What ``bench.py`` does and this tool does not, each by design:

* no CPU fallback (bench.py:89-92 shrinks the run when no chip is
  attached): without CUDA the tool exits 1 and prints no JSON line, unless
  ``--device cpu`` asks for the plain twin at the sizes given;
* no second engine (bench.py:112-119 drops to an XLA scan where the Pallas
  path is unavailable): every batch the port can build runs in the kernel,
  and a failed build or launch raises;
* no swallowed device error in a repeat (bench.py:164-166) and no extra
  config that may fail silently (bench.py:203-205): an error fails the run;
* no persistent compilation cache: the kernel's library is cached in
  ``jssenv_tpu_torch/build/`` by the hash of its source.

Usage:
  python tools/bench_torch.py [--instance ta01] [--batch 16384] [--steps 8192]
                              [--repeats 3] [--no-extra] [--device cpu]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# the reference env's throughput on one CPU core (BASELINE.md "Reference
# throughput" rows), as bench.py:27 has it
REFERENCE_STEPS_PER_S = {"ta01": 8400.0, "ta41": 5900.0, "ta71": 3300.0}
# the ride-along configs of bench.py:200-205: BASELINE config #4 (ragged
# ta41-ta50, 10 instances x 1024 lanes) and the largest family (ta71, 100x20)
EXTRA = (("ta41-ta50", 10240), ("ta71", 8192))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_instances(spec: str):
    """"ta01" | "ta01,ta02" | "ta41-ta50" -> list of names (bench.py:34-46)."""
    names = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part[3:]:
            lo, hi = part.split("-")
            prefix = lo.rstrip("0123456789")
            a, b = int(lo[len(prefix):]), int(hi[len(prefix):])
            names.extend(f"{prefix}{i:0{len(lo)-len(prefix)}d}" for i in range(a, b + 1))
        else:
            names.append(part)
    return names


def card(device) -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` gives them (None for both on the CPU)."""
    if device.type != "cuda":
        return {"gpu": None, "power_limit": None}
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found: the card's power limit cannot be read")
    index = device.index if device.index is not None else 0
    line = subprocess.run(
        [smi, f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    name, _, limit = line.rpartition(",")
    return {"gpu": name.strip(), "power_limit": limit.strip()}


def run_config(instance_spec: str, batch: int, steps: int, repeats: int, device) -> dict:
    """Measure one (instance set, batch) config; returns its record."""
    import torch

    from jssenv_tpu_torch import instances as inst
    from jssenv_tpu_torch import vector
    from jssenv_tpu_torch.core import _build, fused_rollout

    log(f"instance={instance_spec} batch={batch} steps={steps}")
    names = parse_instances(instance_spec)
    source = inst.get_instance(names[0]) if len(names) == 1 else inst.get_instance_set(names)
    state = vector.make_batch(source, batch, device=device)
    on_card = device.type == "cuda"
    # rollout.cu's storage dtype for the batch; the twin steps the engine's own int32 state
    vdt = str(fused_rollout.value_dtype(state) if on_card else state.time.dtype).removeprefix("torch.")

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def run(seed):
        """One rollout: (stats, host seconds, device ms of the call or None)."""
        sync()
        if on_card:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        st = fused_rollout.rollout_free(state, steps, seed=seed)
        if on_card:
            e1.record()
        # the one readback of the stats, as bench.py's device_get
        eps, mk_sum, mk_min, viol = torch.stack(
            [st["episodes"], st["total_makespan"], st["min_makespan"].to(torch.int64),
             st["identity_violations"]]).tolist()
        dt = time.perf_counter() - t0
        dev_ms = e0.elapsed_time(e1) if on_card else None
        if viol:
            raise RuntimeError(f"reward-identity violations: {viol} ({instance_spec}, seed {seed})")
        stats = {"seed": seed, "episodes": eps, "total_makespan": mk_sum, "min_makespan": mk_min,
                 "identity_violations": viol}
        return stats, dt, dev_ms

    # the build the batch launches: the static one of its shape where every
    # lane is unpadded (all three configurations), else the general one
    cold = on_card and not _build.library_path(*fused_rollout.free_kernel_job(state)).exists()
    fused_rollout.reset_launch_counts()
    # the warm-up runs the full step count, as bench.py:149-156
    t0 = time.perf_counter()
    run(0)
    warmup_s = time.perf_counter() - t0
    log(f"warm-up ({'cuda' if on_card else 'twin'} {vdt}, {steps} steps, "
        f"{'cold build' if cold else 'kernel already built' if on_card else 'no build'}): {warmup_s:.2f}s")

    best, runs = 0.0, []
    for r in range(repeats):
        stats, dt, dev_ms = run(r + 1)
        sps = batch * steps / dt
        avg = stats["total_makespan"] / stats["episodes"] if stats["episodes"] else float("nan")
        dev_txt = f", device {dev_ms:.2f} ms by CUDA events ({batch * steps / (dev_ms / 1e3):,.0f} env-steps/s)" \
            if dev_ms is not None else ""
        log(f"repeat {r}: {sps:,.0f} env-steps/s ({dt * 1e3:.2f} ms host clock{dev_txt}; "
            f"{stats['episodes']} episodes, avg makespan {avg:.0f}, min {stats['min_makespan']})")
        runs.append(dict(stats, host_s=dt, device_ms=dev_ms))
        best = max(best, sps)

    ref = REFERENCE_STEPS_PER_S.get(names[0], REFERENCE_STEPS_PER_S["ta01"])
    return {
        "metric": f"env-steps/s per chip, batched {instance_spec}, random policy",
        "value": round(best, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(best / ref, 2),
        "backend": device.type,
        "engine": "cuda" if on_card else "twin",
        "batch": batch,
        "steps": steps,
        "warmup_s": round(warmup_s, 1),
        "value_dtype": vdt,
        **card(device),
        "cold_build": cold,
        "runs": runs,
        "launches": dict(fused_rollout.LAUNCHES),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--instance", default="ta01")
    p.add_argument("--batch", type=int, default=int(os.environ.get("JSS_BENCH_BATCH", 16384)))
    p.add_argument("--steps", type=int, default=int(os.environ.get("JSS_BENCH_STEPS", 8192)))
    p.add_argument("--repeats", type=int, default=3)
    # accepted and ignored, as bench.py does: the warm-up always runs the
    # full step count
    p.add_argument("--warmup-steps", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--no-extra", action="store_true", help="skip the ta41-ta50 and ta71 records")
    p.add_argument("--device", default="cuda", help="cuda (the default; the kernel) or cpu (the plain twin)")
    args = p.parse_args(argv)
    if args.warmup_steps is not None:
        log("--warmup-steps is ignored (the warm-up runs the full step count)")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("bench_torch: no CUDA device is available; pass --device cpu to run the plain twin on the CPU")
        return 1
    log(f"device={device} torch={torch.__version__} cuda={torch.version.cuda}"
        + (f" gpu={torch.cuda.get_device_name(device)}" if device.type == "cuda" else ""))

    record = run_config(args.instance, args.batch, args.steps, args.repeats, device)
    if args.instance == "ta01" and device.type == "cuda" and not args.no_extra:
        record["extra"] = [run_config(spec, batch, args.steps, args.repeats, device) for spec, batch in EXTRA]
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

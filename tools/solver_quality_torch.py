#!/usr/bin/env python
"""Reproducible solver-quality sweeps of the PyTorch/CUDA port. The
counterpart of ``tools/solver_quality.py``, with its flags, defaults and JSON
schema (the keys of ``docs/solver_quality.json``).

Each instance is solved by ``solve.solve`` (noisy dispatching rollouts, then
``anneal`` or ``tabu_search`` in order space, the winner certified by
replay) on the card, or on the CPU with ``--device cpu``, once per seed:

* ``compile_s`` keeps its name for the schema; here it holds the seconds of
  the warm-up, a 64-iteration solve of the first instance before the
  measured rows (on the card it builds nothing: the solver is eager
  PyTorch, so the warm-up pays the CUDA context, the allocator and the
  first launches of each shape);
* seed discipline: every row reports the first seed's result and the best
  over ``--seeds``, and the summary both means;
* gap anchoring: ``gap_pct`` against the published best known where
  ``BEST_KNOWN`` has it, ``gap_vs_lb_pct`` against
  ``InstanceSpec.lower_bound`` everywhere.

``seconds_per_seed`` is what a user waits for: host-clock seconds around
``solve``, the card synchronised before each clock read. The solver's
random draws are ``torch.Generator``s seeded like the JAX package's keys,
so its makespans agree with the JAX tool's in distribution, not row by row.

``--out`` writes the JSON to a new file and refuses an existing one, so the
JAX package's records (``docs/solver_quality*.json``) are never overwritten.
Without CUDA the tool exits 1 unless ``--device cpu`` is given.

Usage:
  python tools/solver_quality_torch.py --family 30x20 --method tabu \
      --iters 12000 --seeds 0 1 2 --out solver_quality_30x20_h100.json
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

FAMILIES = {
    "15x15": [f"ta{i:02d}" for i in range(1, 11)],
    "30x20": [f"ta{i}" for i in range(41, 51)],
    "dmu": [f"dmu{i}" for i in range(16, 21)],
}

# published best-known makespans (reference golden tests + literature values
# for the 15x15 family already used by docs/solver_quality.json)
BEST_KNOWN = {
    "ta01": 1231, "ta02": 1244, "ta03": 1218, "ta04": 1175, "ta05": 1224,
    "ta06": 1238, "ta07": 1227, "ta08": 1217, "ta09": 1274, "ta10": 1241,
    "ta41": 2006, "ta42": 1939, "ta43": 1846, "ta44": 1979, "ta45": 2000,
    "ta46": 2006, "ta47": 1889, "ta48": 1937, "ta49": 1963, "ta50": 1923,
    "ta51": 2760,
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", choices=sorted(FAMILIES), default="30x20")
    p.add_argument("--instances", nargs="*", default=None,
                   help="explicit instance list (overrides --family)")
    p.add_argument("--method", choices=["anneal", "tabu"], default="tabu")
    p.add_argument("--iters", type=int, default=12000)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--sweeps", type=int, default=3)
    p.add_argument("--chains", type=int, default=128)
    p.add_argument("--proposals", type=int, default=8)
    p.add_argument("--neighborhood", choices=["sampled", "full", "guided"],
                   default="sampled")
    p.add_argument("--guided-temp", type=float, default=4.0)
    p.add_argument("--anneal-t0", type=float, default=0.015)
    p.add_argument("--anneal-t1", type=float, default=0.001)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--out", default=None, help="write JSON to this new file (else stdout)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    if args.out and os.path.exists(args.out):
        log(f"solver_quality_torch: {args.out} exists; --out writes a new file only")
        return 2

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("solver_quality_torch: no CUDA device is available; pass --device cpu to run on the CPU")
        return 1

    from jssenv_tpu_torch import instances as inst, solve
    from jssenv_tpu_torch.core import fused_rollout

    names = args.instances or FAMILIES[args.family]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(name, seed, iters):
        spec = inst.get_instance(name)
        sync()
        t0 = time.perf_counter()
        res = solve.solve(
            spec, batch=args.batch, sweeps=args.sweeps, seed=seed,
            refine_iters=iters, refine_method=args.method,
            anneal_t0=args.anneal_t0, anneal_t1=args.anneal_t1,
            tabu_chains=args.chains, tabu_proposals=args.proposals,
            tabu_neighborhood=args.neighborhood,
            tabu_guided_temp=args.guided_temp, device=device,
        )
        sync()
        return res, time.perf_counter() - t0

    # warm-up: a tiny-budget solve of the first instance
    t0 = time.perf_counter()
    run(names[0], seed=max(args.seeds) + 1, iters=64)
    compile_s = round(time.perf_counter() - t0, 1)
    log(f"warm-up: {compile_s}s")

    rows = []
    for name in names:
        spec = inst.get_instance(name)
        lb = spec.lower_bound()
        per_seed = {}
        secs = {}
        timings0 = None
        for seed in args.seeds:
            res, dt = run(name, seed, args.iters)
            per_seed[seed] = res.makespan
            secs[seed] = round(dt, 1)
            if seed == args.seeds[0]:
                timings0 = res.timings
            log(f"{name} seed {seed}: {res.makespan} ({dt:.1f}s; "
                + ", ".join(f"{k} {v:.2f}" for k, v in res.timings.items()) + ")")
        mk0 = per_seed[0] if 0 in per_seed else per_seed[args.seeds[0]]
        best = min(per_seed.values())
        row = {
            "instance": name,
            "makespan_seed0": mk0,
            "makespan": best,
            "seeds_run": list(per_seed),
            "seconds_per_seed": secs,
            "lower_bound": lb,
            "gap_vs_lb_pct": round(100.0 * (best - lb) / lb, 2),
            "gap_vs_lb_seed0_pct": round(100.0 * (mk0 - lb) / lb, 2),
        }
        if timings0:
            row["timings_seed0"] = timings0
        bk = BEST_KNOWN.get(name)
        if bk:
            row["best_known"] = bk
            row["gap_pct"] = round(100.0 * (best - bk) / bk, 2)
            row["gap_seed0_pct"] = round(100.0 * (mk0 - bk) / bk, 2)
        rows.append(row)

    def mean(key):
        vals = [r[key] for r in rows if key in r]
        return round(sum(vals) / len(vals), 2) if vals else None

    out = {
        "rows": rows,
        "config": (
            f"method={args.method} batch={args.batch} sweeps={args.sweeps} "
            f"iters={args.iters} chains={args.chains} "
            f"proposals={args.proposals} neighborhood={args.neighborhood} "
            f"t={args.anneal_t0}/{args.anneal_t1} seeds={args.seeds}"
        ),
        "compile_s": compile_s,
        "mean_gap": mean("gap_pct"),
        "max_gap": max((r["gap_pct"] for r in rows if "gap_pct" in r),
                       default=None),
        "mean_gap_seed0": mean("gap_seed0_pct"),
        "mean_gap_vs_lb": mean("gap_vs_lb_pct"),
    }
    log(f"kernel launches: {json.dumps(fused_rollout.LAUNCHES)}")
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "x") as f:
            f.write(text + "\n")
        log(f"wrote {args.out}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

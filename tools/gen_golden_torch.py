#!/usr/bin/env python
"""Extend tests/data/golden_solutions.json with solver-derived schedules, on
the PyTorch/CUDA port. The counterpart of ``tools/gen_golden.py``.

The file holds 12 published-optimal machine-order schedules; this tool adds
high-quality orders for other instances, derived with the port's solver
(``jssenv_tpu_torch.solve.solve``: noisy rollouts, then annealing or tabu
search, certified by replay), replays each again through
``jssenv_tpu_torch.replay.replay_machine_order`` (the torch engine on the
card), cross-checks the makespan against the live reference simulator when
its checkout is mounted (``tests/_reference_oracle.py``), and stores
``{"makespan": N, "source": "solve+anneal", "machine_order": ...,
"best_known": opt?}`` entries, as the JAX tool does. Published-optimum
entries are never touched; with ``--update`` a solver-derived entry is
replaced only by an order that certifies lower.

It writes the module-level ``DATA`` path, rewritten whole after each new
entry (``json.dump(indent=1, sort_keys=True)``, the file's own format, so
untouched entries keep their bytes). Runs on the card; without one it exits
1, unless ``--device cpu`` asks for the CPU.

Usage: python tools/gen_golden_torch.py [names...] [--batch 2048] [--sweeps 6]
           [--refine 4000] [--seed 0] [--method anneal|tabu] [--update]
           [--device cuda|cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# published optima / best-known makespans (Taillard benchmark literature);
# informational only — the tests assert the certified replay makespan
BEST_KNOWN = {
    "ta02": 1244, "ta03": 1218, "ta04": 1175, "ta05": 1224, "ta06": 1238,
    "ta07": 1227, "ta08": 1217, "ta09": 1274, "ta10": 1241,
    "ta11": 1357, "ta21": 1642, "ta31": 1764, "ta61": 2868, "ta71": 5464,
}

DEFAULT_NAMES = [
    "ta02", "ta03", "ta04", "ta05", "ta06", "ta07", "ta08", "ta09", "ta10",
    "ta11", "ta21", "ta31", "ta61", "ta71", "dmu16",
]

DATA = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "tests", "data", "golden_solutions.json"
)


def reference_makespan(name: str, order) -> int:
    """Replay ``order`` through the live reference simulator (the driver
    pattern of reference tests/test_solutions.py:41-73); -1 if unavailable."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
    from _reference_oracle import load_reference_env_class, reference_instance_path

    cls = load_reference_env_class()
    if cls is None:
        return -1
    env = cls({"instance_path": reference_instance_path(name)})
    env.reset()
    idx = [0] * env.machines
    # progress guard: an infeasible or cyclic order would otherwise alternate
    # acted=False / increase_time_step forever. A feasible replay does at most
    # jobs*machines steps plus one time advance per distinct completion event
    max_iters = env.jobs * env.machines * 2 + int(env.instance_matrix[..., 1].sum())
    iters = 0
    while not env._is_done():
        iters += 1
        if iters > max_iters:
            raise RuntimeError(
                f"{name}: replay made no progress after {max_iters} iterations "
                f"— stored order is not dispatchable"
            )
        acted = False
        for m in range(env.machines):
            if idx[m] >= len(order[m]):
                continue
            job = order[m][idx[m]]
            if env.needed_machine_jobs[job] == m and env.legal_actions[job]:
                env.step(job)
                idx[m] += 1
                acted = True
        if not acted and not env._is_done():
            env.increase_time_step()
    return int(env.current_time_step)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("names", nargs="*", default=None)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--sweeps", type=int, default=6)
    p.add_argument("--refine", type=int, default=4000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--method", choices=["anneal", "tabu"], default="anneal")
    p.add_argument("--update", action="store_true",
                   help="re-solve SOLVER-DERIVED entries already present and "
                        "keep whichever schedule certifies lower (published-"
                        "optimum entries are never touched)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    names = args.names or DEFAULT_NAMES

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("gen_golden_torch: no CUDA device is available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1

    from jssenv_tpu_torch import instances as inst, replay, solve

    with open(DATA) as f:
        golden = json.load(f)

    for name in names:
        prev = golden.get(name)
        if prev is not None and not args.update:
            print(f"{name}: already present, skipping")
            continue
        if prev is not None and "optimum" in prev:
            print(f"{name}: published optimum entry, never updated")
            continue
        spec = inst.get_instance(name)
        res = solve.solve(
            spec,
            batch=args.batch,
            sweeps=args.sweeps,
            seed=args.seed,
            refine_iters=args.refine,
            refine_method=args.method,
            device=device,
        )
        order = res.machine_order()
        mk, _ = replay.replay_machine_order(spec, order, device=device)
        if mk != res.makespan:
            raise RuntimeError(f"{name}: replay {mk} != solver makespan {res.makespan}")
        ref_mk = reference_makespan(name, order)
        if ref_mk >= 0 and ref_mk != mk:
            raise RuntimeError(f"{name}: reference replay {ref_mk} != {mk}")
        if prev is not None and prev["makespan"] <= mk:
            print(f"{name}: existing {prev['makespan']} <= new {mk}, keeping")
            continue
        entry = {
            "makespan": mk,
            "source": f"solve+{args.method}",
            "machine_order": order,
        }
        if name in BEST_KNOWN:
            entry["best_known"] = BEST_KNOWN[name]
            gap = 100.0 * (mk - BEST_KNOWN[name]) / BEST_KNOWN[name]
            extra = f" (best known {BEST_KNOWN[name]}, gap {gap:+.2f}%)"
        else:
            extra = ""
        ref_note = " ref-checked" if ref_mk >= 0 else ""
        print(f"{name}: certified makespan {mk}{extra}{ref_note}")
        golden[name] = entry
        with open(DATA, "w") as f:
            json.dump(golden, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

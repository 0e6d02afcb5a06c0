#!/usr/bin/env python
"""Distill the bundled 30x20 published-optimal schedules into a policy, on the
PyTorch/CUDA port. The counterpart of ``tools/distill_30x20.py``: the same
subcommands, configuration (``CFG``: perjob 128x128, rich features, unroll
640, 8 loss chunks) and pipeline (``jssenv_tpu_torch.distill``):

  1. collect: replay each optimum of ta41-ta50 (tests/data/golden_solutions.json)
     through the exact engine, recording every (rich_obs, action_mask,
     allocated job) pair;
  2. pretrain: cross-entropy imitation on the pooled pairs;
  3. finetune: staged REINFORCE (full-episode unroll 640) on ta41 with a small
     learning rate; every env step is one launch of the driven kernel;
  4. augment_solve / augment_collect: extra ta41 teachers from the solver's
     distinct tabu schedules, collected into the pairs;
  5. finetune_anchored: REINFORCE rounds interleaved with CE passes over the
     ta41 teacher pairs;
  6. eval <ckpt>: greedy makespan on each instance (each env step one driven
     launch).

Files. The JAX tool reads and writes ``models_data/``. This one writes only
under ``--out-dir`` (default ``jssenv_tpu_torch/build/distill/``, which git
ignores) and refuses an ``--out-dir`` inside ``models_data/``. It reads each
input (the pairs, the pretrained checkpoint, the augmentation orders) from
``--out-dir`` where an earlier step wrote it there, else the shipped file of
that name in ``models_data/``; stderr names the path read. Checkpoints are
saved in the flax layout (``checkpoint.params_to_flax``), so the JAX
package's ``checkpoint.load`` reads them too; ``eval`` takes a flax-layout
npz (the JAX package's or this tool's) or a whole train state
(``checkpoint.save_train_state``).

Randomness comes from ``torch.Generator``s seeded like the JAX tool's keys:
the net's initialisation and the pretrain's minibatch order from seed 0, the
fine-tune's rollouts from ``learner.train``'s seed 0, anchor round r's CE
pass from 100 + r. The streams are not ``jax.random``'s, so the pretrain and
fine-tune trajectories are not the JAX tool's. Only ``collect`` (exact
engine replay) and ``eval`` at float32 (``--dtype float32``; the default is
the nets' bfloat16, as in the JAX tool) are comparable with the JAX
package's results.

Runs on the card; ``--device cpu`` runs every step on the CPU (the driven
kernel's plain twin), and without CUDA the tool exits 1 unless given it.

Usage:
  python tools/distill_30x20_torch.py collect [--instances ta41 ta42]
  python tools/distill_30x20_torch.py pretrain
  python tools/distill_30x20_torch.py finetune [PRE] [OUT]
  python tools/distill_30x20_torch.py augment_solve
  python tools/distill_30x20_torch.py augment_collect
  python tools/distill_30x20_torch.py finetune_anchored
  python tools/distill_30x20_torch.py eval CKPT [--instances ta41] [--dtype float32]
(each with [--device cpu] [--out-dir DIR])
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from jssenv_tpu_torch import checkpoint, distill, instances as inst, solve, vector  # noqa: E402
from jssenv_tpu_torch.core import fused_rollout  # noqa: E402
from jssenv_tpu_torch.parallel import learner  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "data", "golden_solutions.json")
MODELS = os.path.join(ROOT, "models_data")
OUT_DIR = os.path.join(ROOT, "jssenv_tpu_torch", "build", "distill")
PAIRS = "distill_30x20_pairs.npz"
PRE = "ta41_distill_pre.npz"
FINAL = "ta41_distill.npz"
AUG_ORDERS = "distill_ta41_aug.json"
PAIRS41 = "distill_ta41_pairs.npz"
NAMES = [f"ta{n}" for n in range(41, 51)]

CFG = learner.LearnerConfig(
    hidden=(128, 128), arch="perjob", features="rich",
    unroll_steps=640, loss_chunks=8,
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Paths:
    """Where a run writes (``out_dir``) and reads its inputs."""

    out_dir: str

    def out(self, name: str) -> str:
        return os.path.join(self.out_dir, name)

    def input(self, name: str) -> str:
        """``name`` in the output directory if an earlier step wrote it
        there, else the shipped file in models_data/."""
        path = self.out(name) if os.path.exists(self.out(name)) else os.path.join(MODELS, name)
        log(f"reading {path}")
        return path


def load_params(path: str) -> dict:
    """A checkpoint's net as a ``state_dict``: flax layout (the JAX package's
    ``checkpoint.save`` or ``save_params``) or a whole train state
    (``checkpoint.save_train_state``)."""
    named = checkpoint.load(path)
    if any(k.startswith("model/") for k in named):
        return {k.removeprefix("model/"): torch.from_numpy(v) for k, v in named.items() if k.startswith("model/")}
    return checkpoint.params_from_flax(named)


def save_params(path: str, params: dict) -> None:
    checkpoint.save(path, checkpoint.params_to_flax(params))
    log(f"saved {path}")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _pairs(path: str) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in distill.PAIR_KEYS}


def collect(paths: Paths, device, names=NAMES):
    golden = _json(GOLDEN)
    sets = []
    for name in names:
        spec = inst.get_instance(name)
        t0 = time.perf_counter()
        pairs = distill.collect_teacher_pairs(spec, golden[name]["machine_order"], CFG, device=device)
        if pairs["makespan"] != golden[name]["optimum"]:
            raise RuntimeError(f"{name}: the optimum replays to {pairs['makespan']}, not {golden[name]['optimum']}")
        print(f"{name}: {pairs['obs'].shape[0]} pairs, makespan "
              f"{pairs['makespan']} (= published optimum), "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        sets.append(pairs)
    merged = distill.merge_pairs(sets)
    np.savez_compressed(paths.out(PAIRS), **merged)
    print(f"saved {merged['obs'].shape[0]} pairs -> {paths.out(PAIRS)}")


def pretrain(paths: Paths, device, epochs=300, batch_size=512, lr=1e-3, eval_names=("ta41", "ta45", "ta49")):
    pairs = _pairs(paths.input(PAIRS))
    env = vector.make_batch(inst.get_instance("ta41"), 2, device=device)
    t0 = time.perf_counter()
    params = distill.pretrain(
        0, pairs, env, CFG, epochs=epochs,
        batch_size=batch_size, learning_rate=lr, log_fn=print,
    )
    print(f"pretrain {time.perf_counter() - t0:.1f}s")
    save_params(paths.out(PRE), params)
    for name in eval_names:
        r = learner.evaluate_policy(params, inst.get_instance(name), CFG, device=device)
        print(f"{name}: greedy {r['greedy_makespan']}", flush=True)


def augment_solve(paths: Paths, device, seeds=(1, 2, 3), iters=12000):
    """Solve ta41 at several seeds and save the DISTINCT refined machine
    orders: extra teachers for visitation coverage around the optimum."""
    spec = inst.get_instance("ta41")
    golden = _json(GOLDEN)
    seen = {tuple(np.asarray(golden["ta41"]["machine_order"]).ravel())}
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = solve.solve(spec, batch=1024, sweeps=3, seed=seed,
                          refine_iters=iters, refine_method="tabu", device=device)
        order = res.machine_order()
        key = tuple(np.asarray(order).ravel())
        if key in seen:
            print(f"seed {seed}: duplicate schedule, skipped")
            continue
        seen.add(key)
        out.append({"seed": seed, "makespan": res.makespan,
                    "machine_order": order})
        print(f"seed {seed}: makespan {res.makespan} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    with open(paths.out(AUG_ORDERS), "w") as f:
        json.dump(out, f)
    print(f"saved {len(out)} orders -> {paths.out(AUG_ORDERS)}")


def augment_collect(paths: Paths, device):
    """Collect pairs from the augmentation orders: merge them into the
    all-instance pairs AND write a ta41-only pairs file (the anchored
    fine-tune's CE anchor set)."""
    golden = _json(GOLDEN)
    sets = [_pairs(paths.input(PAIRS))]
    spec = inst.get_instance("ta41")
    p41 = [distill.collect_teacher_pairs(spec, golden["ta41"]["machine_order"], CFG, device=device)]
    for rec in _json(paths.input(AUG_ORDERS)):
        pairs = distill.collect_teacher_pairs(spec, rec["machine_order"], CFG, device=device)
        if pairs["makespan"] != rec["makespan"]:
            raise RuntimeError(f"seed {rec['seed']}: replays to {pairs['makespan']}, recorded {rec['makespan']}")
        print(f"seed {rec['seed']}: {pairs['obs'].shape[0]} pairs at "
              f"makespan {pairs['makespan']}", flush=True)
        sets.append(pairs)
        p41.append(pairs)
    merged = distill.merge_pairs(sets)
    np.savez_compressed(paths.out(PAIRS), **merged)
    print(f"saved {merged['obs'].shape[0]} pairs -> {paths.out(PAIRS)}")
    only41 = distill.merge_pairs(p41)
    np.savez_compressed(paths.out(PAIRS41), **only41)
    print(f"saved {only41['obs'].shape[0]} ta41 pairs -> {paths.out(PAIRS41)}")


def finetune(paths: Paths, device, stages=((2e-4, 3e-3, 200), (1e-4, 1e-3, 200), (5e-5, 3e-4, 200)),
             pre=None, out=None):
    params = load_params(pre or paths.input(PRE))
    spec = inst.get_instance("ta41")
    best = None
    for lr, ent, updates in stages:
        cfg = dataclasses.replace(CFG, learning_rate=lr, entropy_coef=ent)
        t0 = time.perf_counter()
        ts, _ = learner.train(
            spec, batch_size=1024, num_updates=updates, config=cfg,
            log_every=50, init_params=params, device=device,
        )
        params = ts.model.state_dict()
        r = learner.evaluate_policy(params, spec, CFG, device=device)
        print(f"stage lr={lr} ent={ent}: greedy {r['greedy_makespan']} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if best is None or r["greedy_makespan"] < best[0]:
            best = (r["greedy_makespan"], params)
    out = out or paths.out(FINAL)
    save_params(out, best[1])
    print(f"best greedy {best[0]} -> {out}")


def finetune_anchored(paths: Paths, device, rounds=10, rl_updates=60, anchor_epochs=4,
                      rl_lr=1e-4, rl_ent=1e-3, anchor_lr=2e-4):
    """Anchored fine-tune: on-policy REINFORCE rounds interleaved with CE
    anchor passes over the ta41 teacher pairs, so that RL fixes the states
    imitation never saw while the CE pass keeps the teacher's actions in
    the states it did."""
    pairs = _pairs(paths.input(PAIRS41))
    params = load_params(paths.input(PRE))
    spec = inst.get_instance("ta41")
    env = vector.make_batch(spec, 2, device=device)
    cfg = dataclasses.replace(CFG, learning_rate=rl_lr, entropy_coef=rl_ent)
    best = (learner.evaluate_policy(params, spec, CFG, device=device)["greedy_makespan"], params)
    print(f"start: greedy {best[0]}", flush=True)
    for r in range(rounds):
        t0 = time.perf_counter()
        ts, _ = learner.train(
            spec, batch_size=1024, num_updates=rl_updates, config=cfg,
            log_every=rl_updates, log_fn=lambda *_: None,
            init_params=params, device=device,
        )
        rl_params = ts.model.state_dict()
        params = distill.pretrain(
            100 + r, pairs, env, CFG,
            epochs=anchor_epochs, batch_size=512, learning_rate=anchor_lr,
            params=rl_params,
        )
        g_rl = learner.evaluate_policy(rl_params, spec, CFG, device=device)
        g_anc = learner.evaluate_policy(params, spec, CFG, device=device)
        print(f"round {r}: rl {g_rl['greedy_makespan']} anchored "
              f"{g_anc['greedy_makespan']} ({time.perf_counter() - t0:.1f}s)",
              flush=True)
        for g, p in ((g_rl["greedy_makespan"], rl_params),
                     (g_anc["greedy_makespan"], params)):
            if g < best[0]:
                best = (g, p)
    save_params(paths.out(FINAL), best[1])
    print(f"best greedy {best[0]} -> {paths.out(FINAL)}")


def evaluate(path: str, device, names=NAMES, dtype=CFG.compute_dtype):
    params = load_params(path)
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    for name in names:
        r = learner.evaluate_policy(params, inst.get_instance(name), cfg, device=device)
        print(f"{name}: greedy {r['greedy_makespan']}", flush=True)


def _in_models(path: str) -> bool:
    models, path = os.path.realpath(MODELS), os.path.realpath(path)
    return path == models or path.startswith(models + os.sep)


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    common.add_argument("--out-dir", default=OUT_DIR, help="where outputs go (never models_data/)")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd")
    sub.add_parser("collect", parents=[common]).add_argument("--instances", nargs="+", default=NAMES)
    sp = sub.add_parser("finetune", parents=[common])
    sp.add_argument("pre", nargs="?", default=None)
    sp.add_argument("out", nargs="?", default=None)
    for name in ("pretrain", "augment_solve", "augment_collect", "finetune_anchored"):
        sub.add_parser(name, parents=[common])
    sp = sub.add_parser("eval", parents=[common])
    sp.add_argument("ckpt")
    sp.add_argument("--instances", nargs="+", default=NAMES)
    sp.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="the nets' compute dtype (float32 is comparable with the JAX package's)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv or ["collect"])

    for target in (args.out_dir, getattr(args, "out", None)):
        if target and _in_models(target):
            log(f"distill_30x20_torch: refusing to write {target}: models_data/ holds the shipped files")
            return 2
    out_dir = os.path.realpath(args.out_dir)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("distill_30x20_torch: no CUDA device is available; pass --device cpu to run on the CPU")
        return 1
    os.makedirs(out_dir, exist_ok=True)
    paths = Paths(out_dir)

    if args.cmd == "collect":
        collect(paths, device, args.instances)
    elif args.cmd == "pretrain":
        pretrain(paths, device)
    elif args.cmd == "finetune":
        finetune(paths, device, pre=args.pre, out=args.out)
    elif args.cmd == "augment_solve":
        augment_solve(paths, device)
    elif args.cmd == "augment_collect":
        augment_collect(paths, device)
    elif args.cmd == "finetune_anchored":
        finetune_anchored(paths, device)
    else:
        evaluate(args.ckpt, device, args.instances, getattr(torch, args.dtype))
    log(f"kernel launches: {json.dumps(fused_rollout.LAUNCHES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jssenv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--quick] [--out FILE] [--profile] [--against ROOT]

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and count, and ``nvidia-smi``'s name and power limit;
2. build ``core/csrc/rollout.cu`` with nvcc and print its ``-Xptxas -v`` report
   (registers, stack, spills) and the launch geometry of each FULL config
   (``fused_rollout.launch_geometry``: a warp a lane, lanes a block, shared
   bytes);
3. driven parity: the plain twin (``vector.step_autoreset``'s two calls,
   under ``random_legal_actions``) on the card records actions, raw rewards,
   episode ends and the final state; ``fused_rollout.rollout_driven``
   replays the actions in the kernel; rewards, ends and every state field
   must be equal, and the launch without ends must give the same run. Also
   at the main paths' shapes, one step per launch for as many steps as the
   policy loop takes, across episode ends and open no-op gates: ta01
   B=16384 on the full state (the policy loop) and ta01 B=8192 on the light
   state (``vector.strip_solution``, as the learner and serving run it);
4. free parity, bits mode: the same (T, B) bits through the kernel and the
   plain twin; per-lane integer stats equal, return within rel 1e-5, no
   reward-identity violations. Where a case's values fit int16, both
   instantiations of the free kernel (int32 and int16) are held against the
   same twin;
5. the main path at full width, launch counts zeroed just before: a
   policy-in-the-loop rollout (``random_legal_actions`` outside, the env step
   in the driven kernel) on ta01 with B=16384, and the free Philox rollout on
   ta01 B=16384, ragged ta01-ta10 B=10240, ragged ta41-ta50 B=10240 and ta71
   B=8192. ``value_dtype`` must pick int16 on the first two (which launch the
   int16 instantiation) and int32 on the last two;
6. the plain twin on the same full-width inputs and seed: equal integer
   stats; then the kernel in bits mode at full width, whose mean makespan must
   be within 1% of the Philox run's; then, on the int16 batches, the int16
   kernel against the int32 one lane by lane on the same Philox seed;
7. kernel times (CUDA events, after warm-up), the plain twins' times, the
   least time the card could take, env-steps/s, int16 against int32; with
   ``--against ROOT``, the kernels of another checkout (e.g. the parent
   commit's, unpacked with ``git archive``) and this one's in turns (root,
   this, this, root), each turn a process of its own;
8. where a policy-loop step's time goes, stage by stage (host clock); with
   ``--profile`` also the device's busy share under ``torch.profiler``;
9. the dispatching-rule sweep: all 7 rules on ragged ta01-ta10, 10240 lanes
   per rule, through ``compare_rules_batched`` on the card, timed per rule.
   Each rule's episodes are also run with every chosen action checked
   against the legal mask: at ``explore_prob=0`` every lane of an instance
   must end alike and the card's per-lane makespans and returns equal a
   CPU run of one lane an instance, at ``explore_prob=0.1``
   every episode must finish with only legal actions;
10. replay: every golden row of ``tests/data/golden_solutions.json`` through
   the native engine, and the 12 published optima plus ta71 through the
   torch engine on the card, each to its stored makespan, timed per row;
11. one ta01 SPT episode through ``JssEnv`` on each engine (``"native"``,
   and the default ``"torch"`` on the card); every public attribute equal
   after every step;
12. serving: greedy ``learner.evaluate_policy`` of the shipped checkpoints
   (``models_data``, loaded by ``checkpoint.params_from_flax``), each env
   step one driven launch: at bfloat16 under the JAX package's test bounds
   (``ta41_distill`` recorded only), at float32 equal to the JAX package's
   float32 makespans, one run with 63 sampled lanes; the reward identity of
   each greedy episode from the kernel's rewards and ends;
13. training at full width: the JAX package's learner configuration (ta01,
   B=8192, unroll 32, 256x256 ``MaskedPolicyNet``, REINFORCE), then 2 PPO
   updates at that shape and 2 ``perjob`` updates on ta41 (B=1024, rich
   features): finite losses, every parameter moved, exactly ``unroll_steps``
   driven launches an update, the reward identity on every lane that ends;
   ms an update, env-steps/s, the rollout/learn split (CUDA events), the
   busy share with ``--profile``; then the driven kernel held against its
   twin on the learner's last recorded step (light state, every state
   field, rewards and ends equal) and timed there, ends written;
14. data and tensor parallel on this card: (a) a 1-rank NCCL group, the
   learner configuration of phase 13 through ``make_train_step(config,
   mesh)``, 4 updates against the plain step from the same seed (actions
   equal, loss and params within rel 1e-6, bit-equality reported), ms an
   update and the NCCL all-reduce's device time; (b) 2 ranks on this card
   over gloo (processes of this script, ``--rank-worker``), dp=2 then mp=2,
   at float32 and bfloat16, 2 updates each, against the plain card run
   (float32: actions equal, loss rel 1e-5, params 1e-5 of the largest;
   bfloat16: the JAX test's bounds); (c) their ``sharded_rollout`` of
   ragged ta41-ta50, global B=10240, T=1024, each rank one free-kernel
   launch with its ``lane_offset``, integer stats equal to the unsharded
   kernel run; and the offset kernel against its twin and the whole
   batch's run on one shard, int32 and int16;
15. distillation at ``tools/distill_30x20.py``'s width (perjob 128x128, rich,
   B=1024, unroll 640, ``loss_chunks`` 8): the four ta41 teachers collected
   on the card (equal to ``models_data/distill_ta41_pairs.npz``), 5
   pretrain epochs at batch 512 (CE falls), 2 fine-tune updates, greedy
   ta41 makespans before and after, each teacher and epoch timed;
16. ``invariant_errors`` over phase 13's learner batch (all 0), then its
   TrainState saved and loaded on the card: the next update bit-equal to
   the uninterrupted one;
17. the solver (``anneal``, ``solve``; plain PyTorch, no kernel of its own):
   ``evaluate_orders`` on the 12 published optima, on the card equal to the
   CPU and to the optimum; the sweep, tails, critical pairs, neighbor
   bounds and swap estimates of 1024 random feasible ta41 orders, card
   equal to CPU; ``solve`` on ta01 at the JAX package's defaults (batch
   2048, 4 sweeps), then with 600 refine iterations of annealing and of
   tabu, each result replayed to its makespan; ta41 tabu at
   docs/BENCHMARKS.md's round-5 configuration (128 chains x 8 proposals)
   in the three neighborhoods, 200 iterations (cut from 50 000). Seconds a
   stage, ms a refine iteration, sweep passes and host reads a sweep, the
   makespans; no rollout kernel is launched.

``--quick`` runs phases 1-4 and 9-17 at small shapes (a first check of a new
build). ``--out`` writes every measured number as JSON. On an H100 the run
takes about 8 minutes (``--quick`` about 3); ``--against`` adds about 3. The
last stdout lines are the ``nvidia-smi`` line, one ``{"kernels": [...]}``
line and ``{"ok": true, "device": {...}}``; the driven kernel's
``launches`` there sum phases 5, 12, 13, 14 (both ranks' too) and 15, and
the free kernels' phases 5 and 14, each path counted from zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, and
# int32 operations/s outside the tensor cores — 64 INT32 lanes per SM against
# 128 FP32 lanes, i.e. a quarter of the 67 TFLOP/s float32 rate (which counts
# an FMA as two operations).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

SEED = 20261016
# (config, B, T) of each phase; see the module docstring
DRIVEN_CASES = (
    ("ta01", 1024, 512, {}),
    ("ta41-ta50", 1280, 256, {}),
    ("ta71", 256, 256, {}),
    ("ta01", 512, 256, {"jobs_pad": 16, "machines_pad": 16}),
    ("rand6x5", 256, 256, {}),
)
QUICK_DRIVEN_CASES = (("ta01", 256, 300, {}), ("ta01", 256, 300, {"light": True}), ("rand6x5", 128, 128, {}),
                      ("ta71", 64, 64, {}))
FREE_CASES = (("ta01", 1024, 512), ("ta41-ta50", 1280, 768))
QUICK_FREE_CASES = (("ta01", 256, 300), ("rand6x5", 128, 128))
FULL = (("ta01", 16384, 1024), ("ta01-ta10", 10240, 1024), ("ta41-ta50", 10240, 1024), ("ta71", 8192, 3072))
# the free kernel's storage dtype each FULL batch must select (value_dtype)
FULL_DTYPE = {"ta01": "int16", "ta01-ta10": "int16", "ta41-ta50": "int32", "ta71": "int32"}
MAIN_B = 16384  # ta01 lanes of the policy-in-the-loop main path
LOOP_STEPS = 256  # its steps, one driven launch each
LEARNER_B = 8192  # ta01 lanes of the learner's light env state (phase 13)
RULE_SET, RULE_LANES, QUICK_RULE_LANES, RULE_MAX_STEPS = "ta01-ta10", 10240, 70, 4096
EXPLORE = (0.0, 0.1)
GOLDEN = Path(__file__).resolve().parent / "tests" / "data" / "golden_solutions.json"
REPLAY_TORCH_EXTRA = ("ta71",)  # replayed on the card beside the published optima

# phase 12: (checkpoint, instance, compute dtype, sampled lanes beside the
# greedy one, the JAX package's value): a bound (< at bfloat16, from
# tests/test_parallel.py), its float32 makespan on the CPU, or None (recorded
# only: ta41_distill at bfloat16 sits on argmax ties)
MODELS = Path(__file__).resolve().parent / "models_data"
CHECKPOINT_CONFIG = {  # checkpoint -> (arch, hidden, features)
    "ta01_policy": ("flat", (256, 256), "reference"),
    "ta01_policy_rich": ("flat", (256, 256), "rich"),
    "ta41_policy_rich": ("flat", (256, 256), "rich"),
    "ta_cross_policy": ("perjob", (128, 128), "rich"),
    "ta41_distill": ("perjob", (128, 128), "rich"),
}
SERVING = (
    ("ta01_policy", "ta01", "bfloat16", 0, 1500),
    ("ta01_policy_rich", "ta01", "bfloat16", 0, 1400),
    ("ta41_policy_rich", "ta41", "bfloat16", 0, 2499),
    ("ta_cross_policy", "ta45", "bfloat16", 0, 2487),
    ("ta_cross_policy", "ta09", "bfloat16", 0, 1541),
    ("ta41_distill", "ta41", "bfloat16", 0, None),
    ("ta01_policy_rich", "ta01", "float32", 0, 1347),
    ("ta41_distill", "ta41", "float32", 0, 2658),
    ("ta41_policy_rich", "ta41", "float32", 0, None),
    ("ta01_policy_rich", "ta01", "bfloat16", 63, 1400),
)
SERVING_QUICK = (("ta01_policy_rich", "ta01", "float32", 0, 1347), ("ta01_policy", "ta01", "bfloat16", 7, 1500))
# phase 13: (tag, instance, B, updates, LearnerConfig fields); the first is the
# JAX package's learner configuration (docs/BENCHMARKS.md: ta01, B=8192,
# unroll 32, 256x256 MaskedPolicyNet, REINFORCE)
TRAIN = (
    ("reinforce", "ta01", LEARNER_B, 12, {}),
    ("ppo", "ta01", LEARNER_B, 2, {"algo": "ppo"}),
    ("perjob", "ta41", 1024, 2, {"arch": "perjob", "hidden": (128, 128), "features": "rich"}),
)
TRAIN_QUICK = (
    ("reinforce", "ta01", 512, 2, {"unroll_steps": 8}),
    ("ppo", "ta01", 512, 2, {"algo": "ppo", "unroll_steps": 8}),
    ("perjob", "ta41", 64, 2, {"arch": "perjob", "hidden": (128, 128), "features": "rich", "unroll_steps": 8}),
)

# LAUNCHES key -> (kernel, the TPU kernel it replaces)
KERNELS = {
    "rollout_driven": ("rollout_driven_kernel", "jssenv_tpu/core/pallas_rollout.py:598"),
    "rollout_free": ("rollout_free_kernel", "jssenv_tpu/core/pallas_rollout.py:653"),
    "rollout_free_i16": ("rollout_free_kernel<int16>", "jssenv_tpu/core/pallas_rollout.py:653"),
}
SOURCE = "jssenv_tpu_torch/core/csrc/rollout.cu"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def busy_share(fn):
    """Device busy share of ``fn()`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): the aten:: rows above them
    # report the same device time again
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / wall_us if busy_us else "not measured",
            "top": [(e.key, e.self_device_time_total / 1e3, e.count) for e in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="run the small parity phases only")
    ap.add_argument("--out", default=None, help="write all measurements to this JSON file")
    ap.add_argument("--profile", action="store_true", help="add torch.profiler windows to phases 8, 9 and 13")
    ap.add_argument("--against", metavar="ROOT", default=None,
                    help="also time another checkout's kernels (e.g. the parent commit's) in turns with these")
    ap.add_argument("--time-kernels", metavar="ROOT", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank-worker", nargs=4, metavar=("WORK", "RANK", "WORLD", "PORT"), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_kernels:
        return time_kernels_of(args.time_kernels, args.out)
    if args.rank_worker:
        work, rank, world, port = args.rank_worker
        return rank_worker(work, int(rank), int(world), int(port), args.quick)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import _build, fused_rollout as fr
    from jssenv_tpu_torch.core.state import FIELD_NAMES

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report: dict = {}

    # ---- 1. device ---------------------------------------------------------
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[1] device: {kind} x{count} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    report["device"] = {"kind": kind, "count": count, "nvidia_smi": smi}

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    fr._lib()
    report["build_s"] = time.perf_counter() - t0
    log(f"[2] built {SOURCE} in {report['build_s']:.1f}s\n{_build.ptxas_report('rollout')}")
    report["ptxas"] = _build.ptxas_report("rollout")

    def make(name, B, **pad):
        return vector.make_batch(source(instances, name), B, device=dev, **pad)

    # the launch geometry (fused_rollout.launch_geometry) of each FULL config
    # in its value dtype, and of the driven kernel's main shape
    report["geometry"] = {}
    for name, vdt in [(n, FULL_DTYPE[n]) for n, _, _ in FULL] + [("ta01", "int32")]:
        few = make(name, 10)
        geo = fr.launch_geometry(few.jobs_pad, few.machines_pad, getattr(torch, vdt))
        report["geometry"][f"{name} {vdt}"] = geo._asdict()
        log(f"[2] launch geometry {name} (J={few.jobs_pad}, M={few.machines_pad}) {vdt}: {geo}")

    def max_err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0

    def state_err(s1, s2) -> int:
        errs = {k: max_err(getattr(s1, k), getattr(s2, k)) for k in FIELD_NAMES}
        bad = {k: v for k, v in errs.items() if v}
        check(not bad, f"state fields differ: {bad}")
        return max(errs.values())

    class Events:
        """Sum of CUDA-event intervals over several timed regions."""

        def __init__(self):
            self.pairs = []

        def __enter__(self):
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()

        def __exit__(self, *exc):
            self.e1.record()
            self.pairs.append((self.e0, self.e1))

        def ms(self) -> float:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.pairs) / len(self.pairs)

    # ---- 3. driven parity --------------------------------------------------
    driven_cases = QUICK_DRIVEN_CASES if args.quick else DRIVEN_CASES
    report["driven_parity"] = []
    driven_err = 0
    recorded = {}  # the first case's inputs, episodes and allocations, timed in phase 7
    for i, (name, B, T, pad) in enumerate(driven_cases):
        state = make(name, B, **{k: v for k, v in pad.items() if k != "light"})
        if pad.get("light"):
            state = vector.strip_solution(state)
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        acts, raws, ends, s = [], [], [], state
        plain = Events()
        for _ in range(T):
            a = vector.random_legal_actions(gen, s)
            with plain:  # the twin's step: vector.step_autoreset's vstep and reset_lanes
                s, r, e = fr.rollout_driven_reference(s, a[None], 1, return_ends=True)
            acts.append(a)
            raws.append(r[0])
            ends.append(e[0])
        kern = Events()
        with kern:
            fin, rew, k_ends = fr.rollout_driven(state, torch.stack(acts), T, return_ends=True)
        torch.cuda.synchronize()
        ends = torch.stack(ends)
        err = max(max_err(rew, torch.stack(raws)), max_err(k_ends, ends), state_err(fin, s))
        check(err == 0, f"driven {name}: rewards or ends differ")
        fin_plain, rew_plain = fr.rollout_driven(state, torch.stack(acts), T)  # the launch without ends
        check(max(max_err(rew_plain, rew), state_err(fin_plain, fin)) == 0, f"driven {name}: ends changed the run")
        driven_err = max(driven_err, err)
        episodes = int((ends > 0).sum())
        row = {"config": name, "pad": pad, "B": B, "T": T, "episodes": episodes,
               "max_abs_err": err, "kernel_call_ms": kern.ms(), "plain_step_ms": plain.ms()}
        report["driven_parity"].append(row)
        log(f"[3] driven parity (rewards, ends, state) {row}")
        if i == 0:
            acts = torch.stack(acts)
            recorded["T512"] = (state, acts, episodes, int((acts < state.num_jobs).sum()))
    check(any(r["episodes"] > 0 for r in report["driven_parity"]), "no episode crossed a boundary")

    if not args.quick:
        # the main paths' driven shapes, one step per launch, as long as the
        # policy loop, so that lanes reset and no-op gates open: the policy
        # loop's (B=MAIN_B, full state) and the learner's and serving's
        # (B=LEARNER_B, light state: vector.strip_solution)
        for key, B, light in (("driven_main_shape", MAIN_B, False), ("driven_learner_shape", LEARNER_B, True)):
            T = LOOP_STEPS
            s_p = s_k = make("ta01", B)
            if light:
                s_p = s_k = vector.strip_solution(s_p)
            gen = torch.Generator(device=dev).manual_seed(SEED + B)
            episodes = torch.zeros((), dtype=torch.int64, device=dev)
            noop_steps = torch.zeros((), dtype=torch.int64, device=dev)
            plain = Events()
            for t in range(T):
                a = vector.random_legal_actions(gen, s_p)
                s_in = s_p
                with plain:
                    s_p, r_p, e_p = fr.rollout_driven_reference(s_p, a[None], 1, return_ends=True)
                s_k, rew, e_k = fr.rollout_driven(s_k, a[None], 1, return_ends=True)
                err = max(max_err(rew, r_p), max_err(e_k, e_p), state_err(s_k, s_p))
                check(err == 0, f"driven B={B} light={light}: rewards or ends differ")
                check(s_k.solution.shape[1] == (0 if light else s_k.jobs_pad),
                      f"driven B={B} light={light}: solution rows {s_k.solution.shape[1]}")
                noop_steps += s_p.noop_legal.sum()
                episodes += (e_p > 0).sum()
            if not light:
                recorded["main"] = (s_in, a[None].contiguous(), int((e_p > 0).sum()),
                                    int((a < s_in.num_jobs).sum()))
            row = {"B": B, "T": T, "light": light, "max_abs_err": 0, "episodes": int(episodes),
                   "noop_legal_lane_steps": int(noop_steps), "plain_step_ms": plain.ms()}
            check(row["episodes"] > 0 and row["noop_legal_lane_steps"] > 0,
                  f"{key} parity crossed no episode end or no open no-op gate: {row}")
            report[key] = row
            log(f"[3] driven parity (rewards, ends, state) at ta01 B={B}, one step a launch, "
                f"{'light' if light else 'full'} state: {row}")

    # ---- 4. free parity, bits mode -----------------------------------------
    def rand_bits(T, B, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randint(0, 2**32, (T, B), dtype=torch.int64, device=dev, generator=g)
        return (x - 2**31).to(torch.int32)

    def compare_free(k, r, tag):
        errs = {key: max_err(k[key], r[key]) for key in ("episodes", "mk_sum", "mk_min", "viol")}
        check(not any(errs.values()), f"{tag}: per-lane stats differ {errs}")
        ret_err = float((k["ret"] - r["ret"]).abs().max())
        ka, ra = fr._reduce_stats(k, 1, 1), fr._reduce_stats(r, 1, 1)
        rel = abs(float(ka["total_return"]) - float(ra["total_return"])) / max(1.0, abs(float(ra["total_return"])))
        check(rel <= 1e-5, f"{tag}: total_return rel err {rel}")
        check(int(ka["identity_violations"]) == 0, f"{tag}: reward-identity violations")
        return ret_err, rel

    KEY = {torch.int32: "rollout_free", torch.int16: "rollout_free_i16"}

    def free_kernel(state, T, vdt, seed=0, bits=None):
        """Per-lane stats of one launch of the free kernel's ``vdt``
        instantiation; checks that it launched."""
        before = fr.LAUNCHES[KEY[vdt]]
        out = fr._free_kernel(state, T, seed, bits, vdt)
        check(fr.LAUNCHES[KEY[vdt]] == before + 1, f"{KEY[vdt]} did not launch")
        return out

    free_cases = QUICK_FREE_CASES if args.quick else FREE_CASES
    report["free_parity"] = []
    free_err = {key: 0.0 for key in KEY.values()}  # max |kernel - twin| of a lane's return
    for i, (name, B, T) in enumerate(free_cases):
        state = make(name, B)
        bits = rand_bits(T, B, SEED + 100 + i)
        r = fr.free_lane_stats_reference(state, T, bits=bits)
        row = {"config": name, "B": B, "T": T, "episodes": int(r["episodes"].sum()),
               "value_dtype": str(fr.value_dtype(state))}
        for vdt in (torch.int32, torch.int16) if fr.value_dtype(state) == torch.int16 else (torch.int32,):
            ret_err, rel = compare_free(free_kernel(state, T, vdt, bits=bits), r, f"free bits {KEY[vdt]} {name}")
            free_err[KEY[vdt]] = max(free_err[KEY[vdt]], ret_err)
            row[KEY[vdt]] = {"ret_max_abs_err": ret_err, "total_return_rel_err": rel}
        check(row["episodes"] > 0, f"free bits {name}: no episode ended")
        report["free_parity"].append(row)
        log(f"[4] free parity (bits) {row}")
    check(any("rollout_free_i16" in r for r in report["free_parity"]), "no bits-mode case ran the int16 kernel")

    if args.quick:
        # the Philox words of the kernel and of the twin, in both instantiations
        state = make("rand6x5", 128)
        ref = fr.free_lane_stats_reference(state, 128, seed=SEED)
        for vdt in KEY:
            compare_free(free_kernel(state, 128, vdt, seed=SEED), ref, f"free philox {KEY[vdt]}")
        log("[4] free parity (philox, int32 and int16) ok")
        rule_phase(report, dev, QUICK_RULE_LANES, profile=False)
        replay_phase(report, dev, quick=True)
        wrapper_phase(report, dev)
        serving_phase(report, dev, quick=True)
        _, call = training_phase(report, dev, quick=True, profile=False)
        parallel_phase(report, dev, quick=True)
        distill_phase(report, dev, quick=True)
        resume_phase(report, dev, call["final"])
        solver_phase(report, dev, quick=True, smi=smi)
        kernels = [{"name": KERNELS[n][0], "launches": fr.LAUNCHES[n]} for n in KERNELS]
        log(json.dumps({"kernels": kernels}))
        return finish(report, args, smi, kind, count)

    # ---- 5. the main path at full width ------------------------------------
    fr.reset_launch_counts()
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    # policy-in-the-loop: the policy outside, one env step per driven launch
    loop_B = MAIN_B
    s = make("ta01", loop_B)
    spec = source(instances, "ta01")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    ep_raw = torch.zeros(loop_B, dtype=torch.int64, device=dev)
    loop_eps = torch.zeros((), dtype=torch.int64, device=dev)
    loop_bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(LOOP_STEPS):
        a = vector.random_legal_actions(gen, s)
        s, rew = fr.rollout_driven(s, a[None], 1)
        ep_raw += rew[0]
        # a lane that finished this step was reset: no work done or running
        ended = (s.work_done.sum(1) == 0) & (s.job_busy_for.sum(1) == 0)
        mk2 = 2 * spec.sum_op - ep_raw  # == M * makespan by the reward identity
        mk = mk2 // spec.num_machines
        bad = ended & ((mk2 % spec.num_machines != 0) | (mk < spec.lower_bound()) | (mk > spec.sum_op))
        loop_eps += ended.sum()
        loop_bad += bad.sum()
        ep_raw = torch.where(ended, 0, ep_raw)
    loop_eps, loop_bad = int(loop_eps), int(loop_bad)
    check(loop_eps > 0 and loop_bad == 0, f"policy loop: {loop_eps} episodes, {loop_bad} bad makespans")
    report["policy_loop"] = {"config": "ta01", "B": loop_B, "T": LOOP_STEPS, "episodes": loop_eps}

    def free_run(name, B, T):
        state = make(name, B)
        vdt = str(fr.value_dtype(state)).removeprefix("torch.")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fr.rollout_free(state, T, seed=SEED)
        out = {k: v.item() for k, v in out.items()}
        host_s = time.perf_counter() - t0
        check(vdt == FULL_DTYPE[name], f"{name}: value_dtype {vdt}, expected {FULL_DTYPE[name]}")
        check(out["identity_violations"] == 0, f"{name}: reward-identity violations {out}")
        check(out["episodes"] > 0, f"{name}: no episode ended in {T} steps")
        row = dict(out, B=B, T=T, value_dtype=vdt, host_s=host_s,
                   mean_makespan=out["total_makespan"] / out["episodes"])
        log(f"[5] free philox {name}: {row}")
        return row

    free_main = {name: free_run(name, B, T) for name, B, T in FULL}
    torch.cuda.synchronize()
    launches = dict(fr.LAUNCHES)
    report["main_path"] = {"launches": launches, "seconds": time.perf_counter() - t_main,
                           "free": free_main}
    log(f"[5] main path launches {launches}; value_dtype {FULL_DTYPE}")
    n16 = sum(v == "int16" for v in FULL_DTYPE.values())
    check(launches == {"rollout_driven": LOOP_STEPS, "rollout_free": len(FULL) - n16, "rollout_free_i16": n16},
          f"the main path's launches: {launches}")
    I16_FULL = [(name, B, T) for name, B, T in FULL if FULL_DTYPE[name] == "int16"]

    # ---- 6. plain twin at full width; bits mode at full width --------------
    plain_free_ms = {}
    free_full_err = {}
    for name, B, T in FULL:
        state = make(name, B)
        plain = Events()
        with plain:
            r = fr.rollout_free_reference(state, T, seed=SEED)
        plain_free_ms[name] = plain.ms()
        r = {k: v.item() for k, v in r.items()}
        k = free_main[name]
        for key in ("episodes", "total_makespan", "min_makespan", "steps", "identity_violations"):
            check(k[key] == r[key], f"{name}: {key} kernel {k[key]} plain {r[key]}")
        abs_err = abs(k["total_return"] - r["total_return"])
        rel = abs_err / max(1.0, abs(r["total_return"]))
        check(rel <= 1e-5, f"{name}: total_return rel err {rel}")
        free_full_err[name] = abs_err
        bits = rand_bits(T, B, SEED + 200)
        kb = {k_: v.item() for k_, v in fr.rollout_free(state, T, bits=bits).items()}
        check(kb["identity_violations"] == 0 and kb["episodes"] > 0, f"{name} bits: {kb}")
        mean_bits = kb["total_makespan"] / kb["episodes"]
        drift = abs(k["mean_makespan"] - mean_bits) / mean_bits
        check(drift <= 0.01, f"{name}: philox mean makespan {k['mean_makespan']} vs bits {mean_bits}")
        free_main[name].update(plain_ms=plain_free_ms[name], total_return_rel_err=rel,
                               bits_mean_makespan=mean_bits, philox_vs_bits=drift)
        log(f"[6] {name}: twin equal (return rel err {rel:.2e}), bits-mode mean makespan "
            f"{mean_bits:.2f} vs philox {k['mean_makespan']:.2f} ({drift:.2e}), plain {plain_free_ms[name]:.0f} ms")

    # the int16 kernel against the int32 kernel, lane by lane, at full width
    for name, B, T in I16_FULL:
        state = make(name, B)
        k16 = free_kernel(state, T, torch.int16, seed=SEED)
        k32 = free_kernel(state, T, torch.int32, seed=SEED)
        errs = {key: max_err(k16[key], k32[key]) for key in ("episodes", "mk_sum", "mk_min", "viol")}
        check(not any(errs.values()), f"int16 vs int32 {name}: per-lane stats differ {errs}")
        check(torch.equal(k16["ret"], k32["ret"]), f"int16 vs int32 {name}: returns differ")
        red = {key: v.item() for key, v in fr._reduce_stats(k16, T, B).items()}
        for key in ("episodes", "total_makespan", "min_makespan", "identity_violations"):
            check(red[key] == free_main[name][key], f"int16 {name}: {key} differs from the main path's run")
        check(red["identity_violations"] == 0, f"int16 {name}: reward-identity violations")
        free_main[name]["int16_vs_int32_max_abs_err"] = max(errs.values())
        log(f"[6] int16 vs int32 {name} B={B} T={T}: per-lane stats equal "
            f"({int(k16['episodes'].sum())} episodes, 0 identity violations)")

    # ---- 7. kernel times and bounds ----------------------------------------
    timings = {}
    # the driven kernel on inputs of the parity runs: the last step of the
    # main-shape run, and the first driven case
    state, acts, resets, job_steps = recorded["main"]
    timings["rollout_driven"] = dict(
        launch_timer(fr, dev, "rollout_driven", state, 1, actions=acts, resets=resets, job_steps=job_steps),
        shape=f"ta01 B={MAIN_B} T=1 (step {LOOP_STEPS} of a policy loop)", resets=resets,
        plain_ms=report["driven_main_shape"]["plain_step_ms"])
    name, B, T, _ = DRIVEN_CASES[0]
    state, acts, resets, job_steps = recorded["T512"]
    timings["rollout_driven_T512"] = dict(
        launch_timer(fr, dev, "rollout_driven", state, T, actions=acts, resets=resets, job_steps=job_steps),
        shape=f"{name} B={B} T={T}", resets=resets,
        plain_ms=report["driven_parity"][0]["plain_step_ms"] * T)
    for name, B, T in FULL:
        state = make(name, B)
        if FULL_DTYPE[name] == "int32":
            row = dict(launch_timer(fr, dev, "rollout_free", state, T, repeats=3),
                       shape=f"{name} B={B} T={T}", plain_ms=plain_free_ms[name])
            row["env_steps_per_s"] = B * T / (row["ms"] / 1e3)
            timings[f"rollout_free {name}"] = row
            log(f"[7] rollout_free {name}: {row['ms']:.2f} ms, {row['env_steps_per_s']:.4g} env-steps/s "
                f"({smi}); bound {row['bound_ms']:.4f} ms by {row['bound_by']}; plain {row['plain_ms']:.0f} ms")
            continue
        # the int16 kernel, and the int32 one on the same batch, in turns
        # (int32, int16, int16, int32), two launches each turn
        turns = {torch.int32: [], torch.int16: []}
        for vdt in (torch.int32, torch.int16, torch.int16, torch.int32):
            turns[vdt].append(launch_timer(fr, dev, "rollout_free", state, T, repeats=2, vdt=vdt))
        ms32 = sum(t["ms"] for t in turns[torch.int32]) / 2
        row = dict(turns[torch.int16][0], ms=sum(t["ms"] for t in turns[torch.int16]) / 2,
                   ms_turns=[t["ms"] for t in turns[torch.int16]],
                   int32_ms=ms32, int32_ms_turns=[t["ms"] for t in turns[torch.int32]],
                   int32_bound_ms=turns[torch.int32][0]["bound_ms"], shape=f"{name} B={B} T={T}",
                   plain_ms=plain_free_ms[name])
        row["ratio_to_int32"] = row["ms"] / ms32
        row["env_steps_per_s"] = B * T / (row["ms"] / 1e3)
        timings[f"rollout_free_i16 {name}"] = row
        log(f"[7] rollout_free_i16 {name}: {row['ms']:.2f} ms against int32 {ms32:.2f} ms "
            f"(ratio {row['ratio_to_int32']:.3f}), {row['env_steps_per_s']:.4g} env-steps/s ({smi}); "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} (int32 {row['int32_bound_ms']:.4f}); "
            f"plain {row['plain_ms']:.0f} ms")
    for key in ("rollout_driven", "rollout_driven_T512"):
        log(f"[7] {key} {timings[key]['shape']}: {timings[key]['ms']:.3f} ms ({smi}); "
            f"bound {timings[key]['bound_ms']:.5f} ms; plain {timings[key]['plain_ms']:.1f} ms")
    report["timings"] = timings
    if args.against:
        report["turns"] = turns_against(args.against, smi)

    # ---- 8. where the main path's time goes --------------------------------
    def policy_step(s, gen, clock=None):
        """One policy-loop step, the stages of ``fr.rollout_driven`` spelled
        out so that ``clock`` (a dict) can take each stage's host time."""
        stages = (
            ("sample", lambda: vector.random_legal_actions(gen, s)),
            ("to_lanes", lambda: fr._to_lanes(s, True)),
            ("lane_inputs", lambda: fr._lane_inputs(s)),
        )
        out = {}
        for name, fn in stages:
            t0 = time.perf_counter()
            out[name] = fn()
            if clock is not None:
                torch.cuda.synchronize()
                clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()
        rewards = torch.empty((1, s.batch_size), dtype=torch.int32, device=dev)
        fr.launch_driven(s, out["to_lanes"], *out["lane_inputs"], out["sample"][None].contiguous(),
                         rewards, True)
        if clock is not None:
            torch.cuda.synchronize()
            clock["kernel"] = clock.get("kernel", 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()
        s = fr._from_lanes(out["to_lanes"], s, True)
        if clock is not None:
            torch.cuda.synchronize()
            clock["from_lanes"] = clock.get("from_lanes", 0.0) + time.perf_counter() - t0
        return s

    n = 32
    s = make("ta01", MAIN_B)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    s = policy_step(s, gen)  # warm-up
    clock: dict = {}
    for _ in range(n):
        s = policy_step(s, gen, clock)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        s = policy_step(s, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    stage_ms = {k: v / n * 1e3 for k, v in clock.items()}
    report["policy_step"] = {"B": MAIN_B, "steps": n, "step_ms": step_ms, "stage_ms": stage_ms}
    log(f"[8] policy-loop step ta01 B={MAIN_B}: {step_ms:.3f} ms unsynchronised; synchronised stages "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()) + f" ({smi})")

    if args.profile:
        def loop():
            nonlocal s
            for _ in range(n):
                s = policy_step(s, gen)

        prof_loop = busy_share(loop)
        state = make("ta01", MAIN_B)
        prof_free = busy_share(lambda: fr.rollout_free(state, FULL[0][2], seed=SEED))
        report["profile"] = {"policy_loop": prof_loop, "free_ta01": prof_free}
        log(f"[8] profile policy loop: {prof_loop}\n[8] profile free ta01: {prof_free}")

    # ---- 9-11. rules, replay, wrappers -------------------------------------
    fr.reset_launch_counts()
    rule_phase(report, dev, RULE_LANES, profile=args.profile)
    replay_phase(report, dev, quick=False)
    wrapper_phase(report, dev)
    check(not any(fr.LAUNCHES.values()), f"rules, replay and wrappers launched a rollout kernel: {fr.LAUNCHES}")

    # ---- 12-13. serving and training: the policy nets on the driven kernel -
    driven_by_path = {"policy_loop": launches["rollout_driven"],
                      "serving": serving_phase(report, dev, quick=False)}
    driven_by_path["training"], call = training_phase(report, dev, quick=False, profile=args.profile)
    launches["rollout_driven"] = sum(driven_by_path.values())
    report["main_path"]["driven_launches_by_path"] = driven_by_path
    # the driven kernel at the learner's shape: the last env step of the
    # REINFORCE run (light state), its ends written; kernel and twin on the
    # same inputs must agree in every state field, the rewards and the ends
    st, acts = call["state"], call["actions"]
    check(st.solution.shape[1] == 0, "the learner's env state is not light")
    twin = Events()
    for _ in range(2):
        with twin:
            ref = fr.rollout_driven_reference(st, acts, 1, return_ends=True)
    got = fr.rollout_driven(st, acts, 1, return_ends=True)
    torch.cuda.synchronize()
    err = max(state_err(got[0], ref[0]), max_err(got[1], ref[1]), max_err(got[2], ref[2]))
    check(err == 0 and got[0].solution.shape[1] == 0, "driven at the learner's shape: kernel and twin differ")
    driven_err = max(driven_err, err)
    log(f"[13] rollout_driven at the learner's shape: kernel equals its twin on the recorded step "
        f"({int((ref[2] > 0).sum())} lanes end)")
    timings["rollout_driven_learner"] = dict(
        launch_timer(fr, dev, "rollout_driven", st, 1, actions=acts, resets=int(call["resets"].sum()),
                     job_steps=int(call["jobs"].sum()), ends=True, repeats=20),
        shape=f"ta01 B={st.batch_size} T=1 with ends (the learner's env step, light state)",
        plain_ms=twin.ms(), launches=driven_by_path["training"])
    row = timings["rollout_driven_learner"]
    log(f"[13] rollout_driven at the learner's shape {row['shape']}: {row['ms']:.4f} ms ({smi}); bound "
        f"{row['bound_ms']:.5f} ms by {row['bound_by']}; plain {row['plain_ms']:.2f} ms")

    # ---- 14-16. data and tensor parallel, distillation, diagnostics and resume
    par_launches, par_errs = parallel_phase(report, dev, quick=False)
    driven_by_path["parallel"] = par_launches["rollout_driven"]
    driven_by_path["distill"] = distill_phase(report, dev, quick=False)
    resume_phase(report, dev, call["final"])
    solver_phase(report, dev, quick=False, smi=smi)
    launches["rollout_driven"] = sum(driven_by_path.values())
    free_by_path = {}
    for key in KEY.values():
        free_by_path[key] = {"main_path": launches[key], "sharded": par_launches[key]}
        launches[key] += par_launches[key]
        free_err[key] = max(free_err[key], par_errs[key])
    report["main_path"]["driven_launches_by_path"] = driven_by_path

    main_rows = {"rollout_driven": timings["rollout_driven"], "rollout_free": timings["rollout_free ta41-ta50"],
                 "rollout_free_i16": timings["rollout_free_i16 ta01"]}
    errs = {"rollout_driven": driven_err}
    for vdt, key in KEY.items():
        names = [n for n, _, _ in FULL if FULL_DTYPE[n] == str(vdt).removeprefix("torch.")]
        errs[key] = max(free_err[key], *(free_full_err[n] for n in names))
    kernels = [
        {"name": KERNELS[n][0], "route": "cuda", "source": SOURCE, "replaces": KERNELS[n][1],
         "launches": launches[n], "max_abs_err": errs[n], "ms": main_rows[n]["ms"],
         "plain_ms": main_rows[n]["plain_ms"], "bound_ms": main_rows[n]["bound_ms"],
         "bound_by": main_rows[n]["bound_by"], "library_ms": None, "shape": main_rows[n]["shape"]}
        for n in KERNELS
    ]
    kernels[0]["launches_by_path"] = driven_by_path
    kernels[1]["launches_by_path"] = free_by_path["rollout_free"]
    kernels[2]["launches_by_path"] = free_by_path["rollout_free_i16"]
    kernels[0]["learner_shape"] = {k: timings["rollout_driven_learner"][k]
                                   for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")}
    report["kernels"] = kernels
    log(json.dumps({"kernels": kernels}))
    return finish(report, args, smi, kind, count)


def launch_timer(fr, dev, kernel, state, T, actions=None, bits=None, repeats=5, resets=0, job_steps=0,
                 vdt=None, ends=False):
    """Mean ms of one launch (CUDA events), each on a freshly restored state
    buffer, and the launch's bound. ``fr``: the ``fused_rollout`` module
    whose kernels are timed (this checkout's or another's). ``resets`` and
    ``job_steps``: the episodes that end and the jobs allocated in the
    launch (they set the driven kernel's solution writes). ``vdt``: the free
    kernel's storage dtype (int32 by default). ``ends``: the driven kernel
    also writes its (T, B) episode ends, as the learner's steps do."""
    import torch

    vdt = torch.int32 if vdt is None else vdt
    ws = kernel == "rollout_driven" and fr._solution_mode(state)
    buf0 = fr._to_lanes(state, ws, vdt)
    buf = buf0.clone()
    tab, lanec = fr._lane_inputs(state)
    B = state.batch_size
    if kernel == "rollout_driven":
        rewards = torch.empty((T, B), dtype=torch.int32, device=dev)
        out_ends = torch.empty_like(rewards) if ends else None
        extra = (out_ends,) if ends else ()  # an older checkout's launcher takes no ends
        go = lambda: fr.launch_driven(state, buf, tab, lanec, actions, rewards, ws, *extra)  # noqa: E731
    else:
        st = torch.empty((4, B), dtype=torch.int64, device=dev)
        ret = torch.empty((B,), dtype=torch.float32, device=dev)
        go = lambda: fr.launch_free(state, buf, tab, lanec, bits, SEED, st, ret, T, vdt)  # noqa: E731
    buf.copy_(buf0)
    go()  # warm-up
    total = 0.0
    for _ in range(repeats):
        buf.copy_(buf0)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        go()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    # bytes: the light state rows in the storage dtype, read once by the free
    # kernel (which writes no state) and read and written once by the driven
    # one (whose solution is only written: one word per allocated job, J*M
    # per reset); the tables, the lane constants the kernel reads, the
    # actions or bits, the outputs (the driven kernel's rewards and, when
    # asked, its ends: T*B words each)
    J, M = state.jobs_pad, state.machines_pad
    passes = 2 if kernel == "rollout_driven" else 1
    state_bytes = passes * (4 + 10 * J + 2 * M) * B * buf.element_size()
    words = tab.numel()
    if kernel == "rollout_driven":
        words += 4 * B + (3 if ends else 2) * T * B + (job_steps + resets * J * M if ws else 0)
        ops_per = 4 * J + 2 * M
    else:
        words += 5 * B + (T * B if bits is not None else 0) + 2 * 4 * B + B
        ops_per = 5 * J + 2 * M + (0 if bits is not None else 100)
    nbytes, nops = state_bytes + 4 * words, T * B * ops_per
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
    return {"ms": total / repeats, "bytes": nbytes, "int_ops": nops,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def source(instances, name):
    """The instance or instance set of a config name."""
    if name in ("ta41-ta50", "ta01-ta10"):
        lo, hi = (41, 50) if name == "ta41-ta50" else (1, 10)
        return instances.get_instance_set([f"ta{i:02d}" for i in range(lo, hi + 1)])
    if name == "rand6x5":
        return instances.random_instance(6, 5, (1, 9), seed=3)
    return instances.get_instance(name)


def time_kernels_of(root: str, out: str) -> int:
    """``--time-kernels ROOT``: import ``jssenv_tpu_torch`` from the checkout
    at ``root`` (this one, or another such as the parent commit's), build its
    kernels there, and write to ``out`` (JSON) the time of its free kernel
    on each FULL config in the config's value dtype and of its driven kernel
    at the main shape (ta01, B=MAIN_B, T=1, the last step of a
    LOOP_STEPS-step policy loop run on the plain path) and at the first
    driven parity case's (ta01, B=1024, T=512 random-policy steps)."""
    root_path = Path(root).resolve()
    sys.path.insert(0, str(root_path))
    import torch

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import _build, fused_rollout as fr

    check(Path(fr.__file__).resolve().is_relative_to(root_path), f"imported {fr.__file__}, not {root}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    fr._lib()
    res = {"root": str(root_path), "build_s": time.perf_counter() - t0, "ptxas": _build.ptxas_report("rollout")}
    s = vector.make_batch(instances.get_instance("ta01"), MAIN_B, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stats = vector.RolloutStats.zero(dev)
    for _ in range(LOOP_STEPS - 1):
        s, _, stats = vector.step_autoreset(s, vector.random_legal_actions(gen, s), stats)
    acts = vector.random_legal_actions(gen, s)[None].contiguous()
    res["rollout_driven"] = launch_timer(fr, dev, "rollout_driven", s, 1, actions=acts, repeats=20)["ms"]
    # the first driven parity case's shape: T=512 steps of a random policy
    name, B, T, _ = DRIVEN_CASES[0]
    s0 = s = vector.make_batch(source(instances, name), B, device=dev)
    acts = []
    for _ in range(T):
        acts.append(vector.random_legal_actions(gen, s))
        s, _, stats = vector.step_autoreset(s, acts[-1], stats)
    res["rollout_driven_T512"] = launch_timer(fr, dev, "rollout_driven", s0, T, actions=torch.stack(acts).contiguous(),
                                              repeats=5)["ms"]
    for name, B, T in FULL:
        state = vector.make_batch(source(instances, name), B, device=dev)
        vdt = fr.value_dtype(state)
        res[f"rollout_free {name}"] = launch_timer(fr, dev, "rollout_free", state, T, repeats=2, vdt=vdt)["ms"]
    Path(out).write_text(json.dumps(res))
    return 0


def turns_against(root: str, smi: str) -> dict:
    """``--against ROOT``: the kernels of the checkout at ``root`` and of this
    one, timed in turns (root, this, this, root), each turn a process of its
    own (``--time-kernels``) on this card."""
    here = Path(__file__).resolve().parent
    scratch = here / "jssenv_tpu_torch" / "build"
    scratch.mkdir(parents=True, exist_ok=True)
    turns = []
    for i, (tag, r) in enumerate((("parent", root), ("change", here), ("change", here), ("parent", root))):
        out = scratch / f"turn{i}.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time-kernels", str(r), "--out", str(out)],
                       check=True, timeout=900)
        turns.append((tag, json.loads(out.read_text())))
        log(f"[7b] turn {i} ({tag}, {r}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in turns[-1][1].items() if k.startswith("rollout")))
    keys = [k for k in turns[0][1] if k.startswith("rollout")]
    rows = {}
    for k in keys:
        p = [t[k] for tag, t in turns if tag == "parent"]
        c = [t[k] for tag, t in turns if tag == "change"]
        rows[k] = {"parent_ms": p, "change_ms": c, "ratio": (sum(c) / 2) / (sum(p) / 2)}
        log(f"[7b] {k}: parent {p[0]:.4f}, {p[1]:.4f} ms; change {c[0]:.4f}, {c[1]:.4f} ms; "
            f"change/parent {rows[k]['ratio']:.4f} ({smi})")
    return {"root": str(root), "rows": rows,
            "ptxas": {tag: t["ptxas"] for tag, t in turns[:2]}}


def rule_phase(report: dict, dev, lanes: int, profile: bool) -> None:
    """Phase 9: the seven rules on ragged ta01-ta10 at ``lanes`` lanes per
    rule, through ``compare_rules_batched`` on the card (timed per rule), and
    through the same episodes with every action checked against the mask."""
    import torch

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.rules import dispatching as dsp

    src = instances.get_instance_set([f"ta{i:02d}" for i in range(1, 11)])
    n_inst = len(src)
    check(lanes % n_inst == 0, "lanes must tile the instances evenly")

    def checked_episodes(device, name, explore, seed, n=lanes):
        """(makespans, returns, illegal choices) of ``compare_rules_batched``'s
        episodes for one rule on ``n`` lanes, each chosen action checked
        against the mask."""
        state = vector.make_batch(src, n, device=device)
        gen = torch.Generator(device=state.device).manual_seed(seed)
        base = dsp.get_rule(name).policy(explore_prob=explore)
        illegal = torch.zeros((), dtype=torch.int64, device=state.device)

        def policy(g, s):
            a = base(g, s)
            mask = s.action_mask()
            slot = torch.where(a == s.num_jobs, s.jobs_pad, a).long()
            ok = mask.gather(1, slot[:, None])[:, 0] | ~mask.any(dim=1)
            illegal.add_((~ok).sum())
            return a

        _, ms, ret = vector.episode_makespans(gen, state, RULE_MAX_STEPS, policy)
        return ms.cpu(), ret.cpu(), int(illegal)

    out = {"config": RULE_SET, "lanes_per_rule": lanes, "max_steps": RULE_MAX_STEPS, "runs": {}}
    for explore in EXPLORE:
        rows = {}
        t_cpu = 0.0
        for i, name in enumerate(sorted(dsp.DISPATCHING_RULES)):
            seed = SEED + i
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = dsp.compare_rules_batched(src, rules=[name], num_episodes=lanes, max_steps=RULE_MAX_STEPS,
                                            explore_prob=explore, seed=seed, device=dev)[name]
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            ms, ret, illegal = checked_episodes(dev, name, explore, seed)
            check(illegal == 0, f"rule {name} explore={explore}: {illegal} illegal actions")
            check(bool((ms > 0).all()), f"rule {name} explore={explore}: an episode did not finish")
            check(res["avg_makespan"] == float(ms.numpy().mean()) and res["avg_reward"] == float(ret.numpy().mean()),
                  f"rule {name} explore={explore}: compare_rules_batched {res} differs from its checked episodes")
            per_inst = ms.view(-1, n_inst)  # lane l runs instance l % n_inst
            row = {"wall_s": wall_s, "avg_makespan": res["avg_makespan"], "avg_reward": res["avg_reward"],
                   "makespan_per_instance_mean": per_inst.double().mean(0).tolist()}
            if explore == 0.0:
                check(bool((per_inst == per_inst[:1]).all()), f"rule {name}: greedy lanes of one instance differ")
                # greedy lanes of one instance are equal (just checked), so one
                # CPU lane an instance holds every card lane
                t0 = time.perf_counter()
                ms_cpu, ret_cpu, illegal_cpu = checked_episodes("cpu", name, explore, seed, n_inst)
                t_cpu += time.perf_counter() - t0
                reps = lanes // n_inst
                check(illegal_cpu == 0 and torch.equal(ms, ms_cpu.repeat(reps))
                      and torch.equal(ret, ret_cpu.repeat(reps)),
                      f"rule {name}: the card's makespans or returns differ from the CPU run's")
                row["makespan_per_instance"] = per_inst[0].tolist()
            rows[name] = row
            log(f"[9] rule {name} explore={explore}: {lanes} lanes in {wall_s:.3f} s on the card, "
                f"avg makespan {res['avg_makespan']:.2f}, all legal, all finished")
        out["runs"][str(explore)] = {"rules": rows, "card_s": sum(r["wall_s"] for r in rows.values()),
                                     "cpu_check_s": t_cpu}
        if explore == 0.0:
            log(f"[9] greedy sweep: the card's per-lane makespans equal the CPU run's for all 7 rules "
                f"(CPU run {t_cpu:.1f} s)")
    if profile:
        out["profile_spt"] = busy_share(lambda: dsp.compare_rules_batched(
            src, rules=["SPT"], num_episodes=lanes, max_steps=RULE_MAX_STEPS, seed=SEED, device=dev))
        log(f"[9] profile SPT sweep: {out['profile_spt']}")
    report["rules"] = out


def replay_phase(report: dict, dev, quick: bool) -> None:
    """Phase 10: golden replays, native for every row, torch on the card for
    the published optima and ta71 (ta01 only with ``quick``)."""
    import torch

    from jssenv_tpu_torch import instances, replay

    golden = json.loads(GOLDEN.read_text())
    stored = {k: v.get("optimum", v.get("makespan")) for k, v in golden.items()}
    on_card = ["ta01"] if quick else sorted(k for k, v in golden.items() if "optimum" in v)
    on_card += [] if quick else list(REPLAY_TORCH_EXTRA)
    check(quick or len(on_card) == 13, f"expected 12 optima and ta71, got {on_card}")
    rows = {}
    for name in sorted(golden):
        spec = instances.get_instance(name)
        order = golden[name]["machine_order"]
        t0 = time.perf_counter()
        mk, st = replay.replay_machine_order(spec, order, backend="native")
        row = {"native_s": time.perf_counter() - t0, "makespan": mk}
        check(mk == stored[name] and st.done and not st.any_busy, f"native replay {name}: {mk} != {stored[name]}")
        if name in on_card:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mk_t, st_t = replay.replay_machine_order(spec, order, device=dev)
            torch.cuda.synchronize()
            row["torch_card_s"] = time.perf_counter() - t0
            check(st_t.device.type == dev.type, f"torch replay {name} ran on {st_t.device}")
            check(mk_t == stored[name] and bool(st_t.done[0]) and not bool(st_t.any_busy[0]),
                  f"torch replay {name}: {mk_t} != {stored[name]}")
            check(torch.equal(st_t.solution[0].cpu(), torch.from_numpy(st.solution)),
                  f"replay {name}: torch and native schedules differ")
        rows[name] = row
        log(f"[10] replay {name}: makespan {mk} (stored {stored[name]}), native {row['native_s'] * 1e3:.1f} ms"
            + (f", torch on the card {row['torch_card_s']:.2f} s" if "torch_card_s" in row else ""))
    report["replay"] = rows


def wrapper_phase(report: dict, dev) -> None:
    """Phase 11: a ta01 SPT episode through ``JssEnv`` on each engine; every
    public attribute equal after every step."""
    import numpy as np
    import torch

    from jssenv_tpu_torch.envs.gym_env import PUBLIC_ATTRIBUTES, JssEnv
    from jssenv_tpu_torch.rules import dispatching as dsp

    # the torch wrapper is the default one: no engine and no device given
    envs = {"native": JssEnv({"instance_path": "ta01", "engine": "native"}),
            "torch": JssEnv({"instance_path": "ta01"})}
    check(envs["native"].uses_native_engine and not envs["torch"].uses_native_engine, "engine selection")
    check(envs["torch"].engine_state.device.type == dev.type, "the default wrapper is not on the card")
    compared = [a for a in PUBLIC_ATTRIBUTES if a not in ("colors", "start_timestamp")]

    def same(ctx):
        for name in compared:
            a, b = getattr(envs["torch"], name), getattr(envs["native"], name)
            if name == "state":
                check(a.shape == b.shape and float(np.abs(a - b).max()) <= 1e-6, f"{ctx}: {name}")
            elif isinstance(b, np.ndarray):
                check(a.dtype == b.dtype and np.array_equal(a, b), f"{ctx}: {name}")
            else:
                check(type(a) is type(b) and a == b, f"{ctx}: {name} {a!r} != {b!r}")

    rule = dsp.get_rule("SPT")
    secs = {e: 0.0 for e in envs}
    for env in envs.values():
        env.reset()
    same("reset")
    done, steps = False, 0
    while not done:
        outs = {}
        for e, env in envs.items():
            t0 = time.perf_counter()
            a = rule(env)
            outs[e] = (a, env.step(a))
            torch.cuda.synchronize()
            secs[e] += time.perf_counter() - t0
        (a_n, o_n), (a_t, o_t) = outs["native"], outs["torch"]
        check(a_n == a_t and o_n[1:] == o_t[1:], f"step {steps}: actions or step outputs differ")
        same(f"step {steps}")
        done = o_n[2]
        steps += 1
        check(steps < 5000, "the SPT episode did not end")
    mk = envs["native"].last_time_step
    check(mk == envs["torch"].last_time_step >= 1231, f"SPT makespan {mk}")
    report["wrappers"] = {"steps": steps, "makespan": mk,
                          "ms_per_step": {e: s / steps * 1e3 for e, s in secs.items()}}
    log(f"[11] JssEnv ta01 SPT: {steps} steps, makespan {mk}, every public attribute equal on both engines; "
        + ", ".join(f"{e} {s / steps * 1e3:.3f} ms/step" for e, s in secs.items()))


class DrivenRecorder:
    """While active, wraps ``fused_rollout.rollout_driven`` (which
    ``step_autoreset`` and ``evaluate_policy`` call) to see each call's
    inputs, raw rewards and ends; launches are still counted where the
    kernel launches, nowhere else. ``on_call(state, actions, raw, ends)``
    runs after each call. It sees only calls made through the module
    attribute, so each phase that uses it requires its call count to equal
    the kernel's launch count."""

    def __init__(self, fr, on_call):
        self.fr, self.on_call = fr, on_call

    def __enter__(self):
        orig = self.orig = self.fr.rollout_driven

        def wrapped(state, actions, num_steps, return_ends=False):
            out = orig(state, actions, num_steps, return_ends)
            self.on_call(state, actions, out[1], out[2] if return_ends else None)
            return out

        self.fr.rollout_driven = wrapped
        return self

    def __exit__(self, *exc):
        self.fr.rollout_driven = self.orig


def serving_phase(report: dict, dev, quick: bool) -> int:
    """Phase 12: greedy ``evaluate_policy`` of the shipped checkpoints on the
    card, every env step in the driven kernel; returns its driven launches.
    bfloat16 against the JAX package's test bounds, float32 against its
    float32 makespans on the CPU; each greedy episode's reward identity
    checked from the kernel's own rewards and ends."""
    import torch

    from jssenv_tpu_torch import checkpoint, instances
    from jssenv_tpu_torch.core import fused_rollout as fr
    from jssenv_tpu_torch.parallel import learner

    runs = SERVING_QUICK if quick else SERVING
    rows, launches = [], 0
    for name, spec_name, dtype, lanes, want in runs:
        arch, hidden, features = CHECKPOINT_CONFIG[name]
        cfg = learner.LearnerConfig(arch=arch, hidden=hidden, features=features,
                                    compute_dtype=getattr(torch, dtype))
        spec = instances.get_instance(spec_name)
        params = checkpoint.params_from_flax(MODELS / f"{name}.npz")
        raws, ends = [], []
        fr.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with DrivenRecorder(fr, lambda s, a, r, e: (raws.append(r[0, 0]), ends.append(e[0, 0]))):
            res = learner.evaluate_policy(params, spec, cfg, stochastic_lanes=lanes, max_steps=4096, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = fr.LAUNCHES["rollout_driven"]
        check(n == res["steps"] and n == len(ends) and sum(fr.LAUNCHES.values()) == n,
              f"serve {name} {spec_name}: {fr.LAUNCHES} launches for {res['steps']} steps")
        launches += n
        mk = res["greedy_makespan"]
        raws, ends = torch.stack(raws).cpu(), torch.stack(ends).cpu()
        check(mk > 0 and bool((ends > 0).any()), f"serve {name} {spec_name}: no complete schedule ({mk})")
        first = int((ends > 0).nonzero()[0, 0])
        check(int(ends[first]) == mk, f"serve {name} {spec_name}: makespan {mk}, first end {int(ends[first])}")
        check(int(raws[:first + 1].sum()) == 2 * spec.sum_op - spec.num_machines * mk,
              f"serve {name} {spec_name}: reward identity fails")
        if want is not None:
            ok = mk == want if dtype == "float32" else mk < want
            check(ok, f"serve {name} {spec_name} {dtype}: makespan {mk}, expected "
                  f"{'' if dtype == 'float32' else '< '}{want}")
        row = dict(res, checkpoint=name, instance=spec_name, dtype=dtype, expected=want, seconds=secs,
                   ms_per_step=secs / n * 1e3, launches=n)
        rows.append(row)
        log(f"[12] serve {name} on {spec_name} ({dtype}, {1 + lanes} lanes): greedy makespan {mk} "
            f"({'recorded, no bound' if want is None else ('JAX value ' if dtype == 'float32' else 'JAX bound < ') + str(want)}), "
            f"{n} steps, {n} driven launches, "
            f"{secs:.2f} s, {secs / n * 1e3:.3f} ms a step"
            + (f"; sampled best {res['best_sampled_makespan']}, mean {res['avg_sampled_makespan']:.1f}"
               if lanes else ""))
    report["serving"] = rows
    return launches


def training_phase(report: dict, dev, quick: bool, profile: bool):
    """Phase 13: the learner at full width (ta01, B=8192, unroll 32, 256x256
    MaskedPolicyNet, REINFORCE; then PPO at the same shape and the perjob
    net on ta41 with rich features). Every loss finite, every parameter
    moved, ``unroll_steps`` driven launches an update, the reward identity
    on every lane that ends; ms an update, env-steps/s and the
    rollout/learn split by CUDA events. Returns (driven launches, the
    learner-shape driven launch recorded for timing)."""
    import dataclasses

    import torch

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import fused_rollout as fr
    from jssenv_tpu_torch.parallel import learner

    out, launches = {}, 0
    last_call = {}
    runs = TRAIN_QUICK if quick else TRAIN
    for tag, spec_name, B, updates, extra in runs:
        cfg = learner.LearnerConfig(**extra)
        T = cfg.unroll_steps
        spec = instances.get_instance(spec_name)
        state = vector.strip_solution(vector.make_batch(spec, B, device=dev))
        ts = learner.init_train_state(SEED, state, cfg)
        step = learner.make_train_step(cfg)
        p0 = {k: v.detach().clone() for k, v in ts.model.state_dict().items()}
        so, nm = 2 * spec.sum_op, spec.num_machines
        ep_raw = torch.zeros(B, dtype=torch.int64, device=dev)
        viol = torch.zeros((), dtype=torch.int64, device=dev)
        ended = torch.zeros((), dtype=torch.int64, device=dev)
        roll_end = []

        def on_call(s, a, raw, e):
            nonlocal ep_raw
            ep_raw += raw[0]
            done = e[0] > 0
            viol.add_((done & (ep_raw != so - nm * e[0].to(torch.int64))).sum())
            ended.add_(done.sum())
            ep_raw = torch.where(done, 0, ep_raw)
            if tag == "reinforce":
                last_call.update(state=s, actions=a.to(torch.int32).contiguous(), resets=done,
                                 jobs=a < s.num_jobs)
            calls[0] += 1
            if calls[0] % T == 0:  # the update's rollout is done
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                roll_end.append(ev)

        calls = [0]
        starts, ends_ev, metrics = [], [], []
        fr.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with DrivenRecorder(fr, on_call):
            for _ in range(updates):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                ts, m = step(ts)
                e1.record()
                starts.append(e0)
                ends_ev.append(e1)
                metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = fr.LAUNCHES["rollout_driven"]
        check(n == updates * T and sum(fr.LAUNCHES.values()) == n,
              f"train {tag}: {fr.LAUNCHES} launches for {updates} updates of {T} steps")
        check(calls[0] == n, f"train {tag}: the recorder saw {calls[0]} of {n} driven launches")
        launches += n
        losses = [float(m["loss"]) for m in metrics]
        check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)), f"train {tag}: losses {losses}")
        moved = {k: float((v - p0[k]).abs().max()) for k, v in ts.model.state_dict().items()}
        check(all(v > 0 for v in moved.values()), f"train {tag}: parameters that did not move {moved}")
        check(int(viol) == 0, f"train {tag}: {int(viol)} reward-identity violations")
        eps = sum(int(m["episodes"]) for m in metrics)
        check(eps == int(ended), f"train {tag}: {eps} episodes in the stats, {int(ended)} lanes ended")
        check(quick or tag != "reinforce" or eps > 0, f"train {tag}: no episode ended")
        upd_ms = [a.elapsed_time(b) for a, b in zip(starts, ends_ev)]
        roll_ms = [a.elapsed_time(b) for a, b in zip(starts, roll_end)]
        steady = slice(1, None) if updates > 1 else slice(None)  # the first update warms up
        mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
        row = {"instance": spec_name, "B": B, "updates": updates, "config": {k: str(v) for k, v in
                                                                          dataclasses.asdict(cfg).items()},
               "losses": losses, "episodes": eps, "identity_violations": int(viol), "launches": n,
               "wall_s": wall, "ms_per_update": mean(upd_ms[steady]), "ms_per_update_all": upd_ms,
               "rollout_ms": mean(roll_ms[steady]),
               "learn_ms": mean([u - r for u, r in zip(upd_ms, roll_ms)][steady]),
               "min_makespan": min(int(m["min_makespan"]) for m in metrics),
               "mean_makespan": (sum(int(m["total_makespan"]) for m in metrics) / eps) if eps else None}
        row["env_steps_per_s"] = B * T / (row["ms_per_update"] / 1e3)
        if tag == "reinforce" and profile:
            row["profile"] = busy_share(lambda: [step(ts) for _ in range(2)])
        out[tag] = row
        last_call.setdefault("final", {})[tag] = (ts, cfg)
        log(f"[13] train {tag} {spec_name} B={B} T={T} {cfg.arch} {cfg.hidden} {cfg.features}: {updates} updates, "
            f"{row['ms_per_update']:.2f} ms an update (rollout {row['rollout_ms']:.2f}, returns+loss+backward+Adam "
            f"{row['learn_ms']:.2f}; CUDA events), {row['env_steps_per_s']:.4g} training env-steps/s, "
            f"{n} driven launches, {eps} episodes, 0 identity violations, losses {[f'{x:.4f}' for x in losses]}"
            + (f"; profile {row['profile']}" if "profile" in row else ""))
    report["training"] = out
    return launches, last_call


# phase 14: the learner's global batch and updates (the 1-rank NCCL run and
# its plain twin run ``updates``; the 2-rank gloo runs ``rank_updates``), the
# sharded free rollout (config, global B, T), and the offset kernel's shard
# checks (config, storage dtype, global B, T; the shard is the second half;
# T long enough for episodes to end)
PARALLEL = {"B": LEARNER_B, "unroll": 32, "updates": 4, "rank_updates": 2, "free": ("ta41-ta50", 10240, 1024),
            "offset": (("ta41-ta50", "int32", 2048, 768), ("ta01", "int32", 2048, 300),
                       ("ta01", "int16", 2048, 300))}
PARALLEL_QUICK = {"B": 512, "unroll": 8, "updates": 2, "rank_updates": 2, "free": ("ta41-ta50", 1280, 128),
                  "offset": (("ta41-ta50", "int32", 512, 64), ("ta01", "int16", 512, 64))}
RANK_MESHES = (("dp2", 2, 1), ("mp2", 1, 2))  # (tag, dp, mp) of the 2-rank runs
RANK_DTYPES = ("float32", "bfloat16")
# phase 15: tools/distill_30x20.py's configuration; the teachers are ta41's
# golden optimum and the orders of models_data/distill_ta41_aug.json
DISTILL = {"epochs": 5, "batch": 512, "finetune": 2, "lanes": 1024, "teachers": 4, "unroll": 640}
DISTILL_QUICK = {"epochs": 2, "batch": 512, "finetune": 1, "lanes": 64, "teachers": 1, "unroll": 32}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_config(quick: bool, dtype: str):
    """The JAX package's learner configuration (ta01, unroll 32, 256x256
    MaskedPolicyNet, REINFORCE) in ``dtype``; unroll 8 with ``quick``."""
    import torch

    from jssenv_tpu_torch.parallel import learner

    P = PARALLEL_QUICK if quick else PARALLEL
    return learner.LearnerConfig(unroll_steps=P["unroll"], compute_dtype=getattr(torch, dtype))


def learner_run(dev, cfg, B: int, updates: int, mesh=None, snaps=()):
    """``updates`` train steps from SEED on a ta01 light batch of B lanes
    (this rank's part of it on ``mesh``, the net partitioned when mp > 1):
    the actions of every env step (T*updates, B_local), the losses, ms an
    update (CUDA events) and the whole params after each update in
    ``snaps``; the final TrainState and step under "ts" and "step"."""
    import torch

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import fused_rollout as fr
    from jssenv_tpu_torch.parallel import learner

    state = vector.strip_solution(vector.make_batch(instances.get_instance("ta01"), B, device=dev))
    ts = learner.init_train_state(SEED, state, cfg)
    if mesh is not None:
        ts = learner.shard_train_state(ts, mesh, mp_axis="mp" if mesh.mp > 1 else None)
    step = learner.make_train_step(cfg, mesh)
    acts, losses, events, params = [], [], [], {}
    with DrivenRecorder(fr, lambda s, a, r, e: acts.append(a[0].clone())):
        for i in range(updates):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            ts, m = step(ts)
            e1.record()
            events.append((e0, e1))
            losses.append(float(m["loss"]))
            if i + 1 in snaps:
                params[i + 1] = learner.gather_params(ts.model, mesh)
    torch.cuda.synchronize()
    return {"actions": torch.stack(acts), "losses": losses, "ms": [a.elapsed_time(b) for a, b in events],
            "params": params, "ts": ts, "step": step}


def params_err(got: dict, want: dict) -> float:
    """max |got - want| over every parameter, over the largest |want|."""
    scale = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k].to(v.device) - v).abs().max()) for k, v in want.items()) / scale


def adam_outliers(got: dict, want: dict, rel: float = 1e-5):
    """(count, largest difference) of the parameter elements further than
    ``rel`` of the largest |want| from ``want``, and the element count."""
    import torch

    scale = max(float(v.abs().max()) for v in want.values())
    d = torch.cat([(got[k].to(v.device) - v).abs().flatten() for k, v in want.items()])
    over = d > rel * scale
    return int(over.sum()), float(d[over].max()) if bool(over.any()) else 0.0, d.numel()


def rank_worker(work: str, rank: int, world: int, port: int, quick: bool) -> int:
    """One rank of phase 14(b)-(c) (``--rank-worker``): gloo on card 0 with
    ``world`` ranks; each mesh of RANK_MESHES and dtype of RANK_DTYPES runs
    ``rank_updates`` learner updates, then the sharded free rollout; the
    results go to ``work/rank<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import fused_rollout as fr
    from jssenv_tpu_torch.parallel import mesh as meshlib, multihost

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    P = PARALLEL_QUICK if quick else PARALLEL
    out = {}
    fr.reset_launch_counts()
    for tag, dp, mp in RANK_MESHES:
        mesh = meshlib.make_mesh(dp=dp, mp=mp, device=dev)
        for dt in RANK_DTYPES:
            run = learner_run(dev, parallel_config(quick, dt), P["B"], P["rank_updates"], mesh, (P["rank_updates"],))
            key = f"{tag}_{dt}"
            out.update({f"{key}_actions": run["actions"].cpu().numpy(), f"{key}_losses": np.asarray(run["losses"]),
                        f"{key}_offset": mesh.lanes(P["B"])[0], f"{key}_ms": np.asarray(run["ms"])})
            out.update({f"{key}_p_{k}": v.cpu().numpy() for k, v in run["params"][P["rank_updates"]].items()})
    learner_launches = dict(fr.LAUNCHES)
    name, B, T = P["free"]
    mesh = meshlib.make_mesh(dp=world, mp=1, device=dev)
    state = vector.make_batch(source(instances, name), B, device=dev)
    fr.reset_launch_counts()
    stats = meshlib.sharded_rollout(mesh, SEED, state, T)
    out.update({f"free_{k}": v.item() for k, v in stats.items()})
    out["free_launches"] = json.dumps(dict(fr.LAUNCHES))
    out["learner_launches"] = json.dumps(learner_launches)
    np.savez(Path(work) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()
    return 0


def spawn_ranks(work: Path, world: int, quick: bool, timeout: int = 240):
    """Run ``world`` rank workers (this script, ``--rank-worker``); every
    child is waited for or killed, and any failure fails the phase."""
    import os

    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank-worker", str(work), str(r),
                               str(world), str(port)] + (["--quick"] if quick else []),
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
    codes = [p.returncode for p in procs]
    check(all(c == 0 for c in codes), f"rank workers exited {codes}:\n" + "\n---\n".join(outs))


def parallel_phase(report: dict, dev, quick: bool):
    """Phase 14: (a) a 1-rank NCCL group: the learner's step through
    ``make_train_step(config, mesh)`` against the plain step from the same
    seed (actions equal, loss and params within rel 1e-6; bit-equality
    reported), ms an update and the NCCL all-reduce's share; (b) 2 ranks on
    this card over gloo (spawned processes), dp=2 then mp=2, at float32 and
    bfloat16, against the plain card run; (c) their sharded free rollout
    (the kernel with each shard's ``lane_offset``) against the unsharded
    kernel run; and the offset kernel against its twin on one shard, int32
    and int16. Returns (launches by kernel on the path, max errors by
    kernel)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import fused_rollout as fr
    from jssenv_tpu_torch.instances import stack_instances
    from jssenv_tpu_torch.parallel import mesh as meshlib, multihost

    P = PARALLEL_QUICK if quick else PARALLEL
    B, updates, ru = P["B"], P["updates"], P["rank_updates"]
    out = {"config": {k: str(v) for k, v in P.items()}}
    path = {k: 0 for k in fr.LAUNCHES}
    errs = {k: 0.0 for k in fr.LAUNCHES}

    # (a) one rank, NCCL
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    mesh = meshlib.make_mesh()
    cfg = parallel_config(quick, "bfloat16")
    T = cfg.unroll_steps
    plain = learner_run(dev, cfg, B, updates, snaps=(ru, updates))
    fr.reset_launch_counts()
    nccl = learner_run(dev, cfg, B, updates, mesh, snaps=(ru, updates))
    launches = dict(fr.LAUNCHES)
    check(launches == {"rollout_driven": updates * T, "rollout_free": 0, "rollout_free_i16": 0},
          f"1-rank NCCL learner launches {launches}")
    path["rollout_driven"] += launches["rollout_driven"]
    check(torch.equal(nccl["actions"], plain["actions"]), "1-rank NCCL: actions differ from the plain step's")
    loss_rel = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(nccl["losses"], plain["losses"]))
    p_rel = params_err(nccl["params"][updates], plain["params"][updates])
    bit_equal = nccl["losses"] == plain["losses"] and all(
        torch.equal(nccl["params"][updates][k], v) for k, v in plain["params"][updates].items())
    ts, step = nccl["ts"], nccl["step"]
    # one more update with every collective timed on the host clock,
    # synchronised before and after (an in-place all-reduce over one NCCL
    # rank may launch no kernel at all)
    coll = []
    orig_all_reduce = meshlib.all_reduce

    def timed_all_reduce(t, group, op=dist.ReduceOp.SUM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig_all_reduce(t, group, op)
        torch.cuda.synchronize()
        coll.append((time.perf_counter() - t0) * 1e3)
        return r

    meshlib.all_reduce = timed_all_reduce
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = step(ts)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
    finally:
        meshlib.all_reduce = orig_all_reduce
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ts, _ = step(ts)
        e1.record()
        torch.cuda.synchronize()
    prof_ms = e0.elapsed_time(e1)
    dev_rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    nccl_ms = sum(e.self_device_time_total for e in dev_rows if "nccl" in e.key.lower()) / 1e3
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    steady = slice(1, None) if updates > 1 else slice(None)
    out["nccl_1rank"] = {
        "B": B, "updates": updates, "losses": nccl["losses"], "plain_losses": plain["losses"],
        "loss_rel_err": loss_rel, "params_rel_err": p_rel, "bit_equal": bit_equal,
        "reassociated": "none" if bit_equal else
        "the means over the global batch are sums over the global count (pg_loss, v_loss, entropy)",
        "ms_per_update": mean(nccl["ms"][steady]), "plain_ms_per_update": mean(plain["ms"][steady]),
        "profiled_update_ms": prof_ms, "nccl_device_ms": nccl_ms if dev_rows else "not measured",
        "nccl_share": nccl_ms / prof_ms if dev_rows else "not measured", "launches": launches,
        "all_reduce_calls": len(coll), "all_reduce_host_ms": sum(coll), "timed_update_ms": timed_ms,
        "all_reduce_share": sum(coll) / timed_ms}
    log(f"[14a] 1-rank NCCL learner, ta01 B={B} T={T} 256x256 bfloat16, {updates} updates: actions equal, "
        f"loss rel err {loss_rel:.3g}, params rel err {p_rel:.3g}, bit-equal {bit_equal}; "
        f"{out['nccl_1rank']['ms_per_update']:.2f} ms an update (plain {out['nccl_1rank']['plain_ms_per_update']:.2f}); "
        f"NCCL device time {nccl_ms:.4f} ms of a {prof_ms:.2f} ms profiled update; {len(coll)} all-reduce calls "
        f"{sum(coll):.3f} ms on the synchronised host clock of a {timed_ms:.2f} ms update")
    check(loss_rel <= 1e-6 and p_rel <= 1e-6, f"1-rank NCCL step differs from the plain one: {out['nccl_1rank']}")
    dist.destroy_process_group()
    refs = {"bfloat16": plain}
    refs["float32"] = learner_run(dev, parallel_config(quick, "float32"), B, ru, snaps=(ru,))

    # (b), (c): two ranks on this card over gloo
    work = Path(__file__).resolve().parent / "jssenv_tpu_torch" / "build" / "ranks"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    spawn_ranks(work, 2, quick)
    out["ranks_wall_s"] = time.perf_counter() - t0
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    rows, fails = {}, []
    for tag, dp, mp in RANK_MESHES:
        for dt in RANK_DTYPES:
            key, ref = f"{tag}_{dt}", refs[dt]
            want_a = ref["actions"][: ru * T].cpu().numpy()
            got_a = np.concatenate([ranks[d * mp][f"{key}_actions"] for d in range(dp)], axis=1)
            mism = int((got_a != want_a).sum()) + sum(
                int((r[f"{key}_actions"] != ranks[(r[f"{key}_offset"] * dp // B) * mp][f"{key}_actions"]).sum())
                for r in ranks)
            loss_rel = max(abs(float(a) - b) / max(1.0, abs(b)) for r in ranks
                           for a, b in zip(r[f"{key}_losses"], ref["losses"][:ru]))
            want_p = ref["params"][ru]
            p_rel = max(params_err({k: torch.from_numpy(r[f"{key}_p_{k}"]) for k in want_p},
                                   {k: v.cpu() for k, v in want_p.items()}) for r in ranks)
            allclose = all(np.allclose(r[f"{key}_p_{k}"], v.cpu().numpy(), rtol=5e-2, atol=5e-3)
                           for r in ranks for k, v in want_p.items())
            row = {"action_mismatches": mism, "actions": int(want_a.size), "loss_rel_err": loss_rel,
                   "params_rel_err": p_rel, "ms_per_update": [r[f"{key}_ms"].tolist() for r in ranks]}
            if dt == "float32":
                # Adam's first updates move a weight by about +-lr whatever
                # its gradient's size: a weight whose gradient is below the
                # float32 noise of a sum taken in another order may move the
                # other way. Such elements (beyond 1e-5 of the largest
                # parameter) must be few (1e-4 of all) and within
                # 2 * lr * updates
                n_over, max_over, n_all = max(adam_outliers(
                    {k: torch.from_numpy(r[f"{key}_p_{k}"]) for k in want_p}, {k: v.cpu() for k, v in want_p.items()})
                    for r in ranks)
                lr = parallel_config(quick, dt).learning_rate
                row.update({"params_beyond_1e-5": n_over, "params_beyond_max": max_over, "params": n_all})
                ok = (mism == 0 and loss_rel <= 1e-5
                      and n_over <= 1e-4 * n_all and max_over <= 2 * lr * ru * (1 + 1e-3))
            else:
                # bfloat16: the JAX test's bounds; an action may flip where a
                # product summed in another order rounds to the other
                # neighbouring bfloat16 (recorded, held under 1e-3 of them)
                ok = mism <= 1e-3 * want_a.size and loss_rel <= 5e-3 and allclose
            rows[key] = dict(row, ok=ok)
            if not ok:
                fails.append(key)
            log(f"[14b] {tag} over gloo, 2 ranks on this card, {dt}, global B={B}, {ru} updates: "
                f"{mism} of {want_a.size} actions differ, loss rel err {loss_rel:.3g}, params rel err {p_rel:.3g}"
                + (f" ({row['params_beyond_1e-5']} of {row['params']} elements beyond 1e-5, at most "
                   f"{row['params_beyond_max']:.3g})" if dt == "float32" else ""))
    out["ranks"] = rows
    for r in ranks:
        lr = json.loads(str(r["learner_launches"]))
        check(lr["rollout_driven"] == ru * T * len(RANK_MESHES) * len(RANK_DTYPES),
              f"rank worker learner launches {lr}")
        path["rollout_driven"] += lr["rollout_driven"]

    name, Bf, Tf = P["free"]
    full = vector.make_batch(source(instances, name), Bf, device=dev)
    ref = {k: v.item() for k, v in fr.rollout_free(full, Tf, seed=SEED).items()}
    rel = 0.0
    for r in ranks:
        fl = json.loads(str(r["free_launches"]))
        key = "rollout_free" if fr.value_dtype(full) == torch.int32 else "rollout_free_i16"
        check(fl[key] == 1 and sum(fl.values()) == 1, f"sharded free rollout launches {fl}")
        path[key] += 1
        for k in ("episodes", "total_makespan", "min_makespan", "identity_violations", "steps"):
            check(int(r[f"free_{k}"]) == ref[k], f"sharded free {name}: {k} {int(r[f'free_{k}'])} != {ref[k]}")
        rel = max(rel, abs(float(r["free_total_return"]) - ref["total_return"]) / max(1.0, abs(ref["total_return"])))
        check(rel <= 1e-5, f"sharded free {name}: total_return rel err {rel}")
    out["sharded_free"] = dict(ref, config=name, B=Bf, T=Tf, ranks=2, return_rel_err=rel)
    check(quick or ref["episodes"] > 0, f"sharded free {name}: no episode ended")
    log(f"[14c] sharded free rollout {name} B={Bf} T={Tf} over 2 gloo ranks, each one kernel launch with its "
        f"lane_offset: integer stats equal to the unsharded kernel's ({ref['episodes']} episodes), "
        f"return rel err {rel:.3g}")

    # the offset kernel against its twin, and against the whole batch's
    # kernel run, on the second half of a batch
    out["offset"] = {}
    for name, vdt, Bo, To in P["offset"]:
        vdt = getattr(torch, vdt)
        src = source(instances, name)
        src = stack_instances([src]) if not hasattr(src, "names") else src
        whole = vector.make_lanes(src, torch.arange(Bo), dev)
        shard = vector.make_lanes(src, torch.arange(Bo // 2, Bo), dev)
        check(vdt == torch.int32 or fr.value_dtype(shard) == torch.int16, f"{name} does not fit int16")
        k = fr._free_kernel(shard, To, SEED, None, vdt, lane_offset=Bo // 2)
        w = fr._free_kernel(whole, To, SEED, None, vdt)
        t = fr.free_lane_stats_reference(shard, To, SEED, lane_offset=Bo // 2)
        for key_ in ("episodes", "mk_sum", "mk_min", "viol"):
            check(torch.equal(k[key_], t[key_]) and torch.equal(k[key_], w[key_][Bo // 2:]),
                  f"offset kernel {name} {vdt}: {key_} differs")
        check(torch.equal(k["ret"], w["ret"][Bo // 2:]), f"offset kernel {name} {vdt}: returns differ from the whole run's")
        ret_err = float((k["ret"] - t["ret"]).abs().max())
        kk = "rollout_free" if vdt == torch.int32 else "rollout_free_i16"
        errs[kk] = max(errs[kk], ret_err)
        out["offset"][f"{name} {vdt}"] = {"B": Bo, "T": To, "episodes": int(k["episodes"].sum()),
                                          "ret_max_abs_err": ret_err}
        check(quick or int(k["episodes"].sum()) > 0, f"offset kernel {name}: no episode ended")
        log(f"[14] offset kernel {name} {str(vdt).removeprefix('torch.')}: lanes [{Bo // 2}, {Bo}) with lane_offset "
            f"{Bo // 2} equal the twin's and the whole batch's ({int(k['episodes'].sum())} episodes, T={To})")
    report["parallel"] = out
    check(not fails, f"2-rank runs outside their bounds: {fails} {rows}")
    return path, errs


def distill_phase(report: dict, dev, quick: bool) -> int:
    """Phase 15: tools/distill_30x20.py's configuration (perjob 128x128,
    rich, B=1024, unroll 640, loss_chunks 8): the four ta41 teachers
    collected on the card (each to its recorded makespan, together equal to
    models_data/distill_ta41_pairs.npz), 5 pretrain epochs at batch 512 (CE
    falls), 2 fine-tune updates (every env step a driven launch), the greedy
    ta41 makespan. Returns its driven launches."""
    import numpy as np
    import torch

    from jssenv_tpu_torch import distill, instances, vector
    from jssenv_tpu_torch.core import fused_rollout as fr
    from jssenv_tpu_torch.parallel import learner

    D = DISTILL_QUICK if quick else DISTILL
    cfg = learner.LearnerConfig(hidden=(128, 128), arch="perjob", features="rich", unroll_steps=D["unroll"],
                                loss_chunks=8)
    spec = instances.get_instance("ta41")
    golden = json.loads(GOLDEN.read_text())["ta41"]
    aug = json.loads((MODELS / "distill_ta41_aug.json").read_text())
    teachers = ([(golden["machine_order"], golden["optimum"])]
                + [(r["machine_order"], r["makespan"]) for r in aug])[: D["teachers"]]
    out = {"teachers": []}
    sets = []
    for order, want in teachers:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pairs = distill.collect_teacher_pairs(spec, order, cfg, device=dev)
        secs = time.perf_counter() - t0
        check(pairs["makespan"] == want, f"teacher replays to {pairs['makespan']}, recorded {want}")
        sets.append(pairs)
        out["teachers"].append({"makespan": want, "pairs": len(pairs["action"]), "seconds": secs})
        log(f"[15] teacher ta41 makespan {want}: {len(pairs['action'])} pairs collected on the card in {secs:.2f} s")
    merged = distill.merge_pairs(sets)
    with np.load(MODELS / "distill_ta41_pairs.npz") as z:
        shipped = {k: z[k][: len(merged["action"])] for k in distill.PAIR_KEYS}
    obs_err = float(np.abs(merged["obs"] - shipped["obs"]).max())
    check(obs_err <= 1e-6 and all(np.array_equal(merged[k], shipped[k]) for k in ("mask", "valid", "action")),
          f"teacher pairs differ from the shipped distill_ta41_pairs.npz (obs err {obs_err})")
    log(f"[15] {len(merged['action'])} pairs equal the shipped rows (obs max err {obs_err:.3g}, the rest exact)")
    env1 = vector.strip_solution(vector.make_batch(spec, 1, device=dev))
    stamps = []

    def on_epoch(msg):
        stamps.append((time.perf_counter(), float(msg.split("ce=")[1])))

    fr.reset_launch_counts()
    t0 = time.perf_counter()
    params = distill.pretrain(SEED, merged, env1, cfg, epochs=D["epochs"], batch_size=D["batch"], log_fn=on_epoch)
    ce = [c for _, c in stamps]
    epoch_s = [b - a for a, b in zip([t0] + [t for t, _ in stamps[:-1]], [t for t, _ in stamps])]
    check(len(ce) == D["epochs"] and ce[-1] < ce[0], f"pretrain CE did not fall: {ce}")
    pre = learner.evaluate_policy(params, spec, cfg, max_steps=4096, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, hist = learner.train(spec, batch_size=D["lanes"], num_updates=D["finetune"], config=cfg, log_every=1,
                             log_fn=lambda *_: None, init_params=params, device=dev)
    torch.cuda.synchronize()
    ft_s = (time.perf_counter() - t0) / D["finetune"]
    fin = learner.evaluate_policy(ts.model.state_dict(), spec, cfg, max_steps=4096, device=dev)
    n = fr.LAUNCHES["rollout_driven"]
    check(n == D["finetune"] * cfg.unroll_steps + pre["steps"] + fin["steps"] and sum(fr.LAUNCHES.values()) == n,
          f"distillation launches {fr.LAUNCHES}")
    check(all(map(lambda h: h["loss"] == h["loss"], hist)) and pre["greedy_makespan"] > 0 and fin["greedy_makespan"] > 0,
          f"fine-tune {hist}, greedy {pre} {fin}")
    out.update(pairs=len(merged["action"]), obs_max_err=obs_err, ce=ce, epoch_s=epoch_s,
               pretrained_greedy=pre["greedy_makespan"], finetune_s_per_update=ft_s, finetune=hist,
               greedy_makespan=fin["greedy_makespan"], launches=n)
    report["distill"] = out
    log(f"[15] pretrain {D['epochs']} epochs at batch {D['batch']}: CE {[f'{c:.4f}' for c in ce]}, "
        f"{[f'{e:.3f}' for e in epoch_s]} s an epoch; greedy ta41 {pre['greedy_makespan']}; "
        f"{D['finetune']} fine-tune updates at B={D['lanes']} unroll {cfg.unroll_steps}, {ft_s:.2f} s an update; "
        f"greedy ta41 after them {fin['greedy_makespan']}; {n} driven launches")
    return n


def resume_phase(report: dict, dev, final: dict) -> None:
    """Phase 16: ``invariant_errors`` over the learner's batch after phase
    13 (all zero); then ``save_train_state`` -> ``load_train_state`` into a
    fresh template on the card, and the next update of both: losses and
    params bit-equal (same process, same shapes, so cuBLAS takes the same
    algorithms)."""
    import torch

    from jssenv_tpu_torch import checkpoint, diagnostics, instances, vector
    from jssenv_tpu_torch.parallel import learner

    ts, cfg = final["reinforce"]
    bits = diagnostics.invariant_errors(ts.env_state)
    check(bits.device.type == dev.type and not bool(bits.any()),
          f"invariant errors on {int((bits != 0).sum())} lanes after training")
    path = Path(__file__).resolve().parent / "jssenv_tpu_torch" / "build" / "train_state.npz"
    t0 = time.perf_counter()
    checkpoint.save_train_state(str(path), ts)
    save_s = time.perf_counter() - t0
    fresh = vector.strip_solution(vector.make_batch(instances.get_instance("ta01"), ts.env_state.batch_size,
                                                    device=dev))
    t0 = time.perf_counter()
    back = checkpoint.load_train_state(str(path), learner.init_train_state(SEED + 1, fresh, cfg))
    load_s = time.perf_counter() - t0
    step = learner.make_train_step(cfg)
    ts2, m = step(ts)
    back2, m_back = step(back)
    sd, sd_back = ts2.model.state_dict(), back2.model.state_dict()
    bit_equal = all(float(m[k]) == float(m_back[k]) for k in m) and all(torch.equal(sd[k], sd_back[k]) for k in sd)
    err = params_err(sd_back, sd)
    report["resume"] = {"lanes": ts.env_state.batch_size, "invariant_errors": 0, "bit_equal": bit_equal,
                        "params_rel_err": err, "save_s": save_s, "load_s": load_s,
                        "bytes": path.stat().st_size}
    log(f"[16] invariant_errors 0 on all {ts.env_state.batch_size} lanes after training; train state saved "
        f"({path.stat().st_size} bytes, {save_s:.2f} s) and loaded ({load_s:.2f} s) on the card: the next update "
        f"{'is bit-equal' if bit_equal else f'differs (params rel err {err:.3g})'} to the uninterrupted one")
    check(bit_equal, f"the resumed update differs from the uninterrupted one: {report['resume']}")


# phase 17: solve() at the JAX package's defaults (jssenv_tpu/solve.py:100-115)
# on ta01, refined 600 iterations as tests/test_solve.py:41 does; ta41 tabu
# at docs/BENCHMARKS.md's round-5 configuration (128 chains x 8 proposals,
# seeded from a 1024-lane rollout), its 50 000 iterations cut to 200
SOLVER = {"orders": 1024, "batch": 2048, "sweeps": 4, "refine": 600, "ta41_lanes": 1024, "chains": 128,
          "proposals": 8, "tabu_iters": 200}
SOLVER_QUICK = {"orders": 128, "batch": 256, "sweeps": 2, "refine": 40, "ta41_lanes": 256, "chains": 32,
                "proposals": 8, "tabu_iters": 20}


def solver_phase(report: dict, dev, quick: bool, smi: str) -> None:
    """Phase 17: the solver on the card (module docstring). Its sweeps read
    their loop condition on the host every ``anneal.SWEEP_PASSES`` passes;
    the phase reports passes and host reads per sweep beside the times."""
    import torch

    from jssenv_tpu_torch import anneal, instances, replay, solve, vector
    from jssenv_tpu_torch.core import engine, fused_rollout as fr

    cfg = SOLVER_QUICK if quick else SOLVER
    launches_before = dict(fr.LAUNCHES)
    out = {"config": cfg}

    def tables(spec, device):
        s = engine.state_from_spec(spec, device=device)
        return anneal.schedule_tables(s.op_machine[0], s.op_dur[0], s.op_pos[0], device=device)

    def sweep_counts():
        n = max(anneal.SWEEP_STATS["sweeps"], 1)
        return {"sweeps": anneal.SWEEP_STATS["sweeps"], "passes_per_sweep": anneal.SWEEP_STATS["passes"] / n,
                "host_syncs_per_sweep": anneal.SWEEP_STATS["host_syncs"] / n}

    # (a) the published optima, card against CPU against the optimum
    golden = json.loads(GOLDEN.read_text())
    optima = sorted(k for k, v in golden.items() if "optimum" in v)
    check(len(optima) == 12, f"expected 12 published optima, got {optima}")
    for name in optima:
        spec = instances.get_instance(name)
        order = torch.tensor([golden[name]["machine_order"]], dtype=torch.int32)
        mk_c, st_c = anneal._sweep(tables(spec, dev), order.to(dev))
        mk_h, st_h = anneal._sweep(tables(spec, "cpu"), order)
        check(int(mk_c[0]) == int(mk_h[0]) == golden[name]["optimum"] and torch.equal(st_c.cpu(), st_h),
              f"evaluate_orders {name}: card {int(mk_c[0])}, CPU {int(mk_h[0])}, optimum {golden[name]['optimum']}")
    log(f"[17] evaluate_orders on the 12 published optima: card equal to the CPU and to the optimum, starts "
        f"equal ({', '.join(optima)})")
    out["optima"] = optima

    # (b) random feasible ta41 orders: every evaluator output, card against CPU
    spec = instances.get_instance("ta41")
    state = vector.make_batch(spec, cfg["orders"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    final, ms, _ = vector.episode_makespans(gen, state, spec.num_jobs * spec.num_machines * 3)
    check(bool((ms > 0).all()), "ta41: a random-legal episode did not end")
    orders = anneal.orders_from_solutions(state.op_pos[0], final.solution)

    def evaluator(t, o):
        mk, starts = anneal._sweep(t, o)
        tails = anneal._tails(anneal.reverse_tables(t), o)
        dur_rank = anneal._dur_rank(t, o)
        jp, js = anneal._neighbor_bounds(t, o, starts, tails, dur_rank)
        return {"mk": mk, "starts": starts, "tails": tails,
                "critical_pairs": anneal._critical_pairs_from(t, o, mk, starts, tails),
                "neighbor_JPend": jp, "neighbor_JStail": js,
                "swap_estimates": anneal._swap_estimates(t, o, starts, tails, dur_rank)}

    t_c = tables(spec, dev)
    card = evaluator(t_c, orders)
    host = evaluator(tables(spec, "cpu"), orders.cpu())
    errs = {k: int((card[k].cpu().long() - host[k].long()).abs().max()) for k in card}
    check(not any(errs.values()), f"ta41 evaluator: card and CPU differ: {errs}")
    check(bool((card["mk"].cpu() <= ms.cpu()).all()), "ta41: a DAG makespan exceeds its episode's makespan")
    ev = []
    anneal.reset_sweep_stats()
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        anneal.evaluate_orders(t_c, orders)
        e1.record()
        torch.cuda.synchronize()
        ev.append(e0.elapsed_time(e1))
    out["ta41_orders"] = {"lanes": cfg["orders"], "max_abs_err": errs, "evaluate_ms": ev, **sweep_counts(),
                          "mean_makespan": float(card["mk"].double().mean())}
    log(f"[17] ta41, {cfg['orders']} random feasible orders: sweep, tails, critical pairs, neighbor bounds and "
        f"swap estimates equal on card and CPU; evaluate_orders {min(ev):.2f}-{max(ev):.2f} ms "
        f"(CUDA events, {out['ta41_orders']['passes_per_sweep']:.0f} passes and "
        f"{out['ta41_orders']['host_syncs_per_sweep']:.0f} host reads a sweep; {smi})")

    # (c) solve on ta01: the rollout alone, then with anneal and tabu refinement
    spec = instances.get_instance("ta01")
    runs = {}
    for tag, kw in (("rollout", {}), ("anneal", {"refine_iters": cfg["refine"]}),
                    ("tabu", {"refine_iters": cfg["refine"], "refine_method": "tabu"})):
        anneal.reset_sweep_stats()
        res = solve.solve(spec, batch=cfg["batch"], sweeps=cfg["sweeps"], seed=SEED, device=dev, **kw)
        counts = sweep_counts()
        mk, _ = replay.replay_machine_order(spec, res.machine_order(), backend="native")
        check(mk == res.makespan, f"solve ta01 {tag}: replays to {mk}, claims {res.makespan}")
        check(res.episodes >= cfg["batch"] and res.solution.min() >= 0, f"solve ta01 {tag}: incomplete schedule")
        row = {"makespan": res.makespan, "episodes": res.episodes, **res.timings}
        if kw:
            check(res.makespan <= runs["rollout"]["makespan"], f"solve ta01 {tag}: worse than the rollout alone")
            row.update(counts, refine_ms_per_iter=res.timings["refine_s"] / cfg["refine"] * 1e3)
        runs[tag] = row
        log(f"[17] solve ta01 batch={cfg['batch']} sweeps={cfg['sweeps']} {tag}: makespan {res.makespan} "
            f"(gap {100 * (res.makespan - 1231) / 1231:.2f}%), replayed; "
            + ", ".join(f"{k} {v:.3f}" for k, v in res.timings.items())
            + (f"; {row['refine_ms_per_iter']:.2f} ms a refine iteration, {row['passes_per_sweep']:.1f} passes and "
               f"{row['host_syncs_per_sweep']:.1f} host reads a sweep" if kw else "") + f" ({smi})")
    out["solve_ta01"] = runs

    # (d) ta41 tabu, the three neighborhoods from the same seeds
    spec = instances.get_instance("ta41")
    state = vector.make_batch(spec, cfg["ta41_lanes"], device=dev)
    best_mk, best_sol, _ = solve._solve_scan(state, torch.Generator(device=dev).manual_seed(SEED),
                                             spec.num_jobs * spec.num_machines + 8, 0.7, 5)
    all_orders = anneal.orders_from_solutions(state.op_pos[0], best_sol)
    seeds = solve.top_k_distinct_orders(all_orders, anneal.evaluate_orders(t_c, all_orders), cfg["chains"])
    seed_best = int(anneal.evaluate_orders(t_c, seeds).min())
    tabu = {"seed_best": seed_best, "rollout_best": int(best_mk.min())}
    for nb in ("sampled", "full", "guided"):
        anneal.reset_sweep_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bo, bmk = anneal.tabu_search(t_c, seeds, SEED + 1, cfg["tabu_iters"], proposals=cfg["proposals"],
                                     neighborhood=nb)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lane = int(torch.argmin(bmk))
        check(torch.equal(anneal.evaluate_orders(t_c, bo), bmk), f"ta41 tabu {nb}: best_mk is not exact")
        certified, _ = replay.replay_machine_order(spec, bo[lane].tolist(), backend="native")
        check(int(bmk[lane]) <= seed_best and certified >= int(bmk[lane]),
              f"ta41 tabu {nb}: best {int(bmk[lane])}, seeds {seed_best}, replayed {certified}")
        tabu[nb] = {"makespan": int(bmk[lane]), "replayed": certified, "s": dt,
                    "ms_per_iter": dt / cfg["tabu_iters"] * 1e3, **sweep_counts()}
        log(f"[17] ta41 tabu {nb} {cfg['chains']}x{cfg['proposals']}, {cfg['tabu_iters']} iterations: {seed_best} -> "
            f"{int(bmk[lane])} (replayed {certified}, gap {100 * (certified - 2006) / 2006:.2f}%), "
            f"{tabu[nb]['ms_per_iter']:.2f} ms an iteration, {tabu[nb]['passes_per_sweep']:.1f} passes and "
            f"{tabu[nb]['host_syncs_per_sweep']:.1f} host reads a sweep ({smi})")
    out["tabu_ta41"] = tabu
    check(dict(fr.LAUNCHES) == launches_before, "the solver launched a rollout kernel")
    log("[17] the solver launched no rollout kernel: the kernels line's counts are those of phases 1-16")
    report["solver"] = out


def finish(report, args, smi, kind, count) -> int:
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

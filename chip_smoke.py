#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jssenv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--quick] [--out FILE] [--profile]

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and count, and ``nvidia-smi``'s name and power limit;
2. build ``core/csrc/rollout.cu`` with nvcc and print its ``-Xptxas -v`` report;
3. driven parity: the plain path (``vector.step_autoreset`` under
   ``random_legal_actions``) on the card records actions, raw rewards and the
   final state; ``fused_rollout.rollout_driven`` replays the actions in the
   kernel; rewards and every state field must be equal. Also at the main
   path's shape (ta01, B=16384, one step per launch) for as many steps as the
   policy loop takes, across episode ends and open no-op gates;
4. free parity, bits mode: the same (T, B) bits through the kernel and the
   plain twin; per-lane integer stats equal, return within rel 1e-5, no
   reward-identity violations;
5. the main path at full width, launch counts zeroed just before: a
   policy-in-the-loop rollout (``random_legal_actions`` outside, the env step
   in the driven kernel) on ta01 with B=16384, and the free Philox rollout on
   ta01 B=16384, ragged ta41-ta50 B=10240 and ta71 B=8192;
6. the plain twin on the same full-width inputs and seed: equal integer
   stats; then the kernel in bits mode at full width, whose mean makespan must
   be within 1% of the Philox run's;
7. kernel times (CUDA events, after warm-up), the plain twins' times, the
   least time the card could take, env-steps/s;
8. where a policy-loop step's time goes, stage by stage (host clock); with
   ``--profile`` also the device's busy share under ``torch.profiler``.

``--quick`` stops after phase 4 at small shapes (a first check of a new
build). ``--out`` writes every measured number as JSON. The last stdout lines
are the ``nvidia-smi`` line, one ``{"kernels": [...]}`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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
QUICK_DRIVEN_CASES = (("ta01", 256, 300, {}), ("rand6x5", 128, 128, {}), ("ta71", 64, 64, {}))
FREE_CASES = (("ta01", 1024, 512), ("ta41-ta50", 1280, 768))
QUICK_FREE_CASES = (("ta01", 256, 300), ("rand6x5", 128, 128))
FULL = (("ta01", 16384, 1024), ("ta41-ta50", 10240, 1024), ("ta71", 8192, 3072))
MAIN_B = 16384  # ta01 lanes of the policy-in-the-loop main path
LOOP_STEPS = 256  # its steps, one driven launch each

REPLACES = {
    "rollout_driven": "jssenv_tpu/core/pallas_rollout.py:598",
    "rollout_free": "jssenv_tpu/core/pallas_rollout.py:653",
}
SOURCE = "jssenv_tpu_torch/core/csrc/rollout.cu"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="stop after the small parity phases")
    ap.add_argument("--out", default=None, help="write all measurements to this JSON file")
    ap.add_argument("--profile", action="store_true", help="add a torch.profiler window to phase 8")
    args = ap.parse_args()

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

    def source(name):
        if name == "ta41-ta50":
            return instances.get_instance_set([f"ta{i}" for i in range(41, 51)])
        if name == "rand6x5":
            return instances.random_instance(6, 5, (1, 9), seed=3)
        return instances.get_instance(name)

    def make(name, B, **pad):
        return vector.make_batch(source(name), B, device=dev, **pad)

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
        state = make(name, B, **pad)
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        stats = vector.RolloutStats.zero(dev)
        acts, raws, s = [], [], state
        plain = Events()
        for _ in range(T):
            a = vector.random_legal_actions(gen, s)
            with plain:
                s, tr, stats = vector.step_autoreset(s, a, stats)
            acts.append(a)
            raws.append(tr.raw_reward)
        kern = Events()
        with kern:
            fin, rew = fr.rollout_driven(state, torch.stack(acts), T)
        torch.cuda.synchronize()
        err = max(max_err(rew, torch.stack(raws)), state_err(fin, s))
        check(err == 0, f"driven {name}: rewards differ")
        driven_err = max(driven_err, err)
        row = {"config": name, "pad": pad, "B": B, "T": T, "episodes": int(stats.episodes),
               "max_abs_err": err, "kernel_call_ms": kern.ms(), "plain_step_ms": plain.ms()}
        report["driven_parity"].append(row)
        log(f"[3] driven parity {row}")
        if i == 0:
            acts = torch.stack(acts)
            recorded["T512"] = (state, acts, int(stats.episodes), int((acts < state.num_jobs).sum()))
    check(any(r["episodes"] > 0 for r in report["driven_parity"]), "no episode crossed a boundary")

    if not args.quick:
        # the main path's driven shape: one step per launch at B=MAIN_B, as
        # long as the policy loop, so that lanes reset and no-op gates open
        B, T = MAIN_B, LOOP_STEPS
        s_p = s_k = make("ta01", B)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        stats = vector.RolloutStats.zero(dev)
        noop_steps = torch.zeros((), dtype=torch.int64, device=dev)
        plain = Events()
        for t in range(T):
            a = vector.random_legal_actions(gen, s_p)
            s_in, eps_in = s_p, stats.episodes
            with plain:
                s_p, tr, stats = vector.step_autoreset(s_p, a, stats)
            s_k, rew = fr.rollout_driven(s_k, a[None], 1)
            err = max(max_err(rew[0], tr.raw_reward), state_err(s_k, s_p))
            check(err == 0, f"driven B={B}: rewards differ")
            noop_steps += s_p.noop_legal.sum()
        recorded["main"] = (s_in, a[None].contiguous(), int(stats.episodes - eps_in),
                            int((a < s_in.num_jobs).sum()))
        row = {"B": B, "T": T, "max_abs_err": 0, "episodes": int(stats.episodes),
               "noop_legal_lane_steps": int(noop_steps), "plain_step_ms": plain.ms()}
        check(row["episodes"] > 0 and row["noop_legal_lane_steps"] > 0,
              f"main-shape parity crossed no episode end or no open no-op gate: {row}")
        report["driven_main_shape"] = row
        log(f"[3] driven parity at the main path's shape {row}")

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

    free_cases = QUICK_FREE_CASES if args.quick else FREE_CASES
    report["free_parity"] = []
    free_err = 0.0
    for i, (name, B, T) in enumerate(free_cases):
        state = make(name, B)
        bits = rand_bits(T, B, SEED + 100 + i)
        k = fr.free_lane_stats(state, T, bits=bits)
        r = fr.free_lane_stats_reference(state, T, bits=bits)
        ret_err, rel = compare_free(k, r, f"free bits {name}")
        free_err = max(free_err, ret_err)
        row = {"config": name, "B": B, "T": T, "episodes": int(k["episodes"].sum()),
               "ret_max_abs_err": ret_err, "total_return_rel_err": rel}
        check(row["episodes"] > 0, f"free bits {name}: no episode ended")
        report["free_parity"].append(row)
        log(f"[4] free parity (bits) {row}")

    if args.quick:
        # the Philox words of the kernel and of the twin
        state = make("rand6x5", 128)
        compare_free(fr.free_lane_stats(state, 128, seed=SEED),
                     fr.free_lane_stats_reference(state, 128, seed=SEED), "free philox")
        log("[4] free parity (philox) ok")
        kernels = [{"name": n, "launches": fr.LAUNCHES[n]} for n in REPLACES]
        log(json.dumps({"kernels": kernels}))
        return finish(report, args, smi, kind, count)

    # ---- 5. the main path at full width ------------------------------------
    fr.reset_launch_counts()
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    # policy-in-the-loop: the policy outside, one env step per driven launch
    loop_B = MAIN_B
    s = make("ta01", loop_B)
    spec = source("ta01")
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

    free_main = {}
    for name, B, T in FULL:
        state = make(name, B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fr.rollout_free(state, T, seed=SEED)
        out = {k: v.item() for k, v in out.items()}
        host_s = time.perf_counter() - t0
        check(out["identity_violations"] == 0, f"{name}: reward-identity violations {out}")
        check(out["episodes"] > 0, f"{name}: no episode ended in {T} steps")
        free_main[name] = dict(out, B=B, T=T, host_s=host_s,
                               mean_makespan=out["total_makespan"] / out["episodes"])
        log(f"[5] free philox {name}: {free_main[name]}")
    torch.cuda.synchronize()
    launches = dict(fr.LAUNCHES)
    report["main_path"] = {"launches": launches, "seconds": time.perf_counter() - t_main,
                           "free": free_main}
    log(f"[5] main path launches {launches}")
    check(all(launches[n] > 0 for n in REPLACES), f"a kernel of the main path never ran: {launches}")

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

    # ---- 7. kernel times and bounds ----------------------------------------
    def launch_timer(kernel, state, T, actions=None, bits=None, repeats=5, resets=0, job_steps=0):
        """Mean ms of one launch, each on a freshly restored state buffer,
        and the launch's bound. ``resets`` and ``job_steps``: the episodes
        that end and the jobs allocated in the launch (they set the driven
        kernel's solution writes)."""
        ws = kernel == "rollout_driven" and fr._solution_mode(state)
        buf0 = fr._to_lanes(state, ws)
        buf = buf0.clone()
        tab, lanec = fr._lane_inputs(state)
        B = state.batch_size
        if kernel == "rollout_driven":
            rewards = torch.empty((T, B), dtype=torch.int32, device=dev)
            go = lambda: fr.launch_driven(state, buf, tab, lanec, actions, rewards, ws)  # noqa: E731
        else:
            st = torch.empty((4, B), dtype=torch.int64, device=dev)
            ret = torch.empty((B,), dtype=torch.float32, device=dev)
            go = lambda: fr.launch_free(state, buf, tab, lanec, bits, SEED, st, ret, T)  # noqa: E731
        buf.copy_(buf0)
        go()  # warm-up
        ev = Events()
        for _ in range(repeats):
            buf.copy_(buf0)
            with ev:
                go()
        # bytes: the state rows a step reads and writes (the solution is only
        # written: one word per allocated job, J*M per reset), the tables, the
        # lane constants the kernel reads, the actions or bits, the outputs
        J, M = state.jobs_pad, state.machines_pad
        words = 2 * (4 + 10 * J + 2 * M) * B + tab.numel()
        if kernel == "rollout_driven":
            words += 4 * B + 2 * T * B + (job_steps + resets * J * M if ws else 0)
            ops_per = 4 * J + 2 * M
        else:
            words += 5 * B + (T * B if bits is not None else 0) + 2 * 4 * B + B
            ops_per = 5 * J + 2 * M + (0 if bits is not None else 100)
        nbytes, nops = 4 * words, T * B * ops_per
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
        return {"ms": ev.ms(), "bytes": nbytes, "int_ops": nops,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    timings = {}
    # the driven kernel on inputs of the parity runs: the last step of the
    # main-shape run, and the first driven case
    state, acts, resets, job_steps = recorded["main"]
    timings["rollout_driven"] = dict(
        launch_timer("rollout_driven", state, 1, actions=acts, resets=resets, job_steps=job_steps),
        shape=f"ta01 B={MAIN_B} T=1 (step {LOOP_STEPS} of a policy loop)", resets=resets,
        plain_ms=report["driven_main_shape"]["plain_step_ms"])
    name, B, T, _ = DRIVEN_CASES[0]
    state, acts, resets, job_steps = recorded["T512"]
    timings["rollout_driven_T512"] = dict(
        launch_timer("rollout_driven", state, T, actions=acts, resets=resets, job_steps=job_steps),
        shape=f"{name} B={B} T={T}", resets=resets,
        plain_ms=report["driven_parity"][0]["plain_step_ms"] * T)
    for name, B, T in FULL:
        row = dict(launch_timer("rollout_free", make(name, B), T, repeats=3),
                   shape=f"{name} B={B} T={T}", plain_ms=plain_free_ms[name])
        row["env_steps_per_s"] = B * T / (row["ms"] / 1e3)
        timings[f"rollout_free {name}"] = row
        log(f"[7] rollout_free {name}: {row['ms']:.2f} ms, {row['env_steps_per_s']:.4g} env-steps/s "
            f"({smi}); bound {row['bound_ms']:.4f} ms by {row['bound_by']}; plain {row['plain_ms']:.0f} ms")
    for key in ("rollout_driven", "rollout_driven_T512"):
        log(f"[7] {key} {timings[key]['shape']}: {timings[key]['ms']:.3f} ms ({smi}); "
            f"bound {timings[key]['bound_ms']:.5f} ms; plain {timings[key]['plain_ms']:.1f} ms")
    report["timings"] = timings

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
        from torch.profiler import ProfilerActivity, profile

        def busy_share(fn):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            # device-side rows only (kernels, copies): the aten:: rows above
            # them report the same device time again
            rows = [e for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
            busy_us = sum(e.self_device_time_total for e in rows)
            top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
            return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                    "busy_share": busy_us / wall_us if busy_us else "not measured",
                    "top": [(e.key, e.self_device_time_total / 1e3, e.count) for e in top]}

        def loop():
            nonlocal s
            for _ in range(n):
                s = policy_step(s, gen)

        prof_loop = busy_share(loop)
        state = make("ta01", MAIN_B)
        prof_free = busy_share(lambda: fr.rollout_free(state, FULL[0][2], seed=SEED))
        report["profile"] = {"policy_loop": prof_loop, "free_ta01": prof_free}
        log(f"[8] profile policy loop: {prof_loop}\n[8] profile free ta01: {prof_free}")

    main_rows = {"rollout_driven": timings["rollout_driven"], "rollout_free": timings["rollout_free ta01"]}
    errs = {"rollout_driven": driven_err, "rollout_free": max(free_err, *free_full_err.values())}
    kernels = [
        {"name": n, "route": "cuda", "source": SOURCE, "replaces": REPLACES[n],
         "launches": launches[n], "max_abs_err": errs[n], "ms": main_rows[n]["ms"],
         "plain_ms": main_rows[n]["plain_ms"], "bound_ms": main_rows[n]["bound_ms"],
         "bound_by": main_rows[n]["bound_by"], "library_ms": None, "shape": main_rows[n]["shape"]}
        for n in REPLACES
    ]
    report["kernels"] = kernels
    log(json.dumps({"kernels": kernels}))
    return finish(report, args, smi, kind, count)


def finish(report, args, smi, kind, count) -> int:
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

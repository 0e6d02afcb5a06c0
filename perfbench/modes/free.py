"""Free-rollout traffic: back-to-back ``fused_rollout.rollout_free`` calls.

A closed loop, one client: each call runs ``steps_per_call`` steps of the
uniform-over-legal policy on every lane of the same freshly reset batch,
its seed the run's seed plus one plus its index, and ends in the read-back
of its stats. Set-up builds the batch from the instance pack and warms up
with one call of the same shape (the first run in a checkout builds the
kernel there). The window counts every call completed; ``env_steps_per_s``
is their B*T env-steps over the window's host seconds.

The check: a call of the window drawn from the seed is run again on the
plain reference (``reference/free.py``), from the raw instance tables, once
the window has closed and the program's batch is freed; its stats must be
equal and every call's reward identity must hold. With ``ctx.control`` (a
dtype name) the reference stored in that narrower type is judged in the
program's place: the control, which must fail.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import torch

from perfbench.lib import compare
from perfbench.lib.trace import Stretch
from perfbench.reference import env as ref_env
from perfbench.reference import free as ref_free

KEYS = ("episodes", "total_makespan", "min_makespan", "identity_violations", "total_return", "steps")
VALUE_BYTES = {"int16": 2, "int32": 4}


def run(ctx) -> SimpleNamespace:
    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import fused_rollout

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    B, T = cfg["batch"]["free"], traffic["steps_per_call"]
    ctx.mark("imported")
    state = vector.make_batch(instances.get_instance_set(cfg["instances"]), B, device=dev)
    ctx.mark("batch built")

    def call(seed: int) -> dict:
        out = fused_rollout.rollout_free(state, T, seed=seed)
        return dict(zip(KEYS, torch.stack([out[k].to(torch.float64) for k in KEYS]).tolist()))

    call(ctx.seed)  # warm-up: the kernel's build and load, the lane inputs, the allocator
    ctx.mark("warmed up")
    calls, stretch = [], None
    start = time.perf_counter()
    ctx.setup_s = time.monotonic() - ctx.t_start
    while not calls or time.perf_counter() - start < ctx.seconds or (ctx.trace and stretch is None):
        if ctx.trace and stretch is None and len(calls) == traffic["trace_after"]:
            with Stretch(dev) as stretch:
                for _ in range(traffic["trace_calls"]):
                    calls.append(call(ctx.seed + 1 + len(calls)))
            continue
        calls.append(call(ctx.seed + 1 + len(calls)))
    window_s = time.perf_counter() - start
    ctx.mark(f"window closed: {len(calls)} calls")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    k = random.Random(ctx.seed).randrange(len(calls))
    tables = ref_env.load_tables(ctx.root / cfg["instance_pack"], cfg["instances"])
    fresh = ref_env.batch(tables, torch.arange(B), dev)
    ref = ref_free.stats(fresh, T, ctx.seed + 1 + k)
    judged = calls[k]
    if ctx.control is not None:  # the reference in a narrower storage type, in the program's place
        judged = ref_free.stats(fresh, T, ctx.seed + 1 + k, store_dtype=getattr(torch, ctx.control))
    ctx.mark("reference done")
    checks = compare.free(judged, ref, int(sum(c["identity_violations"] for c in calls)), cfg["limits"]["free"])
    out = SimpleNamespace(
        attempted=len(calls),
        failed=sum(c["identity_violations"] > 0 or c["steps"] != B * T for c in calls),
        metrics={"env_steps_per_s": len(calls) * B * T / window_s},
        checks=checks, memory_peak_bytes=peak, trace=None,
    )
    if stretch is not None:
        out.trace = stretch.trace
        out.trace.units = traffic["trace_calls"]
        out.trace.sizes = dict(mode="free", B=B, T=T, J=int(tables[0].shape[1]), M=int(tables[0].shape[2]),
                               value_bytes=VALUE_BYTES[cfg["value_dtype"]], instances=len(cfg["instances"]))
    return out

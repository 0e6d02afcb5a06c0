#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jssenv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--quick] [--out FILE] [--profile] [--against ROOT]

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and count, and ``nvidia-smi``'s name and power limit;
2. build with nvcc the general kernels of ``core/csrc/rollout.cu``, for
   every shape the run meets (``STATIC_SHAPES``) the static builds of
   ``core/csrc/driven_static.cu`` and ``core/csrc/free_static.cu``, and for
   every slot class (``SLOT_CLASSES``: 1-4 job slots, 1-2 machine words a
   thread) ``core/csrc/general_lane.cu`` (both kernels for padded and
   mixed-shape batches), all on ``core/csrc/static_lane.cuh`` (a lane's
   state in registers), with the instrumented static free kernels of
   rollout.cu and free_static.cu (``-DJSS_PASS_CLOCKS``, read in phase 7c),
   every nvcc started together, and print each build's ``-Xptxas -v``
   report (registers, stack, spills), the launch geometry of each FULL and
   WIDE config (``fused_rollout.launch_geometry``: a warp a lane, lanes a
   block, shared bytes, machine slots), and the resident warps an SM and
   waves of the driven static build at each shape, of the free one at each
   unpadded FULL config and of both slot-class kernels in each class. A
   batch whose every lane is unpadded launches the static builds of its
   shape, a padded or mixed one its slot class's, one past 128 jobs or 64
   machines rollout.cu's of its machine-slot class (``fused_rollout.
   machine_slots``: ceil(M/32) machines a thread, at least two; the classes
   the run meets, ``WIDE_CLASSES``, are built beside the two-slot one)
   (``fused_rollout.static_shape``, ``driven_build``, ``free_build``);
3. driven parity: the plain twin (``vector.step_autoreset``'s two calls,
   under ``random_legal_actions``) on the card records actions, raw rewards,
   episode ends and the final state; ``fused_rollout.rollout_driven``
   replays the actions in the kernel; rewards, ends and every state field
   must be equal, and the launch without ends must give the same run. Also
   at the main paths' shapes, one step per launch for as many steps as the
   policy loop takes, across episode ends and open no-op gates: ta01
   B=16384 on the full state (the policy loop) and ta01 B=8192 on the light
   state (``vector.strip_solution``, as the learner and serving run it). On
   every batch rollout.cu's build and (on an unpadded one) the slot-class
   build run the same actions too and must be bit-equal to the build the
   batch takes; every launch leaves its input state unchanged and writes
   masks of the bytes 0 and 1 only (``hold_driven``);
4. free parity, bits mode: the same (T, B) bits through the kernel and the
   plain twin; per-lane integer stats equal, return within rel 1e-5, no
   reward-identity violations. The register builds (static, slot class)
   read the state's own fields; rollout.cu's reads a lane buffer, and where
   a case's values fit int16 both its instantiations (int32 and int16) are
   held against the same twin; every build that takes the batch bit-equal
   lane by lane; a padded case too; then past 64
   machines (``WIDE_PARITY``: random 20x100, 150x70 and 12x70 instances,
   rollout.cu's builds of four and three machine slots a thread) from a
   fresh and a mid-episode start, the driven kernel (full and light, ends,
   ``hold_driven``) and the free kernel in Philox from a non-zero
   ``lane_offset`` and in bits mode, int32 and (12x70) int16, each lane by
   lane against the twin;
5. the main path at full width, launch counts zeroed just before: a
   policy-in-the-loop rollout (``random_legal_actions`` outside, the env step
   in the driven kernel) on ta01 with B=16384, and the free Philox rollout on
   ta01 B=16384, ragged ta01-ta10 B=10240, ragged ta41-ta50 B=10240 and ta71
   B=8192 (static builds), and on the padded batches of two shapes ta01+ta11
   and ta01+ta41, B=10240, T=512 (the slot-class build), each on the
   state's own fields. ``value_dtype`` (rollout.cu's storage type) must
   pick int16 on ta01, ta01-ta10 and ta01+ta11 and int32 on the others. Also the policy loop on the padded
   ta01+ta11 batch (B=8192, 300 steps; the slot-class driven kernel, each
   lane's reward identity at its episode ends, from the kernel's own ends);
   every ``LOOP_HOLD``-th step of both loops held against the twin and the
   other builds (``hold_driven``, uncounted); and the instances past the
   register lane's 128 jobs (``LARGE``: random 160x5 and 140x20 instances,
   B=1024, the free rollout in int16 and int32 and a 64-step policy loop),
   which launch rollout.cu's build, each held against its twin; and the
   instances past 64 machines (``WIDE``): a 64-step policy loop on 20x100
   at B=4096 (every 8th step held), a driven launch on 150x70 (T=128) and
   on 12x70 (T=1024, across its episode ends, each lane's reward identity
   held from the kernel's ends), each held against the twin, and the free
   Philox rollout of each at B=4096, 1024, 1024, T=512, held lane by lane
   (rollout.cu's builds of four and three machine slots);
6. the plain twin on the same full-width inputs and seed: lane by lane equal
   to the kernel in every build that takes the batch (every stat and the
   float32 return), and on an
   unpadded batch lanes [B/2, B) alone with lane_offset B/2 equal to the
   whole run's; then the kernel in bits mode at full width, in both builds
   lane by lane against the twin on the same bits, its mean makespan within
   1% of the Philox run's; then, on the unpadded int16 batches, rollout.cu's
   int16 kernel against its int32 one lane by lane on the same Philox seed; then
   each WIDE config's lanes [B/2, B) from their lane_offset against the
   whole run's, and its bits mode against the twin;
7. kernel times (CUDA events, after warm-up, the card kept busy by a queued
   spin while the host issues each launch, so that the events time the
   kernel and not the launch call, whose host time is kept beside) on each
   batch in turns, rollout.cu's build, the slot-class build and the static
   one (in that order, then back; a padded batch has the first two), the
   plain twins' times,
   the least time the card could take, env-steps/s; with
   ``--against ROOT``, the kernels of another checkout (e.g. the parent
   commit's, unpacked with ``git archive``) and this one's in turns (root,
   this, this, root), each turn a process of its own. The driven rows also
   time the whole ``rollout_driven`` call (``call_timer``: the device time of
   all it enqueues, its host call, the synchronised host clock), in turns
   too (on the padded policy loop's step, ta01+ta11 B=8192 T=1, in the
   slot-class build and in rollout.cu's); their bound counts the bytes of
   the state's fields each way at their own dtypes, the tables, the
   actions, rewards and ends; and rollout.cu's kernels on the LARGE and
   WIDE configs (the free kernel in ns a lane-step beside big140x20's, the
   driven kernel at the wide policy loop's step and on each WIDE_DRIVEN
   batch, the whole call beside it); ``--against`` times the LARGE and WIDE
   kernels in turns too (a parent that refuses a WIDE shape says so);
7c. where a step's cycles go in the static free kernel, in both designs
   (rollout.cu's and free_static.cu's), on each unpadded FULL config:
   the instrumented builds' clock64 per pass (the draw, the action's update,
   fast_forward, prioritization, check_no_op, the reset), mean cycles a
   lane-step, their stats equal to the plain kernel's (never timed or
   counted);
8. where a policy-loop step's time goes, stage by stage on the driven static
   build (host clock: the draw, the lane inputs, the new state's
   allocations, the input fields, the launch); the padded policy loop's
   T=1 call under ``torch.profiler``: one device kernel, the slot-class
   build's, and nothing else (rollout.cu's call beside it, its layout
   copies counted); the wide policy loop's T=1 call likewise (rollout.cu's
   kernel once, with its layout copies); with ``--profile`` also the
   device's busy share;
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
   each greedy episode from the kernel's rewards and ends; a few calls of
   each run held against the twin and the other builds (``SERVING_HOLDS``);
13. training at full width: the JAX package's learner configuration (ta01,
   B=8192, unroll 32, 256x256 ``MaskedPolicyNet``, REINFORCE), then 2 PPO
   updates at that shape and 2 ``perjob`` updates on ta41 (B=1024, rich
   features): finite losses, every parameter moved, exactly ``unroll_steps``
   driven launches an update, the reward identity on every lane that ends,
   every 8th call of the warm-up update held against the twin and the
   general build;
   ms an update, env-steps/s, the rollout/learn split (CUDA events), the
   busy share with ``--profile``; then the driven kernel held against its
   twin on the learner's last recorded step (light state, every state
   field, rewards and ends equal) and timed there, ends written; and
   ``observe_kernel`` on that step's state: ``obs``, ``mask`` and ``valid``
   bit-equal to the plain expressions, both timed in turns against its
   bytes bound;
14. data and tensor parallel on this card: (a) a 1-rank NCCL group, the
   learner configuration of phase 13 through ``make_train_step(config,
   mesh)``, 4 updates against the plain step from the same seed (every 8th
   driven call of each run's first update, the ranks' too, held against the
   twin and the general build; actions
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
   makespans; no rollout kernel is launched;
18. the repo's entry points on the port, each a process of this checkout on
   the card (``tools/*_torch.py``; any non-zero exit fails the run): the
   bench at its defaults (ta01 B=16384, ragged ta41-ta50 B=10240, ta71
   B=8192, each at T=8192: one JSON line of three records, engine "cuda",
   int16 on ta01 and int32 on the others, every run's launches counted, 0
   identity violations; its ta01 run at seed 1 equal to a direct
   ``rollout_free`` at that seed); the solver-quality sweep on ta01 and
   ta02 with 200 tabu iterations (each row's schedule, recorded as the
   tool runs, replayed on the native engine to the row's makespan; gaps, ms
   a refine iteration); the distillation tool's ``collect`` of ta41 and
   ta42 (equal to the leading rows of ``models_data/distill_30x20_pairs.npz``,
   in order) and its float32 ``eval`` of ``ta41_distill`` on ta41 (2658;
   every ``EVAL_HOLD``-th driven call in its process held against the twin
   and the general build, ``HOLD_DRIVEN``);
   ``tools/bench_scaling_torch.py`` at its defaults (256 lanes a card, 128
   steps; one row a card count up to the cards there are: on one card the
   1-rank NCCL row), every env step one driven launch a rank, its batch
   also stepped in this process with every 8th step held; and
   ``tools/gen_golden_torch.py`` on ta12 (no entry in the golden file; batch
   1024, 2 sweeps, 200 refine iterations) into a copy of the golden file,
   its entry replayed to its makespan on the card and on the native engine,
   every other entry and the repo's file unchanged.

``--quick`` runs phases 1-4 and 9-18 at small shapes (a first check of a new
build). ``--out`` writes every measured number as JSON. On an H100 the run
takes about 9 minutes (``--quick`` about 4); ``--against`` adds about 3. The
last stdout lines are the ``nvidia-smi`` line, one ``{"kernels": [...]}``
line and ``{"ok": true, "device": {...}}``. The kernels line has each
kernel in each build (``KERNELS``: rollout.cu's general build of two, three
and four machine slots, static, slot class), its time at the main shape of
its kind (rollout.cu's two-slot build's on the same unpadded batch as the
static build's, its wider classes' on the WIDE batches, the slot-class
build's at the padded batch of its kind, ``observe_kernel``'s at the
learner's), and its ``launches``: the driven kernel's sum phases 5,
12, 13, 14 (both ranks' too), 15 and 18, the free kernels' phases 5, 14 and
18, ``observe_kernel``'s phases 12 (reference features), 13 and 14, each
path counted from zero (phase 18's from its processes' own counts)
and listed in ``launches_by_path``. Every build must have been launched on
the main paths. The script exits 1 with its reason, before anything else,
where the checkout around it is incomplete (``CHECKOUT``), e.g. when it is
copied alone into an empty directory.
"""

from __future__ import annotations

import argparse
import ctypes
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
# cycles of torch.cuda._sleep queued ahead of each timed launch (about 0.5 ms
# at 1.98 GHz, far above the host's launch call): the card is still busy when
# the launch is issued, so the events around it time the kernel alone
QUEUE_CYCLES = 1_000_000
# the same ahead of a whole rollout_driven call (about 2 ms: longer than the
# host's issue of the general path's layout copies and launch)
CALL_QUEUE_CYCLES = 4_000_000

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
                      ("ta71", 64, 64, {}), ("ta01+ta11", 128, 300, {}))
FREE_CASES = (("ta01", 1024, 512), ("ta41-ta50", 1280, 768), ("ta01+ta11", 1024, 512))
QUICK_FREE_CASES = (("ta01", 256, 300), ("rand6x5", 128, 128), ("ta01+ta11", 128, 300))
FULL = (("ta01", 16384, 1024), ("ta01-ta10", 10240, 1024), ("ta41-ta50", 10240, 1024), ("ta71", 8192, 3072),
        ("ta01+ta11", 10240, 512), ("ta01+ta41", 10240, 512))
# the free kernel's storage dtype each FULL batch must select (value_dtype)
FULL_DTYPE = {"ta01": "int16", "ta01-ta10": "int16", "ta41-ta50": "int32", "ta71": "int32", "ta01+ta11": "int16",
              "ta01+ta41": "int32"}
# the FULL batches with padded lanes (two shapes in one batch): they run the
# slot-class build (general_lane.cu, slot class 1x1); every other batch is
# unpadded and runs the static build of its shape (fused_rollout.static_shape)
PADDED = ("ta01+ta11", "ta01+ta41")
MAIN_B = 16384  # ta01 lanes of the policy-in-the-loop main path
LOOP_STEPS = 256  # its steps, one driven launch each
LOOP_HOLD = 32  # every 32nd step of phase 5's policy loops held against the twin (and the general build)
# the policy loop on a padded batch (the slot-class driven kernel), long
# enough for ta01's random-policy episodes (about 260 steps) to end
PAD_LOOP = ("ta01+ta11", 8192, 300)
# instances past the register lane's 128 jobs, which launch rollout.cu's
# build on the main path: (config, B, T) of the free rollout (160x5 fits
# int16, 140x20 with Taillard's durations 1-99 needs int32), and the policy
# loop's (config, B, steps, steps between holds)
LARGE = (("big160x5", 1024, 512), ("big140x20", 1024, 512))
LARGE_SPECS = {"big160x5": (160, 5, (1, 9)), "big140x20": (140, 20, (1, 99))}  # jobs, machines, durations
LARGE_DTYPE = {"big160x5": "int16", "big140x20": "int32"}
LARGE_LOOP = ("big140x20", 1024, 64, 16)
# instances past the 64 machines of rollout.cu's two-slot build, which launch
# its builds of three and four machine slots a thread (WIDE_CLASSES) on the
# main path: (config, B, T) of the free rollout (Taillard's durations 1-99
# store int32; 12x70 with durations 1-9 fits int16), the driven launches'
# (config, B, T: 12x70's long enough for its random-policy episodes, about
# 860 steps, to end) and the policy loop's (config, B, steps, steps between
# holds); WIDE_PARITY / QUICK_WIDE (config, B, T) of phase 4's holds
WIDE = (("wide20x100", 4096, 512), ("wide150x70", 1024, 512), ("wide12x70", 1024, 512))
WIDE_SPECS = {"wide20x100": (20, 100, (1, 99)), "wide150x70": (150, 70, (1, 99)), "wide12x70": (12, 70, (1, 9))}
WIDE_DTYPE = {"wide20x100": "int32", "wide150x70": "int32", "wide12x70": "int16"}
WIDE_CLASSES = {"wide20x100": 4, "wide150x70": 3, "wide12x70": 3}
WIDE_DRIVEN = (("wide150x70", 1024, 128), ("wide12x70", 1024, 1024))
WIDE_LOOP = ("wide20x100", 4096, 64, 8)
WIDE_PARITY = (("wide20x100", 512, 192), ("wide150x70", 256, 128), ("wide12x70", 256, 512))
QUICK_WIDE = (("wide20x100", 128, 64), ("wide150x70", 64, 48), ("wide12x70", 128, 450))
# the static shapes (J, M) the run meets: ta01 and ta01-ta10, ta41-ta50
# (and ta41, ta42, ta45), ta71, the 6x5 random instance; built in phase 2
# with the general kernels, every nvcc started together
STATIC_SHAPES = ((15, 15), (30, 20), (100, 20), (6, 5))
# the slot classes of core/csrc/general_lane.cu (job slots, machine words a
# thread): all eight are built in phase 2 (-Xptxas -v of each); the padded
# batches of the main path are of class (1, 1), the others run in phase 4 on
# SLOT_CASES, batches of two random shapes padded to one (B, T: SLOT_BT)
SLOT_CLASSES = tuple((s, k) for s in range(1, 5) for k in range(1, 3))
SLOT_CASES = ("mix6x40+2x35", "mix40x3+3x5", "mix40x3+2x40", "mix70x4+3x3", "mix70x4+2x33", "mix100x3+3x5",
              "mix100x3+2x40")
SLOT_BT = (256, 160)
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
# a serving run's calls held against the twin and the general build: every
# 8th of its first 32 (their time is in the run's host-clock seconds)
SERVING_HOLDS = (8, 32)
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

# LAUNCHES key -> (kernel, the TPU kernel it replaces); a "_static" key is
# the static build (the counterpart of the JAX kernels' static_lane variant,
# pallas_rollout.py _static_lane :1018, _fresh_static :503), a "_slots" key
# the slot-class build (their static_lane=None variant on the register lane)
SOURCE = "jssenv_tpu_torch/core/csrc/rollout.cu"
FREE_SOURCE = "jssenv_tpu_torch/core/csrc/free_static.cu"  # the free kernel's static build
DRIVEN_SOURCE = "jssenv_tpu_torch/core/csrc/driven_static.cu"  # the driven kernel's static build
GENERAL_SOURCE = "jssenv_tpu_torch/core/csrc/general_lane.cu"  # both kernels' slot-class build
LANE_HEADER = "jssenv_tpu_torch/core/csrc/static_lane.cuh"  # the step math of the register lane
LANE_BODIES = ("jssenv_tpu_torch/core/csrc/driven_lane.cuh", "jssenv_tpu_torch/core/csrc/free_lane.cuh")
OBSERVE_SOURCE = "jssenv_tpu_torch/core/csrc/observe.cu"  # the policy's inputs of a step
KERNELS = {
    "rollout_driven": ("rollout_driven_kernel", "jssenv_tpu/core/pallas_rollout.py:598", SOURCE),
    "rollout_driven_static": ("driven_static_kernel (static J,M)", "jssenv_tpu/core/pallas_rollout.py:598",
                              DRIVEN_SOURCE),
    "rollout_free": ("rollout_free_kernel", "jssenv_tpu/core/pallas_rollout.py:653", SOURCE),
    "rollout_free_static": ("free_static_kernel (static J,M)", "jssenv_tpu/core/pallas_rollout.py:653",
                            FREE_SOURCE),
    "rollout_free_i16": ("rollout_free_kernel<int16>", "jssenv_tpu/core/pallas_rollout.py:653", SOURCE),
    "rollout_driven_slots": ("driven_general_kernel (slot class S,K)", "jssenv_tpu/core/pallas_rollout.py:598",
                             GENERAL_SOURCE),
    "rollout_free_slots": ("free_general_kernel (slot class S,K)", "jssenv_tpu/core/pallas_rollout.py:653",
                           GENERAL_SOURCE),
    # rollout.cu's builds of more machine slots a thread (past 64 machines)
    "rollout_driven_m3": ("rollout_driven_kernel (3 machine slots)", "jssenv_tpu/core/pallas_rollout.py:598", SOURCE),
    "rollout_driven_m4": ("rollout_driven_kernel (4 machine slots)", "jssenv_tpu/core/pallas_rollout.py:598", SOURCE),
    "rollout_free_m3": ("rollout_free_kernel<int32_t> (3 machine slots)", "jssenv_tpu/core/pallas_rollout.py:653",
                        SOURCE),
    "rollout_free_m4": ("rollout_free_kernel<int32_t> (4 machine slots)", "jssenv_tpu/core/pallas_rollout.py:653",
                        SOURCE),
    "rollout_free_i16_m3": ("rollout_free_kernel<int16_t> (3 machine slots)", "jssenv_tpu/core/pallas_rollout.py:653",
                            SOURCE),
    "observe": ("observe_kernel", "none: XLA fusion of jssenv_tpu/core/state.py EnvState.obs", OBSERVE_SOURCE),
}
DRIVEN_KEYS = ("rollout_driven", "rollout_driven_static", "rollout_driven_slots", "rollout_driven_m3",
               "rollout_driven_m4")
# the passes of the instrumented free kernels (-DJSS_PASS_CLOCKS), in the
# sources' order: the draw, the action's update, fast_forward,
# prioritization, check_no_op, the episode's bookkeeping and reset
PASS_NAMES = ("draw", "act", "fast_forward", "prioritization", "check_no_op", "reset")
CLOCKS = ("JSS_PASS_CLOCKS",)
# what the script runs or reads of the checkout around it
CHECKOUT = ("jssenv_tpu_torch", SOURCE, FREE_SOURCE, DRIVEN_SOURCE, GENERAL_SOURCE, LANE_HEADER, *LANE_BODIES, OBSERVE_SOURCE,
            "tools/bench_torch.py", "tools/solver_quality_torch.py",
            "tools/distill_30x20_torch.py", "tools/bench_scaling_torch.py", "tools/gen_golden_torch.py",
            "models_data", "tests/data/golden_solutions.json")


def driven(counts) -> int:
    """The driven kernel's launches in ``counts``, every build."""
    return sum(counts.get(k, 0) for k in DRIVEN_KEYS)


def free_key(vdt, build="") -> str:
    """The LAUNCHES key of the free kernel in the build of key suffix
    ``build`` ("", "_static", "_slots", "_m3", ...): rollout.cu's in storage
    dtype ``vdt`` (a torch dtype or its name); the register builds
    ("_static", "_slots") read the state's fields and have none."""
    if build in ("_static", "_slots"):
        return "rollout_free" + build
    return ("rollout_free_i16" if "int16" in str(vdt) else "rollout_free") + build


def job_tag(job) -> str:
    """A ``_build`` job's name in the reports: its source and build."""
    name, shape, *defines = job
    if name == "general_lane":
        slots = [d.split("=")[1] for d in defines[0] if d.startswith("JSS_SLOTS")]
        return f"general_lane slots {slots[0]}x{slots[1]}"
    extra = [d for d in defines[0] if not d.startswith("JSS_SLOTS")] if defines else []
    return f"{name} " + ("general" if shape is None else f"static {shape[0]}x{shape[1]}") + "".join(
        " " + d for d in extra)


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


def device_ops(fn) -> dict:
    """{name: count} of the device kernels and copies ``fn()`` enqueues,
    under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0}


def other_builds(fr, state, own: str) -> list:
    """The builds other than ``own`` that take ``state``: the slot-class
    build (within 128 jobs and 64 machines) and rollout.cu's."""
    fits = fr.slot_class(state.jobs_pad, state.machines_pad) is not None
    return [b for b in ("slots", "rollout") if b != own and (b == "rollout" or fits)]


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
    here = Path(__file__).resolve().parent
    missing = [p for p in CHECKOUT if not (here / p).exists()]
    if missing:
        print(f"chip_smoke: {here} is not a checkout of the repo (no {', '.join(missing)}); run the script from "
              "the root of a checkout", file=sys.stderr)
        return 1
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
    # the general kernels and the static builds of every shape the run meets
    # (driven_static.cu, free_static.cu), with the instrumented static free
    # kernels of rollout.cu and free_static.cu (-DJSS_PASS_CLOCKS, libraries
    # of their own, read in phase 7c only), every nvcc started together; a
    # failed build raises with its output
    t0 = time.perf_counter()
    clock_jobs = [] if args.quick else [(name, sh, CLOCKS) for sh in STATIC_SHAPES
                                        for name in ("rollout", "free_static")]
    batches = [None, *STATIC_SHAPES, *(fr.Build("slots", c) for c in SLOT_CLASSES),
               *(fr.Build("rollout", k) for k in sorted(set(WIDE_CLASSES.values())))]
    jobs = fr.kernel_jobs(batches) + clock_jobs
    _build.build_jobs(jobs)
    fr.build_kernels(batches)
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {job_tag(job): _build.ptxas_report(*job) for job in jobs}
    log(f"[2] built {SOURCE} (general; machine-slot classes 2 and {sorted(set(WIDE_CLASSES.values()))}), "
        f"{DRIVEN_SOURCE} and {FREE_SOURCE} (static) for {list(STATIC_SHAPES)}, "
        f"{GENERAL_SOURCE} for the slot classes {list(SLOT_CLASSES)}"
        f"{', and the instrumented static free kernels' if clock_jobs else ''}: {len(jobs)} nvcc processes "
        f"started together, {report['build_s']:.1f}s")
    for tag, rep_ in report["ptxas"].items():
        log(f"[2] {tag}:\n{rep_}")
    kerr = {k: 0.0 for k in KERNELS}  # max |kernel - twin| (or - another build) by LAUNCHES key

    def variant(state) -> str:
        """The LAUNCHES suffix of a driven launch on ``state``."""
        return fr._key(fr.driven_build(state))

    def free_variant(state) -> str:
        """The LAUNCHES suffix of a free launch on ``state``."""
        return fr._key(fr.free_build(state))

    def make(name, B, **pad):
        return vector.make_batch(source(instances, name), B, device=dev, **pad)

    # the launch geometry (fused_rollout.launch_geometry) of each FULL config
    # in its value dtype, and of the driven kernel's main shape
    report["geometry"] = {}
    for name, vdt in ([(n, FULL_DTYPE[n]) for n, _, _ in FULL] + [("ta01", "int32")]
                      + [(n, WIDE_DTYPE[n]) for n, _, _ in WIDE] + [("wide12x70", "int32")]):
        few = make(name, 10)
        geo = fr.launch_geometry(few.jobs_pad, few.machines_pad, getattr(torch, vdt))
        report["geometry"][f"{name} {vdt}"] = geo._asdict()
        log(f"[2] launch geometry {name} (J={few.jobs_pad}, M={few.machines_pad}) {vdt}: {geo}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the driven static build's registers, spills, resident warps and waves
    # at each static shape, at the policy loop's B
    report["driven_static_occupancy"] = {}
    for shape in STATIC_SHAPES:
        lib = fr._driven_lib(shape)
        lib.jss_driven_static_blocks_per_sm.argtypes, lib.jss_driven_static_blocks_per_sm.restype = [], ctypes.c_int
        blocks = lib.jss_driven_static_blocks_per_sm()
        check(blocks >= 1, f"driven_static {shape}: occupancy query failed ({blocks})")
        geo = fr.static_geometry(MAIN_B)
        ptx = [ln for ln in report["ptxas"][f"driven_static static {shape[0]}x{shape[1]}"].split("\n") if ln.strip()]
        row = {"shape": shape, "blocks_per_sm": blocks, "warps_per_sm": blocks * geo.lanes,
               "waves_at_main_B": geo.blocks / (blocks * sms), "ptxas": ptx}
        report["driven_static_occupancy"][f"{shape[0]}x{shape[1]}"] = row
        log(f"[2] driven_static_kernel {shape}: {blocks} blocks of {geo.lanes} lanes an SM ({blocks * geo.lanes} "
            f"resident warps), {row['waves_at_main_B']:.3f} waves at B={MAIN_B}")
    # the free kernel's registers, spills, resident warps and waves at each
    # unpadded FULL config
    report["free_static_occupancy"] = {}
    for name, B, _ in FULL:
        if name in PADDED:
            continue
        few = make(name, 2)
        shape = (few.jobs_pad, few.machines_pad)
        lib = fr._free_lib(shape)
        lib.jss_free_static_blocks_per_sm.argtypes = []
        lib.jss_free_static_blocks_per_sm.restype = ctypes.c_int
        blocks = lib.jss_free_static_blocks_per_sm()
        check(blocks >= 1, f"free_static {shape}: occupancy query failed ({blocks})")
        geo = fr.static_geometry(B)
        ptx = [ln for ln in report["ptxas"][f"free_static static {shape[0]}x{shape[1]}"].split("\n")
               if ln.strip()]
        row = {"shape": shape, "blocks_per_sm": blocks, "warps_per_sm": blocks * geo.lanes,
               "waves": geo.blocks / (blocks * sms), "ptxas": ptx}
        report["free_static_occupancy"][name] = row
        log(f"[2] free_static_kernel {name} {shape} B={B}: {blocks} blocks of {geo.lanes} lanes an SM "
            f"({blocks * geo.lanes} resident warps), {geo.blocks} blocks over {sms} SMs: {row['waves']:.3f} waves")
    # both slot-class kernels of each class: registers, spills, resident warps
    report["general_occupancy"] = {}
    for slots in SLOT_CLASSES:
        lib = fr._general_lib(slots)
        lib.jss_driven_general_blocks_per_sm.argtypes = []
        lib.jss_free_general_blocks_per_sm.argtypes = []
        for fn in (lib.jss_driven_general_blocks_per_sm, lib.jss_free_general_blocks_per_sm):
            fn.restype = ctypes.c_int
        blocks = {"driven": lib.jss_driven_general_blocks_per_sm(), "free": lib.jss_free_general_blocks_per_sm()}
        check(min(blocks.values()) >= 1, f"general_lane {slots}: occupancy query failed ({blocks})")
        tag = job_tag(fr.build_job("driven", fr.Build("slots", slots)))
        ptx = [ln.strip() for ln in report["ptxas"][tag].split("\n") if ln.strip()]
        row = {"slots": slots, "blocks_per_sm": blocks,
               "warps_per_sm": {k: v * fr.STATIC_LANES for k, v in blocks.items()}, "ptxas": ptx}
        report["general_occupancy"][f"{slots[0]}x{slots[1]}"] = row
        log(f"[2] general_lane slot class {slots}: resident warps an SM {row['warps_per_sm']}")

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
        snap = snapshot(state)
        with kern:
            fin, rew, k_ends = fr.rollout_driven(state, torch.stack(acts), T, return_ends=True)
        torch.cuda.synchronize()
        ends = torch.stack(ends)
        err = max(max_err(rew, torch.stack(raws)), max_err(k_ends, ends), state_err(fin, s))
        check(err == 0, f"driven {name}: rewards or ends differ")
        fin_plain, rew_plain = fr.rollout_driven(state, torch.stack(acts), T)  # the launch without ends
        check(max(max_err(rew_plain, rew), state_err(fin_plain, fin)) == 0, f"driven {name}: ends changed the run")
        key = "rollout_driven" + variant(state)
        kerr[key] = max(kerr[key], err)
        # the input unchanged, the masks' bytes, the twin and the other
        # builds on the same inputs
        hold_driven(fr, state, snap, torch.stack(acts), T, (fin, rew, k_ends), f"driven {name}")
        episodes = int((ends > 0).sum())
        row = {"config": name, "pad": pad, "B": B, "T": T, "episodes": episodes, "kernel": key,
               "max_abs_err": err, "kernel_call_ms": kern.ms(), "plain_step_ms": plain.ms()}
        report["driven_parity"].append(row)
        log(f"[3] driven parity (rewards, ends, state) {row}")
        if i == 0:
            acts = torch.stack(acts)
            recorded["T512"] = (state, acts, episodes)
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
            check(variant(s_k) == "_static", f"driven ta01 B={B}: not the static build")
            for t in range(T):
                a = vector.random_legal_actions(gen, s_p)
                s_in = s_p
                with plain:
                    s_p, r_p, e_p = fr.rollout_driven_reference(s_p, a[None], 1, return_ends=True)
                # rollout.cu's and the slot-class build on the same state and
                # actions, then the static one
                others = [fr._driven_kernel(s_k, a[None].contiguous(), 1, not light, True, build=b)
                          for b in ("rollout", "slots")]
                snap = snapshot(s_k)
                s_in_k = s_k
                s_k, rew, e_k = fr.rollout_driven(s_k, a[None], 1, return_ends=True)
                err = max(max_err(rew, r_p), max_err(e_k, e_p), state_err(s_k, s_p))
                check(err == 0, f"driven B={B} light={light}: rewards or ends differ")
                for b, g in zip(("rollout", "slots"), others):
                    check(max(max_err(g[1], rew), max_err(g[2], e_k), state_err(g[0], s_k)) == 0,
                          f"driven B={B} light={light}: the static and the {b} kernels differ")
                changed = [k for k, v in snap.items() if not torch.equal(getattr(s_in_k, k), v)]
                check(not changed, f"driven B={B} light={light}: the launch changed its input {changed}")
                check(not any(bool((getattr(s_k, k).view(torch.uint8) > 1).any()) for k in fr._DRIVEN_U8),
                      f"driven B={B} light={light}: mask bytes other than 0 and 1")
                check(s_k.solution.shape[1] == (0 if light else s_k.jobs_pad),
                      f"driven B={B} light={light}: solution rows {s_k.solution.shape[1]}")
                noop_steps += s_p.noop_legal.sum()
                episodes += (e_p > 0).sum()
            if not light:
                recorded["main"] = (s_in, a[None].contiguous(), int((e_p > 0).sum()))
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

    def free_kernel(state, T, vdt, seed=0, bits=None, build=None, lane_offset=0):
        """Per-lane stats of one launch of the free kernel in the build the
        batch takes (or ``build``): rollout.cu's in its ``vdt``
        instantiation, a register build on the state's fields; checks that
        it launched, under its key."""
        key = free_key(vdt, fr._key(fr.free_build(state, build)))
        before = dict(fr.LAUNCHES)
        out = fr._free_kernel(state, T, seed, bits, vdt, lane_offset=lane_offset, build=build)
        check(fr.LAUNCHES[key] == before[key] + 1 and sum(fr.LAUNCHES.values()) == sum(before.values()) + 1,
              f"{key} did not launch")
        return out

    def same_lanes(a, b, tag):
        """Per-lane stats equal bit for bit, the float32 return too."""
        bad = [f for f in a if not torch.equal(a[f], b[f])]
        check(not bad, f"{tag}: per-lane {bad} differ")

    def free_both(state, T, vdt, tag, seed=0, bits=None, lane_offset=0):
        """The free kernel in the build the batch takes and in every other
        build that takes it (the slot class's, rollout.cu's) on the same
        batch: bit-equal. Returns the first's per-lane stats."""
        k = free_kernel(state, T, vdt, seed, bits, lane_offset=lane_offset)
        own = fr.free_build(state).kind
        for b in other_builds(fr, state, own):
            same_lanes(k, free_kernel(state, T, vdt, seed, bits, build=b, lane_offset=lane_offset),
                       f"{tag}: the {own} and {b} kernels")
        return k

    free_cases = QUICK_FREE_CASES if args.quick else FREE_CASES
    report["free_parity"] = []
    for i, (name, B, T) in enumerate(free_cases):
        state = make(name, B)
        bits = rand_bits(T, B, SEED + 100 + i)
        r = fr.free_lane_stats_reference(state, T, bits=bits)
        row = {"config": name, "B": B, "T": T, "episodes": int(r["episodes"].sum()),
               "value_dtype": str(fr.value_dtype(state))}
        for vdt in (torch.int32, torch.int16) if fr.value_dtype(state) == torch.int16 else (torch.int32,):
            key = free_key(vdt, free_variant(state))
            k = free_both(state, T, vdt, f"free bits {key} {name}", bits=bits)
            ret_err, rel = compare_free(k, r, f"free bits {key} {name}")
            same_lanes(k, r, f"free bits {key} {name}: kernel and twin")
            kerr[key] = max(kerr[key], ret_err)
            row[key] = {"ret_max_abs_err": ret_err, "total_return_rel_err": rel}
        check(row["episodes"] > 0, f"free bits {name}: no episode ended")
        report["free_parity"].append(row)
        log(f"[4] free parity (bits; every build bit-equal) {row}")
    for key in ("rollout_free_static", "rollout_free_slots"):
        check(any(key in r for r in report["free_parity"]), f"no bits-mode case ran {key}")

    # every other slot class, on a batch of two random shapes padded to one:
    # the driven kernel on the twin's own random-policy actions, and the free
    # one in bits mode in both storage types, each against the twin and
    # rollout.cu's build
    report["slot_parity"] = {}
    B, T = SLOT_BT
    for i, name in enumerate(SLOT_CASES):
        state = make(name, B)
        build = fr.driven_build(state)
        check(build.kind == "slots", f"{name}: {build}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 300 + i)
        acts, s = [], state
        for _ in range(T):
            acts.append(vector.random_legal_actions(gen, s).to(torch.int32))
            s, _ = fr.rollout_driven_reference(s, acts[-1][None], 1)
        acts = torch.stack(acts)
        snap = snapshot(state)
        got = fr.rollout_driven(state, acts, T, return_ends=True)
        hold_driven(fr, state, snap, acts, T, got, f"driven {name}")
        bits = rand_bits(T, B, SEED + 400 + i)
        r = fr.free_lane_stats_reference(state, T, bits=bits)
        for vdt in (torch.int32, torch.int16):
            same_lanes(free_both(state, T, vdt, f"free bits {name}", bits=bits), r, f"free bits {name}: kernel and twin")
        row = {"slots": build.shape, "B": B, "T": T, "driven_episodes": int((got[2] > 0).sum()),
               "free_episodes": int(r["episodes"].sum())}
        check(row["driven_episodes"] > 0 and row["free_episodes"] > 0, f"{name}: no episode ended {row}")
        report["slot_parity"][name] = row
        log(f"[4] slot class {build.shape} on {name}: driven and free (int32, int16) kernels equal to the twin and "
            f"rollout.cu's build {row}")
    check({r["slots"] for r in report["slot_parity"].values()} | {(1, 1)} == set(SLOT_CLASSES), "a slot class was not run")

    # past 64 machines: rollout.cu's builds of three and four machine slots a
    # thread (WIDE_CLASSES). From a fresh state and from the twin's state T
    # random-policy steps later (mid-episode; 12x70's window crosses its
    # episode ends), the driven kernel on the twin's next T actions, full and
    # light with ends (hold_driven: input unchanged, mask bytes, the twin),
    # and the free kernel in Philox from a non-zero lane_offset and in bits
    # mode, int32 and (12x70) int16, each lane by lane against the twin. A
    # mid-episode start's first episode misses the rewards before it, so the
    # identity is held on the fresh starts only.
    report["wide_parity"] = {}
    for i, (name, B, T) in enumerate(QUICK_WIDE if args.quick else WIDE_PARITY):
        state = make(name, B)
        build = fr.driven_build(state)
        check(build == fr.free_build(state) == fr.Build("rollout", WIDE_CLASSES[name]), f"{name}: {build}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 500 + i)
        acts, s = [], state
        for t in range(2 * T):
            if t == T:
                mid = s
            acts.append(vector.random_legal_actions(gen, s).to(torch.int32))
            s, _ = fr.rollout_driven_reference(s, acts[-1][None], 1)
        acts = torch.stack(acts)
        row = {"machine_slots": build.shape, "B": B, "T": T, "driven_episodes": 0, "free_episodes": 0}
        for start, window, tag in ((state, acts[:T], "fresh"), (mid, acts[T:], "mid-episode")):
            for st in (start, vector.strip_solution(start)):
                snap = snapshot(st)
                got = fr.rollout_driven(st, window, T, return_ends=True)
                hold_driven(fr, st, snap, window, T, got, f"driven {name} {tag} {'full' if st is start else 'light'}")
            row["driven_episodes"] += int((got[2] > 0).sum())
            bits = rand_bits(T, B, SEED + 600 + i)
            for vdt in (torch.int32, torch.int16) if fr.value_dtype(state) == torch.int16 else (torch.int32,):
                for seed, b, off in ((SEED, None, B + 7), (0, bits, 0)):
                    key = free_key(vdt, variant(state))
                    k = free_kernel(start, T, vdt, seed, b, lane_offset=off)
                    r = fr.free_lane_stats_reference(start, T, seed, b, off)
                    mode = "bits" if b is not None else "philox"
                    same_lanes(k, r, f"free {key} {name} {tag} {mode}: kernel and twin")
                    kerr[key] = max(kerr[key], float((k["ret"] - r["ret"]).abs().max()))
                    check(tag != "fresh" or int(k["viol"].sum()) == 0, f"free {key} {name}: identity violations")
                    row["free_episodes"] += int(k["episodes"].sum())
        report["wide_parity"][name] = row
        log(f"[4] rollout.cu past 64 machines, {name} ({build.shape} machine slots): driven (full, light, ends) and "
            f"free (Philox from lane_offset {B + 7}, bits; {WIDE_DTYPE[name]}) kernels equal to the twin from a fresh "
            f"and a mid-episode start {row}")
    check(sum(r["driven_episodes"] for r in report["wide_parity"].values()) > 0
          and sum(r["free_episodes"] for r in report["wide_parity"].values()) > 0,
          f"no wide episode ended: {report['wide_parity']}")

    if args.quick:
        # the Philox words of the kernel and of the twin, in both instantiations
        state = make("rand6x5", 128)
        ref = fr.free_lane_stats_reference(state, 128, seed=SEED)
        for vdt in KEY:
            compare_free(free_both(state, 128, vdt, f"free philox {KEY[vdt]}", seed=SEED), ref,
                         f"free philox {KEY[vdt]}")
        log("[4] free parity (philox, int32 and int16, every build) ok")
        rule_phase(report, dev, QUICK_RULE_LANES, profile=False)
        replay_phase(report, dev, quick=True)
        wrapper_phase(report, dev)
        serving_phase(report, dev, quick=True)
        _, call = training_phase(report, dev, quick=True, profile=False)
        parallel_phase(report, dev, quick=True)
        distill_phase(report, dev, quick=True)
        resume_phase(report, dev, call["final"])
        solver_phase(report, dev, quick=True, smi=smi)
        counts = dict(fr.LAUNCHES)
        for key, n in tools_phase(report, dev, quick=True, smi=smi).items():
            counts[key] += n
        kernels = [{"name": KERNELS[n][0], "launches": counts[n]} for n in KERNELS]
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
    held = 0
    for t in range(LOOP_STEPS):
        a = vector.random_legal_actions(gen, s)
        s_in, snap = s, (snapshot(s) if t % LOOP_HOLD == 0 else None)
        s, rew = fr.rollout_driven(s, a[None], 1)
        if snap is not None:  # held against the twin and the general build (their launches uncounted)
            hold_driven(fr, s_in, snap, a[None], 1, (s, rew), f"policy loop step {t}")
            held += 1
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
    report["policy_loop"] = {"config": "ta01", "B": loop_B, "T": LOOP_STEPS, "episodes": loop_eps, "held": held}
    # the same loop on a padded batch of two shapes (the general driven
    # kernel): each lane's reward identity at its episode ends, from the
    # kernel's own ends
    name, B, T = PAD_LOOP
    s = make(name, B)
    check(variant(s) == "_slots", f"policy loop {name}: not the slot-class build")
    ep_raw = torch.zeros(B, dtype=torch.int64, device=dev)
    pad_eps = torch.zeros((), dtype=torch.int64, device=dev)
    pad_bad = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(T):
        a = vector.random_legal_actions(gen, s)
        s_in, snap = s, (snapshot(s) if t % LOOP_HOLD == 0 else None)
        s, rew, ends = fr.rollout_driven(s, a[None], 1, return_ends=True)
        if snap is not None:  # held against the twin and rollout.cu's build
            hold_driven(fr, s_in, snap, a[None], 1, (s, rew, ends), f"padded policy loop step {t}")
        ep_raw += rew[0]
        done = ends[0] > 0
        pad_eps += done.sum()
        pad_bad += (done & (ep_raw != 2 * s.sum_op - s.num_machines * ends[0])).sum()
        ep_raw = torch.where(done, 0, ep_raw)
    check(int(pad_eps) > 0 and int(pad_bad) == 0,
          f"policy loop {name}: {int(pad_eps)} episodes, {int(pad_bad)} reward-identity violations")
    report["policy_loop_padded"] = {"config": name, "B": B, "T": T, "episodes": int(pad_eps)}
    recorded["padded"] = (s_in, a[None].to(torch.int32).contiguous(), int((ends > 0).sum()))
    # instances past the register lane's limits: rollout.cu's build, every
    # LARGE_LOOP[3]-th step held against the twin
    name, B, T, every = LARGE_LOOP
    s = make(name, B)
    check(variant(s) == "", f"policy loop {name}: not rollout.cu's build")
    for t in range(T):
        a = vector.random_legal_actions(gen, s)
        s_in, snap = s, (snapshot(s) if t % every == 0 else None)
        s, rew, ends = fr.rollout_driven(s, a[None], 1, return_ends=True)
        if snap is not None:
            hold_driven(fr, s_in, snap, a[None], 1, (s, rew, ends), f"{name} policy loop step {t}")
    report["policy_loop_large"] = {"config": name, "B": B, "T": T, "held": -(-T // every)}
    plain_wide = {}  # the twins' ms on the main path's LARGE and WIDE inputs
    for name, B, T in LARGE:
        state = make(name, B)
        vdt = getattr(torch, LARGE_DTYPE[name])
        check(fr.value_dtype(state) == vdt and variant(state) == "", f"{name}: {fr.value_dtype(state)}, "
              f"{fr.driven_build(state)}")
        k = fr.free_lane_stats(state, T, seed=SEED)
        plain = Events()
        with plain:
            r = fr.free_lane_stats_reference(state, T, seed=SEED)
        same_lanes(k, r, f"free {name}: kernel and twin")
        plain_wide[f"free {name}"] = plain.ms()
        red = {key: v.item() for key, v in fr._reduce_stats(k, T, B).items()}
        check(red["identity_violations"] == 0, f"free {name}: {red}")
        report.setdefault("large", {})[name] = dict(red, B=B, T=T, value_dtype=LARGE_DTYPE[name])
        log(f"[5] free philox {name} (rollout.cu's build, {LARGE_DTYPE[name]}): equal to the twin lane by lane, {red}")
    # past 64 machines (WIDE): rollout.cu's builds of three and four machine
    # slots a thread. The policy loop on wide20x100 (every WIDE_LOOP[3]-th
    # step held against the twin), one driven launch on each WIDE_DRIVEN
    # batch on the twin's random-policy actions (held; the reward identity of
    # each lane at its episode ends, from the kernel's rewards and ends), and
    # the free Philox rollout of each WIDE config, held lane by lane
    name, B, T, every = WIDE_LOOP
    s = make(name, B)
    check(variant(s) == f"_m{WIDE_CLASSES[name]}", f"policy loop {name}: {fr.driven_build(s)}")
    for t in range(T):
        a = vector.random_legal_actions(gen, s)
        s_in, snap = s, (snapshot(s) if t % every == 0 else None)
        s, rew, ends = fr.rollout_driven(s, a[None], 1, return_ends=True)
        if snap is not None:
            hold_driven(fr, s_in, snap, a[None], 1, (s, rew, ends), f"{name} policy loop step {t}")
    report["policy_loop_wide"] = {"config": name, "B": B, "T": T, "held": -(-T // every)}
    recorded["wide_loop"] = (s_in, a[None].to(torch.int32).contiguous(), int((ends > 0).sum()))
    for name, B, T in WIDE_DRIVEN:
        state = make(name, B)
        check(variant(state) == f"_m{WIDE_CLASSES[name]}", f"driven {name}: {fr.driven_build(state)}")
        gen_w = torch.Generator(device=dev).manual_seed(SEED + 9)
        acts, s_p, plain = [], state, Events()
        for _ in range(T):
            acts.append(vector.random_legal_actions(gen_w, s_p).to(torch.int32))
            with plain:
                s_p, _ = fr.rollout_driven_reference(s_p, acts[-1][None], 1)
        acts = torch.stack(acts)
        snap = snapshot(state)
        fin, rew, ends = fr.rollout_driven(state, acts, T, return_ends=True)
        hold_driven(fr, state, snap, acts, T, (fin, rew, ends), f"driven {name}")
        ep_raw = torch.cumsum(rew.to(torch.int64), dim=0)  # no lane ends twice in T
        done = ends > 0
        bad = int((done & (ep_raw != 2 * state.sum_op - state.num_machines * ends)).sum())
        check(bad == 0 and (name != "wide12x70" or int(done.sum()) > 0),
              f"driven {name}: {int(done.sum())} episode ends, {bad} reward-identity violations")
        check(int(done.sum(0).max()) <= 1, f"driven {name}: a lane ended twice in {T} steps")
        plain_wide[f"driven {name}"] = plain.ms() * T
        recorded[f"wide {name}"] = (state, acts, int(done.sum()))
        log(f"[5] driven {name} B={B} T={T} ({fr.driven_build(state).shape} machine slots): equal to the twin, "
            f"{int(done.sum())} episode ends, each lane's reward identity held")
    for name, B, T in WIDE:
        state = make(name, B)
        vdt = getattr(torch, WIDE_DTYPE[name])
        check(fr.value_dtype(state) == vdt and variant(state) == f"_m{WIDE_CLASSES[name]}",
              f"{name}: {fr.value_dtype(state)}, {fr.driven_build(state)}")
        k = fr.free_lane_stats(state, T, seed=SEED)
        plain = Events()
        with plain:
            r = fr.free_lane_stats_reference(state, T, seed=SEED)
        same_lanes(k, r, f"free {name}: kernel and twin")
        plain_wide[f"free {name}"] = plain.ms()
        red = {key: v.item() for key, v in fr._reduce_stats(k, T, B).items()}
        check(red["identity_violations"] == 0, f"free {name}: {red}")
        report.setdefault("wide", {})[name] = dict(red, B=B, T=T, value_dtype=WIDE_DTYPE[name])
        log(f"[5] free philox {name} (rollout.cu's {fr.free_build(state).shape} machine slots, {WIDE_DTYPE[name]}): "
            f"equal to the twin lane by lane, {red}")

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
    log(f"[5] main path launches {launches}; value_dtype {FULL_DTYPE}; padded {PADDED}")
    want = dict.fromkeys(fr.LAUNCHES, 0)
    want["rollout_driven_static"] += LOOP_STEPS
    want["rollout_driven_slots"] += PAD_LOOP[2]
    want["rollout_driven"] += LARGE_LOOP[2]
    for name, _, _ in FULL:
        want[free_key(FULL_DTYPE[name], "_slots" if name in PADDED else "_static")] += 1
    for name, _, _ in LARGE:
        want[free_key(LARGE_DTYPE[name])] += 1
    want[f"rollout_driven_m{WIDE_CLASSES[WIDE_LOOP[0]]}"] += WIDE_LOOP[2]
    for name, _, _ in WIDE_DRIVEN:
        want[f"rollout_driven_m{WIDE_CLASSES[name]}"] += 1
    for name, _, _ in WIDE:
        want[free_key(WIDE_DTYPE[name], f"_m{WIDE_CLASSES[name]}")] += 1
    # every rollout build; observe_kernel runs where a net chooses (12-14)
    check(launches == want and all(launches[k] for k in KERNELS if k != "observe"),
          f"the main path's launches: {launches}, expected {want}")
    I16_FULL = [(name, B, T) for name, B, T in FULL if FULL_DTYPE[name] == "int16" and name not in PADDED]

    # ---- 6. plain twin at full width; bits mode at full width --------------
    plain_free_ms = {}
    for name, B, T in FULL:
        state = make(name, B)
        plain = Events()
        with plain:
            r_lanes = fr.free_lane_stats_reference(state, T, seed=SEED)
        plain_free_ms[name] = plain.ms()
        # the kernel lane by lane, in every build that takes the batch:
        # bit-equal to the twin
        vdt = getattr(torch, FULL_DTYPE[name])
        kkey = free_key(vdt, free_variant(state))
        check(kkey.endswith("_slots") == (name in PADDED), f"{name}: {kkey}, padded {PADDED}")
        k_lanes = free_both(state, T, vdt, f"{kkey} {name}", seed=SEED)
        same_lanes(k_lanes, r_lanes, f"{kkey} {name}: kernel and twin")
        # lanes [B/2, B) alone, with their lane_offset: the whole run's lanes
        # (so the twin's), in every build
        src = source(instances, name)
        src = src if hasattr(src, "names") else instances.stack_instances([src])
        half = vector.make_lanes(src, torch.arange(B // 2, B), dev)
        k_half = free_both(half, T, vdt, f"{kkey} {name} offset", seed=SEED, lane_offset=B // 2)
        same_lanes(k_half, {f: v[B // 2:] for f, v in k_lanes.items()}, f"{kkey} {name}: offset {B // 2}")
        r = {k: v.item() for k, v in fr._reduce_stats(r_lanes, T, B).items()}
        k = free_main[name]
        for key in ("episodes", "total_makespan", "min_makespan", "steps", "identity_violations"):
            check(k[key] == r[key], f"{name}: {key} kernel {k[key]} plain {r[key]}")
        abs_err = abs(k["total_return"] - r["total_return"])
        rel = abs_err / max(1.0, abs(r["total_return"]))
        check(rel <= 1e-5, f"{name}: total_return rel err {rel}")
        kerr[kkey] = max(kerr[kkey], abs_err)
        # bits mode: the kernel in both builds against the twin, lane by lane
        bits = rand_bits(T, B, SEED + 200)
        kb_lanes = free_both(state, T, vdt, f"{kkey} {name} bits", bits=bits)
        same_lanes(kb_lanes, fr.free_lane_stats_reference(state, T, bits=bits), f"{kkey} {name} bits: kernel and twin")
        kb = {k_: v.item() for k_, v in fr._reduce_stats(kb_lanes, T, B).items()}
        check(kb["identity_violations"] == 0 and kb["episodes"] > 0, f"{name} bits: {kb}")
        mean_bits = kb["total_makespan"] / kb["episodes"]
        drift = abs(k["mean_makespan"] - mean_bits) / mean_bits
        check(drift <= 0.01, f"{name}: philox mean makespan {k['mean_makespan']} vs bits {mean_bits}")
        free_main[name].update(plain_ms=plain_free_ms[name], total_return_rel_err=rel,
                               bits_mean_makespan=mean_bits, philox_vs_bits=drift, kernel=kkey)
        log(f"[6] {name}: twin equal in Philox and bits mode, lane by lane in every build, and from lane_offset "
            f"{B // 2} (return rel err {rel:.2e}), bits-mode mean makespan "
            f"{mean_bits:.2f} vs philox {k['mean_makespan']:.2f} ({drift:.2e}), plain {plain_free_ms[name]:.0f} ms")

    # rollout.cu's int16 kernel against its int32 kernel, lane by lane, at
    # full width (the register builds have no storage type)
    for name, B, T in I16_FULL:
        state = make(name, B)
        k16 = free_kernel(state, T, torch.int16, seed=SEED, build="rollout")
        k32 = free_kernel(state, T, torch.int32, seed=SEED, build="rollout")
        diff = {key: max_err(k16[key], k32[key]) for key in ("episodes", "mk_sum", "mk_min", "viol")}
        check(not any(diff.values()), f"int16 vs int32 {name}: per-lane stats differ {diff}")
        check(torch.equal(k16["ret"], k32["ret"]), f"int16 vs int32 {name}: returns differ")
        red = {key: v.item() for key, v in fr._reduce_stats(k16, T, B).items()}
        for key in ("episodes", "total_makespan", "min_makespan", "identity_violations"):
            check(red[key] == free_main[name][key], f"int16 {name}: {key} differs from the main path's run")
        check(red["identity_violations"] == 0, f"int16 {name}: reward-identity violations")
        free_main[name]["int16_vs_int32_max_abs_err"] = max(diff.values())
        log(f"[6] int16 vs int32 {name} B={B} T={T}: per-lane stats equal "
            f"({int(k16['episodes'].sum())} episodes, 0 identity violations)")

    # the wide configs at full width: lanes [B/2, B) alone with their
    # lane_offset equal to the whole run's, and bits mode against the twin
    for name, B, T in WIDE:
        state = make(name, B)
        vdt = getattr(torch, WIDE_DTYPE[name])
        key = free_key(vdt, free_variant(state))
        whole = free_kernel(state, T, vdt, seed=SEED)
        src = instances.stack_instances([source(instances, name)])
        half = free_kernel(vector.make_lanes(src, torch.arange(B // 2, B), dev), T, vdt, seed=SEED, lane_offset=B // 2)
        same_lanes(half, {f: v[B // 2:] for f, v in whole.items()}, f"{key} {name}: offset {B // 2}")
        bits = rand_bits(T, B, SEED + 700)
        kb = free_kernel(state, T, vdt, bits=bits)
        same_lanes(kb, fr.free_lane_stats_reference(state, T, bits=bits), f"{key} {name} bits: kernel and twin")
        check(int(kb["viol"].sum()) == 0, f"{key} {name} bits: identity violations")
        log(f"[6] {key} {name} B={B} T={T}: lanes [{B // 2}, {B}) from lane_offset {B // 2} equal to the whole run's, "
            "bits mode equal to the twin lane by lane")

    # ---- 7. kernel times and bounds ----------------------------------------
    # each row in turns on one batch (CUDA events; the launch_timer calls in
    # the order given, then reversed): rollout.cu's build (in the batch's
    # storage type), the slot-class build and the static one of the batch's
    # shape (both on the state's fields). A padded batch has the first two.
    timings = {}

    def in_turns(kernel, state, T, variants, **kw):
        """{(vdt, build): [row, row]}: launch_timer of each variant, in
        turns (v1, v2, ..., v2, v1)."""
        out = {}
        for vdt, build in list(variants) + list(reversed(variants)):
            out.setdefault((vdt, build), []).append(
                launch_timer(fr, dev, kernel, state, T, vdt=vdt, build=build, **kw))
        return out

    def turn_row(turns, main, **extra):
        """Variant ``main``'s row (ms and host_ms: the means of its turns;
        ``build`` its build), with rollout.cu's times on the same batch
        (``general_ms``, ``general_host_ms``) and the slot-class build's
        (``slots_ms``, ``slots_host_ms``) where they ran, and main's ratio to
        each (``<build>_to_general``, ``<build>_to_slots``)."""
        ms = [t["ms"] for t in turns[main]]
        host = sum(t["host_ms"] for t in turns[main]) / len(ms)
        row = dict(turns[main][0], ms=sum(ms) / len(ms), ms_turns=ms, host_ms=host, build=main[1], **extra)
        for kind, name_ in (("rollout", "general"), ("slots", "slots")):
            g = (main[0], kind)
            if g != main and g in turns:
                gms = [t["ms"] for t in turns[g]]
                row.update({f"{name_}_ms": sum(gms) / len(gms), f"{name_}_ms_turns": gms,
                            f"{name_}_host_ms": sum(t["host_ms"] for t in turns[g]) / len(gms)})
                row[f"{main[1]}_to_{name_}"] = row["ms"] / row[f"{name_}_ms"]
        return row

    # the driven kernel on inputs of the parity runs: the last step of the
    # main-shape run, and the first driven case; the padded policy loop's
    # last step in its two builds, the whole call in each
    driven_turns = [(None, "rollout"), (None, "slots"), (None, "static")]
    state, acts, resets = recorded["main"]
    turns = in_turns("rollout_driven", state, 1, driven_turns, actions=acts)
    timings["rollout_driven"] = turn_row(turns, (None, "static"), resets=resets,
                                         shape=f"ta01 B={MAIN_B} T=1 (step {LOOP_STEPS} of a policy loop)",
                                         plain_ms=report["driven_main_shape"]["plain_step_ms"],
                                         call=call_timer(fr, state, acts, 1, repeats=10))
    name, B, T, _ = DRIVEN_CASES[0]
    state, acts, resets = recorded["T512"]
    turns = in_turns("rollout_driven", state, T, driven_turns, actions=acts)
    timings["rollout_driven_T512"] = turn_row(turns, (None, "static"), resets=resets, shape=f"{name} B={B} T={T}",
                                              plain_ms=report["driven_parity"][0]["plain_step_ms"] * T,
                                              call=call_timer(fr, state, acts, T, repeats=3))
    name, B, T = PAD_LOOP
    state, acts, resets = recorded["padded"]
    plain = Events()
    for _ in range(3):
        with plain:
            fr.rollout_driven_reference(state, acts, 1, return_ends=True)
    turns = in_turns("rollout_driven", state, 1, [(None, "rollout"), (None, "slots")], actions=acts, ends=True,
                     repeats=20)
    timings["rollout_driven_padded"] = turn_row(
        turns, (None, "slots"), resets=resets, plain_ms=plain.ms(),
        shape=f"{name} B={B} T=1 with ends (step {T} of the padded policy loop)",
        call=call_timer(fr, state, acts, 1, True, repeats=10),
        call_general=call_timer(fr, state, acts, 1, True, repeats=10, build="rollout"))
    for name, B, T in FULL:
        state = make(name, B)
        vdt = getattr(torch, FULL_DTYPE[name])
        variants = [(vdt, "rollout"), (vdt, "slots")] + ([] if name in PADDED else [(vdt, "static")])
        turns = in_turns("rollout_free", state, T, variants, repeats=2)
        row = turn_row(turns, variants[-1], shape=f"{name} B={B} T={T}", plain_ms=plain_free_ms[name])
        row["env_steps_per_s"] = B * T / (row["ms"] / 1e3)
        timings[f"{KEY[vdt]} {name}"] = row
        log(f"[7] {KEY[vdt]} {name} ({row['build']} build): {row['ms']:.3f} ms"
            + (f", slot class {row['slots_ms']:.3f} ms" if "slots_ms" in row else "")
            + f", rollout.cu's {row['general_ms']:.3f} ms ({row['build']}/general {row[row['build'] + '_to_general']:.3f})"
            + f"; {row['env_steps_per_s']:.4g} env-steps/s ({smi}); bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}; plain {row['plain_ms']:.0f} ms")
    for key in ("rollout_driven", "rollout_driven_T512", "rollout_driven_padded"):
        log_driven_row(key, timings[key], smi)
    # rollout.cu past 64 machines, and the LARGE instances beside them: the
    # free kernel on each config (its build: the batch's machine-slot class)
    # and ns a lane-step; the driven kernel at the wide policy loop's step
    # (T=1 with ends, the whole call beside it) and on each WIDE_DRIVEN batch
    wide_keys = []
    for name, B, T in LARGE + WIDE:
        state = make(name, B)
        vdt = fr.value_dtype(state)
        row = launch_timer(fr, dev, "rollout_free", state, T, repeats=3, vdt=vdt)
        slots = fr.launch_geometry(state.jobs_pad, state.machines_pad).machine_slots
        row.update(shape=f"{name} B={B} T={T}", build=f"rollout {slots} machine slots",
                   ns_per_lane_step=row["ms"] * 1e6 / (B * T), env_steps_per_s=B * T / (row["ms"] / 1e3),
                   plain_ms=plain_wide.get(f"free {name}"))
        wide_keys.append(f"{KEY[vdt]} {name}")
        timings[wide_keys[-1]] = row
    base = timings["rollout_free big140x20"]["ns_per_lane_step"]
    for key in wide_keys:
        row = timings[key]
        row["to_big140x20_per_lane_step"] = row["ns_per_lane_step"] / base
        log(f"[7] {key} ({row['build']}): {row['ms']:.4f} ms, {row['ns_per_lane_step']:.4f} ns a lane-step "
            f"({row['to_big140x20_per_lane_step']:.3f}x big140x20's), {row['env_steps_per_s']:.4g} env-steps/s; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}; plain "
            + (f"{row['plain_ms']:.0f} ms" if row["plain_ms"] else "not timed") + f" ({smi})")
    state, acts, resets = recorded["wide_loop"]
    plain = Events()
    for _ in range(3):
        with plain:
            fr.rollout_driven_reference(state, acts, 1, return_ends=True)
    row = launch_timer(fr, dev, "rollout_driven", state, 1, actions=acts, ends=True, repeats=20)
    timings["rollout_driven_wide"] = dict(
        row, resets=resets, plain_ms=plain.ms(), build=f"rollout {WIDE_CLASSES[WIDE_LOOP[0]]} machine slots",
        shape=f"{WIDE_LOOP[0]} B={WIDE_LOOP[1]} T=1 with ends (step {WIDE_LOOP[2]} of the wide policy loop)",
        call=call_timer(fr, state, acts, 1, True, repeats=10))
    for name, B, T in WIDE_DRIVEN:
        state, acts, resets = recorded[f"wide {name}"]
        row = launch_timer(fr, dev, "rollout_driven", state, T, actions=acts, ends=True, repeats=3)
        timings[f"rollout_driven {name}"] = dict(
            row, resets=resets, plain_ms=plain_wide[f"driven {name}"], shape=f"{name} B={B} T={T} with ends",
            build=f"rollout {WIDE_CLASSES[name]} machine slots", call=call_timer(fr, state, acts, T, True, repeats=3))
    for key in ["rollout_driven_wide"] + [f"rollout_driven {n}" for n, _, _ in WIDE_DRIVEN]:
        r, c = timings[key], timings[key]["call"]
        log(f"[7] {key} {r['shape']} ({r['build']}): kernel {r['ms']:.4f} ms (host ms of the launch call "
            f"{r['host_ms']:.4f}); the whole rollout_driven call {c['ms']:.4f} ms on the card, its host call "
            f"{c['host_ms']:.4f} ms, {c['sync_ms']:.4f} ms on the synchronised host clock ({smi}); bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']} (the call's: {r['call_bound_ms']:.5f} ms); plain "
            f"{r['plain_ms']:.2f} ms")
    report["timings"] = timings

    # ---- 7c. where a step's cycles go: the instrumented static free kernels
    # of both sources (the shared-memory design in rollout.cu, the register
    # one in free_static.cu) on each unpadded FULL config, in its value dtype;
    # their stats must equal the plain kernel's. Never timed, never counted.
    report["pass_clocks"] = {}
    for name, B, T in FULL:
        if name in PADDED:
            continue
        state = make(name, B)
        vdt = getattr(torch, FULL_DTYPE[name])
        plain = fr._free_kernel(state, T, SEED, None, vdt)
        row = {}
        for which in ("rollout.cu", "free_static.cu"):
            per, got = pass_clocks(fr, _build, dev, state, T, vdt, old=which == "rollout.cu")
            same_lanes(got, plain, f"instrumented {which} {name}: stats")
            total = sum(per.values())
            row[which] = {"cycles_per_lane_step": per, "total": total}
            log(f"[7c] {which} static free kernel, {name} B={B} T={T} {FULL_DTYPE[name]}: {total:.1f} cycles a "
                "lane-step (" + ", ".join(f"{k} {v:.1f} ({v / total:.1%})" for k, v in per.items()) + f") ({smi})")
        row["old_to_new"] = row["rollout.cu"]["total"] / row["free_static.cu"]["total"]
        report["pass_clocks"][name] = row
    if args.against:
        report["turns"] = turns_against(args.against, smi)

    # ---- 8. where the main path's time goes --------------------------------
    def policy_step(s, gen, clock=None):
        """One policy-loop step, the stages of ``fr.rollout_driven`` on the
        driven static build spelled out, so that ``clock`` (a dict) can take
        each stage's host time: the policy's draw, the cached lane inputs, the
        new state's two allocations and views, the input fields as the kernel
        reads them, and the launch."""
        check(fr.driven_build(s) is not None, "the policy loop's batch does not take the driven static build")
        out = {}
        stages = (
            ("sample", lambda: vector.random_legal_actions(gen, s)[None].to(torch.int32).contiguous()),
            ("lane_inputs", lambda: fr._lane_inputs(s)),
            ("outputs", lambda: fr._driven_outputs(s, 1)),
            ("inputs", lambda: fr._driven_inputs(s)),
            ("kernel", lambda: fr.launch_driven_static(s, out["inputs"], *out["lane_inputs"], out["sample"],
                                                       *out["outputs"][:2], True)),
        )
        for name, fn in stages:
            t0 = time.perf_counter()
            out[name] = fn()
            if clock is not None:
                torch.cuda.synchronize()
                clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0
        return out["outputs"][2]

    n = 32
    s = make("ta01", MAIN_B)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    s = policy_step(s, gen)  # warm-up
    clock: dict = {}
    for _ in range(n):
        s = policy_step(s, gen, clock)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):  # the user's path: the policy, then rollout_driven
        s, _ = fr.rollout_driven(s, vector.random_legal_actions(gen, s)[None], 1)
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
                s, _ = fr.rollout_driven(s, vector.random_legal_actions(gen, s)[None], 1)

        prof_loop = busy_share(loop)
        state = make("ta01", MAIN_B)
        prof_free = busy_share(lambda: fr.rollout_free(state, FULL[0][2], seed=SEED))
        report["profile"] = {"policy_loop": prof_loop, "free_ta01": prof_free}
        log(f"[8] profile policy loop: {prof_loop}\n[8] profile free ta01: {prof_free}")

    # the padded policy loop's T=1 call (its last step, int32 actions as the
    # loop's step hands them over) under torch.profiler: one device kernel,
    # the slot-class build's, and no layout copy; rollout.cu's call beside it
    state, acts, _ = recorded["padded"]
    ops = {}
    for build in ("slots", "rollout"):
        go = (lambda: fr.rollout_driven(state, acts, 1, return_ends=True)) if build == "slots" else (
            lambda: fr._driven_kernel(state, acts, 1, True, True, build="rollout"))
        go()
        ops[build] = device_ops(go)
    report["padded_call_device_ops"] = ops
    check(len(ops["slots"]) == 1 and all("driven_general_kernel" in k and n == 1 for k, n in ops["slots"].items()),
          f"the padded T=1 call enqueues more than its kernel: {ops['slots']}")
    log(f"[8] padded policy loop, one T=1 rollout_driven call under torch.profiler: device ops {ops['slots']}; "
        f"rollout.cu's call on the same inputs: {sum(ops['rollout'].values())} device ops {ops['rollout']}")
    # the wide policy loop's T=1 call (rollout.cu's four-slot build): the
    # kernel and the layout copies of _to_lanes / _from_lanes around it
    state, acts, _ = recorded["wide_loop"]
    wide_call = lambda: fr.rollout_driven(state, acts, 1, return_ends=True)  # noqa: E731
    wide_call()
    wide_ops = device_ops(wide_call)
    report["wide_call_device_ops"] = wide_ops
    check(sum(n for k, n in wide_ops.items() if "rollout_driven_kernel" in k) == 1,
          f"the wide T=1 call did not launch rollout_driven_kernel once: {wide_ops}")
    log(f"[8] wide policy loop ({WIDE_LOOP[0]} B={WIDE_LOOP[1]}), one T=1 rollout_driven call under torch.profiler: "
        f"{sum(wide_ops.values())} device ops {wide_ops}")

    # ---- 9-11. rules, replay, wrappers -------------------------------------
    fr.reset_launch_counts()
    rule_phase(report, dev, RULE_LANES, profile=args.profile)
    replay_phase(report, dev, quick=False)
    wrapper_phase(report, dev)
    check(not any(fr.LAUNCHES.values()), f"rules, replay and wrappers launched a rollout kernel: {fr.LAUNCHES}")

    # ---- 12-13. serving and training: the policy nets on the driven kernel -
    # launches by path, each a LAUNCHES dict counted from zero
    by_path = {"main_path": launches, "serving": serving_phase(report, dev, quick=False)}
    by_path["training"], call = training_phase(report, dev, quick=False, profile=args.profile)
    # the driven kernel at the learner's shape: the last env step of the
    # REINFORCE run (light state), its ends written; kernel and twin on the
    # same inputs must agree in every state field, the rewards and the ends,
    # and the other builds with them
    st, acts = call["state"], call["actions"]
    check(st.solution.shape[1] == 0, "the learner's env state is not light")
    check(variant(st) == "_static", "the learner's batch does not take the static build")
    twin = Events()
    for _ in range(2):
        with twin:
            ref = fr.rollout_driven_reference(st, acts, 1, return_ends=True)
    got = fr.rollout_driven(st, acts, 1, return_ends=True)
    others = {b: fr._driven_kernel(st, acts, 1, False, True, build=b) for b in ("rollout", "slots")}
    torch.cuda.synchronize()
    err = max(state_err(got[0], ref[0]), max_err(got[1], ref[1]), max_err(got[2], ref[2]))
    check(err == 0 and got[0].solution.shape[1] == 0, "driven at the learner's shape: kernel and twin differ")
    for b, gen_ in others.items():
        check(max(state_err(gen_[0], got[0]), max_err(gen_[1], got[1]), max_err(gen_[2], got[2])) == 0,
              f"driven at the learner's shape: the static and {b} kernels differ")
    kerr["rollout_driven_static"] = max(kerr["rollout_driven_static"], err)
    log(f"[13] rollout_driven at the learner's shape: the static kernel equals its twin, rollout.cu's and the "
        f"slot-class kernel on the recorded step ({int((ref[2] > 0).sum())} lanes end)")
    turns = in_turns("rollout_driven", st, 1, driven_turns, actions=acts, ends=True, repeats=20)
    timings["rollout_driven_learner"] = turn_row(
        turns, (None, "static"), shape=f"ta01 B={st.batch_size} T=1 with ends (the learner's env step, light state)",
        plain_ms=twin.ms(), launches=driven(by_path["training"]), call=call_timer(fr, st, acts, 1, True, repeats=10))
    log_driven_row("rollout_driven_learner", timings["rollout_driven_learner"], smi, phase=13)
    # observe_kernel on the same state: the net's inputs bit-equal to the
    # plain expressions, then both timed in turns (kernel, plain, plain,
    # kernel) against the bytes the launch reads and writes
    plain = lambda: (st.observation()["real_obs"], st.action_mask(), st.job_valid)  # noqa: E731
    got, want = fr.observe(st), plain()
    torch.cuda.synchronize()
    check(all(torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                          w.view(torch.int32) if w.is_floating_point() else w) for g, w in zip(got, want)),
          "observe at the learner's shape: obs, mask or valid differ from the plain expressions")
    kerr["observe"] = max(kerr["observe"], float((got[0] - want[0]).abs().max()),
                          max_err(got[1], want[1]), max_err(got[2], want[2]))
    turns = {True: [], False: []}
    for kernel in (True, False, False, True):
        turns[kernel].append(enqueue_timer((lambda: fr.observe(st)) if kernel else plain, repeats=20))
    nbytes = sum(t.numel() * t.element_size() for t in (*fr._observe_inputs(st), *got))
    timings["observe"] = {
        "ms": sum(t["ms"] for t in turns[True]) / 2, "ms_turns": [t["ms"] for t in turns[True]],
        "host_ms": sum(t["host_ms"] for t in turns[True]) / 2,
        "plain_ms": sum(t["ms"] for t in turns[False]) / 2, "plain_ms_turns": [t["ms"] for t in turns[False]],
        "plain_host_ms": sum(t["host_ms"] for t in turns[False]) / 2, "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "build": "general",
        "shape": f"ta01 B={st.batch_size} J={st.jobs_pad} (the learner's step, light state)"}
    ob = timings["observe"]
    log(f"[13] observe_kernel at the learner's shape equals the plain expressions; {ob['ms']:.5f} ms a launch "
        f"({ob['host_ms']:.3f} ms host), plain {ob['plain_ms']:.4f} ms ({ob['plain_host_ms']:.3f} ms host); bound "
        f"{ob['bound_ms']:.5f} ms by bytes ({nbytes} B) ({smi})")

    # ---- 14-16. data and tensor parallel, distillation, diagnostics and resume
    by_path["parallel"], par_errs = parallel_phase(report, dev, quick=False)
    by_path["distill"] = distill_phase(report, dev, quick=False)
    resume_phase(report, dev, call["final"])
    solver_phase(report, dev, quick=False, smi=smi)
    by_path["tools"] = tools_phase(report, dev, quick=False, smi=smi)
    total = {k: sum(c.get(k, 0) for c in by_path.values()) for k in KERNELS}
    for k in KERNELS:
        kerr[k] = max(kerr[k], par_errs.get(k, 0.0))
    check(all(total.values()), f"a kernel was not launched on the main paths: {total}")
    report["main_path"]["launches_by_path"] = by_path

    # each kernel's time at the main shape of its kind: rollout.cu's on the
    # same unpadded batch as the static build's, the slot-class build's on
    # the padded batch of its kind
    main_rows = {"rollout_driven": timings["rollout_driven"], "rollout_free": timings["rollout_free ta41-ta50"],
                 "rollout_free_i16": timings["rollout_free_i16 ta01"],
                 "rollout_driven_slots": timings["rollout_driven_padded"],
                 "rollout_free_slots": timings["rollout_free ta01+ta41"],
                 "rollout_driven_m3": timings["rollout_driven wide12x70"],
                 "rollout_driven_m4": timings["rollout_driven_wide"],
                 "rollout_free_m3": timings["rollout_free wide150x70"],
                 "rollout_free_m4": timings["rollout_free wide20x100"],
                 "rollout_free_i16_m3": timings["rollout_free_i16 wide12x70"], "observe": timings["observe"]}
    kernels = []
    for n in KERNELS:
        row = main_rows.get(n, main_rows[n.removesuffix("_static")])
        # rollout.cu's two-slot build, timed on the static build's batch
        general = n in ("rollout_driven", "rollout_free", "rollout_free_i16")
        kernels.append({
            "name": KERNELS[n][0], "route": "cuda", "source": KERNELS[n][2], "replaces": KERNELS[n][1],
            "launches": total[n], "max_abs_err": kerr[n], "ms": row["general_ms"] if general else row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"] + (" (rollout.cu's general build)" if general else
                                                         f" ({row['build']} build)"),
            "launches_by_path": {p: c.get(n, 0) for p, c in by_path.items()}})
        if n in ("rollout_driven", "rollout_driven_static"):
            lr = timings["rollout_driven_learner"]
            kernels[-1]["learner_shape"] = dict({k: lr[k] for k in ("shape", "plain_ms", "bound_ms", "bound_by")},
                                                ms=lr["general_ms"] if general else lr["ms"])
    report["kernels"] = kernels
    log(json.dumps({"kernels": kernels}))
    return finish(report, args, smi, kind, count)


def log_driven_row(key, row, smi, phase=7) -> None:
    c, b = row["call"], row["build"]
    slots = (f"; the slot-class build's {row['slots_ms']:.4f} ms ({b}/slots {row[b + '_to_slots']:.3f}, turns "
             f"{row['slots_ms_turns']}, host {row['slots_host_ms']:.4f})" if "slots_ms" in row else "")
    cg = row.get("call_general")
    log(f"[{phase}] {key} {row['shape']}: {b} build {row['ms']:.4f} ms against rollout.cu's general build's "
        f"{row['general_ms']:.4f} ms ({b}/general {row[b + '_to_general']:.3f}; turns {row['ms_turns']}, "
        f"{row['general_ms_turns']}; host ms of the launch call {row['host_ms']:.4f} against "
        f"{row['general_host_ms']:.4f}){slots}; the whole rollout_driven call {c['ms']:.4f} ms on the card, its "
        f"host call {c['host_ms']:.4f} ms, {c['sync_ms']:.4f} ms on the synchronised host clock"
        + (f" (rollout.cu's: {cg['ms']:.4f}, {cg['host_ms']:.4f}, {cg['sync_ms']:.4f})" if cg else "")
        + f" ({smi}); bound {row['bound_ms']:.5f} ms by {row['bound_by']}; plain {row['plain_ms']:.2f} ms")


def launch_timer(fr, dev, kernel, state, T, actions=None, bits=None, repeats=5, vdt=None, ends=False,
                 build=None):
    """Mean ms of one launch (CUDA events, the card kept busy while the host
    issues it: kernel time alone), each on the same inputs (a general or
    older build's state buffer restored first), the mean host ms of the
    launch call (``host_ms``), and the launch's bound. ``fr``: the
    ``fused_rollout`` module whose kernels are timed (this checkout's or
    another's). ``vdt``: the storage dtype of rollout.cu's free kernel (int32 by default; this checkout's
    register builds read the state's fields). ``ends``: the driven kernel's (T, B) episode
    ends are asked for, as the learner's steps do (the driven static and
    slot-class builds write them always). ``build``: "rollout" (rollout.cu's
    general build), "slots" or "static" (a checkout without slot classes:
    "rollout" or the batch's), else the build the batch takes."""
    import torch

    vdt = torch.int32 if vdt is None else vdt
    ws = kernel == "rollout_driven" and fr._solution_mode(state)
    tab, lanec = fr._lane_inputs(state)
    B = state.batch_size
    three = hasattr(fr, "Build")  # a checkout with the slot-class build
    # the driven build on the state's own tensors: this checkout's static or
    # slot-class build, or an older checkout's static one
    if three:
        lane = kernel == "rollout_driven" and fr.driven_build(state, build).kind
        lane = lane if lane in ("static", "slots") else None
    else:
        lane = "static" if kernel == "rollout_driven" and hasattr(fr, "launch_driven_static") and (
            build != "rollout" and fr.static_shape(state) is not None) else None
    # the free kernel's register builds on the state's own fields (this
    # checkout's); an older checkout's read a lane buffer
    field_free = hasattr(fr, "_free_inputs")
    fields = kernel == "rollout_free" and field_free and fr.free_build(state, build).kind != "rollout"
    buf0 = buf = inputs = None
    if fields:
        inputs = fr._free_inputs(state)
        b = fr.free_build(state, build)
        st = torch.empty((4, B), dtype=torch.int64, device=dev)
        ret = torch.empty((B,), dtype=torch.float32, device=dev)
        go = lambda: fr._launch_free_lane(b, state, inputs, tab, lanec, bits, SEED, st, ret, T)  # noqa: E731
    elif lane:
        inputs = fr._driven_inputs(state)
        out, out8, *_ = fr._driven_outputs(state, T)
        if three:
            b = fr.driven_build(state, lane)
            go = lambda: fr._launch_driven_lane(b, state, inputs, tab, lanec, actions, out, out8, ws)  # noqa: E731
        else:
            go = lambda: fr.launch_driven_static(state, inputs, tab, lanec, actions, out, out8, ws)  # noqa: E731
    else:
        buf0 = fr._to_lanes(state, ws, vdt)
        buf = buf0.clone()
        if kernel == "rollout_driven":
            rewards = torch.empty((T, B), dtype=torch.int32, device=dev)
            extra = (torch.empty_like(rewards),) if ends else ()
            go = lambda: fr.launch_driven(state, buf, tab, lanec, actions, rewards, ws, *extra)  # noqa: E731
        else:
            # an older checkout's free launcher chooses the build by `_general`
            # or `build`; this one's is rollout.cu's alone
            force = {} if field_free else {"build": build} if three else {"_general": build == "rollout"}
            st = torch.empty((4, B), dtype=torch.int64, device=dev)
            ret = torch.empty((B,), dtype=torch.float32, device=dev)
            go = lambda: fr.launch_free(state, buf, tab, lanec, bits, SEED, st, ret, T, vdt, **force)  # noqa: E731
    restore = (lambda: buf.copy_(buf0)) if buf0 is not None else (lambda: None)
    restore()
    go()  # warm-up
    total = host = 0.0
    for _ in range(repeats):
        restore()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        e0.record()
        h0 = time.perf_counter()
        go()
        host += time.perf_counter() - h0
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    J, M = state.jobs_pad, state.machines_pad
    if kernel == "rollout_driven":
        # the bytes of the EnvState fields the call must read and write, at
        # their own dtypes (a full state's solution included), the tables, the
        # actions, the rewards and, where asked for, the ends: the same work
        # for every design of the kernel that writes a new state. rollout.cu's
        # kernel updates the lane buffer in place: its own bound counts the
        # light rows each way and leaves out the solution rows, of which a
        # step writes at most one word a lane (``call_bound_ms`` keeps the
        # fields' bound, which the whole call's copies must meet)
        fields = sum(t.numel() * t.element_size() for t in state.dynamic_fields().values())
        steps = 4 * tab.numel() + (3 if ends else 2) * 4 * T * B
        call_bytes = 2 * fields + steps
        nbytes = call_bytes if buf is None else 2 * 4 * (4 + 10 * J + 2 * M) * B + steps
        ops_per = 4 * J + 2 * M
    else:
        # the light state rows in the storage dtype (or the fields read, at
        # their own dtypes), read once; the tables, the lane constants, the
        # bits, the stats and returns
        light = (4 + 10 * J + 2 * M) * B * buf.element_size() if buf is not None else sum(
            t.numel() * t.element_size() for t in inputs)
        nbytes = light + 4 * (
            tab.numel() + 5 * B + (T * B if bits is not None else 0) + 2 * 4 * B + B)
        ops_per = 5 * J + 2 * M + (0 if bits is not None else 100)
    nops = T * B * ops_per
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
    out = {"ms": total / repeats, "host_ms": host / repeats * 1e3, "bytes": nbytes, "int_ops": nops,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if kernel == "rollout_driven":
        out["call_bound_ms"] = max(call_bytes / HBM_BYTES_PER_S * 1e3, t_ops)
    return out


def enqueue_timer(go, repeats):
    """``go()`` after a warm-up call: the mean device ms of everything it
    enqueues (CUDA events around the call, the card kept busy by a queued
    spin while the host issues it) and the mean host ms of the call itself."""
    import torch

    go()  # warm-up
    dev_ms = host = 0.0
    for _ in range(repeats):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(CALL_QUEUE_CYCLES)
        e0.record()
        h0 = time.perf_counter()
        go()
        host += time.perf_counter() - h0
        e1.record()
        torch.cuda.synchronize()
        dev_ms += e0.elapsed_time(e1)
    return {"ms": dev_ms / repeats, "host_ms": host / repeats * 1e3}


def call_timer(fr, state, actions, T, ends=False, repeats=5, build=None):
    """The whole ``fr.rollout_driven`` call, from the first input to the
    returned state, in the build the batch takes (or ``build``'s, through
    ``_driven_kernel``): ``enqueue_timer``'s device and host ms, and the
    mean ms on the host clock synchronised before and after (``sync_ms``:
    the caller's wall time)."""
    import torch

    if build is None:
        go = lambda: fr.rollout_driven(state, actions, T, return_ends=ends)  # noqa: E731
    else:
        go = lambda: fr._driven_kernel(state, actions, T, fr._solution_mode(state), ends, build=build)  # noqa: E731
    out = enqueue_timer(go, repeats)
    wall = 0.0
    for _ in range(repeats):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        wall += time.perf_counter() - h0
    return dict(out, sync_ms=wall / repeats * 1e3)


def pass_clocks(fr, _build, dev, state, T, vdt, old: bool):
    """One launch of the instrumented static free kernel (``old``: the
    shared-memory design, rollout.cu built with -DJSS_PASS_CLOCKS, on its
    lane buffer in storage ``vdt``; else free_static.cu's, on the state's
    fields) on ``state``, Philox at SEED: the
    mean cycles a lane-step of each pass (PASS_NAMES; clock64 deltas summed
    per lane by the warp's rank 0) and the per-lane stats."""
    import torch

    J, M, B = state.jobs_pad, state.machines_pad, state.batch_size
    i16 = int(vdt == torch.int16)
    lib = _build.load("rollout" if old else "free_static", (J, M), CLOCKS)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.jss_pass_count.argtypes, lib.jss_pass_count.restype = [], I
    check(lib.jss_pass_count() == len(PASS_NAMES), "the instrumented kernel's passes")
    tab, lanec = fr._lane_inputs(state)
    stats = torch.empty((4, B), dtype=torch.int64, device=dev)
    ret = torch.empty((B,), dtype=torch.float32, device=dev)
    clocks = torch.zeros((len(PASS_NAMES), B), dtype=torch.int64, device=dev)
    tail = [tab.data_ptr(), lanec.data_ptr(), None, SEED, stats.data_ptr(), ret.data_ptr(), B, J, M, T, 0]
    stream = torch.cuda.current_stream().cuda_stream
    if old:
        buf = fr._to_lanes(state, with_solution=False, vdt=vdt)
        geo = fr.launch_geometry(J, M, vdt)
        fn = lib.jss_rollout_free_clocks
        fn.argtypes, fn.restype = [P, P, P, P, ctypes.c_ulonglong, P, P, I, I, I, I, I, I, I, I, I, P, P, I], I
        err = fn(buf.data_ptr(), *tail, geo.lanes, geo.state_stride, geo.scratch_stride, geo.shared_bytes, stream,
                 clocks.data_ptr(), i16)
    else:  # on the state's fields: no storage type
        inputs = fr._free_inputs(state)
        fn = lib.jss_free_static_clocks
        fn.argtypes, fn.restype = fr._FREE_ARGTYPES + [P], I
        err = fn(*[t.data_ptr() for t in inputs], *tail, stream, clocks.data_ptr())
    check(err == 0, f"instrumented {'rollout' if old else 'free_static'} ({J}, {M}): cudaError {err}")
    torch.cuda.synchronize()
    per = clocks.sum(dim=1).tolist()
    return ({k: v / (B * T) for k, v in zip(PASS_NAMES, per)},
            {"episodes": stats[0], "mk_sum": stats[1], "mk_min": stats[2], "viol": stats[3], "ret": ret})


def source(instances, name):
    """The instance or instance set of a config name."""
    if name in ("ta41-ta50", "ta01-ta10"):
        lo, hi = (41, 50) if name == "ta41-ta50" else (1, 10)
        return instances.get_instance_set([f"ta{i:02d}" for i in range(lo, hi + 1)])
    if name == "rand6x5":
        return instances.random_instance(6, 5, (1, 9), seed=3)
    if name in LARGE_SPECS:
        J, M, durations = LARGE_SPECS[name]
        return instances.random_instance(J, M, durations, seed=J)
    if name in WIDE_SPECS:
        J, M, durations = WIDE_SPECS[name]
        return instances.random_instance(J, M, durations, seed=J + M)
    if name.startswith("mix"):  # random shapes (durations 1-9) padded to the largest
        shapes = [tuple(map(int, s.split("x"))) for s in name[3:].split("+")]
        return instances.stack_instances([instances.random_instance(j, m, (1, 9), seed=20 + i)
                                          for i, (j, m) in enumerate(shapes)])
    if "+" in name:  # a batch of two shapes, padded to the larger
        return instances.get_instance_set(name.split("+"))
    return instances.get_instance(name)


def time_kernels_of(root: str, out: str) -> int:
    """``--time-kernels ROOT``: import ``jssenv_tpu_torch`` from the checkout
    at ``root`` (this one, or another such as the parent commit's), build its
    kernels there, and write to ``out`` (JSON) the time of its free kernel
    on each FULL config in the config's value dtype and of its driven kernel
    at the main shape (ta01, B=MAIN_B, T=1, the last step of a
    LOOP_STEPS-step policy loop run on the plain path), at the learner's
    (ta01, B=LEARNER_B, light, T=1 with ends, after as many steps), at the
    padded policy loop's (ta01+ta11, B=8192, T=1 with ends, after as many
    steps; "rollout_driven_padded") and at the first driven parity case's
    (ta01, B=1024, T=512 random-policy steps). Each time of rollout.cu's
    general build is under the key an older checkout uses; a checkout with a
    static build has its static build's, on an unpadded batch, under that
    key plus " static", and one with the slot-class build that build's
    under the key plus " slots" (the launch call's host ms under "...
    static host", "... slots host"). At each driven shape also the whole
    ``rollout_driven`` call in the build the batch takes (``call_timer``):
    "<key> call" (device ms of all it enqueues), "<key> call host" (the
    call's host ms) and "<key> call sync" (the synchronised host clock).
    Then rollout.cu's kernels past 128 jobs or 64 machines: the free kernel
    on each LARGE and WIDE config ("rollout_free <config>") and the driven
    kernel at T=1 with ends on LARGE_LOOP's and WIDE_LOOP's batch after one
    random-policy step ("rollout_driven <config>"); where the checkout's
    ``launch_geometry`` refuses the shape (a parent without its machine-slot
    class), the key holds "refused: <its message>" instead of a time."""
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
    two_builds = hasattr(fr, "static_shape")
    three = hasattr(fr, "Build")  # the slot-class build
    batches = [None, *STATIC_SHAPES] + ([fr.Build("slots", (1, 1))] if three else [])
    if hasattr(fr, "rollout_build"):  # rollout.cu's machine-slot classes
        batches += [fr.Build("rollout", k) for k in sorted(set(WIDE_CLASSES.values()))]
    t0 = time.perf_counter()
    if two_builds:
        fr.build_kernels(batches)
    else:
        fr._lib()
    res = {"root": str(root_path), "build_s": time.perf_counter() - t0, "ptxas": _build.ptxas_report("rollout")}
    if hasattr(fr, "kernel_jobs"):  # a checkout with free_static.cu: one library per source and shape
        res["ptxas"] = {" ".join(map(str, job)): _build.ptxas_report(*job) for job in fr.kernel_jobs(batches)}

    def timed(key, kernel, state, T, **kw):
        res[key] = launch_timer(fr, dev, kernel, state, T, build="rollout" if two_builds else None, **kw)["ms"]
        for build, on in (("static", two_builds and fr.static_shape(state) is not None),
                          ("slots", three and fr.slot_class(state.jobs_pad, state.machines_pad) is not None)):
            if on:
                row = launch_timer(fr, dev, kernel, state, T, build=build if three else None, **kw)
                res[f"{key} {build}"] = row["ms"]
                if kernel == "rollout_driven":
                    res[f"{key} {build} host"] = row["host_ms"]

    def called(key, state, actions, T, ends=False):
        row = call_timer(fr, state, actions, T, ends, repeats=10 if T == 1 else 3)
        res[key + " call"], res[key + " call host"], res[key + " call sync"] = row["ms"], row["host_ms"], row["sync_ms"]

    def loop_state(B, light, name="ta01"):
        """``name`` at B lanes after LOOP_STEPS - 1 random-policy steps, and
        the next step's actions."""
        gen = torch.Generator(device=dev).manual_seed(SEED)
        s = vector.make_batch(source(instances, name), B, device=dev)
        s = vector.strip_solution(s) if light else s
        stats = vector.RolloutStats.zero(dev)
        for _ in range(LOOP_STEPS - 1):
            s, _, stats = vector.step_autoreset(s, vector.random_legal_actions(gen, s), stats)
        return s, vector.random_legal_actions(gen, s)[None].to(torch.int32).contiguous()

    s, acts = loop_state(MAIN_B, light=False)
    timed("rollout_driven", "rollout_driven", s, 1, actions=acts, repeats=20)
    called("rollout_driven", s, acts, 1)
    s, acts = loop_state(LEARNER_B, light=True)
    timed("rollout_driven_learner", "rollout_driven", s, 1, actions=acts, ends=True, repeats=20)
    called("rollout_driven_learner", s, acts, 1, ends=True)
    s, acts = loop_state(PAD_LOOP[1], light=False, name=PAD_LOOP[0])
    timed("rollout_driven_padded", "rollout_driven", s, 1, actions=acts, ends=True, repeats=20)
    called("rollout_driven_padded", s, acts, 1, ends=True)
    # the first driven parity case's shape: T=512 steps of a random policy
    name, B, T, _ = DRIVEN_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stats = vector.RolloutStats.zero(dev)
    s0 = s = vector.make_batch(source(instances, name), B, device=dev)
    acts = []
    for _ in range(T):
        acts.append(vector.random_legal_actions(gen, s))
        s, _, stats = vector.step_autoreset(s, acts[-1], stats)
    acts = torch.stack(acts).to(torch.int32).contiguous()
    timed("rollout_driven_T512", "rollout_driven", s0, T, actions=acts, repeats=5)
    called("rollout_driven_T512", s0, acts, T)
    for name, B, T in FULL:
        state = vector.make_batch(source(instances, name), B, device=dev)
        vdt = fr.value_dtype(state)
        timed(f"rollout_free {name}", "rollout_free", state, T, repeats=2, vdt=vdt)
    this = root_path == Path(__file__).resolve().parent
    for kernel, cases in (("rollout_free", LARGE + WIDE), ("rollout_driven", (LARGE_LOOP[:3], WIDE_LOOP[:3]))):
        for name, B, T in cases:
            state = vector.make_batch(source(instances, name), B, device=dev)
            vdt = fr.value_dtype(state) if kernel == "rollout_free" else torch.int32
            try:
                fr.launch_geometry(state.jobs_pad, state.machines_pad, vdt)
            except ValueError as e:  # only another checkout may refuse it
                check(not this, f"{name}: {e}")
                res[f"{kernel} {name}"] = f"refused: {e}"
                continue
            if kernel == "rollout_free":
                res[f"{kernel} {name}"] = launch_timer(fr, dev, kernel, state, T, repeats=2, vdt=vdt)["ms"]
            else:
                gen = torch.Generator(device=dev).manual_seed(SEED)
                stats = vector.RolloutStats.zero(dev)
                state, _, stats = vector.step_autoreset(state, vector.random_legal_actions(gen, state), stats)
                acts = vector.random_legal_actions(gen, state)[None].to(torch.int32).contiguous()
                res[f"{kernel} {name}"] = launch_timer(fr, dev, kernel, state, 1, actions=acts, ends=True,
                                                       repeats=20)["ms"]
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
            f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
            for k, v in turns[-1][1].items() if k.startswith("rollout")))
    # the change's keys, each against the parent's same key; a " static" or
    # " slots" kernel time the parent lacks against the parent's build of
    # that batch (rollout.cu's general build)
    def parent_key(k, t):
        if k in t:
            return k
        base = k.replace(" slots", "").replace(" static", "")
        return base if base in t and not k.endswith(" host") else None

    keys = [k for k in turns[1][1] if k.startswith("rollout") and parent_key(k, turns[0][1])]
    rows = {}
    for k in keys:
        p = [t[parent_key(k, t)] for tag, t in turns if tag == "parent"]
        c = [t[k] for tag, t in turns if tag == "change"]
        if isinstance(p[0], str):  # a shape the parent refuses: no time to compare
            rows[k] = {"parent": p[0], "change_ms": c}
            log(f"[7b] {k}: parent {p[0]}; change {c[0]:.4f}, {c[1]:.4f} ms ({smi})")
            continue
        rows[k] = {"parent_ms": p, "change_ms": c, "ratio": (sum(c) / 2) / (sum(p) / 2)}
        log(f"[7b] {k}: parent {p[0]:.4f}, {p[1]:.4f} ms; change {c[0]:.4f}, {c[1]:.4f} ms; "
            f"change/parent {rows[k]['ratio']:.4f} ({smi})")
    # the -Xptxas -v lines (registers, stack, spills) of every build both
    # checkouts made, parent against change
    regs = lambda text: [ln.split(":", 1)[-1].strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]  # noqa: E731
    ptx = {tag: t["ptxas"] for tag, t in turns[:2]}
    same = {k: regs(v) == regs(ptx["change"][k]) for k, v in ptx["parent"].items() if k in ptx["change"]}
    log("[7b] -Xptxas -v, parent against change: " + ", ".join(f"{k} {'same' if v else 'DIFFERENT'}" for k, v in same.items()))
    return {"root": str(root), "rows": rows, "ptxas": ptx, "ptxas_same": same}


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


def snapshot(state) -> dict:
    """Copies of the state's dynamic fields, to show later that a launch left
    its input unchanged."""
    return {k: v.clone() for k, v in state.dynamic_fields().items()}


def hold_driven(fr, state, snap, actions, T: int, got, tag: str) -> None:
    """A driven launch's results ``got`` = (new state, rewards[, ends]) on
    ``state`` and ``actions``: the input's fields still equal ``snap``, the
    new masks hold the bytes 0 and 1 only, and the new state (every field),
    the rewards and the ends equal the plain twin's and those of every other
    build that takes the batch (``other_builds``: the slot-class build,
    rollout.cu's) on the same inputs. Those launches are not counted in
    ``LAUNCHES``."""
    import torch

    from jssenv_tpu_torch.core.state import FIELD_NAMES

    changed = [k for k, v in snap.items() if not torch.equal(getattr(state, k), v)]
    check(not changed, f"{tag}: the launch changed its input state: {changed}")
    new = got[0]
    bad = [k for k in fr._DRIVEN_U8 if bool((getattr(new, k).view(torch.uint8) > 1).any())]
    check(not bad, f"{tag}: mask bytes other than 0 and 1 in {bad}")
    actions = actions.to(torch.int32).contiguous()
    others = [("twin", fr.rollout_driven_reference(state, actions, T, return_ends=True))]
    counts = dict(fr.LAUNCHES)
    for b in other_builds(fr, state, fr.driven_build(state).kind):
        others.append((f"{b} build", fr._driven_kernel(state, actions, T, fr._solution_mode(state), True, build=b)))
    fr.LAUNCHES.update(counts)
    for name, other in others:
        diff = [k for k in FIELD_NAMES if not torch.equal(getattr(new, k), getattr(other[0], k))]
        diff += [k for k, i in (("rewards", 1), ("ends", 2)) if i < len(got) and not torch.equal(got[i], other[i])]
        check(not diff, f"{tag}: the kernel and the {name} differ in {diff}")


class DrivenRecorder:
    """While active, wraps ``fused_rollout.rollout_driven`` (which
    ``step_autoreset`` and ``evaluate_policy`` call) to see each call's
    inputs, raw rewards and ends; launches are still counted where the
    kernel launches, nowhere else. ``on_call(state, actions, raw, ends)``
    runs after each call. Every ``hold_every``-th call (0: none) of the
    first ``hold_until`` (None: all), from the first, is held against the
    twin and the general build (``hold_driven``; ``holds`` counts them): the
    phases hold calls of their warm-up update only, or a few a run, so that
    the holds stay out of their times. It sees only calls made through the
    module attribute, so each phase that uses it requires its call count to
    equal the kernel's launch count."""

    def __init__(self, fr, on_call, hold_every: int = 0, hold_until=None):
        self.fr, self.on_call, self.hold_every, self.hold_until = fr, on_call, hold_every, hold_until
        self.calls = self.holds = 0

    def __enter__(self):
        orig = self.orig = self.fr.rollout_driven

        def wrapped(state, actions, num_steps, return_ends=False):
            hold = (self.hold_every and self.calls % self.hold_every == 0
                    and (self.hold_until is None or self.calls < self.hold_until))
            snap = snapshot(state) if hold else None
            out = orig(state, actions, num_steps, return_ends)
            if hold:
                hold_driven(self.fr, state, snap, actions, num_steps, out, f"driven call {self.calls}")
                self.holds += 1
            self.calls += 1
            self.on_call(state, actions, out[1], out[2] if return_ends else None)
            return out

        self.fr.rollout_driven = wrapped
        return self

    def __exit__(self, *exc):
        self.fr.rollout_driven = self.orig


def serving_phase(report: dict, dev, quick: bool) -> dict:
    """Phase 12: greedy ``evaluate_policy`` of the shipped checkpoints on the
    card, every env step in the driven kernel; returns its launches by
    ``LAUNCHES`` key.
    bfloat16 against the JAX package's test bounds, float32 against its
    float32 makespans on the CPU; each greedy episode's reward identity
    checked from the kernel's own rewards and ends."""
    import torch

    from jssenv_tpu_torch import checkpoint, instances
    from jssenv_tpu_torch.core import fused_rollout as fr
    from jssenv_tpu_torch.parallel import learner

    runs = SERVING_QUICK if quick else SERVING
    rows, launches = [], dict.fromkeys(fr.LAUNCHES, 0)
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
        rec = DrivenRecorder(fr, lambda s, a, r, e: (raws.append(r[0, 0]), ends.append(e[0, 0])), *SERVING_HOLDS)
        with rec:
            res = learner.evaluate_policy(params, spec, cfg, stochastic_lanes=lanes, max_steps=4096, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = driven(fr.LAUNCHES)
        n_obs = n if features == "reference" else 0  # the net's inputs: one observe launch a step
        check(n == res["steps"] and n == len(ends) and fr.LAUNCHES["rollout_driven_static"] == n
              and fr.LAUNCHES["observe"] == n_obs and sum(fr.LAUNCHES.values()) == n + n_obs,
              f"serve {name} {spec_name}: {fr.LAUNCHES} launches for {res['steps']} steps")
        check(rec.holds > 0, f"serve {name} {spec_name}: no launch held against the twin")
        for k, v in fr.LAUNCHES.items():
            launches[k] += v
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
                   ms_per_step=secs / n * 1e3, launches=n, held=rec.holds)
        rows.append(row)
        log(f"[12] serve {name} on {spec_name} ({dtype}, {1 + lanes} lanes): greedy makespan {mk} "
            f"({'recorded, no bound' if want is None else ('JAX value ' if dtype == 'float32' else 'JAX bound < ') + str(want)}), "
            f"{n} steps, {n} driven launches ({rec.holds} held against the twin and the general build), "
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
    rollout/learn split by CUDA events. Returns (launches by ``LAUNCHES``
    key, the learner-shape driven launch recorded for timing)."""
    import dataclasses

    import torch

    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import fused_rollout as fr
    from jssenv_tpu_torch.parallel import learner

    out, launches = {}, dict.fromkeys(fr.LAUNCHES, 0)
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
                last_call.update(state=s, actions=a.to(torch.int32).contiguous())
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
        rec = DrivenRecorder(fr, on_call, hold_every=8, hold_until=T)  # the warm-up update's calls
        with rec:
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
        n = driven(fr.LAUNCHES)
        # the net's inputs: one observe launch a step, and PPO's bootstrap one more an update
        n_obs = updates * (T + (cfg.algo == "ppo")) if cfg.features == "reference" else 0
        check(n == updates * T and fr.LAUNCHES["rollout_driven_static"] == n and fr.LAUNCHES["observe"] == n_obs
              and sum(fr.LAUNCHES.values()) == n + n_obs,
              f"train {tag}: {fr.LAUNCHES} launches for {updates} updates of {T} steps")
        check(calls[0] == n, f"train {tag}: the recorder saw {calls[0]} of {n} driven launches")
        check(rec.holds > 0, f"train {tag}: no launch held against the twin")
        for k, v in fr.LAUNCHES.items():
            launches[k] += v
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
               "losses": losses, "episodes": eps, "identity_violations": int(viol), "launches": n, "held": rec.holds,
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
    # the warm-up update's calls held against the twin and the general build
    with DrivenRecorder(fr, lambda s, a, r, e: acts.append(a[0].clone()), hold_every=8, hold_until=cfg.unroll_steps):
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
    check(launches == dict.fromkeys(fr.LAUNCHES, 0) | {"rollout_driven_static": updates * T, "observe": updates * T},
          f"1-rank NCCL learner launches {launches}")
    for k, v in launches.items():
        path[k] += v
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
        n = ru * T * len(RANK_MESHES) * len(RANK_DTYPES)
        check(lr["rollout_driven_static"] == n and lr["observe"] == n and sum(lr.values()) == 2 * n,
              f"rank worker learner launches {lr}")
        for k, v in lr.items():
            path[k] += v

    name, Bf, Tf = P["free"]
    full = vector.make_batch(source(instances, name), Bf, device=dev)
    ref = {k: v.item() for k, v in fr.rollout_free(full, Tf, seed=SEED).items()}
    rel = 0.0
    for r in ranks:
        fl = json.loads(str(r["free_launches"]))
        key = free_key(fr.value_dtype(full), fr._key(fr.free_build(full)))
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
        g = {b: fr._free_kernel(shard, To, SEED, None, vdt, lane_offset=Bo // 2, build=b) for b in ("rollout", "slots")}
        w = fr._free_kernel(whole, To, SEED, None, vdt)
        t = fr.free_lane_stats_reference(shard, To, SEED, lane_offset=Bo // 2)
        for key_ in ("episodes", "mk_sum", "mk_min", "viol"):
            check(torch.equal(k[key_], t[key_]) and torch.equal(k[key_], w[key_][Bo // 2:]),
                  f"offset kernel {name} {vdt}: {key_} differs")
        check(torch.equal(k["ret"], w["ret"][Bo // 2:]), f"offset kernel {name} {vdt}: returns differ from the whole run's")
        for b, gb in g.items():
            check(all(torch.equal(k[f], gb[f]) for f in k), f"offset kernel {name} {vdt}: the static and {b} builds differ")
        ret_err = float((k["ret"] - t["ret"]).abs().max())
        kk = free_key(vdt, fr._key(fr.free_build(shard)))
        errs[kk] = max(errs[kk], ret_err)
        out["offset"][f"{name} {vdt}"] = {"B": Bo, "T": To, "episodes": int(k["episodes"].sum()),
                                          "ret_max_abs_err": ret_err}
        check(quick or int(k["episodes"].sum()) > 0, f"offset kernel {name}: no episode ended")
        log(f"[14] offset kernel {name} {str(vdt).removeprefix('torch.')}: lanes [{Bo // 2}, {Bo}) with lane_offset "
            f"{Bo // 2} equal the twin's and the whole batch's ({int(k['episodes'].sum())} episodes, T={To})")
    report["parallel"] = out
    check(not fails, f"2-rank runs outside their bounds: {fails} {rows}")
    return path, errs


def distill_phase(report: dict, dev, quick: bool) -> dict:
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
    n = driven(fr.LAUNCHES)
    check(n == D["finetune"] * cfg.unroll_steps + pre["steps"] + fin["steps"] and sum(fr.LAUNCHES.values()) == n,
          f"distillation launches {fr.LAUNCHES}")
    counts = dict(fr.LAUNCHES)
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
    return counts


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
    log("[17] the solver launched no rollout kernel")
    report["solver"] = out


# phase 18: the repo's entry points on the port, each a process of its own on
# the card: (tool and arguments) full, quick. The bench runs at its defaults
# (bench.py's three configurations at T=8192); the solver sweep at its
# defaults but two instances and 200 iterations (cut from 12 000); the
# distillation tool collects the first two teachers and evaluates the
# shipped checkpoint at float32 on ta41
TOOLS_DIR = Path(__file__).resolve().parent / "jssenv_tpu_torch" / "build" / "tools"
TOOL_RUNS = {
    "bench": (["tools/bench_torch.py"], ["tools/bench_torch.py", "--batch", "1024", "--steps", "512", "--repeats", "1"]),
    "solver_quality": (["tools/solver_quality_torch.py", "--instances", "ta01", "ta02", "--iters", "200"],
                       ["tools/solver_quality_torch.py", "--instances", "ta01", "--iters", "16", "--batch", "64",
                        "--sweeps", "1", "--chains", "16"]),
    "collect": (["tools/distill_30x20_torch.py", "collect", "--instances", "ta41", "ta42"],
                ["tools/distill_30x20_torch.py", "collect", "--instances", "ta41"]),
    "eval": (["tools/distill_30x20_torch.py", "eval", "models_data/ta41_distill.npz", "--instances", "ta41",
              "--dtype", "float32"],) * 2,
    # the JAX tool's defaults (256 lanes a card, 128 steps); one card here
    "scaling": (["tools/bench_scaling_torch.py", "256", "128"], ["tools/bench_scaling_torch.py", "64", "16"]),
    # one instance without an entry (ta12, 20x15), the budget cut from
    # batch 2048, 6 sweeps and 4000 refine iterations
    "golden": (["tools/gen_golden_torch.py", "ta12", "--batch", "1024", "--sweeps", "2", "--refine", "200"],
               ["tools/gen_golden_torch.py", "ta12", "--batch", "64", "--sweeps", "1", "--refine", "16"]),
}
SCALING_WARMUP = 8  # the scaling tool's warm-up steps (WARMUP_STEPS there)
# runs tools/gen_golden_torch.py with its module-level DATA pointed at the
# file named by the first argument
GEN_GOLDEN = """
import importlib.util, sys
out, sys.argv = sys.argv[1], sys.argv[2:]
spec = importlib.util.spec_from_file_location("gen_golden_torch", sys.argv[0])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.DATA = out
sys.exit(mod.main(sys.argv[1:]))
"""
BENCH_CONFIGS = ("ta01", "ta41-ta50", "ta71")  # the bench's records, in order
# runs a tool as __main__ with every EVAL_HOLD-th rollout_driven call held
# against the twin and the general build (DrivenRecorder); the counts go to
# the JSON file named by the second argument, the checkout's root is the first
HOLD_DRIVEN = """
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from jssenv_tpu_torch.core import fused_rollout
out, every, sys.argv = sys.argv[2], int(sys.argv[3]), sys.argv[4:]
rec = chip_smoke.DrivenRecorder(fused_rollout, lambda *a: None, hold_every=every)
try:
    with rec:
        runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    with open(out, "w") as f:
        json.dump({"calls": rec.calls, "holds": rec.holds}, f)
"""
EVAL_HOLD = 50
# runs a tool as __main__ with jssenv_tpu_torch.solve.solve recorded: each
# result's instance, makespan and machine order go to the JSON file named by
# the first argument when the tool exits
RECORD_SOLVES = """
import json, runpy, sys
from jssenv_tpu_torch import solve
real, seen = solve.solve, []
def recording(spec, **kw):
    res = real(spec, **kw)
    seen.append({"instance": spec.name, "makespan": res.makespan, "machine_order": res.machine_order()})
    return res
solve.solve = recording
out, sys.argv = sys.argv[1], sys.argv[2:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    with open(out, "w") as f:
        json.dump(seen, f)
"""


def run_tool(argv, timeout: int = 600, prefix=()):
    """One tool as a process of its own from the checkout's root; fails the
    phase on a non-zero exit. Returns (stdout, stderr, host seconds) and
    logs the tool's stderr."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *prefix, *argv], cwd=root, capture_output=True, text=True,
                          timeout=timeout)
    secs = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines()[-40:]:
        log(f"[18]   | {line}")
    check(proc.returncode == 0, f"{' '.join(argv)} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout, proc.stderr, secs


def tool_launches(stderr: str) -> dict:
    """The ``kernel launches: {...}`` line a tool prints last on stderr."""
    lines = [ln for ln in stderr.splitlines() if ln.startswith("kernel launches: ")]
    check(len(lines) == 1, f"a tool printed {len(lines)} kernel-launch lines")
    return json.loads(lines[0].removeprefix("kernel launches: "))


def tools_phase(report: dict, dev, quick: bool, smi: str) -> dict:
    """Phase 18: the five entry points of the repo ported in
    ``tools/*_torch.py``, each run as a process on the card (module
    docstring). Returns their kernel launches by ``LAUNCHES`` key."""
    import numpy as np
    import torch

    from jssenv_tpu_torch import distill, instances, replay, vector
    from jssenv_tpu_torch.core import fused_rollout as fr

    pick = 1 if quick else 0
    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    launches = {k: 0 for k in KERNELS}

    # (a) the bench: one JSON line, three records, every run in the kernel
    stdout, _, secs = run_tool(TOOL_RUNS["bench"][pick])
    lines = stdout.splitlines()
    check(len(lines) == 1, f"the bench printed {len(lines)} stdout lines")
    rec = json.loads(lines[0])
    records = [rec] + rec.get("extra", [])
    names = [r["metric"].split("batched ")[1].split(",")[0] for r in records]
    check(names == list(BENCH_CONFIGS), f"the bench's configurations: {names}")
    name, _, limit = smi.rpartition(",")
    for cfg, r in zip(names, records):
        n = 1 + len(r["runs"])  # the warm-up and the repeats
        key = free_key(FULL_DTYPE[cfg], "_static")  # every configuration of the bench is unpadded
        check(r["engine"] == "cuda" and r["backend"] == "cuda" and r["value_dtype"] == FULL_DTYPE[cfg],
              f"bench {cfg}: engine {r['engine']}, backend {r['backend']}, dtype {r['value_dtype']}")
        check(r["launches"] == {k: (n if k == key else 0) for k in r["launches"]} and key in r["launches"],
              f"bench {cfg}: launches {r['launches']}")
        # at --quick's 512 steps no ta71 episode (2000 operations) ends
        check(all(run["identity_violations"] == 0 and (run["episodes"] > 0 or quick) for run in r["runs"]),
              f"bench {cfg}: runs {r['runs']}")
        check((r["gpu"], r["power_limit"]) == (name.strip(), limit.strip()), f"bench {cfg}: card {r['gpu']}")
        launches[key] += n
    # the bench's ta01 run at seed 1 against a direct rollout_free at that seed
    run1 = rec["runs"][0]
    state = vector.make_batch(instances.get_instance("ta01"), rec["batch"], device=dev)
    direct = {k: v.item() for k, v in fr.rollout_free(state, rec["steps"], seed=run1["seed"]).items()}
    for key in ("episodes", "total_makespan", "min_makespan", "identity_violations"):
        check(direct[key] == run1[key], f"bench ta01 seed {run1['seed']}: {key} {run1[key]}, direct {direct[key]}")
    out["bench"] = {"records": records, "process_s": secs}
    for cfg, r in zip(names, records):
        host = [x["host_s"] * 1e3 for x in r["runs"]]
        device = [x["device_ms"] for x in r["runs"]]
        log(f"[18] bench {cfg} B={r['batch']} T={r['steps']} {r['value_dtype']}: {r['value']:.6g} env-steps/s "
            f"(host clock {min(host):.2f}-{max(host):.2f} ms, CUDA events {min(device):.2f}-{max(device):.2f} ms "
            f"a run; warm-up {r['warmup_s']} s, cold build {r['cold_build']}), {r['runs'][0]['episodes']} "
            f"episodes at seed 1, 0 identity violations ({r['gpu']}, {r['power_limit']})")
    log(f"[18] bench ta01 seed {run1['seed']}: {run1['episodes']} episodes, equal to a direct rollout_free "
        f"(and its makespan sum and minimum); the process took {secs:.1f} s")

    # (b) the solver sweep: every row's schedule replayed on the native engine
    sq_out, solves = TOOLS_DIR / "solver_quality.json", TOOLS_DIR / "solves.json"
    sq_out.unlink(missing_ok=True)
    argv = TOOL_RUNS["solver_quality"][pick]
    _, stderr, secs = run_tool([*argv, "--out", str(sq_out)], prefix=("-c", RECORD_SOLVES, str(solves)))
    check(not any(tool_launches(stderr).values()), "the solver launched a rollout kernel")
    sq = json.loads(sq_out.read_text())
    seen = json.loads(solves.read_text())[1:]  # the first solve is the warm-up
    iters = int(argv[argv.index("--iters") + 1])
    check(len(seen) == len(sq["rows"]), f"{len(seen)} solves for {len(sq['rows'])} rows")
    for row, res in zip(sq["rows"], seen):
        spec = instances.get_instance(row["instance"])
        mk, _ = replay.replay_machine_order(spec, res["machine_order"], backend="native")
        check(res["instance"] == row["instance"] and mk == res["makespan"] == row["makespan_seed0"],
              f"solver {row['instance']}: row {row['makespan_seed0']}, solve {res['makespan']}, replayed {mk}")
        check(row["lower_bound"] == spec.lower_bound() <= row["makespan"] and "gap_pct" in row,
              f"solver {row['instance']}: {row}")
        row["refine_ms_per_iter"] = row["timings_seed0"]["refine_s"] / iters * 1e3
        log(f"[18] solver_quality {row['instance']}: {row['makespan']} (replayed), gap {row['gap_pct']}% to the "
            f"best known, {row['gap_vs_lb_pct']}% to the lower bound; {row['seconds_per_seed']['0']} s, "
            f"{row['refine_ms_per_iter']:.2f} ms a refine iteration ({smi})")
    out["solver_quality"] = dict(sq, process_s=secs)
    log(f"[18] solver_quality: warm-up {sq['compile_s']} s, mean gap {sq['mean_gap']}%; the process took "
        f"{secs:.1f} s")

    # (c) the distillation tool: the collected teachers equal the shipped pairs
    pairs_dir = TOOLS_DIR / "distill"
    (pairs_dir / "distill_30x20_pairs.npz").unlink(missing_ok=True)
    argv = TOOL_RUNS["collect"][pick]
    _, stderr, secs = run_tool([*argv, "--out-dir", str(pairs_dir)])
    check(not any(tool_launches(stderr).values()), "teacher collection launched a rollout kernel")
    with np.load(pairs_dir / "distill_30x20_pairs.npz") as z:
        got = {k: z[k] for k in distill.PAIR_KEYS}
    names = argv[argv.index("--instances") + 1:]
    n = len(got["action"])
    check(n == sum(instances.get_instance(x).num_jobs * instances.get_instance(x).num_machines for x in names),
          f"collect {names}: {n} pairs")
    with np.load(MODELS / "distill_30x20_pairs.npz") as z:
        shipped = {k: z[k][:n] for k in distill.PAIR_KEYS}
    obs_err = float(np.abs(got["obs"] - shipped["obs"]).max())
    check(obs_err <= 1e-6 and all(np.array_equal(got[k], shipped[k]) for k in ("mask", "valid", "action")),
          f"collect {names}: pairs differ from the shipped rows (obs err {obs_err})")
    out["collect"] = {"instances": names, "pairs": n, "obs_max_err": obs_err, "process_s": secs}
    log(f"[18] collect {names} on the card: {n} pairs equal the shipped rows 0-{n - 1} in order (obs max err "
        f"{obs_err:.3g}, the rest exact); the process took {secs:.1f} s")

    # (d) the float32 greedy eval of the shipped ta41_distill: 2658, every
    # EVAL_HOLD-th driven call in the tool's process held against the twin
    # and the general build
    hold_file = TOOLS_DIR / "eval_holds.json"
    hold_file.unlink(missing_ok=True)
    root = str(Path(__file__).resolve().parent)
    stdout, stderr, secs = run_tool(TOOL_RUNS["eval"][pick], prefix=("-c", HOLD_DRIVEN, root, str(hold_file),
                                                                     str(EVAL_HOLD)))
    check(stdout.splitlines() == ["ta41: greedy 2658"], f"eval ta41_distill float32: {stdout!r}")
    ev = tool_launches(stderr)
    check(ev["rollout_driven_static"] > 0 and ev["rollout_driven_static"] == sum(ev.values()), f"eval launches {ev}")
    holds = json.loads(hold_file.read_text())
    check(holds["calls"] == ev["rollout_driven_static"] and holds["holds"] > 0, f"eval holds {holds}, launches {ev}")
    launches["rollout_driven_static"] += ev["rollout_driven_static"]
    out["eval"] = {"greedy_makespan": 2658, "launches": ev, "process_s": secs, "held": holds["holds"]}
    log(f"[18] eval ta41_distill float32: greedy 2658 (= the JAX package's), {ev['rollout_driven_static']} driven "
        f"launches, {holds['holds']} held against the twin and the general build; the process took {secs:.1f} s")

    # (e) the weak-scaling tool: a row for each card count up to the cards
    # there are (one card: the 1-rank NCCL row), each env step one driven
    # launch a rank
    argv = TOOL_RUNS["scaling"][pick]
    stdout, stderr, secs = run_tool(argv)
    lines = stdout.splitlines()
    check(len(lines) == 1, f"the scaling tool printed {len(lines)} stdout lines")
    rec = json.loads(lines[0])
    lanes, steps = (int(x) for x in argv[1:3])
    rows = rec["weak_scaling"]
    check([r["devices"] for r in rows] == [n for n in (1, 2, 4, 8) if n <= torch.cuda.device_count()]
          and all(r["batch"] == lanes * r["devices"] and r["steps_per_s"] > 0
                  and set(r) == {"devices", "batch", "steps_per_s", "step_us", "episodes"} for r in rows),
          f"scaling rows {rows}")
    check((rec["gpu"], rec["power_limit"]) == (name.strip(), limit.strip()), f"scaling: card {rec['gpu']}")
    sc = tool_launches(stderr)
    n = sum(r["devices"] for r in rows) * (SCALING_WARMUP + 3 * steps)
    check(sc["rollout_driven_static"] == n and sum(sc.values()) == n, f"scaling launches {sc}, expected {n}")
    launches["rollout_driven_static"] += n
    # its batch (ta01, `lanes` lanes), stepped here as its ranks step it
    # (random legal actions, one driven launch a step), every 8th step held
    # against the twin and the general build; these launches are not counted
    counts = dict(fr.LAUNCHES)
    s = vector.make_batch(instances.get_instance("ta01"), lanes, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    held = 0
    for t in range(steps):
        a = vector.random_legal_actions(gen, s)[None]
        snap = snapshot(s) if t % 8 == 0 else None
        s_in, (s, raw, ends) = s, fr.rollout_driven(s, a, 1, return_ends=True)
        if snap is not None:
            hold_driven(fr, s_in, snap, a, 1, (s, raw, ends), f"scaling batch step {t}")
            held += 1
    fr.LAUNCHES.update(counts)
    out["scaling"] = dict(rec, process_s=secs, launches=sc, held=held)
    log(f"[18] bench_scaling_torch, one card: {rows[0]['steps_per_s']} env-steps/s at {lanes} lanes, "
        f"{rows[0]['step_us']} us a vectorized step, {rows[0]['episodes']} episodes, {n} driven launches "
        f"({rec['gpu']}, {rec['power_limit']}); the process took {secs:.1f} s; its batch stepped here "
        f"{steps} times, {held} steps held against the twin and the general build")

    # (f) the golden-file tool on one instance without an entry, into a copy
    # of the golden file: its entry replayed to its makespan on the card and
    # the native engine; every other entry and the repo's file untouched
    data = TOOLS_DIR / "golden_solutions.json"
    before = GOLDEN.read_text()
    data.write_text(before)
    argv = TOOL_RUNS["golden"][pick]
    stdout, stderr, secs = run_tool(["-c", GEN_GOLDEN, str(data), *argv])
    inst_name = argv[1]
    check(GOLDEN.read_text() == before, "the repo's golden file changed")
    after = json.loads(data.read_text())
    entry = after.pop(inst_name)
    check(json.dumps(after, indent=1, sort_keys=True) == before, "gen_golden changed another entry")
    spec = instances.get_instance(inst_name)
    mk_card, _ = replay.replay_machine_order(spec, entry["machine_order"], device=dev)
    mk_native, _ = replay.replay_machine_order(spec, entry["machine_order"], backend="native")
    check(entry["makespan"] == mk_card == mk_native and spec.lower_bound() <= mk_card,
          f"gen_golden {inst_name}: entry {entry['makespan']}, replayed {mk_card} (card), {mk_native} (native)")
    out["golden"] = {"instance": inst_name, "makespan": entry["makespan"], "source": entry["source"],
                     "lower_bound": spec.lower_bound(), "stdout": stdout.strip(), "process_s": secs}
    log(f"[18] gen_golden_torch {inst_name}: certified makespan {entry['makespan']} (lower bound "
        f"{spec.lower_bound()}), replayed to it on the card and on the native engine; the repo's golden file "
        f"unchanged; the process took {secs:.1f} s")
    out["launches"] = launches
    report["tools"] = out
    return launches


def finish(report, args, smi, kind, count) -> int:
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

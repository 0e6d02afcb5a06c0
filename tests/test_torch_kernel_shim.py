"""The CUDA sources of the rollouts, run on the CPU through a shim.

``csrc/free_static.cu`` and ``csrc/driven_static.cu`` (the static builds of
the free and the driven kernel, one library per shape), ``csrc/general_lane.cu``
(both kernels for padded and mixed-shape batches, one library per slot
class: ``SLOT_CLASSES``), all on ``csrc/static_lane.cuh``, and the general
build of ``csrc/rollout.cu``'s kernels (one library per machine-slot class:
``ROLLOUT_CLASSES``) are compiled as C++ (``g++ -std=c++20``) against
``SHIM`` below: every CUDA
thread of a block is a fiber of one host thread, the blocks of a grid run
one after another, and per warp a barrier of its 32 fibers around a 32-slot
array stands for ``__syncwarp`` and every vote, shuffle and reduction; the
dynamic shared memory is one static array. One host thread switching fibers
at each collective needs one core and no scheduler, so the run takes as
long beside other busy processes as alone. Only the
device part of each source is compiled (up to ``// ---- host side``); the
entry points below launch its kernels as the source's own do. The libraries
go into a temporary directory.

Each case runs in a process of this file (``python
tests/test_torch_kernel_shim.py LIBDIR CASE``) with a time limit of its own.
A free case holds each kernel's per-lane stats and float32 returns bit for
bit against ``fused_rollout.free_lane_stats_reference``: the register builds
on the state's own fields (views of a larger batch too, ``SLICED``),
rollout.cu's on its lane buffer in int32 and int16 storage where the values
fit, Philox words with a non-zero ``lane_offset`` and caller bits, from
fresh states and from states a few hundred driven steps into an episode
(``START``: running jobs, no-op pins, work done and busy machines, which a
fresh state has none of). A driven case (``DRIVEN``)
holds the driven kernel's new state, field by field, its rewards and its
ends bit for bit against ``fused_rollout.rollout_driven_reference`` at T = 0,
1 and 40 on the full and the light state, fresh and mid-episode, at every
job-slot and machine-slot count, and checks that the input state is
unchanged and that the new masks hold the bytes 0 and 1 only; one of them
also against the JAX package's ``rollout_driven`` in interpret mode. The
``g-`` driven cases and the ``slots`` free runs do the same for
``general_lane.cu`` on padded and mixed-shape batches (ta01+ta11, ta01+ta41,
a padded ta01, random instance sets), every slot class S in 1..4, K in 1..2
met; one padded case of B = 1024 also against the JAX package's
``rollout_driven`` (``static_lane=None``). The ``r-`` driven cases and the
``wide`` free cases do the same for ``rollout.cu``'s general build past 64
machines (3 and 4 machine slots a thread: 4x70 and 3x100 fresh and
mid-episode, 150x70 with five job slots), int32 and int16; one of them
(``r-wide4x70``) also against the JAX package's ``rollout_driven``."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import fused_rollout as fr  # noqa: E402
from jssenv_tpu_torch.core import state as ts  # noqa: E402
from test_torch_free_static import driven_start  # noqa: E402

CSRC = ROOT / "jssenv_tpu_torch" / "core" / "csrc"

SHIM = r"""
// CPU stand-in for the CUDA device code of csrc/: every CUDA thread of a
// block is a fiber (ucontext) of one host thread, switched cooperatively
// at the warp's collectives, so the run needs one core and no scheduler.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <functional>
#include <memory>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __constant__
#define __launch_bounds__(...)
#define __align__(n)
struct dim3 { unsigned x = 1, y = 1, z = 1; };
dim3 threadIdx, blockIdx, blockDim, gridDim;  // threadIdx: the running fiber's
alignas(16) unsigned char smem[1 << 20];
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int atomicMin(int* p, int v) {  // one host thread: no race
  const int old = *p;
  if (v < old) *p = v;
  return old;
}
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
};
std::vector<Fiber> g_fibers;
int g_cur;
ucontext_t g_main;
std::function<void()> g_body;
// to the next fiber of the block that has not returned (none: the launch)
static void switch_on() {
  const int me = g_cur, n = (int)g_fibers.size();
  for (int k = 1; k <= n; ++k) {
    const int nx = (me + k) % n;
    if (!g_fibers[nx].done) {
      if (nx == me) return;
      g_cur = nx;
      threadIdx.x = nx;
      swapcontext(&g_fibers[me].ctx, &g_fibers[nx].ctx);
      threadIdx.x = me;  // resumed
      return;
    }
  }
  swapcontext(&g_fibers[me].ctx, &g_main);
}
static void fiber_entry() {
  g_body();
  g_fibers[g_cur].done = true;
  switch_on();
}
// a barrier of `n` fibers: the last to arrive goes on, the others yield
// until the phase moves
struct Barrier {
  int count = 0;
  unsigned phase = 0;
  void arrive_and_wait(int n) {
    const unsigned ph = phase;
    if (++count == n) {
      count = 0;
      ++phase;
      return;
    }
    while (phase == ph) switch_on();
  }
};
struct Warp {
  Barrier bar;
  int64_t slot[2][32];  // by phase parity: a collective reads one while the next writes the other
};
std::vector<Warp> g_warps;
Barrier g_block;
static Warp& warp(unsigned mask) {
  if (mask != 0xffffffffu) std::abort();  // the sources sync whole warps only
  return g_warps[threadIdx.x / 32];
}
inline void __syncwarp(unsigned m = 0xffffffffu) { warp(m).bar.arrive_and_wait(32); }
inline void __syncthreads() { g_block.arrive_and_wait((int)blockDim.x); }
template <typename F>
static int64_t reduce(unsigned m, int64_t v, F f) {
  Warp& w = warp(m);
  int64_t* slot = w.slot[w.bar.phase & 1];
  slot[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait(32);
  int64_t acc = slot[0];
  for (int i = 1; i < 32; ++i) acc = f(acc, slot[i]);
  return acc;
}
inline int __reduce_add_sync(unsigned m, int v) {
  return (int)reduce(m, v, [](int64_t a, int64_t b) { return (int64_t)(int)((uint32_t)a + (uint32_t)b); });
}
inline int __reduce_min_sync(unsigned m, int v) {
  return (int)reduce(m, v, [](int64_t a, int64_t b) { return std::min(a, b); });
}
inline int __reduce_max_sync(unsigned m, int v) {
  return (int)reduce(m, v, [](int64_t a, int64_t b) { return std::max(a, b); });
}
inline unsigned __reduce_or_sync(unsigned m, unsigned v) {
  return (unsigned)reduce(m, (int64_t)v, [](int64_t a, int64_t b) { return a | b; });
}
inline bool __any_sync(unsigned m, bool p) { return reduce(m, p, [](int64_t a, int64_t b) { return a | b; }) != 0; }
inline unsigned __ballot_sync(unsigned m, bool p) {
  return (unsigned)reduce(m, (int64_t)p << (threadIdx.x % 32), [](int64_t a, int64_t b) { return a | b; });
}
template <typename T>
inline T __shfl_sync(unsigned m, T v, int src, int width = 32) {
  Warp& w = warp(m);
  int64_t* slot = w.slot[w.bar.phase & 1];
  slot[threadIdx.x % 32] = (int64_t)v;
  w.bar.arrive_and_wait(32);
  return (T)slot[src % width];
}
typedef void* cudaStream_t;
inline void launch(int grid, int block, std::function<void()> body) {
  constexpr size_t kStack = 1 << 16;
  blockDim.x = block;
  gridDim.x = grid;
  g_body = std::move(body);
  for (int bx = 0; bx < grid; ++bx) {
    blockIdx.x = bx;
    g_warps.assign(block / 32, Warp{});
    g_block = Barrier{};
    g_fibers.clear();
    g_fibers.resize(block);
    for (auto& f : g_fibers) {
      f.stack.reset(new char[kStack]);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, fiber_entry, 0);
    }
    g_cur = 0;
    threadIdx.x = 0;
    swapcontext(&g_main, &g_fibers[0].ctx);
  }
}
"""

# The C entry points of each library, with the arguments of the source's own.
FREE_ENTRY = r"""
extern "C" int shim_free(JSS_FREE_PARAMS) {
  const FreeIO io = JSS_FREE_IO;
  launch((B + kLanes - 1) / kLanes, kLanes * 32, [=] { JSS_FREE_KERNEL(io); });
  return kLanes;
}
"""

STATIC_ENTRY = FREE_ENTRY + r"""
extern "C" int shim_mod_small(unsigned x, int d) { return mod_small(x, d); }
"""

DRIVEN_ENTRY = r"""
extern "C" int shim_driven(const void* const* p, int B, int T, int with_solution) {
  const DrivenIO io{(const int*)p[0], (const int*)p[1], (const int*)p[2], (const int*)p[3], (const int*)p[4],
                    (const int*)p[5], (const int*)p[6], (const int*)p[7], (const int*)p[8], (const int*)p[9],
                    (const int*)p[10], (const int*)p[11], (const int*)p[12], (const uint8_t*)p[13],
                    (const uint8_t*)p[14], (const uint8_t*)p[15], (const uint8_t*)p[16], (const int*)p[17],
                    (const int*)p[18], (const int*)p[19], (int*)p[20], (uint8_t*)p[21], B, T, with_solution};
  launch((B + kLanes - 1) / kLanes, kLanes * 32, [=] { driven_static_kernel(io); });
  return kLanes;
}
"""

LANE_ENTRY = FREE_ENTRY + r"""
extern "C" int shim_driven(const void* const* p, int B, int J, int M, int T, int with_solution) {
  const DrivenIO io{(const int*)p[0], (const int*)p[1], (const int*)p[2], (const int*)p[3], (const int*)p[4],
                    (const int*)p[5], (const int*)p[6], (const int*)p[7], (const int*)p[8], (const int*)p[9],
                    (const int*)p[10], (const int*)p[11], (const int*)p[12], (const uint8_t*)p[13],
                    (const uint8_t*)p[14], (const uint8_t*)p[15], (const uint8_t*)p[16], (const int*)p[17],
                    (const int*)p[18], (const int*)p[19], (int*)p[20], (uint8_t*)p[21], B, T, with_solution, J, M};
  launch((B + kLanes - 1) / kLanes, kLanes * 32, [=] { driven_general_kernel(io); });
  return kLanes;
}
"""

GENERAL_ENTRY = r"""
extern "C" int shim_free(const void* state, const void* tab, const void* lanec, const void* bits,
                         unsigned long long seed, void* stats, void* ret, int B, int J, int M, int T,
                         int lane_offset, int lanes, int stride, int scr_stride, int i16) {
  const int grid = (B + lanes - 1) / lanes;
  if (i16)
    launch(grid, lanes * 32, [=] {
      rollout_free_kernel<int16_t, 0, 0>((const int16_t*)state, (const int*)tab, (const int*)lanec,
                                         (const uint32_t*)bits, seed, (long long*)stats, (float*)ret, B, J, M,
                                         T, lane_offset, stride, scr_stride);
    });
  else
    launch(grid, lanes * 32, [=] {
      rollout_free_kernel<int32_t, 0, 0>((const int32_t*)state, (const int*)tab, (const int*)lanec,
                                         (const uint32_t*)bits, seed, (long long*)stats, (float*)ret, B, J, M,
                                         T, lane_offset, stride, scr_stride);
    });
  return 0;
}
extern "C" int shim_driven(void* state, const void* tab, const void* lanec, const void* actions, void* rewards,
                           void* ends, int B, int J, int M, int T, int with_solution, int lanes, int stride,
                           int scr_stride) {
  launch((B + lanes - 1) / lanes, lanes * 32, [=] {
    rollout_driven_kernel<0, 0>((int*)state, (const int*)tab, (const int*)lanec, (const int*)actions, (int*)rewards,
                                (int*)ends, B, J, M, T, with_solution, stride, scr_stride);
  });
  return 0;
}
"""

# The slot classes of csrc/general_lane.cu: (job slots S, machine words K).
SLOT_CLASSES = tuple((s, k) for s in range(1, 5) for k in range(1, 3))
# The machine-slot classes of csrc/rollout.cu built here: the default two
# (at most 64 machines) and the classes of the wide cases (M = 70, 100).
ROLLOUT_CLASSES = (2, 3, 4)


def _mixed(*shapes, jobs_pad=None, machines_pad=None):
    """A source of random instances of the given (J, M) shapes (durations 1-9,
    seeds 20, 21, ...), stacked and padded to the largest (or to the pads)."""
    return lambda: ti.stack_instances([ti.random_instance(j, m, (1, 9), seed=20 + i) for i, (j, m) in enumerate(shapes)],
                                      jobs_pad=jobs_pad, machines_pad=machines_pad)


# padded and mixed-shape sources of the slot-class build, at least one a slot
# class; each -> its padded slot class
ta01_11 = lambda: ti.get_instance_set(["ta01", "ta11"])  # noqa: E731
MIXED = {
    "ta01+ta11": (ta01_11, (1, 1)),
    "pad16": (lambda: ti.stack_instances([ti.get_instance("ta01")], jobs_pad=16, machines_pad=16), (1, 1)),
    "mix6x40+2x35": (_mixed((6, 40), (2, 35)), (1, 2)),
    "mix40x3+3x5": (_mixed((40, 3), (3, 5)), (2, 1)),
    "mix40x3+2x40": (_mixed((40, 3), (2, 40)), (2, 2)),
    "mix70x4+3x3": (_mixed((70, 4), (3, 3)), (3, 1)),
    "mix70x4+2x33": (_mixed((70, 4), (2, 33)), (3, 2)),
    "mix100x3+3x5": (_mixed((100, 3), (3, 5)), (4, 1)),
    "mix100x3+2x40": (_mixed((100, 3), (2, 40)), (4, 2)),
}

# case -> (instance source, B, T, static shape or None (a padded batch), the
# runs: (build, storage type, random words)); Philox words are drawn with
# lane_offset 5. Together the runs cover the three builds ("static",
# "slots": general_lane.cu, "general": rollout.cu, whose storage type alone
# is int32 or int16; the register builds read the fields), Philox and bits,
# and every slot class on a padded batch.
I32, I16 = torch.int32, torch.int16
CASES = {
    "ta01": (lambda: ti.get_instance("ta01"), 8, 300, (15, 15),
             (("static", I16, "philox"), ("static", I32, "bits"), ("general", I16, "bits"),
              ("general", I32, "philox"), ("slots", I16, "philox"))),
    "rand6x5": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 8, 300, (6, 5),
                (("static", I32, "philox"), ("static", I16, "bits"), ("general", I16, "philox"))),
    "2x2": (lambda: ti.random_instance(2, 2, (1, 9), seed=5), 8, 60, (2, 2),
            (("static", I16, "philox"), ("static", I32, "bits"), ("general", I32, "philox"))),
    "ta41": (lambda: ti.get_instance("ta41"), 4, 200, (30, 20),
             (("static", I32, "philox"), ("static", I32, "bits"), ("general", I32, "bits"))),
    # two job slots a thread (J = 40); two machine words (M = 40)
    "rand40x3": (lambda: ti.random_instance(40, 3, (1, 9), seed=7), 4, 300, (40, 3), (("static", I16, "philox"),)),
    "rand3x40": (lambda: ti.random_instance(3, 40, (1, 9), seed=8), 4, 300, (3, 40), (("static", I16, "bits"),)),
    # a ragged batch of two shapes, padded
    "ta01+ta41": (lambda: ti.get_instance_set(["ta01", "ta41"]), 4, 300, None,
                  (("general", I32, "philox"), ("general", I32, "bits"), ("slots", I32, "philox"),
                   ("slots", I32, "bits"))),
    "ta01+ta11": (ta01_11, 8, 300, None, (("slots", I16, "philox"), ("slots", I32, "bits"), ("general", I16, "bits"))),
    "pad16": (MIXED["pad16"][0], 8, 300, None, (("slots", I32, "philox"), ("slots", I16, "bits"))),
    # every other slot class, on a batch of two random shapes
    **{name: (MIXED[name][0], 4, 300, None, (("slots", I16, "philox"), ("slots", I32, "bits")))
       for name in MIXED if name.startswith("mix")},
    # mid-episode starts (START)
    "ta01-mid": (lambda: ti.get_instance("ta01"), 8, 300, (15, 15), (("static", I16, "philox"), ("static", I32, "bits"))),
    "ta41-mid": (lambda: ti.get_instance("ta41"), 4, 300, (30, 20), (("static", I32, "philox"),)),
    "rand6x5-mid": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 8, 300, (6, 5), (("static", I16, "bits"),)),
    "ta01+ta11-mid": (ta01_11, 8, 300, None, (("slots", I16, "philox"), ("slots", I32, "bits"))),
    "mix100x3+2x40-mid": (MIXED["mix100x3+2x40"][0], 4, 300, None, (("slots", I16, "bits"),)),
    # states whose fields are views of a larger batch (SLICED): a leading
    # slice, contiguous at an offset (the form of the benchmark's half-batch
    # fault), read where it lies; a strided one, copied first
    "ta01-half": (lambda: ti.get_instance("ta01"), 16, 300, (15, 15),
                  (("static", I32, "philox"), ("static", I32, "bits"), ("general", I16, "bits"))),
    "ta01+ta11-strided": (ta01_11, 16, 300, None, (("slots", I32, "philox"), ("general", I32, "philox"))),
    # rollout.cu past 64 machines: 3 machine slots a thread (M = 70), 4 (M =
    # 100), and five job slots with three machine slots (150x70, int32 only)
    "wide4x70": (lambda: ti.random_instance(4, 70, (1, 9), seed=3), 4, 300, (4, 70),
                 (("general", I32, "philox"), ("general", I16, "bits"))),
    "wide4x70-mid": (lambda: ti.random_instance(4, 70, (1, 9), seed=3), 4, 300, (4, 70),
                     (("general", I16, "philox"), ("general", I32, "bits"))),
    "wide3x100-mid": (lambda: ti.random_instance(3, 100, (1, 9), seed=4), 4, 300, (3, 100),
                      (("general", I16, "philox"), ("general", I32, "bits"))),
    "wide150x70": (lambda: ti.random_instance(150, 70, (1, 9), seed=5), 2, 150, (150, 70),
                   (("general", I32, "philox"), ("general", I32, "bits"))),
}
# case -> (driven steps, seed of the random legal actions) before the free
# rollout starts: every lane mid-episode, with no-op pins in some
START = {"ta01-mid": (150, 0), "ta41-mid": (450, 1), "rand6x5-mid": (47, 0), "ta01+ta11-mid": (150, 2),
         "mix100x3+2x40-mid": (160, 3), "wide4x70-mid": (150, 4), "wide3x100-mid": (160, 5),
         "ta01-half": (150, 6), "ta01+ta11-strided": (150, 7)}
# case -> the slice of the batch its runs take, every field a view
SLICED = {"ta01-half": slice(None, 8), "ta01+ta11-strided": slice(None, None, 3)}
TIME_LIMIT_S = 90  # a case's process; each takes 2-8 s alone
LANE_OFFSET = 5

# driven case -> (instance source, B, driven steps before the window (0: a
# fresh state), seed of its actions, kind of actions in the window). Every
# case runs T = 0, 1 and 40 on the full and the light state. The job slots a
# thread: one (J = 6, 15, 30), two (40), three (70), four (100); two machine
# words at M = 40. The mid-episode windows cross episode ends. "any" actions
# are drawn from [-2, J + 2) whatever the mask: waits, illegal allocations
# and a negative id (engine.step clamps it to job 0).
DRIVEN = {
    "d-ta01": (lambda: ti.get_instance("ta01"), 8, 0, 1, "legal"),
    "d-ta01-mid": (lambda: ti.get_instance("ta01"), 8, 235, 2, "legal"),
    "d-rand6x5": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 8, 0, 3, "legal"),
    "d-rand6x5-any": (lambda: ti.random_instance(6, 5, (1, 9), seed=3), 6, 20, 4, "any"),
    "d-ta41-mid": (lambda: ti.get_instance("ta41"), 4, 650, 5, "legal"),
    "d-rand40x3-mid": (lambda: ti.random_instance(40, 3, (1, 9), seed=7), 4, 105, 6, "legal"),
    "d-rand70x4-mid": (lambda: ti.random_instance(70, 4, (1, 9), seed=9), 4, 265, 7, "legal"),
    "d-rand100x3-mid": (lambda: ti.random_instance(100, 3, (1, 9), seed=10), 4, 285, 8, "legal"),
    "d-rand6x40-mid": (lambda: ti.random_instance(6, 40, (1, 9), seed=11), 4, 225, 9, "legal"),
    # the slot-class build (general_lane.cu) on padded and mixed batches
    "g-ta01+ta11": (ta01_11, 8, 0, 11, "legal"),
    "g-ta01+ta11-mid": (ta01_11, 8, 235, 12, "legal"),
    "g-ta01+ta41-mid": (lambda: ti.get_instance_set(["ta01", "ta41"]), 4, 250, 13, "legal"),
    "g-pad16-any": (MIXED["pad16"][0], 6, 20, 14, "any"),
    **{f"g-{name}-mid": (MIXED[name][0], 4, 120, 15 + i, "legal") for i, name in enumerate(MIXED)
       if name.startswith("mix")},
    # rollout.cu's general build past 64 machines (its lane buffer, _to_lanes
    # / _from_lanes): 3 and 4 machine slots a thread, the mid-episode windows
    # across episode ends (random-legal episodes of 4x70 and 3x100 take about
    # 280 and 300 steps), and 150x70 (five job slots) fresh
    "r-wide4x70": (lambda: ti.random_instance(4, 70, (1, 9), seed=3), 4, 0, 31, "legal"),
    "r-wide4x70-mid": (lambda: ti.random_instance(4, 70, (1, 9), seed=3), 4, 255, 32, "legal"),
    "r-wide3x100-mid": (lambda: ti.random_instance(3, 100, (1, 9), seed=4), 4, 278, 33, "legal"),
    "r-wide4x70-any": (lambda: ti.random_instance(4, 70, (1, 9), seed=3), 3, 270, 34, "any"),
    "r-wide150x70": (lambda: ti.random_instance(150, 70, (1, 9), seed=5), 2, 0, 35, "legal"),
}
DRIVEN_T = (0, 1, 40)
# the padded driven case held against the JAX package at B >= 1024: a mixed
# set of two small shapes, so that every lane ends episodes in the window
JAX_PADDED = (_mixed((4, 3), (3, 2)), 1024, 30)


def _source(name):
    """(C++ text of the source's device part) of csrc/<name>.cu."""
    text = (CSRC / f"{name}.cu").read_text()
    device = text.split("// ---- host side")[0]
    return device.replace("#include <cuda_runtime.h>", '#include "shim.h"')


def _driven_shape(case):
    """The static shape of a driven case, the slot class of a ``g-`` one or
    the machine-slot class of an ``r-`` one (rollout.cu)."""
    spec = DRIVEN[case][0]()
    if case.startswith("g-"):
        return fr.slot_class(*np.asarray(spec.op_dur).shape[1:])
    if case.startswith("r-"):
        return fr.machine_slots(spec.num_machines)
    return spec.num_jobs, spec.num_machines


def _lib_name(name, shape):
    if name == "rollout":  # a machine-slot class
        return "librollout_general.so" if shape == 2 else f"librollout_m{shape}.so"
    return f"lib{name}_{shape[0]}x{shape[1]}.so"


def build(libdir: Path) -> dict:
    """Compile the general libraries (``ROLLOUT_CLASSES``) and one static
    library per shape of CASES (free) and of DRIVEN (driven) that the static
    builds take, every g++ started together; returns {(source, shape or
    class): path}."""
    libdir.mkdir(parents=True, exist_ok=True)
    (libdir / "shim.h").write_text(SHIM)
    jobs = {("rollout", k): GENERAL_ENTRY for k in ROLLOUT_CLASSES}
    for _, _, _, shape, _ in CASES.values():
        if fr.static_fits(shape):
            jobs["free_static", shape] = STATIC_ENTRY
    for case in DRIVEN:
        if not case.startswith(("g-", "r-")):
            jobs["driven_static", _driven_shape(case)] = DRIVEN_ENTRY
    for slots in SLOT_CLASSES:
        jobs["general_lane", slots] = LANE_ENTRY
    procs, out = [], {}
    for (name, shape), entry in jobs.items():
        if name == "rollout":
            tag = _lib_name(name, shape)[len("librollout_"):-len(".so")]
            defs = [f"-D{d}" for d in fr.rollout_defines(shape)]
        else:
            tag = f"{shape[0]}x{shape[1]}"
            defs = [f"-D{d}" for d in fr.slot_defines(shape)] if name == "general_lane" else [
                f"-DJSS_STATIC_J={shape[0]}", f"-DJSS_STATIC_M={shape[1]}"]
        cpp, lib = libdir / f"{name}_{tag}.cpp", libdir / f"lib{name}_{tag}.so"
        cpp.write_text(_source(name) + entry)
        cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{CSRC}", *defs, "-o", str(lib), str(cpp)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        out[name, shape] = lib
    for cmd, p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"{' '.join(cmd)}\n{log}"
    return out


def _run_lib(lib, state, T, vdt, seed, bits, lane_offset, build):
    """One launch of the shim library of ``build`` ("static", "slots" or
    "general": rollout.cu) on the port's kernel inputs: the register builds
    on the state's own fields (``fused_rollout._free_inputs``, no storage
    type: ``vdt`` is rollout.cu's), rollout.cu on its lane buffer in
    ``vdt``; per-lane stats as ``fused_rollout._free_kernel`` returns
    them."""
    B = state.batch_size
    tab, lanec = fr._lane_inputs(state)
    stats = torch.zeros((4, B), dtype=torch.int64)
    ret = torch.zeros((B,), dtype=torch.float32)
    P, I = ctypes.c_void_p, ctypes.c_int
    tail = [tab.data_ptr(), lanec.data_ptr(), None if bits is None else bits.data_ptr(), seed & (2**64 - 1),
            stats.data_ptr(), ret.data_ptr(), B]
    if build == "general":
        buf = fr._to_lanes(state, with_solution=False, vdt=vdt)
        geo = fr.launch_geometry(state.jobs_pad, state.machines_pad, vdt)
        args = [buf.data_ptr(), *tail, state.jobs_pad, state.machines_pad, T, lane_offset, geo.lanes,
                geo.state_stride, geo.scratch_stride, int(vdt == torch.int16)]
        lib.shim_free.argtypes = [P, P, P, P, ctypes.c_ulonglong, P, P] + [I] * (len(args) - 7)
    else:  # the entry point's own signature, JSS_FREE_PARAMS
        inputs = fr._free_inputs(state)
        args = [t.data_ptr() for t in inputs] + tail + [state.jobs_pad, state.machines_pad, T, lane_offset]
        lib.shim_free.argtypes = fr._FREE_ARGTYPES[:-1]
    lib.shim_free.restype = I
    lib.shim_free(*args)
    return {"episodes": stats[0], "mk_sum": stats[1], "mk_min": stats[2], "viol": stats[3], "ret": ret}


def _run_driven(lib, state, actions, T, slots=False):
    """One launch of the shim's driven library (static, or a slot class's) on
    the port's kernel inputs and output allocations; returns (new state,
    rewards, ends, the uint8 allocation of the masks)."""
    B = state.batch_size
    if slots == "rollout":
        return _run_driven_lanes(lib, state, actions, T)
    tab, lanec = fr._lane_inputs(state)
    inputs = fr._driven_inputs(state)
    out, out8, new, rewards, ends = fr._driven_outputs(state, T)
    ptrs = [t.data_ptr() for t in inputs] + [tab.data_ptr(), lanec.data_ptr(), actions.data_ptr(),
                                             out.data_ptr(), out8.data_ptr()]
    dims = [state.jobs_pad, state.machines_pad] if slots else []
    lib.shim_driven.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * (3 + len(dims))
    lib.shim_driven.restype = ctypes.c_int
    lib.shim_driven((ctypes.c_void_p * len(ptrs))(*ptrs), B, *dims, T, int(fr._solution_mode(state)))
    return new, rewards, ends, out8


def _run_driven_lanes(lib, state, actions, T):
    """One launch of rollout.cu's driven kernel on the lane buffer, as
    ``fused_rollout._driven_kernel``'s ``"rollout"`` build packs and unpacks
    it; returns (new state, rewards, ends, the new masks as bytes)."""
    B, J, M, ws = state.batch_size, state.jobs_pad, state.machines_pad, fr._solution_mode(state)
    geo = fr.launch_geometry(J, M)
    buf = fr._to_lanes(state, ws)
    tab, lanec = fr._lane_inputs(state)
    rewards = torch.zeros((T, B), dtype=torch.int32)
    ends = torch.zeros((T, B), dtype=torch.int32)
    I = ctypes.c_int
    lib.shim_driven.argtypes = [ctypes.c_void_p] * 6 + [I] * 8
    lib.shim_driven.restype = I
    lib.shim_driven(buf.data_ptr(), tab.data_ptr(), lanec.data_ptr(), actions.data_ptr(), rewards.data_ptr(),
                    ends.data_ptr(), B, J, M, T, int(ws), geo.lanes, geo.state_stride, geo.scratch_stride)
    new = fr._from_lanes(buf, state, ws)
    masks = torch.cat([getattr(new, k).reshape(-1).view(torch.uint8) for k in fr._DRIVEN_U8])
    return new, rewards, ends, masks


def _window_actions(state, T, seed, kind):
    """(T, B) int32 actions for the window: the twin's own trajectory under
    random legal actions, or ids drawn from [-2, J + 2) whatever the mask."""
    if kind == "any":
        g = np.random.default_rng(seed)
        return torch.from_numpy(g.integers(-2, state.jobs_pad + 2, size=(T, state.batch_size)).astype(np.int32))
    g = torch.Generator().manual_seed(seed)
    acts = []
    for _ in range(T):
        acts.append(tv.random_legal_actions(g, state).to(torch.int32))
        state, _ = fr.rollout_driven_reference(state, acts[-1][None], 1)
    return torch.stack(acts) if acts else torch.zeros((0, state.batch_size), dtype=torch.int32)


def driven_window(case):
    """The case's start state and its (max T, B) actions."""
    src, B, steps, seed, kind = DRIVEN[case]
    state = tv.make_batch(src(), B, device="cpu")
    if steps:
        state = driven_start(state, steps, seed)
    return state, _window_actions(state, max(DRIVEN_T), seed + 100, kind)


def run_driven_case(libdir: str, case: str) -> None:
    """The body of one driven case (a process of its own): T = 0, 1 and 40
    on the full and the light state, each against the twin."""
    torch.set_num_threads(1)
    start, acts = driven_window(case)
    slots = {"g": True, "r": "rollout"}.get(case[0], False)
    build = fr.driven_build(start)
    if slots == "rollout":
        assert build == fr.rollout_build(start.machines_pad) and build.shape == _driven_shape(case), build
        name = "rollout"
    else:
        assert build == fr.Build("slots" if slots else "static", _driven_shape(case)), build
        name = "general_lane" if slots else "driven_static"
    lib = ctypes.CDLL(str(Path(libdir) / _lib_name(name, _driven_shape(case))))
    ended = 0
    for state in (start, tv.strip_solution(start)):
        for T in DRIVEN_T:
            a = acts[:T].contiguous()
            before = {k: v.clone() for k, v in state.dynamic_fields().items()}
            new, rewards, ends, out8 = _run_driven(lib, state, a, T, slots)
            ref, ref_raw, ref_ends = fr.rollout_driven_reference(state, a, T, return_ends=True)
            tag = f"{case} T={T} {'light' if state.solution.shape[1] == 0 else 'full'}"
            assert torch.equal(rewards, ref_raw), f"{tag}: rewards {rewards.tolist()} != {ref_raw.tolist()}"
            assert torch.equal(ends, ref_ends), f"{tag}: ends {ends.tolist()} != {ref_ends.tolist()}"
            for k in ts.FIELD_NAMES:
                got, want = getattr(new, k), getattr(ref, k)
                assert got.dtype == want.dtype and torch.equal(got, want), f"{tag}: {k} {got.tolist()} != {want.tolist()}"
            assert all(torch.equal(getattr(state, k), v) for k, v in before.items()), f"{tag}: the input changed"
            assert int(out8.max()) <= 1, f"{tag}: a mask byte other than 0 and 1"
            ended += int((ref_ends > 0).sum())
            print(f"{tag}: equal to the twin ({int((ref_ends > 0).sum())} episode ends)")
    assert ended > 0 or DRIVEN[case][2] == 0 and case != "d-rand6x5", f"{case}: no episode ended in the window"


def run_driven_jax_case(libdir: str, out: str, padded: bool = False, case: str = "d-rand6x5") -> None:
    """The ``case`` window at T = 40 on the full state (``padded``: the
    ``JAX_PADDED`` batch through the slot-class build): the shim's results,
    saved to ``out`` (npz) for the test process to hold against JAX."""
    torch.set_num_threads(1)
    if case.startswith("r-"):
        state, acts = driven_window(case)
        lib = ctypes.CDLL(str(Path(libdir) / _lib_name("rollout", _driven_shape(case))))
        padded = "rollout"
    elif padded:
        src, B, T = JAX_PADDED
        state = tv.make_batch(src(), B, device="cpu")
        acts = _window_actions(state, T, 7, "legal")
        lib = ctypes.CDLL(str(Path(libdir) / _lib_name("general_lane", fr.driven_build(state).shape)))
    else:
        state, acts = driven_window("d-rand6x5")
        lib = ctypes.CDLL(str(Path(libdir) / "libdriven_static_6x5.so"))
    new, rewards, ends, _ = _run_driven(lib, state, acts.contiguous(), acts.shape[0], padded)
    np.savez(out, actions=acts.numpy(), rewards=rewards.numpy(), ends=ends.numpy(),
             **{f"state_{k}": v for k, v in ts.to_numpy(new).items()})


def _lib(libdir, build, state):
    """The shim library of ``build`` ("static", "slots", "general") for
    ``state``."""
    if build == "general":
        return ctypes.CDLL(str(Path(libdir) / _lib_name("rollout", fr.machine_slots(state.machines_pad))))
    b = fr.free_build(state, build)
    return ctypes.CDLL(str(Path(libdir) / _lib_name("free_static" if build == "static" else "general_lane", b.shape)))


def run_case(libdir: str, case: str) -> None:
    """The body of one case (a process of its own): each of its runs
    against the twin on the same words."""
    torch.set_num_threads(1)
    src, B, T, shape, runs = CASES[case]
    state = tv.make_batch(src(), B, device="cpu")
    if case in START:
        state = driven_start(state, *START[case])
    if case in SLICED:
        whole = state
        state = state.replace(**{k: getattr(state, k)[SLICED[case]] for k in vars(state)})
        B = state.batch_size
        assert all(getattr(state, k)._base is getattr(whole, k) for k in vars(state))
        assert state.time.is_contiguous() == (case == "ta01-half")
    assert fr.static_shape(state) == shape
    bits = torch.from_numpy(np.random.default_rng(11).integers(-(2**31), 2**31, size=(T, B)).astype(np.int32))
    words = {"philox": (97, None, LANE_OFFSET), "bits": (0, bits, 0)}
    refs = {}
    for build_, vdt, mode in runs:
        assert vdt == torch.int32 or fr.value_dtype(state) == torch.int16, f"{case} does not fit int16"
        if mode not in refs:
            refs[mode] = fr.free_lane_stats_reference(state, T, *words[mode])
            # a mid-episode start's first episode misses the rewards before it
            assert case in START or int(refs[mode]["viol"].sum()) == 0
        ref = refs[mode]
        got = _run_lib(_lib(libdir, build_, state), state, T, vdt, *words[mode], build_)
        tag = f"{case} {build_} {vdt} {mode}"
        for f in ref:
            assert torch.equal(got[f], ref[f]), f"{tag}: {f} {got[f].tolist()} != {ref[f].tolist()}"
        print(f"{tag}: equal to the twin ({int(ref['episodes'].sum())} episodes)")
    # ta41 and 150x70 take longer than T for a random-legal episode
    assert sum(int(r["episodes"].sum()) for r in refs.values()) > 0 or case in ("ta41", "wide150x70"), \
        f"{case}: no episode ended"


def run_dead_fields(libdir: str) -> None:
    """A scrambled op_end_at, idle_frozen, idle_total_alloc and wait4 leave
    the static kernel's stats as they were, from a fresh state and from one
    mid-episode: it reads none of them."""
    torch.set_num_threads(1)
    fresh = tv.make_batch(ti.get_instance("ta01"), 4, device="cpu")
    lib = _lib(libdir, "static", fresh)
    for state in (fresh, driven_start(fresh, *START["ta01-mid"])):
        want = _run_lib(lib, state, 120, torch.int32, 3, None, 0, "static")
        g = torch.Generator().manual_seed(1)
        junk = {f: torch.randint(-999, 999, getattr(state, f).shape, dtype=torch.int32, generator=g)
                for f in ("op_end_at", "idle_frozen", "idle_total_alloc", "wait4")}
        got = _run_lib(lib, state.replace(**junk), 120, torch.int32, 3, None, 0, "static")
        assert all(torch.equal(got[f], want[f]) for f in want)
        ref = fr.free_lane_stats_reference(state, 120, 3, None, 0)
        assert all(torch.equal(want[f], ref[f]) for f in ref)


def _in_process(libdir, case, *extra):
    """Run ``case`` in a process of this file, under its time limit."""
    try:
        proc = subprocess.run([sys.executable, __file__, str(libdir), case, *extra], capture_output=True, text=True,
                              timeout=TIME_LIMIT_S, env=dict(os.environ, OMP_NUM_THREADS="1"))
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"{case}: no result in {TIME_LIMIT_S} s (a hung warp collective?)\n{e.stdout}")
    assert proc.returncode == 0, f"{case}:\n{proc.stdout}\n{proc.stderr}"


@pytest.fixture(scope="module")
def libdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kernel_shim")
    build(d)
    return d


def test_shim_builds_one_library_per_shape(libdir):
    names = sorted(p.name for p in libdir.glob("*.so"))
    shapes = sorted({f"{c[3][0]}x{c[3][1]}" for c in CASES.values() if fr.static_fits(c[3])})
    driven = sorted({"{}x{}".format(*_driven_shape(c)) for c in DRIVEN if not c.startswith(("g-", "r-"))})
    assert names == sorted([_lib_name("rollout", k) for k in ROLLOUT_CLASSES]
                           + [f"libfree_static_{s}.so" for s in shapes]
                           + [f"libdriven_static_{s}.so" for s in driven]
                           + [_lib_name("general_lane", s) for s in SLOT_CLASSES])
    # the wide cases meet every machine-slot class built past the default
    wide = {fr.machine_slots(c[0]().num_machines) for n, c in DRIVEN.items() if n.startswith("r-")}
    assert wide | {2} == set(ROLLOUT_CLASSES)
    assert {fr.machine_slots(CASES[n][3][1]) for n in CASES if n.startswith("wide")} | {2} == set(ROLLOUT_CLASSES)
    # the padded cases meet every slot class, and each case's its own
    for name, (src, slots) in MIXED.items():
        assert fr.driven_build(tv.make_batch(src(), 2, device="cpu")) == fr.Build("slots", slots), name
    assert sorted(s for _, s in MIXED.values())[1:] == sorted(SLOT_CLASSES)
    assert {_driven_shape(c) for c in DRIVEN if c.startswith("g-")} == set(SLOT_CLASSES)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_matches_twin_on_cpu(libdir, case):
    _in_process(libdir, case)


@pytest.mark.parametrize("case", list(DRIVEN))
def test_driven_kernel_source_matches_twin_on_cpu(libdir, case):
    _in_process(libdir, case)


def test_driven_kernel_source_matches_jax_on_cpu(libdir, tmp_path):
    """The shim's d-rand6x5 window at T = 40 (episode ends inside) equals the
    JAX package's ``rollout_driven`` in interpret mode: rewards and every
    field of the final state."""
    pytest.importorskip("flax")
    import jax

    from jssenv_tpu import instances as ji
    from jssenv_tpu import vector as jv
    from jssenv_tpu.core import pallas_rollout

    out = tmp_path / "driven_6x5.npz"
    _in_process(libdir, "driven-jax", str(out))
    got = dict(np.load(out))
    src, B = DRIVEN["d-rand6x5"][:2]
    build_ = lambda m: m.stack_instances([m.random_instance(6, 5, (1, 9), seed=3)])  # noqa: E731
    js = jv.make_batch(build_(ji), B)
    T = got["actions"].shape[0]
    jfinal, jraw = pallas_rollout.rollout_driven(js, jax.numpy.asarray(got["actions"]), T, tile=4, interpret=True)
    np.testing.assert_array_equal(got["rewards"], np.asarray(jraw))
    assert int((got["ends"] > 0).sum()) > 0
    for k, v in vars(jax.device_get(jfinal)).items():
        np.testing.assert_array_equal(got[f"state_{k}"], np.asarray(v), err_msg=k)


def test_padded_driven_kernel_source_matches_jax_on_cpu(libdir, tmp_path):
    """The slot-class build on ``JAX_PADDED`` (two shapes padded to one, B =
    1024, episodes ending in the window) equals the JAX package's
    ``rollout_driven`` in interpret mode, which takes ``static_lane=None`` on
    such a batch: rewards and every field of the final state, exactly."""
    pytest.importorskip("flax")
    import jax

    from jssenv_tpu import instances as ji
    from jssenv_tpu import vector as jv
    from jssenv_tpu.core import pallas_rollout

    out = tmp_path / "driven_padded.npz"
    _in_process(libdir, "driven-jax-padded", str(out))
    got = dict(np.load(out))
    _, B, T = JAX_PADDED
    js = jv.make_batch(ji.stack_instances([ji.random_instance(4, 3, (1, 9), seed=20),
                                           ji.random_instance(3, 2, (1, 9), seed=21)]), B)
    jfinal, jraw = pallas_rollout.rollout_driven(js, jax.numpy.asarray(got["actions"]), T, tile=B // 2,
                                                 interpret=True)
    np.testing.assert_array_equal(got["rewards"], np.asarray(jraw))
    assert int((got["ends"] > 0).sum()) > B
    for k, v in vars(jax.device_get(jfinal)).items():
        np.testing.assert_array_equal(got[f"state_{k}"], np.asarray(v), err_msg=k)


def test_wide_driven_kernel_source_matches_jax_on_cpu(libdir, tmp_path):
    """rollout.cu's general build at 70 machines (three machine slots a
    thread) on the ``r-wide4x70`` window, T = 40 from a fresh state, equals
    the JAX package's ``rollout_driven`` in interpret mode: rewards and every
    field of the final state, exactly."""
    pytest.importorskip("flax")
    import jax

    from jssenv_tpu import instances as ji
    from jssenv_tpu import vector as jv
    from jssenv_tpu.core import pallas_rollout

    out = tmp_path / "driven_wide.npz"
    _in_process(libdir, "driven-jax-wide", str(out))
    got = dict(np.load(out))
    B, T = DRIVEN["r-wide4x70"][1], got["actions"].shape[0]
    js = jv.make_batch(ji.stack_instances([ji.random_instance(4, 70, (1, 9), seed=3)]), B)
    jfinal, jraw = pallas_rollout.rollout_driven(js, jax.numpy.asarray(got["actions"]), T, tile=4, interpret=True)
    np.testing.assert_array_equal(got["rewards"], np.asarray(jraw))
    for k, v in vars(jax.device_get(jfinal)).items():
        np.testing.assert_array_equal(got[f"state_{k}"], np.asarray(v), err_msg=k)


def test_static_kernel_reads_no_dead_field_on_cpu(libdir):
    _in_process(libdir, "dead-fields")


def test_draw_modulo_without_division_on_cpu(libdir):
    """free_static.cu's x mod d by a multiply-high (every divisor the draw
    meets at J = 128, x < 2^31) equals the remainder."""
    src = (CSRC / "free_static.cu").read_text().split("// ---- host side")[0]
    cpp = libdir / "mod_small_128.cpp"
    cpp.write_text(src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
                   + 'extern "C" int shim_mod_small(unsigned x, int d) { return mod_small(x, d); }\n')
    lib = libdir / "libmod_small_128.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{CSRC}", "-DJSS_STATIC_J=128",
                    "-DJSS_STATIC_M=2", "-o", str(lib), str(cpp)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).shim_mod_small
    fn.argtypes, fn.restype = [ctypes.c_uint, ctypes.c_int], ctypes.c_int
    xs = np.concatenate([np.random.default_rng(0).integers(0, 2**31, 300), np.arange(64), 2**31 - 1 - np.arange(64),
                         2**np.arange(31), 2**np.arange(1, 31) - 1])
    bad = [(int(x), d) for d in range(1, 130) for x in xs if fn(int(x), d) != int(x) % d]
    assert not bad, bad[:10]


if __name__ == "__main__":
    if sys.argv[2] == "dead-fields":
        run_dead_fields(sys.argv[1])
    elif sys.argv[2] == "driven-jax":
        run_driven_jax_case(sys.argv[1], sys.argv[3])
    elif sys.argv[2] == "driven-jax-padded":
        run_driven_jax_case(sys.argv[1], sys.argv[3], padded=True)
    elif sys.argv[2] == "driven-jax-wide":
        run_driven_jax_case(sys.argv[1], sys.argv[3], case="r-wide4x70")
    elif sys.argv[2] in DRIVEN:
        run_driven_case(sys.argv[1], sys.argv[2])
    else:
        run_case(sys.argv[1], sys.argv[2])

// The driven rollout on the register lane (static_lane.cuh's Lane<true>):
// the kernel body shared by driven_static.cu (built per static shape) and
// general_lane.cu (built per slot class, for padded and mixed-shape
// batches). T steps of engine.step on the caller's (T, B) actions, each
// finished lane reset (vector.step_autoreset); it writes the (T, B) raw
// rewards, the (T, B) episode ends (the makespan where a lane finished at
// that step, else 0) and a new state.
//
// I/O. The kernel reads the dynamic fields where the EnvState holds them,
// batch-first ((B,), (B, J), (B, M), (B, J, M); masks as torch.bool bytes),
// so a lane's row of a field is contiguous and a warp's read of it
// coalesced; there is no batch-last staging buffer and no copy back. It
// writes a new state, whose int32 fields (then the rewards and the ends) are
// views of one int32 allocation and whose masks are views of one uint8
// allocation (fused_rollout._driven_outputs; the order is Out's below); the
// input tensors are never written. Each lane's solution is copied into the
// new state, then allocations and resets write there. Masks are written as
// the bytes 0 and 1. A padded lane's rows are those of the padded shape
// (J, M), its padded jobs and solution cells written back as they were read.

#pragma once
#include "static_lane.cuh"

namespace {

// The pointers of one launch, passed by value.
struct DrivenIO {
  // the input state's dynamic fields (read only)
  const int *time, *nb_legal, *nb_ml, *mbf;                      // (B,), (B,), (B,), (B, M)
  const int *jbf, *next_op, *work_done, *needed;                 // (B, J) each
  const int *op_end_at, *idle_frozen, *idle_total, *wait4;       // (B, J) each
  const int* solution;                                           // (B, J, M), or unread (light)
  const uint8_t *noop_legal, *legal, *noop_pin, *ml;             // (B,), (B, J), (B, J), (B, M)
  const int *tab, *lanec, *actions;                              // tables, lane constants, (T, B)
  int* out;      // the new state's int32 fields, then rewards and ends (Out)
  uint8_t* out8; // the new state's masks (Out8)
  int B, T, with_solution;
  int J, M;      // the padded shape (a static build's own)
};

// Offsets, in int32 elements, of the new state's int32 fields in `out` (the
// order of fused_rollout._DRIVEN_I32), then the (T, B) rewards and ends.
struct Out {
  size_t time, nb_legal, nb_ml, mbf, jbf, next_op, work_done, needed, op_end_at, idle_frozen, idle_total, wait4,
      solution, rewards, ends;
  __device__ Out(const DrivenIO& io, int J, int M) {
    const size_t B = io.B, BJ = B * J;
    time = 0;
    nb_legal = B;
    nb_ml = 2 * B;
    mbf = 3 * B;
    jbf = mbf + B * M;
    next_op = jbf + BJ;
    work_done = next_op + BJ;
    needed = work_done + BJ;
    op_end_at = needed + BJ;
    idle_frozen = op_end_at + BJ;
    idle_total = idle_frozen + BJ;
    wait4 = idle_total + BJ;
    solution = wait4 + BJ;
    rewards = solution + (io.with_solution ? BJ * M : 0);
    ends = rewards + (size_t)io.T * B;
  }
};
// Offsets, in bytes, of the masks in `out8` (fused_rollout._DRIVEN_U8).
struct Out8 {
  size_t noop_legal, legal, noop_pin, ml;
  __device__ Out8(const DrivenIO& io, int J) {
    const size_t B = io.B;
    noop_legal = 0;
    legal = B;
    noop_pin = B + B * J;
    ml = B + 2 * B * J;
  }
};

// The cells of a lane's solution a thread copies: x = r + 32 i for
// i < ceil(JM / 32), kChunk of them at a time with every load of a chunk
// issued before its stores.
#if defined(JSS_STATIC_J)
constexpr int kChunk = (Bounds::JM + 31) / 32 < 8 ? (Bounds::JM + 31) / 32 : 8;
#else
constexpr int kChunk = 8;
#endif

// Lane b's state from the input tensors; its idle_frozen and wait4 rows and
// its solution copied into the new state, where the steps update them. At
// T = 1 a launch is this load and one step, so the loads go out together
// rather than one dependent round trip after another: the first chunk of the
// solution before the state's fields, the op-chain mask's table reads
// unrolled (Lane::load_after's loop waits on each).
__device__ void driven_load(Lane<true>& l, const DrivenIO& io, int b) {
  const int J = l.J, M = l.M, JM = l.JM, sol_iters = (JM + 31) / 32;
  const size_t row = (size_t)b * J;
  const int* src = io.solution + (size_t)b * JM;
  int head[kChunk];
  if (l.sol) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (l.r + 32 * i < JM) head[i] = __ldg(src + l.r + 32 * i);
  }
  l.time = io.time[b];
  l.noop = io.noop_legal[b] != 0;
  l.nb_legal = io.nb_legal[b];
  l.nb_ml = io.nb_ml[b];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = l.r + 32 * s;
    const bool in = l.has_row(s);
    l.jbf[s] = in ? io.jbf[row + j] : 0;
    l.next_op[s] = in ? io.next_op[row + j] : l.nm;
    l.needed[s] = in ? io.needed[row + j] : -1;
    l.work_done[s] = in ? io.work_done[row + j] : 0;
    l.op_end[s] = in ? io.op_end_at[row + j] : 0;
    l.idle_tot[s] = in ? io.idle_total[row + j] : 0;
    l.legal[s] = __ballot_sync(JSS_FULL, in && io.legal[row + j] != 0);
    l.pin[s] = __ballot_sync(JSS_FULL, in && io.noop_pin[row + j] != 0);
    l.last_op[s] = __ballot_sync(JSS_FULL, in && l.next_op[s] == l.nm - 1);
    l.dur[s] = l.m_next[s] = 0;
    l.after[s] = 0;
    if (in) {
      l.idle_frozen[j] = io.idle_frozen[row + j];
      l.wait4[j] = io.wait4[row + j];
    }
    if (l.has_job(s)) {
      l.load_tables(s);
      // the machines of the ops after next_op, the lane's last op excepted
      MMask after = 0;
#pragma unroll 8
      for (int p = 1; p < l.nm - 1; ++p) {
        const int m = clampi(l.tb(T_OM, j, p), 0, M - 1);
        if (p > l.next_op[s]) after |= MMask(1) << m;
      }
      l.after[s] = after;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int m = l.r + 32 * k;
    l.mbf[k] = m < M ? io.mbf[(size_t)b * M + m] : 0;
    l.ml[k] = __ballot_sync(JSS_FULL, m < M && io.ml[(size_t)b * M + m] != 0);
  }
  if (l.sol) {  // cell x by rank x % 32, as every later write of it
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (l.r + 32 * i < JM) l.sol[l.r + 32 * i] = head[i];
    for (int c = kChunk; c < sol_iters; c += kChunk) {
      int v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (c + i < sol_iters && l.r + 32 * (c + i) < JM) v[i] = __ldg(src + l.r + 32 * (c + i));
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (c + i < sol_iters && l.r + 32 * (c + i) < JM) l.sol[l.r + 32 * (c + i)] = v[i];
    }
  }
}

// Lane b's final state into the new state's fields (the rows written as the
// steps went are there already).
__device__ void driven_store(const Lane<true>& l, const DrivenIO& io, const Out& o, const Out8& o8, int b) {
  const int J = l.J, M = l.M;
  int* out = io.out;
  uint8_t* out8 = io.out8;
  const size_t row = (size_t)b * J;
  if (l.r == 0) {
    out[o.time + b] = l.time;
    out[o.nb_legal + b] = l.nb_legal;
    out[o.nb_ml + b] = l.nb_ml;
    out8[o8.noop_legal + b] = (uint8_t)(l.noop != 0);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (!l.has_row(s)) continue;
    const size_t j = row + l.r + 32 * s;
    out[o.jbf + j] = l.jbf[s];
    out[o.next_op + j] = l.next_op[s];
    out[o.work_done + j] = l.work_done[s];
    out[o.needed + j] = l.needed[s];
    out[o.op_end_at + j] = l.op_end[s];
    out[o.idle_total + j] = l.idle_tot[s];
    out8[o8.legal + j] = (uint8_t)((l.legal[s] >> l.r) & 1u);
    out8[o8.noop_pin + j] = (uint8_t)((l.pin[s] >> l.r) & 1u);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int m = l.r + 32 * k;
    if (m >= M) continue;
    out[o.mbf + (size_t)b * M + m] = l.mbf[k];
    out8[o8.ml + (size_t)b * M + m] = (uint8_t)((l.ml[k] >> l.r) & 1u);
  }
}

}  // namespace

// The kernel, written once for both builds and named by the build:
// driven_static_kernel (driven_static.cu) or driven_general_kernel
// (general_lane.cu). T steps of every lane on its (T, B) actions (an action
// >= nj waits, a negative one allocates job 0, as engine.step clamps it),
// finished lanes reset. The actions, rewards and ends go 32 steps at a time:
// rank r loads step t + r's action and keeps step t + r's reward and end, and
// step t takes rank t % 32's action by a shuffle. The body is the kernel's
// own, not a device function's: with a function around it ptxas gave the
// static build of ta71's shape 4 more bytes of spill loads (152 against 148).
#if defined(JSS_STATIC_J)
#define JSS_DRIVEN_KERNEL driven_static_kernel
#else
#define JSS_DRIVEN_KERNEL driven_general_kernel
#endif
__global__ void JSS_LANE_BOUNDS JSS_DRIVEN_KERNEL(const DrivenIO io) {
  const int b = blockIdx.x * kLanes + (int)(threadIdx.x >> 5);
  if (b >= io.B) return;  // the whole warp
  const size_t B = io.B;
  Lane<true> l;
  l.r = threadIdx.x & 31;
  l.bind(io.J, io.M, io.lanec, B, b);
  const Out o(io, l.J, l.M);
  l.tab = io.tab + (size_t)io.lanec[C_INST * B + b] * 4 * l.JM;
  l.mo = io.lanec[C_MO * B + b];
  l.idle_frozen = io.out + o.idle_frozen + (size_t)b * l.J;
  l.wait4 = io.out + o.wait4 + (size_t)b * l.J;
  l.sol = io.with_solution ? io.out + o.solution + (size_t)b * l.JM : nullptr;
  driven_load(l, io, b);
  int* rewards = io.out + o.rewards;
  int* ends = io.out + o.ends;
  int a_mine = 0, raw_mine = 0, end_mine = 0;
  for (int t = 0; t < io.T; ++t) {
    const int q = t & 31;
    if (q == 0 && t + l.r < io.T) a_mine = io.actions[(size_t)(t + l.r) * B + b];
    const int raw = l.step(max(__shfl_sync(JSS_FULL, a_mine, q), 0));
    const bool done = l.nb_legal == 0;
    if (l.r == q) {
      raw_mine = raw;
      end_mine = done ? l.time : 0;
    }
    if ((q == 31 || t == io.T - 1) && l.r <= q) {
      const size_t at = (size_t)(t - q + l.r) * B + b;
      rewards[at] = raw_mine;
      ends[at] = end_mine;
    }
    if (done) l.fresh();
  }
  driven_store(l, io, o, Out8(io, l.J), b);
}

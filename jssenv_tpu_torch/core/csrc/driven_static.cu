// Driven rollout kernel, static build, for NVIDIA Hopper (sm_90a): a lane's
// state in registers for the whole launch, its boolean rows as warp-wide
// bitmasks, read from and written to the EnvState's own batch-first tensors.
//
// Replaces the static build of rollout.cu's rollout_driven_kernel for every
// batch whose lanes are all unpadded (fused_rollout.static_shape) and whose
// shape is within this source's limits (J <= 128, M <= 64; a larger shape
// runs rollout.cu's general build): the counterpart of
// jssenv_tpu/core/pallas_rollout.py's _driven_kernel (:598, pallas_call
// :1119) compiled with _static_lane (:1018) and _fresh_static (:503). T steps
// of engine.step on the caller's (T, B) actions, each finished lane reset
// (vector.step_autoreset); it writes the (T, B) raw rewards, the (T, B)
// episode ends (the makespan where a lane finished at that step, else 0)
// and a new state. Every field is bit-equal to the plain twin,
// fused_rollout.rollout_driven_reference.
//
// Design. The lane and its step math are static_lane.cuh's Lane<true>: one
// env lane on one warp, kLanes lanes a block, each thread's jobs and
// machines in registers, legal / noop_pin / machine_legal as warp-uniform
// words, nothing in shared memory. What the free kernel (free_static.cu) does
// not need and this one returns: op_end_at and idle_total_alloc in registers,
// and idle_frozen, wait4 and the solution written into the new state as they
// change.
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
// the bytes 0 and 1.
//
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W; PERF.md): at T=1, where
// the main paths run it, neither bytes nor operations but each warp's chain
// of dependent memory round trips, times about 3.4 waves of 36 resident warps
// an SM at B=16384: 0.031 ms for a full ta01 state against the 0.0147 ms its
// 1498 bytes a lane each way (60% of them the solution) take at the card's
// memory rate. So the load issues its reads together (see load()); more
// warps with fewer registers spilled and ran slower. At large T the
// instructions each step issues, as in the free kernel.

#include <cuda_runtime.h>
#include <stdint.h>

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
};

// Offsets, in int32 elements, of the new state's int32 fields in `out` (the
// order of fused_rollout._DRIVEN_I32), then the (T, B) rewards and ends.
struct Out {
  size_t time, nb_legal, nb_ml, mbf, jbf, next_op, work_done, needed, op_end_at, idle_frozen, idle_total, wait4,
      solution, rewards, ends;
  __device__ explicit Out(const DrivenIO& io) {
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
  __device__ explicit Out8(const DrivenIO& io) {
    const size_t B = io.B;
    noop_legal = 0;
    legal = B;
    noop_pin = B + B * J;
    ml = B + 2 * B * J;
  }
};

// The cells of a lane's solution a thread copies: x = r + 32 i for
// i < kSolIters, kChunk of them at a time with every load of a chunk issued
// before its stores.
constexpr int kSolIters = (JM + 31) / 32, kChunk = kSolIters < 8 ? kSolIters : 8;

// Lane b's state from the input tensors; its idle_frozen and wait4 rows and
// its solution copied into the new state, where the steps update them. At
// T = 1 a launch is this load and one step, so the loads go out together
// rather than one dependent round trip after another: the first chunk of the
// solution before the state's fields, the op-chain mask's table reads
// unrolled (Lane::load_after's loop waits on each).
__device__ void load(Lane<true>& l, const DrivenIO& io, int b) {
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
    const bool valid = has_job(s, l.r);
    l.jbf[s] = valid ? io.jbf[row + j] : 0;
    l.next_op[s] = valid ? io.next_op[row + j] : M;
    l.needed[s] = valid ? io.needed[row + j] : -1;
    l.work_done[s] = valid ? io.work_done[row + j] : 0;
    l.op_end[s] = valid ? io.op_end_at[row + j] : 0;
    l.idle_tot[s] = valid ? io.idle_total[row + j] : 0;
    l.legal[s] = __ballot_sync(JSS_FULL, valid && io.legal[row + j] != 0);
    l.pin[s] = __ballot_sync(JSS_FULL, valid && io.noop_pin[row + j] != 0);
    l.last_op[s] = __ballot_sync(JSS_FULL, valid && l.next_op[s] == M - 1);
    l.dur[s] = l.m_next[s] = 0;
    l.after[s] = 0;
    if (valid) {
      l.idle_frozen[j] = io.idle_frozen[row + j];
      l.wait4[j] = io.wait4[row + j];
      l.load_tables(s);
      // the machines of the ops after next_op, the last op excepted
      MMask after = 0;
#pragma unroll 8
      for (int p = 1; p < M - 1; ++p) {
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
    for (int c = kChunk; c < kSolIters; c += kChunk) {
      int v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (c + i < kSolIters && l.r + 32 * (c + i) < JM) v[i] = __ldg(src + l.r + 32 * (c + i));
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (c + i < kSolIters && l.r + 32 * (c + i) < JM) l.sol[l.r + 32 * (c + i)] = v[i];
    }
  }
}

// Lane b's final state into the new state's fields (the rows written as the
// steps went are there already).
__device__ void store(const Lane<true>& l, const DrivenIO& io, const Out& o, const Out8& o8, int b) {
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
    if (!has_job(s, l.r)) continue;
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

// T steps of every lane on its (T, B) actions (an action >= J waits, a
// negative one allocates job 0, as engine.step clamps it), finished lanes
// reset. The actions, rewards and ends go 32 steps at a time: rank r loads
// step t + r's action and keeps step t + r's reward and end, and step t takes
// rank t % 32's action by a shuffle.
__global__ void JSS_LANE_BOUNDS driven_static_kernel(const DrivenIO io) {
  const int b = blockIdx.x * kLanes + (int)(threadIdx.x >> 5);
  if (b >= io.B) return;  // the whole warp
  const size_t B = io.B;
  const Out o(io);
  Lane<true> l;
  l.r = threadIdx.x & 31;
  l.tab = io.tab + (size_t)io.lanec[C_INST * B + b] * 4 * JM;
  l.mo = io.lanec[C_MO * B + b];
  l.idle_frozen = io.out + o.idle_frozen + (size_t)b * J;
  l.wait4 = io.out + o.wait4 + (size_t)b * J;
  l.sol = io.with_solution ? io.out + o.solution + (size_t)b * JM : nullptr;
  load(l, io, b);
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
  store(l, io, o, Out8(io), b);
}

// ---- host side: the C entry points ------------------------------------------

extern "C" {

// This build's shape and lanes a block: the wrapper checks them.
int jss_static_j(void) { return J; }
int jss_static_m(void) { return M; }
int jss_driven_static_lanes(void) { return kLanes; }

// Blocks of the kernel resident on one SM of the current device at once, or
// -1 on a CUDA error.
int jss_driven_static_blocks_per_sm(void) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, driven_static_kernel, kLanes * 32, 0);
  return err == cudaSuccess ? n : -1;
}

// One launch, kLanes lanes a block, no shared memory, on `stream`. The
// pointers are the input state's fields (in DrivenIO's order), the tables,
// the lane constants, the (T, B) actions, and the two output allocations.
// Returns 0 when the kernel launched, else the CUDA error; a shape other than
// this build's is refused (cudaErrorInvalidValue) before anything runs.
int jss_driven_static(const void* time, const void* nb_legal, const void* nb_ml, const void* mbf, const void* jbf,
                      const void* next_op, const void* work_done, const void* needed, const void* op_end_at,
                      const void* idle_frozen, const void* idle_total, const void* wait4, const void* solution,
                      const void* noop_legal, const void* legal, const void* noop_pin, const void* ml,
                      const void* tab, const void* lanec, const void* actions, void* out, void* out8, int B,
                      int J_, int M_, int T, int with_solution, void* stream) {
  if (J_ != J || M_ != M || B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const DrivenIO io{(const int*)time, (const int*)nb_legal, (const int*)nb_ml, (const int*)mbf,
                    (const int*)jbf, (const int*)next_op, (const int*)work_done, (const int*)needed,
                    (const int*)op_end_at, (const int*)idle_frozen, (const int*)idle_total, (const int*)wait4,
                    (const int*)solution, (const uint8_t*)noop_legal, (const uint8_t*)legal,
                    (const uint8_t*)noop_pin, (const uint8_t*)ml, (const int*)tab, (const int*)lanec,
                    (const int*)actions, (int*)out, (uint8_t*)out8, B, T, with_solution};
  driven_static_kernel<<<(B + kLanes - 1) / kLanes, kLanes * 32, 0, (cudaStream_t)stream>>>(io);
  return (int)cudaGetLastError();
}

}  // extern "C"

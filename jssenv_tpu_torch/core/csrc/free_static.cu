// Free rollout kernel, static build, for NVIDIA Hopper (sm_90a): a lane's
// state in registers for the whole launch, its boolean rows as warp-wide
// bitmasks.
//
// Replaces the static build of rollout.cu's rollout_free_kernel<V, J, M> for
// every batch whose lanes are all unpadded (fused_rollout.static_shape) and
// whose shape is within this source's limits (J <= 128, M <= 64; a larger
// shape runs rollout.cu's general build): the counterpart of
// jssenv_tpu/core/pallas_rollout.py's _free_kernel (:653, pallas_call :1214)
// compiled with _static_lane (:1018) and _fresh_static (:503). It computes
// the same function to the bit: the same Philox4x32-10 words (key `seed`,
// counter (step, lane_offset + lane), word 0) or caller bits, the same draw,
// the step math of jssenv_tpu_torch.core.engine.step, the same per-lane stats
// and float32 return (raw / max_time_op summed in step order). The plain twin
// is fused_rollout.free_lane_stats_reference.
//
// Design. The lane and its step math are static_lane.cuh's Lane<false>,
// shared with driven_static.cu: one env lane on one warp, kLanes lanes a
// block, each thread's jobs and machines in registers, legal / noop_pin /
// machine_legal as warp-uniform words, nothing in shared memory. This kernel
// adds the draw (the slot from the words' popcounts, the job by one ballot;
// the modulo a multiply-high by a constant table, mod_small), the Philox
// words and the stats. The state is read once from the (R, B) buffer, so
// int16 or int32 storage matters only at that load; op_end_at, idle_frozen,
// idle_total_alloc and wait4 are not read at all: no decision of a step reads
// them, and the free rollout returns only stats.
//
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W; PERF.md): neither bytes
// nor operations (it takes 21-30x its operations bound), but the
// instructions each step issues. The instrumented build counts 2798 cycles
// of a warp's clock a lane-step at ta01 B=16384 (36 warps an SM):
// check_no_op 41%, fast_forward 24%, the draw 16%, the action's update 8%,
// the reset 7%, prioritization 4% (rollout.cu's static build of this kernel:
// 6915 cycles at 40 warps, check_no_op 45%). More warps with fewer
// registers ran slower (40-64 warps an SM at 32-47 registers: 2-8% slower
// at ta01), so the warps are not short of latency to hide; the SM's issue
// slots are the bound.
//
// -DJSS_PASS_CLOCKS builds an instrumented library of its own (never on the
// main path): clock64() at each pass boundary, summed per lane and pass into
// the (PASSES, B) int64 rows of jss_free_static_clocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "static_lane.cuh"

namespace {

// Rows of the light (R, B) state buffer (fused_rollout._ROWS order).
enum : int {
  R_TIME = 0, R_NOOP = 1, R_NB_LEGAL = 2, R_NB_ML = 3, R_LEGAL = 4,
  R_ML = 4 + J, R_MBF = 4 + J + M, R_JBF = 4 + J + 2 * M, R_NEXT_OP = R_JBF + J,
  R_WORK_DONE = R_JBF + 2 * J, R_NEEDED = R_JBF + 3 * J, R_NOOP_PIN = R_JBF + 7 * J,
};
// Per-lane stats rows of the (4, B) int64 output.
enum : int { S_EPISODES = 0, S_MK_SUM, S_MK_MIN, S_VIOL };

// x mod d for x < 2^31 and 1 <= d <= J + 1 (the draw's divisor) without a
// division: q = floor(x / d) = umulhi(x, m) >> (l - 1) with l = ceil(log2 d)
// and m = ceil(2^(31 + l) / d) < 2^32, exact for every x < 2^31 since
// m d - 2^(31 + l) < d <= 2^l (Granlund and Montgomery, PLDI'94, Thm 4.2).
struct Divisors {
  uint32_t m[J + 2];
  int shift[J + 2];
};
constexpr Divisors make_divisors() {
  Divisors t{};
  for (int d = 2; d <= J + 1; ++d) {
    int l = 0;
    while ((1 << l) < d) ++l;
    t.m[d] = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
    t.shift[d] = l - 1;
  }
  return t;
}
__constant__ Divisors kDivisors = make_divisors();

__device__ __forceinline__ int mod_small(uint32_t x, int d) {
  if (d == 1) return 0;
  if (d > J + 1) return (int)(x % (uint32_t)d);  // a count no engine state holds
  const uint32_t q = __umulhi(x, kDivisors.m[d]) >> kDivisors.shift[d];
  return (int)(x - q * (uint32_t)d);
}

// The uniform-over-legal draw: k = (w >>> 1) mod (nb_legal + noop_legal);
// the k-th legal job in index order, or the no-op (J) when k >= nb_legal.
// The slot that holds it from the words' popcounts, then the one thread
// whose legal job has k legal jobs of that word before it.
__device__ int sample(const Lane<false>& l, uint32_t w) {
  int k = mod_small(w >> 1, max(l.nb_legal + l.noop, 1));
  if (k >= l.nb_legal) return J;
  int hit = S - 1;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    const int c = __popc(l.legal[s]);
    if (hit == S - 1 && k < c) hit = s;
    if (hit == S - 1) k -= c;
  }
  unsigned word = l.legal[0];
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (s == hit) word = l.legal[s];
  const bool mine = ((word >> l.r) & 1u) && __popc(word & ((1u << l.r) - 1u)) == k;
  const unsigned one = __ballot_sync(JSS_FULL, mine);
  return one ? 32 * hit + __ffs(one) - 1 : 0;  // none: nb_legal above the legal jobs, as the twin
}

// The lane's state from the (R, B) buffer of storage type V (row x of lane b
// at src[x * B + b]); the only place V matters.
template <typename V>
__device__ void load(Lane<false>& l, const V* src, int B, int b) {
  auto at = [&](int row) { return (int)src[(size_t)row * B + b]; };
  l.time = at(R_TIME);
  l.noop = at(R_NOOP);
  l.nb_legal = at(R_NB_LEGAL);
  l.nb_ml = at(R_NB_ML);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = l.r + 32 * s;
    const bool valid = has_job(s, l.r);
    l.jbf[s] = valid ? at(R_JBF + j) : 0;
    l.next_op[s] = valid ? at(R_NEXT_OP + j) : M;
    l.needed[s] = valid ? at(R_NEEDED + j) : -1;
    l.work_done[s] = valid ? at(R_WORK_DONE + j) : 0;
    l.legal[s] = __ballot_sync(JSS_FULL, valid && at(R_LEGAL + j) != 0);
    l.pin[s] = __ballot_sync(JSS_FULL, valid && at(R_NOOP_PIN + j) != 0);
    l.last_op[s] = __ballot_sync(JSS_FULL, valid && l.next_op[s] == M - 1);
    l.dur[s] = l.m_next[s] = 0;
    l.after[s] = 0;
    if (valid) {
      l.load_tables(s);
      l.load_after(s);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int m = l.r + 32 * k;
    l.mbf[k] = m < M ? at(R_MBF + m) : 0;
    l.ml[k] = __ballot_sync(JSS_FULL, m < M && at(R_ML + m) != 0);
  }
}

// Philox4x32-10 (Salmon et al., SC'11); returns word 0 for counter
// (t, lane, 0, 0) under the 64-bit key `seed` (rollout.cu's philox_word).
__device__ uint32_t philox_word(unsigned long long seed, uint32_t t, uint32_t lane) {
  uint32_t c0 = t, c1 = lane, c2 = 0, c3 = 0;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

#ifdef JSS_PASS_CLOCKS
__device__ long long* jss_pass_clocks;  // (PASSES, B) int64, set by jss_free_static_clocks
#endif

}  // namespace

// T steps of every lane from its state in `state` ((R, B), read only), the
// uniform-over-legal policy drawn in the kernel, finished lanes reset; the
// per-lane stats (4, B) and float32 returns (B,). The per-step random words
// come 32 steps at a time: rank r draws (or loads) step t + r's and step t
// takes rank t % 32's by a shuffle. `lane_offset`: this batch's first lane in
// a batch split over ranks (the Philox counter takes the global lane).
template <typename V>
__global__ void JSS_LANE_BOUNDS free_static_kernel(const V* state, const int* tab, const int* lanec,
                                                 const uint32_t* bits, unsigned long long seed,
                                                 long long* stats, float* ret_out, int B, int T,
                                                 int lane_offset) {
  const int b = blockIdx.x * kLanes + (int)(threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  Lane<false> l;
  l.r = threadIdx.x & 31;
  l.tab = tab + (size_t)lanec[C_INST * B + b] * 4 * JM;
  l.mo = lanec[C_MO * B + b];
  const int so = lanec[C_SO * B + b];
  load(l, state, B, b);
  const float mo_f = (float)l.mo;
  long long mk_sum = 0;
  int episodes = 0, viol = 0, mk_min = JSS_I32_MAX, ep_raw = 0;
  float ret = 0.f;
  uint32_t w_mine = 0;
#ifdef JSS_PASS_CLOCKS
  l.clk.start();
#endif
  for (int t = 0; t < T; ++t) {
    JSS_PASS(l, PASS_DRAW);
    const int q = t & 31;
    if (q == 0 && t + l.r < T)
      w_mine = bits ? bits[(size_t)(t + l.r) * B + b] : philox_word(seed, t + l.r, (uint32_t)(lane_offset + b));
    const int raw = l.step(sample(l, __shfl_sync(JSS_FULL, w_mine, q)));
    JSS_PASS(l, PASS_RESET);
    ep_raw += raw;
    ret += (float)raw / mo_f;
    if (l.nb_legal == 0) {
      const int mk = l.time;
      ++episodes;
      mk_sum += mk;
      mk_min = min(mk_min, mk);
      if (ep_raw != 2 * so - M * mk) ++viol;
      ep_raw = 0;
      l.fresh();
    }
  }
#ifdef JSS_PASS_CLOCKS
  l.clk.to(PASS_DRAW);
  if (l.r == 0)
    for (int i = 0; i < PASSES; ++i) jss_pass_clocks[(size_t)i * B + b] = l.clk.acc[i];
#endif
  if (l.r == 0) {
    stats[S_EPISODES * (size_t)B + b] = episodes;
    stats[S_MK_SUM * (size_t)B + b] = mk_sum;
    stats[S_MK_MIN * (size_t)B + b] = mk_min;
    stats[S_VIOL * (size_t)B + b] = viol;
    ret_out[b] = ret;
  }
}

// ---- host side: the C entry points ------------------------------------------

// A launch of kLanes lanes a block, no shared memory. Returns 0 or the CUDA
// error; a shape other than this build's is refused (cudaErrorInvalidValue)
// before anything runs.
template <typename V>
static int launch(const void* state, const void* tab, const void* lanec, const void* bits,
                  unsigned long long seed, void* stats, void* ret_out, int B, int J_, int M_, int T,
                  int lane_offset, void* stream) {
  if (J_ != J || M_ != M || B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  free_static_kernel<V><<<(B + kLanes - 1) / kLanes, kLanes * 32, 0, (cudaStream_t)stream>>>(
      (const V*)state, (const int*)tab, (const int*)lanec, (const uint32_t*)bits, seed, (long long*)stats,
      (float*)ret_out, B, T, lane_offset);
  return (int)cudaGetLastError();
}

extern "C" {

// This build's shape and lanes a block: the wrapper checks them.
int jss_static_j(void) { return J; }
int jss_static_m(void) { return M; }
int jss_free_static_lanes(void) { return kLanes; }

// Blocks of the kernel (int16 storage where `i16`) resident on one SM of the
// current device at once, or -1 on a CUDA error.
int jss_free_static_blocks_per_sm(int i16) {
  int n = 0;
  const cudaError_t err = i16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                    &n, free_static_kernel<int16_t>, kLanes * 32, 0)
                              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                    &n, free_static_kernel<int32_t>, kLanes * 32, 0);
  return err == cudaSuccess ? n : -1;
}

// On an (R, B) int32 state buffer; 0 when the kernel launched, else the
// CUDA error.
int jss_free_static(const void* state, const void* tab, const void* lanec, const void* bits,
                    unsigned long long seed, void* stats, void* ret_out, int B, int J_, int M_, int T,
                    int lane_offset, void* stream) {
  return launch<int32_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J_, M_, T, lane_offset, stream);
}

// The same on an (R, B) int16 state buffer.
int jss_free_static_i16(const void* state, const void* tab, const void* lanec, const void* bits,
                        unsigned long long seed, void* stats, void* ret_out, int B, int J_, int M_, int T,
                        int lane_offset, void* stream) {
  return launch<int16_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J_, M_, T, lane_offset, stream);
}

#ifdef JSS_PASS_CLOCKS
// The instrumented kernel (int16 storage where `i16`), the cycles of each
// pass summed per lane into `clocks` ((PASSES, B) int64): the draw, the
// action's update, fast_forward, prioritization, check_no_op, the episode's
// bookkeeping and reset.
int jss_free_static_clocks(const void* state, const void* tab, const void* lanec, const void* bits,
                           unsigned long long seed, void* stats, void* ret_out, int B, int J_, int M_,
                           int T, int lane_offset, void* stream, void* clocks, int i16) {
  long long* p = (long long*)clocks;
  const cudaError_t err = cudaMemcpyToSymbolAsync(jss_pass_clocks, &p, sizeof(p), 0,
                                                  cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return i16 ? launch<int16_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J_, M_, T, lane_offset, stream)
             : launch<int32_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J_, M_, T, lane_offset, stream);
}
int jss_pass_count(void) { return PASSES; }
#endif

}  // extern "C"

// The free rollout on the register lane (static_lane.cuh's Lane<false>): the
// kernel body shared by free_static.cu (built per static shape) and
// general_lane.cu (built per slot class, for padded and mixed-shape
// batches). The same function to the bit as jssenv_tpu/core/pallas_rollout.py's
// _free_kernel: the same Philox4x32-10 words (key `seed`, counter
// (step, lane_offset + lane), word 0) or caller bits, the same draw, the step
// math of jssenv_tpu_torch.core.engine.step, the same per-lane stats and
// float32 return (raw / max_time_op summed in step order). The plain twin is
// fused_rollout.free_lane_stats_reference.
//
// Beside the lane this adds the draw (the slot from the words' popcounts, the
// job by one ballot; the modulo a multiply-high by a constant table,
// mod_small), the Philox words and the stats. The state is read once, from
// the EnvState's own batch-first tensors at their own dtypes (int32 fields,
// masks as torch.bool bytes), as driven_lane.cuh's driven_load reads them:
// there is no lane buffer and no storage type. op_end_at, idle_frozen,
// idle_total_alloc, wait4 and the solution are not read at all: no decision
// of a step reads them, and the free rollout returns only stats.

#pragma once
#include "static_lane.cuh"

namespace {

// The pointers of one launch, passed by value. The state's fields come in
// the order of driven_lane.cuh's DrivenIO less the fields the free rollout
// does not read (fused_rollout._FREE_I32, then _FREE_U8).
struct FreeIO {
  const int *time, *nb_legal, *nb_ml, *mbf;           // (B,), (B,), (B,), (B, M)
  const int *jbf, *next_op, *work_done, *needed;      // (B, J) each
  const uint8_t *noop_legal, *legal, *noop_pin, *ml;  // (B,), (B, J), (B, J), (B, M)
  const int *tab, *lanec;                             // tables, lane constants
  const uint32_t* bits;                               // (T, B) caller words, or null: Philox
  unsigned long long seed;                            // the Philox key
  long long* stats;                                   // (4, B) per-lane stats
  float* ret;                                         // (B,) float32 returns
  int B, J, M, T;                                     // J, M: the padded shape (a static build's own)
  int lane_offset;                                    // this batch's first lane in a batch split over ranks
};
// Per-lane stats rows of the (4, B) int64 output.
enum : int { S_EPISODES = 0, S_MK_SUM, S_MK_MIN, S_VIOL };

// x mod d for x < 2^31 and 1 <= d <= kMaxJobs + 1 (the draw's divisor)
// without a division: q = floor(x / d) = umulhi(x, m) >> (l - 1) with
// l = ceil(log2 d) and m = ceil(2^(31 + l) / d) < 2^32, exact for every
// x < 2^31 since m d - 2^(31 + l) < d <= 2^l (Granlund and Montgomery,
// PLDI'94, Thm 4.2).
struct Divisors {
  uint32_t m[kMaxJobs + 2];
  int shift[kMaxJobs + 2];
};
constexpr Divisors make_divisors() {
  Divisors t{};
  for (int d = 2; d <= kMaxJobs + 1; ++d) {
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
  if (d > kMaxJobs + 1) return (int)(x % (uint32_t)d);  // a count no engine state holds
  const uint32_t q = __umulhi(x, kDivisors.m[d]) >> kDivisors.shift[d];
  return (int)(x - q * (uint32_t)d);
}

// The uniform-over-legal draw: k = (w >>> 1) mod (nb_legal + noop_legal);
// the k-th legal job in index order, or the no-op (nj) when k >= nb_legal.
// The slot that holds it from the words' popcounts, then the one thread
// whose legal job has k legal jobs of that word before it.
__device__ int sample(const Lane<false>& l, uint32_t w) {
  int k = mod_small(w >> 1, max(l.nb_legal + l.noop, 1));
  if (k >= l.nb_legal) return l.nj;
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

// Whether slot s of thread r holds a row of a state of J padded jobs
// (Lane::has_row). The load below asks this function rather than the lane:
// ptxas gave the static builds 8 more registers for the member call, or for
// the test written out in the loop (56 -> 64 at one or two job slots).
__device__ __forceinline__ bool row_in(int s, int r, int J) { return s < S - 1 || (S - 1) * 32 + r < J; }

// Lane b's state from the input tensors (row j of lane b's (B, J) field at
// b * J + j: a warp's read of a row is coalesced). The lane's rows go
// through pointers of its own with int offsets (the wrapper keeps B * J and
// B * M below 2^31): size_t offsets into the fields cost the static build of
// ta71's shape 12 more bytes of spill stores.
__device__ void free_load(Lane<false>& l, const FreeIO& io, int b) {
  const int row = b * l.J, mrow = b * l.M;
  const int *jbf = io.jbf + row, *next_op = io.next_op + row, *needed = io.needed + row, *work_done = io.work_done + row;
  const uint8_t *legal = io.legal + row, *pin = io.noop_pin + row;
  l.time = io.time[b];
  l.noop = io.noop_legal[b] != 0;
  l.nb_legal = io.nb_legal[b];
  l.nb_ml = io.nb_ml[b];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = l.r + 32 * s;
    const bool in = row_in(s, l.r, l.J);
    const bool job = kStatic ? in : j < l.nj;
    l.jbf[s] = in ? jbf[j] : 0;
    l.next_op[s] = in ? next_op[j] : l.nm;
    l.needed[s] = in ? needed[j] : -1;
    l.work_done[s] = in ? work_done[j] : 0;
    l.legal[s] = __ballot_sync(JSS_FULL, in && legal[j] != 0);
    l.pin[s] = __ballot_sync(JSS_FULL, in && pin[j] != 0);
    l.last_op[s] = __ballot_sync(JSS_FULL, in && l.next_op[s] == l.nm - 1);
    l.dur[s] = l.m_next[s] = 0;
    l.after[s] = 0;
    if (job) {
      l.load_tables(s);
      l.load_after(s);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int m = l.r + 32 * k;
    l.mbf[k] = m < l.M ? io.mbf[mrow + m] : 0;
    l.ml[k] = __ballot_sync(JSS_FULL, m < l.M && io.ml[mrow + m] != 0);
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

// The C entry points' arguments (free_static.cu's and general_lane.cu's),
// in FreeIO's order, and the FreeIO they make.
#define JSS_FREE_PARAMS                                                                                            \
  const void *time, const void *nb_legal, const void *nb_ml, const void *mbf, const void *jbf, const void *next_op, \
      const void *work_done, const void *needed, const void *noop_legal, const void *legal, const void *noop_pin,   \
      const void *ml, const void *tab, const void *lanec, const void *bits, unsigned long long seed, void *stats,    \
      void *ret_out, int B, int J, int M, int T, int lane_offset
#define JSS_FREE_IO                                                                                               \
  FreeIO {                                                                                                        \
    (const int*)time, (const int*)nb_legal, (const int*)nb_ml, (const int*)mbf, (const int*)jbf,                  \
        (const int*)next_op, (const int*)work_done, (const int*)needed, (const uint8_t*)noop_legal,               \
        (const uint8_t*)legal, (const uint8_t*)noop_pin, (const uint8_t*)ml, (const int*)tab, (const int*)lanec,  \
        (const uint32_t*)bits, seed, (long long*)stats, (float*)ret_out, B, J, M, T, lane_offset                   \
  }

// The kernel, written once for both builds and named by the build:
// free_static_kernel (free_static.cu) or free_general_kernel
// (general_lane.cu). T steps of every lane from the state's fields in `io`
// (read only; a static build has its J, M already), the uniform-over-legal
// policy drawn in the kernel, finished lanes reset; the per-lane stats (4, B)
// and float32 returns (B,). The per-step random words come 32 steps at a
// time: rank r draws (or loads) step t + r's and step t takes rank t % 32's
// by a shuffle. `lane_offset`: this batch's first lane in a batch split over
// ranks (the Philox counter takes the global lane). The body is the kernel's
// own, as in driven_lane.cuh.
#if defined(JSS_STATIC_J)
#define JSS_FREE_KERNEL free_static_kernel
#else
#define JSS_FREE_KERNEL free_general_kernel
#endif
__global__ void JSS_LANE_BOUNDS JSS_FREE_KERNEL(const FreeIO io) {
  const int B = io.B, T = io.T;
  const int b = blockIdx.x * kLanes + (int)(threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  Lane<false> l;
  l.r = threadIdx.x & 31;
  l.bind(io.J, io.M, io.lanec, B, b);
  l.tab = io.tab + (size_t)io.lanec[C_INST * B + b] * 4 * l.JM;
  l.mo = io.lanec[C_MO * B + b];
  const int so = io.lanec[C_SO * B + b];
  free_load(l, io, b);
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
      w_mine = io.bits ? io.bits[(size_t)(t + l.r) * B + b]
                       : philox_word(io.seed, t + l.r, (uint32_t)(io.lane_offset + b));
    const int raw = l.step(sample(l, __shfl_sync(JSS_FULL, w_mine, q)));
    JSS_PASS(l, PASS_RESET);
    ep_raw += raw;
    ret += (float)raw / mo_f;
    if (l.nb_legal == 0) {
      const int mk = l.time;
      ++episodes;
      mk_sum += mk;
      mk_min = min(mk_min, mk);
      if (ep_raw != 2 * so - l.nm * mk) ++viol;
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
    io.stats[S_EPISODES * (size_t)B + b] = episodes;
    io.stats[S_MK_SUM * (size_t)B + b] = mk_sum;
    io.stats[S_MK_MIN * (size_t)B + b] = mk_min;
    io.stats[S_VIOL * (size_t)B + b] = viol;
    io.ret[b] = ret;
  }
}

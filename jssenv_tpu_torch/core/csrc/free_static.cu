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
// Design. One env lane runs on one warp, and a block holds kLanes lanes.
// Thread r keeps its jobs j = r, r + 32, ... (S = ceil(J/32) slots, a
// compile-time constant, so every slot loop unrolls) and its machines
// m = r, r + 32 (K = ceil(M/32) slots) in registers: job_busy_for, next_op,
// needed_machine and work_done; values cached from the instance tables and
// refreshed when a job moves to its next op (the current op's duration, the
// next op's machine, and the machines of the job's later ops as a bitmask,
// which check_no_op's op-chain test reads instead of op_pos); and
// machine_busy_for. legal, noop_pin, machine_legal and "at the last op" are
// one 32-bit word per slot, bit r of word s for job r + 32 s, the same in
// every thread of the warp and updated by ballots: counts change by
// popcounts, the draw picks the k-th set bit (the slot by popcounts, the job
// by one ballot), and a test of machine_legal[m] is a shift. A value of
// another thread (a machine's busy time, the drawn job's fields) comes by
// __shfl_sync; a segment minimum over the jobs of one machine is a loop over
// the few machines it is needed for (set bits of a uniform word), each a
// warp min-reduction. Nothing lives in shared memory. The state is read once
// from the (R, B) buffer, so int16 or int32 storage matters only at that
// load; op_end_at, idle_frozen, idle_total_alloc and wait4 are not read at
// all: no decision of a step reads them, and the free rollout returns only
// stats. The instance tables ((4, J, M) int32 per lane, shared by the lanes
// of an instance) are read through the read-only cache. The draw's modulo is
// a multiply-high by a constant table (mod_small), not a division.
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

#include <type_traits>

#if !defined(JSS_STATIC_J) || !defined(JSS_STATIC_M)
#error "free_static.cu builds for one static shape: -DJSS_STATIC_J=J -DJSS_STATIC_M=M"
#endif
#define JSS_I32_MAX 2147483647
#define JSS_FULL 0xffffffffu

namespace {

constexpr int J = JSS_STATIC_J, M = JSS_STATIC_M, JM = J * M;
constexpr int S = (J + 31) / 32;  // job slots a thread
constexpr int K = (M + 31) / 32;  // machine slots a thread
constexpr int kLanes = 4;         // lanes (warps) a block: fused_rollout.FREE_STATIC_LANES
using MMask = std::conditional_t<(M <= 32), unsigned, unsigned long long>;
static_assert(J >= 1 && M >= 1 && S <= 4 && K <= 2, "free_static.cu takes J <= 128 and M <= 64");

// Rows of the light (R, B) state buffer (fused_rollout._ROWS order).
enum : int {
  R_TIME = 0, R_NOOP = 1, R_NB_LEGAL = 2, R_NB_ML = 3, R_LEGAL = 4,
  R_ML = 4 + J, R_MBF = 4 + J + M, R_JBF = 4 + J + 2 * M, R_NEXT_OP = R_JBF + J,
  R_WORK_DONE = R_JBF + 2 * J, R_NEEDED = R_JBF + 3 * J, R_NOOP_PIN = R_JBF + 7 * J,
};
// The instance tables, in the order of fused_rollout._TABLES.
enum : int { T_OM = 0, T_OD = 1, T_OP = 2, T_CB = 3 };
// Per-lane constants: rows of the (5, B) int32 buffer.
enum : int { C_INST = 0, C_NJ, C_NM, C_MO, C_SO };
// Per-lane stats rows of the (4, B) int64 output.
enum : int { S_EPISODES = 0, S_MK_SUM, S_MK_MIN, S_VIOL };

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// Whether slot s of thread r holds a job: every thread in all slots but the
// last, which is partial unless 32 divides J.
__device__ __forceinline__ bool has_job(int s, int r) { return s < S - 1 || (S - 1) * 32 + r < J; }

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

#ifdef JSS_PASS_CLOCKS
enum : int { PASS_DRAW = 0, PASS_ACT, PASS_FF, PASS_PRIO, PASS_NOOP, PASS_RESET, PASSES };
// clock64() at each pass boundary: the cycles since the last one go to the
// pass that ran them.
struct PassClock {
  long long acc[PASSES], last;
  int cur;
  __device__ void start() {
#pragma unroll
    for (int i = 0; i < PASSES; ++i) acc[i] = 0;
    cur = PASS_DRAW;
    last = clock64();
  }
  __device__ void to(int p) {
    const long long now = clock64();
#pragma unroll
    for (int i = 0; i < PASSES; ++i)
      if (i == cur) acc[i] += now - last;
    cur = p;
    last = now;
  }
};
#define JSS_PASS(l, p) (l).clk.to(p)
#else
#define JSS_PASS(l, p) ((void)0)
#endif

// One env lane as held by one thread of its warp.
struct Lane {
  // this thread's jobs j = r + 32 s (padding slots: jbf 0, next_op M, needed -1)
  int jbf[S], next_op[S], needed[S], work_done[S];
  int dur[S];    // op_dur[j][clamp(next_op)]: the current op's duration
  int m_next[S]; // clamp(op_machine[j][clamp(next_op + 1)]): the next op's machine
  int mbf[K];    // machine_busy_for of machines r + 32 k (0 past M)
  MMask after[S];  // machines of the ops after next_op, the last op excepted
  // warp-uniform: bit r of word s is job r + 32 s's (machine r + 32 k's) flag
  unsigned legal[S], pin[S], ml[K];
  unsigned last_op[S];  // jobs at their last op (next_op == M - 1)
  int time, noop, nb_legal, nb_ml;
  const int* tab;  // this lane's (4, J, M) tables
  int mo, r;
#ifdef JSS_PASS_CLOCKS
  PassClock clk;
#endif

  __device__ int tb(int which, int j, int x) const { return __ldg(tab + which * JM + j * M + x); }
  __device__ void load_after(int s) {
    after[s] = 0;
    for (int p = next_op[s] + 1; p < M - 1; ++p) after[s] |= MMask(1) << clampi(tb(T_OM, r + 32 * s, p), 0, M - 1);
  }
  __device__ void load_tables(int s) {
    const int j = r + 32 * s;
    dur[s] = tb(T_OD, j, clampi(next_op[s], 0, M - 1));
    m_next[s] = clampi(tb(T_OM, j, clampi(next_op[s] + 1, 0, M - 1)), 0, M - 1);
  }
  // bit m of K uniform words
  __device__ static bool bit_of(const unsigned (&w)[K], int m) {
    unsigned v = w[0];
#pragma unroll
    for (int k = 1; k < K; ++k)
      if (m >= 32 * k) v = w[k];
    return (v >> (m & 31)) & 1u;
  }
  // machine_busy_for[m] from its owner; m may differ between threads
  __device__ int mbf_at(int m) const {
    int v = __shfl_sync(JSS_FULL, mbf[0], m & 31);
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const int vk = __shfl_sync(JSS_FULL, mbf[k], m & 31);
      if (m >= 32 * k) v = vk;
    }
    return v;
  }
  // bit m of K words, as this thread's contribution to a warp OR
  __device__ static void set_bit(unsigned (&w)[K], int m) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((m >> 5) == k) w[k] |= 1u << (m & 31);
  }
  __device__ static void warp_or(unsigned (&w)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = __reduce_or_sync(JSS_FULL, w[k]);
  }
  // the least positive machine_busy_for over the lane's machines (I32_MAX:
  // no machine is busy)
  __device__ int min_busy() const {
    int v = JSS_I32_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (mbf[k] > 0) v = min(v, mbf[k]);
    return __reduce_min_sync(JSS_FULL, v);
  }

  // engine._fresh_state for this lane (every job valid: _fresh_static)
  __device__ void fresh() {
    unsigned first[K] = {};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool valid = has_job(s, r);
      jbf[s] = 0;
      work_done[s] = 0;
      next_op[s] = valid ? 0 : M;
      needed[s] = valid ? tb(T_OM, r + 32 * s, 0) : -1;
      after[s] = 0;
      if (valid) {
        load_tables(s);
        load_after(s);
        set_bit(first, clampi(needed[s], 0, M - 1));
      }
      legal[s] = __ballot_sync(JSS_FULL, valid);
      last_op[s] = M == 1 ? legal[s] : 0;
      pin[s] = 0;
    }
    warp_or(first);
    nb_ml = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mbf[k] = 0;
      ml[k] = first[k];
      nb_ml += __popc(first[k]);
    }
    time = 0;
    noop = 0;
    nb_legal = J;
  }

  // The uniform-over-legal draw: k = (w >>> 1) mod (nb_legal + noop_legal);
  // the k-th legal job in index order, or the no-op (J) when k >= nb_legal.
  // The slot that holds it from the words' popcounts, then the one thread
  // whose legal job has k legal jobs of that word before it.
  __device__ int sample(uint32_t w) const {
    int k = mod_small(w >> 1, max(nb_legal + noop, 1));
    if (k >= nb_legal) return J;
    int hit = S - 1;
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      const int c = __popc(legal[s]);
      if (hit == S - 1 && k < c) hit = s;
      if (hit == S - 1) k -= c;
    }
    unsigned word = legal[0];
#pragma unroll
    for (int s = 1; s < S; ++s)
      if (s == hit) word = legal[s];
    const bool mine = ((word >> r) & 1u) && __popc(word & ((1u << r) - 1u)) == k;
    const unsigned one = __ballot_sync(JSS_FULL, mine);
    return one ? 32 * hit + __ffs(one) - 1 : 0;  // none: nb_legal above the legal jobs, as the twin
  }

  // engine.step up to fast_forward: allocate job `a` or wait (a >= J);
  // returns the allocation's raw reward. `a` is uniform over the warp.
  __device__ int act(int a) {
    if (a >= J) {
      // no-op: pin every legal job; its machine loses legality
      unsigned clear[K] = {};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if ((legal[s] >> r) & 1u) set_bit(clear, clampi(needed[s], 0, M - 1));
        pin[s] |= legal[s];
        legal[s] = 0;
      }
      warp_or(clear);
#pragma unroll
      for (int k = 0; k < K; ++k) ml[k] &= ~clear[k];
      nb_legal = 0;
      nb_ml = 0;
      return 0;
    }
    const int sa = a >> 5, ra = a & 31;
    int my_needed = 0, my_dur = 0;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s == sa) {
        my_needed = needed[s];
        my_dur = dur[s];
      }
    const int needed_a = __shfl_sync(JSS_FULL, my_needed, ra);
    const int d = __shfl_sync(JSS_FULL, my_dur, ra);
    const int m = clampi(needed_a, 0, M - 1);
    int kills = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const unsigned same = __ballot_sync(JSS_FULL, needed[s] == needed_a);
      kills += __popc(legal[s] & same);
      legal[s] &= ~same;
      pin[s] &= ~__ballot_sync(JSS_FULL, clampi(needed[s], 0, M - 1) == m);
      if (s == sa && r == ra) jbf[s] = d;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == (m >> 5)) ml[k] &= ~(1u << (m & 31));
      if (k == (m >> 5) && r == (m & 31)) mbf[k] = d;
    }
    nb_legal -= kills;
    nb_ml -= 1;
    return d;
  }

  // engine.fast_forward: jump in closed form to the first re-legalization
  // time (or the last event); returns the machine idle holes (0 if inactive).
  __device__ int fast_forward() {
    if (nb_ml != 0) return 0;
    const int busy = min_busy();
    if (busy == JSS_I32_MAX) return 0;
    int hi = -JSS_I32_MAX - 1;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (r + 32 * k < M) hi = max(hi, mbf[k]);
    const int t0 = time;
    const int first_ev = t0 + busy;
    const int last_ev = t0 + __reduce_max_sync(JSS_FULL, hi);

    // e_j: the time job j becomes a re-legalization candidate (I32_MAX:
    // never), and the machine it would take
    int e[S], mc[S];
    int t_stop = last_ev;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool running = jbf[s] > 0;
      const bool cont = running && next_op[s] + 1 < M;
      mc[s] = cont ? m_next[s] : clampi(needed[s], 0, M - 1);
      const int f = t0 + mbf_at(mc[s]);
      const bool waiting = !running && needed[s] >= 0 && !((legal[s] >> r) & 1u) && !((pin[s] >> r) & 1u);
      e[s] = cont ? max(t0 + jbf[s], f) : waiting ? max(first_ev, f) : JSS_I32_MAX;
      t_stop = min(t_stop, e[s]);
    }
    const int T_stop = __reduce_min_sync(JSS_FULL, t_stop);
    const int span = T_stop - t0;

    // per-job update over [t0, T_stop]; the machine timers keep their entry
    // values until every e_j is read
    unsigned add[K] = {};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = jbf[s];
      bool finished = false;
      if (v > 0) {
        jbf[s] = max(0, v - span);
        work_done[s] += min(span, v);
        if (t0 + v <= T_stop) {
          const int no = ++next_op[s];
          if (no < M) {
            needed[s] = m_next[s];
            after[s] &= ~(MMask(1) << m_next[s]);
            load_tables(s);
          } else if (no == M) {
            needed[s] = -1;
            finished = true;
          }
        }
      }
      const bool cand = e[s] == T_stop;
      if (cand) set_bit(add, mc[s]);
      const unsigned drop = __ballot_sync(JSS_FULL, finished) & legal[s];
      const unsigned become = __ballot_sync(JSS_FULL, cand);
      nb_legal += __popc(become) - __popc(drop);
      legal[s] = (legal[s] & ~drop) | become;
      last_op[s] = __ballot_sync(JSS_FULL, next_op[s] == M - 1);
    }
    warp_or(add);
    int holes = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      nb_ml += __popc(add[k] & ~ml[k]);
      ml[k] |= add[k];
      if (r + 32 * k < M) holes += span - min(mbf[k], span);
      mbf[k] = max(0, mbf[k] - span);
    }
    time = T_stop;
    return __reduce_add_sync(JSS_FULL, holes);
  }

  // engine.prioritization_non_final: per legal machine that a legal
  // final-op job waits for, the least duration of its eligible non-final
  // jobs (a warp min a machine), then the kills.
  __device__ void prioritization() {
    unsigned maybe = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) maybe |= last_op[s] & legal[s];
    if (!maybe) return;
    unsigned fin[S], any = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool f = needed[s] >= 0 && next_op[s] == M - 1 && bit_of(ml, clampi(needed[s], 0, M - 1));
      fin[s] = __ballot_sync(JSS_FULL, f) & legal[s];
      any |= fin[s];
    }
    if (!any) return;
    unsigned machines[K] = {};
    bool free_next[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((fin[s] >> r) & 1u) set_bit(machines, clampi(needed[s], 0, M - 1));
      free_next[s] = mbf_at(m_next[s]) == 0;
    }
    warp_or(machines);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      for (unsigned x = machines[k]; x; x &= x - 1) {
        const int m = 32 * k + __ffs(x) - 1;
        int v = JSS_I32_MAX;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (((legal[s] >> r) & 1u) && needed[s] >= 0 && clampi(needed[s], 0, M - 1) == m &&
              next_op[s] != M - 1 && free_next[s])
            v = min(v, dur[s]);
        const int min_nf = __reduce_min_sync(JSS_FULL, v);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const unsigned kill = __ballot_sync(
              JSS_FULL, ((fin[s] >> r) & 1u) && clampi(needed[s], 0, M - 1) == m && dur[s] > min_nf);
          nb_legal -= __popc(kill);
          legal[s] &= ~kill;
        }
      }
    }
  }

  // engine.check_no_op's decision; every exit is uniform over the warp.
  __device__ int no_op_legal() const {
    if (!(nb_ml > 0 && nb_ml <= 3 && nb_legal <= 4)) return 0;
    const int busy = min_busy();
    if (busy == JSS_I32_MAX) return 0;
    const int t = time, next_ev = t + busy, cap = t + mo;
    bool early = false;  // a legal job ends before the next event
#pragma unroll
    for (int s = 0; s < S; ++s) early |= ((legal[s] >> r) & 1u) && t + dur[s] < next_ev;
    if (__any_sync(JSS_FULL, early)) return 0;

    // the op-chain test of the illegal jobs, per legal machine m: the least
    // tn = base + cum_before[j][m] over the jobs whose op on m comes at or
    // after `start`, before their last op, and starts before max_h
    int base[S];
    MMask cand[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int wait_m = mbf_at(clampi(needed[s], 0, M - 1));
      const bool illegal = has_job(s, r) && !((legal[s] >> r) & 1u);
      const bool case1 = illegal && jbf[s] > 0 && next_op[s] + 1 < M;
      const bool case2 = illegal && !case1 && !((pin[s] >> r) & 1u) && next_op[s] < M;
      const MMask here = next_op[s] < M - 1 ? MMask(1) << clampi(needed[s], 0, M - 1) : MMask(0);
      cand[s] = case1 ? after[s] : case2 ? after[s] | here : MMask(0);
      base[s] = case1 ? t - work_done[s] : t + wait_m - work_done[s];
    }
    // a legal machine that no candidate op reaches is blocked whatever max_h
    // (a test that pays at one or two job slots; at four, its registers
    // cost more than it saves)
    if constexpr (S <= 2) {
      unsigned reach[K] = {};
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int k = 0; k < K; ++k) reach[k] |= (unsigned)(cand[s] >> (32 * k));
      warp_or(reach);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (ml[k] & ~reach[k]) return 0;
    }

    // the legal jobs in index order (at most a few: nb_legal <= 4): the
    // horizon of each machine's first legal job, and per machine the least
    // end of its legal jobs
    int max_h = t;
    int mh[K];
#pragma unroll
    for (int k = 0; k < K; ++k) mh[k] = JSS_I32_MAX;
    unsigned seen[K] = {};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int m_mine = clampi(needed[s], 0, M - 1);
      for (unsigned x = legal[s]; x; x &= x - 1) {
        const int q = __ffs(x) - 1;
        const int m1 = __shfl_sync(JSS_FULL, m_mine, q);
        const int end = t + __shfl_sync(JSS_FULL, dur[s], q);
        if (!bit_of(seen, m1)) max_h = max(max_h, min(cap, end));
        set_bit(seen, m1);
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (m1 == r + 32 * k) mh[k] = min(mh[k], end);
      }
    }

#pragma unroll
    for (int k = 0; k < K; ++k) {
      for (unsigned x = ml[k]; x; x &= x - 1) {
        const int q = __ffs(x) - 1, m = 32 * k + q;
        int tn = JSS_I32_MAX;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (!((cand[s] >> m) & 1u)) continue;
          const int at = base[s] + tb(T_CB, r + 32 * s, m);
          if (max_h > at) tn = min(tn, at);
        }
        const int tn_min = __reduce_min_sync(JSS_FULL, tn);
        if (!(tn_min < min(cap, __shfl_sync(JSS_FULL, mh[k], q)))) return 0;
      }
    }
    return 1;
  }

  // engine.step: the action's update, fast_forward, the two heuristics;
  // returns the raw integer reward
  __device__ int step(int a) {
    JSS_PASS(*this, PASS_ACT);
    int raw = act(a);
    JSS_PASS(*this, PASS_FF);
    raw -= fast_forward();
    JSS_PASS(*this, PASS_PRIO);
    prioritization();
    JSS_PASS(*this, PASS_NOOP);
    noop = no_op_legal();
    return raw;
  }
};

// The lane's state from the (R, B) buffer of storage type V (row x of lane b
// at src[x * B + b]); the only place V matters.
template <typename V>
__device__ void load(Lane& l, const V* src, int B, int b) {
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

// At one or two job slots ptxas takes the registers it needs (55-56, 9
// blocks an SM); at three or four, 6 blocks an SM cap them at 80.
#if (JSS_STATIC_J + 31) / 32 >= 3
#define JSS_FS_BOUNDS __launch_bounds__(kLanes * 32, 6)
#else
#define JSS_FS_BOUNDS __launch_bounds__(kLanes * 32)
#endif

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
__global__ void JSS_FS_BOUNDS free_static_kernel(const V* state, const int* tab, const int* lanec,
                                                 const uint32_t* bits, unsigned long long seed,
                                                 long long* stats, float* ret_out, int B, int T,
                                                 int lane_offset) {
  const int b = blockIdx.x * kLanes + (int)(threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  Lane l;
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
    const int raw = l.step(l.sample(__shfl_sync(JSS_FULL, w_mine, q)));
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

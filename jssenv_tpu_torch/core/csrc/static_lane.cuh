// One env lane held by one warp with its state in registers: the step math
// shared by the kernels built per static shape, free_static.cu (the free
// rollout) and driven_static.cu (the driven one), and by those built per slot
// class for padded and mixed-shape batches, general_lane.cu (both).
//
// The counterpart of jssenv_tpu/core/pallas_rollout.py's _make_step (:243)
// and _fresh (:549), and under _static_lane (:1018) of _fresh_static (:503),
// field for field jssenv_tpu_torch.core.engine.step. Thread r of the warp
// keeps its jobs j = r, r + 32, ... (S = ceil(J/32) slots, a compile-time
// constant, so every slot loop unrolls) and its machines m = r, r + 32
// (K = ceil(M/32) slots):
// job_busy_for, next_op, needed_machine and work_done; values cached from the
// instance tables and refreshed when a job moves to its next op (the current
// op's duration, the next op's machine, and the machines of the job's later
// ops as a bitmask, which check_no_op's op-chain test reads instead of
// op_pos); and machine_busy_for. legal, noop_pin, machine_legal and "at the
// last op" are one 32-bit word per slot, bit r of word s for job r + 32 s, the
// same in every thread of the warp and updated by ballots. A value of another
// thread comes by __shfl_sync; a segment minimum over the jobs of one machine
// is a loop over the few machines it is needed for, each a warp
// min-reduction. Nothing lives in shared memory.
//
// The engine's counts are not always the words' popcounts (a no-op zeroes
// nb_machine_legal but clears only the legal jobs' machines), so both are
// kept; padding slots hold needed -1 and next_op nm, so that no ballot sets
// their bit.
//
// Bounds. The step math compares against the padded shape (J, M) and the
// lane's own instance shape (nj, nm) through Bounds, a base of Lane, as
// rollout.cu's Bounds<SJ, SM> does. A static build (-DJSS_STATIC_J=J
// -DJSS_STATIC_M=M) fixes J and M and takes unpadded lanes only, nj == J and
// nm == M, so every compare folds. A slot-class build (-DJSS_SLOTS_J=S
// -DJSS_SLOTS_M=K, S in 1..4, K in 1..2) fixes only the slot counts: J and M
// come with the launch (ceil(J/32) == S, ceil(M/32) == K) and nj, nm from the
// lane constants. There a padded job (nj <= j < J) is a row of the state like
// any other, held as it is and written back; it starts finished (next_op nm,
// needed -1), is never legal and never allocated (the no-op id is nj), so no
// ballot sets its bit. A padded machine (nm <= m < M) is never legal and its
// idle time is not counted. "At the last op" is next_op == nm - 1, and the
// op-chain mask stops before the lane's last op.
//
// Lane<false> is the free kernel's lane: no decision of a step reads
// op_end_at, idle_frozen, idle_total_alloc, wait4 or the solution, and the
// free rollout returns only stats, so it keeps none of them. Lane<true> is
// the driven kernel's, which returns the whole state: it also keeps op_end_at
// and idle_total_alloc (read at an allocation) in registers, and writes
// idle_frozen, wait4 and the solution, which no step reads, straight into the
// new state's rows in device memory. Every entry of those rows is touched by
// one thread only (a job's by its owner; a solution cell x by rank x % 32),
// so program order keeps them right without a warp sync.
//
// Include once per translation unit, with JSS_STATIC_J and JSS_STATIC_M, or
// JSS_SLOTS_J and JSS_SLOTS_M, defined.

#pragma once
#include <stdint.h>

#include <type_traits>

#if defined(JSS_STATIC_J) && defined(JSS_STATIC_M)
#define JSS_JOB_SLOTS ((JSS_STATIC_J + 31) / 32)
#define JSS_MACHINE_WORDS ((JSS_STATIC_M + 31) / 32)
#elif defined(JSS_SLOTS_J) && defined(JSS_SLOTS_M) && !defined(JSS_STATIC_J) && !defined(JSS_STATIC_M)
#define JSS_JOB_SLOTS JSS_SLOTS_J
#define JSS_MACHINE_WORDS JSS_SLOTS_M
#else
#error "a lane build is for one shape (-DJSS_STATIC_J=J -DJSS_STATIC_M=M) or one slot class (-DJSS_SLOTS_J=S -DJSS_SLOTS_M=K)"
#endif
#define JSS_I32_MAX 2147483647
#define JSS_FULL 0xffffffffu

namespace {

constexpr int S = JSS_JOB_SLOTS;      // job slots a thread
constexpr int K = JSS_MACHINE_WORDS;  // machine slots a thread
constexpr int kLanes = 4;             // lanes (warps) a block: fused_rollout.STATIC_LANES
using MMask = std::conditional_t<(K == 1), unsigned, unsigned long long>;
static_assert(S >= 1 && S <= 4 && K >= 1 && K <= 2, "the lane kernels take J <= 128 and M <= 64");

// The instance tables, in the order of fused_rollout._TABLES.
enum : int { T_OM = 0, T_OD = 1, T_OP = 2, T_CB = 3 };
// Per-lane constants: rows of the (5, B) int32 buffer.
enum : int { C_INST = 0, C_NJ, C_NM, C_MO, C_SO };

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

#if defined(JSS_STATIC_J)
static_assert(JSS_STATIC_J >= 1 && JSS_STATIC_M >= 1, "a static build needs a positive shape");
constexpr bool kStatic = true;
constexpr int kMaxJobs = JSS_STATIC_J;  // the most jobs a lane of this build has
// The static build's bounds: every lane unpadded.
struct Bounds {
  static constexpr int J = JSS_STATIC_J, M = JSS_STATIC_M, JM = J * M, nj = J, nm = M;
  __device__ void bind(int, int, const int*, size_t, int) {}
};
#else
constexpr bool kStatic = false;
constexpr int kMaxJobs = 32 * S;
// A slot class's bounds: the launch's padded shape and the lane's own.
struct Bounds {
  int J, M, JM, nj, nm;
  // (J, M) of the launch; lane b's (nj, nm) from the (5, B) lane constants
  __device__ void bind(int J_, int M_, const int* lanec, size_t B, int b) {
    J = J_;
    M = M_;
    JM = J_ * M_;
    nj = lanec[C_NJ * B + b];
    nm = lanec[C_NM * B + b];
  }
};
#endif

#ifdef JSS_PASS_CLOCKS
enum : int { PASS_DRAW = 0, PASS_ACT, PASS_FF, PASS_PRIO, PASS_NOOP, PASS_RESET, PASSES };
// clock64() at each pass boundary: the cycles since the last one go to the
// pass that ran them (free_static.cu's instrumented build only).
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

// The rows only the driven kernel keeps (see the top of this file).
template <bool kDriven>
struct DrivenRows {};
template <>
struct DrivenRows<true> {
  int op_end[S], idle_tot[S];  // op_end_at, idle_total_alloc of this thread's jobs
  int* idle_frozen;            // this lane's (J,) row of the new state
  int* wait4;                  // this lane's (J,) row of the new state
  int* sol;                    // this lane's (J, M) solution in the new state, or null (light)
};

// One env lane as held by one thread of its warp.
template <bool kDriven>
struct Lane : Bounds, DrivenRows<kDriven> {
  // this thread's jobs j = r + 32 s (padding slots: jbf 0, next_op nm, needed -1)
  int jbf[S], next_op[S], needed[S], work_done[S];
  int dur[S];    // op_dur[j][clamp(next_op)]: the current op's duration
  int m_next[S]; // clamp(op_machine[j][clamp(next_op + 1)]): the next op's machine
  int mbf[K];    // machine_busy_for of machines r + 32 k (0 past M)
  MMask after[S];  // machines of the ops after next_op, the last op excepted
  // warp-uniform: bit r of word s is job r + 32 s's (machine r + 32 k's) flag
  unsigned legal[S], pin[S], ml[K];
  unsigned last_op[S];  // jobs at their last op (next_op == nm - 1)
  int time, noop, nb_legal, nb_ml;
  const int* tab;  // this lane's (4, J, M) tables
  int mo, r;
#ifdef JSS_PASS_CLOCKS
  PassClock clk;
#endif

  // Whether slot s of this thread holds a row of the state (j < J): every
  // slot but the last, which is partial unless 32 divides J. A slot class's
  // J is above 32 (S - 1), as in a static build.
  __device__ bool has_row(int s) const { return s < S - 1 || (S - 1) * 32 + r < J; }
  // Whether it holds a job of the lane's instance (j < nj): a row, in a
  // static build.
  __device__ bool has_job(int s) const {
    if constexpr (kStatic)
      return has_row(s);
    else
      return r + 32 * s < nj;
  }
  __device__ int tb(int which, int j, int x) const { return __ldg(tab + which * JM + j * M + x); }
  __device__ void load_after(int s) {
    after[s] = 0;
    for (int p = next_op[s] + 1; p < nm - 1; ++p) after[s] |= MMask(1) << clampi(tb(T_OM, r + 32 * s, p), 0, M - 1);
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

  // engine._fresh_state for this lane (a static build's every job valid:
  // _fresh_static; a padded job starts finished)
  __device__ void fresh() {
    unsigned first[K] = {};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool valid = has_job(s);
      jbf[s] = 0;
      work_done[s] = 0;
      next_op[s] = valid ? 0 : nm;
      needed[s] = valid ? tb(T_OM, r + 32 * s, 0) : -1;
      after[s] = 0;
      if (valid) {
        load_tables(s);
        load_after(s);
        set_bit(first, clampi(needed[s], 0, M - 1));
      }
      legal[s] = __ballot_sync(JSS_FULL, valid);
      last_op[s] = nm == 1 ? legal[s] : 0;
      pin[s] = 0;
      if constexpr (kDriven) {
        this->op_end[s] = 0;
        this->idle_tot[s] = 0;
        if (has_row(s)) this->idle_frozen[r + 32 * s] = this->wait4[r + 32 * s] = 0;
      }
    }
    if constexpr (kDriven) {
      if (this->sol)
        for (int x = r; x < JM; x += 32) this->sol[x] = -1;
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
    nb_legal = nj;
  }

  // engine.step up to fast_forward: allocate job `a` or wait (a >= nj);
  // returns the allocation's raw reward. `a` is uniform over the warp and
  // not negative.
  __device__ int act(int a) {
    if (a >= nj) {
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
    int my_needed = 0, my_dur = 0, my_op = 0;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s == sa) {
        my_needed = needed[s];
        my_dur = dur[s];
        if constexpr (kDriven) my_op = next_op[s];
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
      if (s == sa && r == ra) {
        jbf[s] = d;
        if constexpr (kDriven) {
          // the job's idle span since its last op ended, at the step's time
          const int span = time - this->op_end[s];
          this->idle_frozen[a] = span;
          this->idle_tot[s] += span;
        }
      }
    }
    if constexpr (kDriven) {
      // solution[a][op] = time, written by the rank that owns the cell
      if (this->sol) {
        const int x = a * M + clampi(__shfl_sync(JSS_FULL, my_op, ra), 0, M - 1);
        if ((x & 31) == r) this->sol[x] = time;
      }
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
    // never), the machine it would take, and that machine's free time (for a
    // job that continues: its next op's wait)
    int e[S], mc[S], f[S];
    int t_stop = last_ev;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool running = jbf[s] > 0;
      const bool cont = running && next_op[s] + 1 < nm;
      mc[s] = cont ? m_next[s] : clampi(needed[s], 0, M - 1);
      f[s] = t0 + mbf_at(mc[s]);
      const bool waiting = !running && needed[s] >= 0 && !((legal[s] >> r) & 1u) && !((pin[s] >> r) & 1u);
      e[s] = cont ? max(t0 + jbf[s], f[s]) : waiting ? max(first_ev, f[s]) : JSS_I32_MAX;
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
          if constexpr (kDriven) this->op_end[s] = t0 + v;
          const int no = ++next_op[s];
          if (no < nm) {
            // a job that continues took the cont branch above: f is its
            // next machine's free time
            if constexpr (kDriven) this->wait4[r + 32 * s] = max(0, f[s] - (t0 + v));
            needed[s] = m_next[s];
            after[s] &= ~(MMask(1) << m_next[s]);
            load_tables(s);
          } else if (no == nm) {
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
      last_op[s] = __ballot_sync(JSS_FULL, next_op[s] == nm - 1);
    }
    warp_or(add);
    int holes = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      nb_ml += __popc(add[k] & ~ml[k]);
      ml[k] |= add[k];
      if (r + 32 * k < nm) holes += span - min(mbf[k], span);
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
      const bool f = needed[s] >= 0 && next_op[s] == nm - 1 && bit_of(ml, clampi(needed[s], 0, M - 1));
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
              next_op[s] != nm - 1 && free_next[s])
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
      const bool illegal = has_job(s) && !((legal[s] >> r) & 1u);
      const bool case1 = illegal && jbf[s] > 0 && next_op[s] + 1 < nm;
      const bool case2 = illegal && !case1 && !((pin[s] >> r) & 1u) && next_op[s] < nm;
      const MMask here = next_op[s] < nm - 1 ? MMask(1) << clampi(needed[s], 0, M - 1) : MMask(0);
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

// At one or two job slots ptxas takes the registers it needs (55-56 in the
// static free kernel, 9 blocks an SM); at three or four, 6 blocks an SM cap
// them at 80.
#if JSS_JOB_SLOTS >= 3
#define JSS_LANE_BOUNDS __launch_bounds__(kLanes * 32, 6)
#else
#define JSS_LANE_BOUNDS __launch_bounds__(kLanes * 32)
#endif

}  // namespace

// Fused auto-resetting job-shop rollout for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of jssenv_tpu/core/pallas_rollout.py:
//   * _driven_kernel (:598; caller-supplied actions, per-step raw rewards and
//     the final state; here also, on request, each lane's episode ends, which
//     a learner's frames and stats need)           -> rollout_driven_kernel;
//   * _free_kernel (:653; in-kernel uniform-over-legal policy, auto-reset,
//     episode stats and the reward-identity check)  -> rollout_free_kernel,
//     instantiated on an int32 state buffer and, for the JAX package's int16
//     value mode (value_dtype, :95), on an int16 one. The int16 one also
//     stands for tools/repro_i16_mosaic.py's one-op kernel, a repro of the
//     TPU compiler crash that keeps that mode off on the TPU;
// both built on one step math, the counterpart of _make_step (:243: step,
// fast_forward, prioritization, check_no_op) and of the in-kernel reset
// _fresh (:549). The semantics are jssenv_tpu_torch.core.engine.step's, field
// for field; the plain twins in core/fused_rollout.py hold the kernels to them.
//
// Design. One env lane is run by one warp. Lane r of the warp owns jobs
// j = r, r + 32, ... and machines m = r, r + 32, ..., JSS_MACHINE_SLOTS of
// them: a library is built for one machine-slot class, ceil(M/32) slots a
// thread (nvcc -DJSS_MACHINE_SLOTS=K, K from 3 to JSS_MAX_MACHINE_SLOTS =
// 32, so M <= 1024; the default build's two slots take M <= 64). The count is
// a compile-time constant: the machine passes unroll over it and check_no_op's
// per-slot horizons stay in registers.
// Ownership is strided, so a ballot over one slot of jobs is in job-index
// order and the warp's accesses to a state row hit consecutive banks. The TPU
// kernel kept J in its vector registers and reduced over it; here every pass
// over J is ceil(J/32) slots per thread and a warp reduction
// (__reduce_*_sync, __ballot_sync, __any_sync, or atomicMin on a per-lane
// scratch row in shared memory). Integer min and sum commute, so each
// reduction is exact whatever the order. A warp syncs with __syncwarp only.
// Groups of fewer threads, several env lanes a warp, measured slower on the
// card even for J, M <= 16: lanes that share a warp diverge at the step's
// data-dependent branches and run in turn, and partial masks cost every sync
// and reduction a convergence check.
//
// The state lives in shared memory for the whole launch (a lane's 4 + 10J +
// 2M state rows and 2M scratch words within a block's 227 KB: the launch
// checks it). A block of `lanes`
// lanes copies its (R, lanes) slice of the batch-last (R, B) buffer
// (fused_rollout._to_lanes; rows in Layout's order) into shared memory,
// coalesced along the lane axis and stored lane-major, each lane's rows
// padded to a stride of 1 word modulo 32, so that the rows of consecutive
// lanes start on different banks in the copy. The machine scratch
// rows are int32 even when the state is int16, for atomicMin. The free kernel
// runs all T steps there and writes only its per-lane stats (the wrapper
// discards the state, as the JAX free kernel has no state output). The
// driven kernel writes the state back at the end and the rewards every step;
// its solution rows (J*M) stay in device memory, one word per allocation and
// J*M/32 per thread per reset. The instance tables, one (n_inst, 4, J, M)
// int32 stack indexed per lane, are read through the read-only path.
//
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W; PERF.md): not bytes or
// operations (the general free kernel takes 59-86x its operations bound),
// but the instructions each step issues: every pass reads and writes its rows in
// shared memory, closes with warp reductions or shared atomicMins, and runs
// its single updates on rank 0 while the warp waits. An instrumented static
// build of the free kernel (-DJSS_PASS_CLOCKS, chip_smoke.py phase 7c)
// counts 6915 cycles of a warp's clock a lane-step at ta01 B=16384 (40
// warps an SM): check_no_op 45%, fast_forward 22%, the action's update 10%,
// the draw 10%, prioritization 8%, the reset 5%; at ta71, four job slots a
// thread, 14382 cycles, check_no_op 52% and fast_forward 28%. The kernels
// are held to 48 registers a thread (JSS_MIN_BLOCKS, 40 warps an SM), which
// shared memory allows (a lane's state and scratch: 0.5 KB at ta01 in
// int16, 4.4 KB at ta71). The classes of three and four machine slots keep
// that cap and spill 28-40 bytes a thread (-Xptxas -v), against 0-20 at two;
// their wide lanes (7.3 KB at 150x70) fit three blocks an SM at most.
//
// Two builds of this one source, as the JAX package compiles each kernel in
// two variants (pallas_rollout.py _static_lane, :1018, passed as static_lane
// to _driven_kernel / _free_kernel). The general build (both kernels) reads
// the padded shape (J, M) from the launch and each lane's own (nj, nm) from
// its lane constants, so padded and mixed-shape batches run: every batch past
// the register lane's 128 jobs or 64 machines (driven_static.cu,
// free_static.cu and general_lane.cu take the others), one library per
// machine-slot class. The static build (-DJSS_STATIC_J=J -DJSS_STATIC_M=M,
// core/_build.py), in which J, M, nj, nm, every row offset, the strides and
// the slot counts are compile-time constants and the reset is the counterpart
// of _fresh_static (:503), is built only with -DJSS_PASS_CLOCKS: the
// instrumented free kernel of this shared-memory design, the baseline of
// chip_smoke.py's phase 7c. Both builds share every line of the step math
// below; only the Bounds of a Group differ.

#include <cuda_runtime.h>
#include <stdint.h>

#define JSS_I32_MAX 2147483647
#define JSS_WARP 32
#define JSS_FULL 0xffffffffu
// machines a thread in the general build (fused_rollout.machine_slots): M <= 32 K
#ifndef JSS_MACHINE_SLOTS
#define JSS_MACHINE_SLOTS 2
#endif
#define JSS_MAX_MACHINE_SLOTS 32  // fast_forward keeps a bit a slot in 32 bits
#define JSS_MAX_M (JSS_WARP * JSS_MACHINE_SLOTS)
#define JSS_MAX_SHARED 232448  // a block's shared bytes on Hopper (fused_rollout._SMEM_LIMIT)
#define JSS_MAX_THREADS 256  // a block's threads (fused_rollout._BLOCK_THREADS)
#define JSS_MIN_BLOCKS 5     // blocks an SM (40 warps): at most 48 registers a thread

// The static build's shape; 0 (the general build) reads the shape at run time.
#ifndef JSS_STATIC_J
#define JSS_STATIC_J 0
#endif
#ifndef JSS_STATIC_M
#define JSS_STATIC_M 0
#endif
static_assert((JSS_STATIC_J > 0) == (JSS_STATIC_M > 0), "a static build fixes both J and M");
static_assert(JSS_MACHINE_SLOTS >= 2 && JSS_MACHINE_SLOTS <= JSS_MAX_MACHINE_SLOTS, "bad machine-slot class");
static_assert(JSS_STATIC_J >= 0 && JSS_STATIC_M >= 0 && JSS_STATIC_M <= JSS_MAX_M, "bad static shape");
#if JSS_STATIC_J > 0 && !defined(JSS_PASS_CLOCKS)
#error "a static build of rollout.cu is the instrumented free kernel only (-DJSS_PASS_CLOCKS)"
#endif

// Each job j of this thread (j = r, r + 32, ... < J), slot by slot; a static
// build's ceil(J/32) slots unroll. `continue` goes on to the next job.
#define JSS_FOR_JOBS(g, j)                                                               \
  _Pragma("unroll") for (int jss_slot_ = 0, j = (g).r; jss_slot_ < (g).job_slots();      \
                         ++jss_slot_, j += JSS_WARP) if (j < (g).J)

namespace {

#ifdef JSS_PASS_CLOCKS
// -DJSS_PASS_CLOCKS (with a static shape) builds an instrumented free kernel
// in a library of its own, never on the main path: clock64() at each pass
// boundary, the cycles since the last one summed per lane into the pass that
// ran them (jss_rollout_free_clocks; free_static.cu has the same passes).
enum { PASS_DRAW = 0, PASS_ACT, PASS_FF, PASS_PRIO, PASS_NOOP, PASS_RESET, PASSES };
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
__device__ long long* jss_pass_clocks;  // (PASSES, B) int64, set by jss_rollout_free_clocks
#define JSS_PASS(g, p) \
  do {                 \
    if ((g).clk) (g).clk->to(p); \
  } while (0)
#else
#define JSS_PASS(g, p) ((void)0)
#endif

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The instance tables, in the order of fused_rollout._TABLES; op_pos (2) is
// not read: check_no_op walks a job's ops in order instead.
enum { T_OM = 0, T_OD = 1, T_CB = 3 };

// The padded shape: compile-time constants in a static build (SJ, SM > 0),
// launch arguments in the general build (Dims<0, 0>).
template <int SJ, int SM>
struct Dims {
  static constexpr int J = SJ, M = SM;
  __device__ Dims(int, int) {}
};
template <>
struct Dims<0, 0> {
  int J, M;
  __device__ Dims(int J_, int M_) : J(J_), M(M_) {}
};

// The bounds the step math compares against: the shape and the lane's own
// instance shape (nj, nm). A static build's lanes are unpadded: nj == J and
// nm == M, and every compare with them folds (the general build reads them
// per lane).
template <int SJ, int SM>
struct Bounds : Dims<SJ, SM> {
  static constexpr int jm = SJ * SM, nj = SJ, nm = SM;
  __device__ Bounds(int J_, int M_) : Dims<SJ, SM>(J_, M_) {}
};
template <>
struct Bounds<0, 0> : Dims<0, 0> {
  int jm, nj = 0, nm = 0;
  __device__ Bounds(int J_, int M_) : Dims<0, 0>(J_, M_), jm(J_ * M_) {}
};

// A static build's lane strides, as fused_rollout.launch_geometry computes
// them: state rows in V's, padded to 1 word modulo 32; scratch 2M words so
// padded. The launch refuses a wrapper whose strides differ.
__host__ __device__ constexpr int bank_pad(int words) { return words + ((1 - words) % 32 + 32) % 32; }
template <typename V, int SJ, int SM>
struct StaticStrides {
  static constexpr int rows = 4 + 10 * SJ + 2 * SM;
  static constexpr int state = bank_pad((rows * (int)sizeof(V) + 3) / 4) * 4 / (int)sizeof(V);
  static constexpr int scratch = bank_pad(2 * SM);
};

// Row offsets of the fields in the (R, B) state buffer; the same order as
// jssenv_tpu_torch.core.fused_rollout._ROWS.
template <int SJ, int SM>
struct Layout : Dims<SJ, SM> {
  using Dims<SJ, SM>::J;
  using Dims<SJ, SM>::M;
  __device__ Layout(int J_, int M_) : Dims<SJ, SM>(J_, M_) {}
  __device__ int time() const { return 0; }
  __device__ int noop_legal() const { return 1; }
  __device__ int nb_legal() const { return 2; }
  __device__ int nb_ml() const { return 3; }
  __device__ int legal() const { return 4; }
  __device__ int ml() const { return 4 + J; }
  __device__ int mbf() const { return 4 + J + M; }
  __device__ int jbf() const { return 4 + J + 2 * M; }
  __device__ int next_op() const { return jbf() + J; }
  __device__ int work_done() const { return jbf() + 2 * J; }
  __device__ int needed() const { return jbf() + 3 * J; }
  __device__ int op_end_at() const { return jbf() + 4 * J; }
  __device__ int idle_frozen() const { return jbf() + 5 * J; }
  __device__ int idle_total() const { return jbf() + 6 * J; }
  __device__ int noop_pin() const { return jbf() + 7 * J; }
  __device__ int wait4() const { return jbf() + 8 * J; }
  __device__ int light_rows() const { return jbf() + 9 * J; }  // = solution()
};

// One lane as seen by one thread of its warp. V is the state's storage type
// (int32_t, or int16_t in the free kernel's int16 value mode). A field is read
// as a V and promoted to int by every expression that uses it, and an int is
// narrowed only where it is stored back: all arithmetic stays in 32-bit
// registers, so no intermediate can wrap. Tables and lane constants are int32.
// SJ, SM: the static build's shape, 0 in the general build (Bounds: J, M, jm
// = J * M, nj, nm).
template <typename V, int SJ, int SM>
struct Group : Bounds<SJ, SM> {
  using Bounds<SJ, SM>::J;
  using Bounds<SJ, SM>::M;
  using Bounds<SJ, SM>::jm;
  using Bounds<SJ, SM>::nj;
  using Bounds<SJ, SM>::nm;
  static constexpr bool kStatic = SJ > 0;
  // machine slots a thread: ceil(M/32) in a static build (1 for M <= 32)
  static constexpr int kMachineSlots = kStatic ? (SM + JSS_WARP - 1) / JSS_WARP : JSS_MACHINE_SLOTS;

  V* s;            // the lane's state rows in shared memory: row x at s[x]
  int* scr;        // 2M int32 words of shared scratch (segment min, first job;
                   // per-machine horizon)
  int* sol;        // solution rows in device memory (x at sol[x * B]) or null
  size_t B;
  Layout<SJ, SM> L;
  const int* tabs; // (4, J, M) tables of this lane's instance (T_OM, ...)
  int mo;          // the lane's max_time_op
  int r;           // this thread's rank in the warp
#ifdef JSS_PASS_CLOCKS
  PassClock* clk = nullptr;  // the free kernel's pass clocks (null: not counted)
#endif

  __device__ Group(int J_, int M_) : Bounds<SJ, SM>(J_, M_), L(J_, M_) {}
  __device__ int job_slots() const { return (J + JSS_WARP - 1) / JSS_WARP; }
  __device__ V& at(int row) { return s[row]; }
  __device__ V& row(int base, int x) { return s[base + x]; }
  __device__ int tab(int which, int j, int x) const {
    return __ldg(tabs + which * jm + j * M + x);
  }
  __device__ bool leader() const { return r == 0; }
  __device__ void sync() const { __syncwarp(JSS_FULL); }
  __device__ int sum(int v) const { return __reduce_add_sync(JSS_FULL, v); }
  __device__ int min_(int v) const { return __reduce_min_sync(JSS_FULL, v); }
  __device__ int max_(int v) const { return __reduce_max_sync(JSS_FULL, v); }
  __device__ bool any(bool p) const { return __any_sync(JSS_FULL, p); }
  // bit i: the predicate of rank i
  __device__ unsigned ballot(bool p) const { return __ballot_sync(JSS_FULL, p); }
  __device__ int machine(int k) const { return k * JSS_WARP + r; }
};

// engine.fast_forward: jump in closed form to the first re-legalization
// time (or the last event); returns the machine idle holes (0 if inactive).
template <class Grp>
__device__ int fast_forward(Grp& g) {
  const int M = g.M, nm = g.nm, mbf = g.L.mbf();
  const int t0 = g.at(g.L.time());
  int busy_min = JSS_I32_MAX, busy_max = -JSS_I32_MAX - 1;
  unsigned ml_entry = 0;  // bit k: machine_legal of machine slot k on entry
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k) {
    const int m = g.machine(k);
    if (m >= M) continue;
    const int v = g.row(mbf, m);
    if (v > 0) busy_min = min(busy_min, v);
    busy_max = max(busy_max, v);
    if (g.row(g.L.ml(), m)) ml_entry |= 1u << k;
  }
  // no machine is busy iff the least busy time is I32_MAX (a duration of
  // I32_MAX would overflow the clock first)
  const int min_busy = g.min_(busy_min);
  if (!(g.at(g.L.nb_ml()) == 0 && min_busy != JSS_I32_MAX)) return 0;
  const int first_ev = t0 + min_busy;
  const int last_ev = t0 + g.max_(busy_max);

  // e_j: the time job j becomes a re-legalization candidate (I32_MAX: never)
  auto e_of = [&](int j, int& m_next, int& f_next, int& mj, bool& cont) {
    const int jbf = g.row(g.L.jbf(), j);
    const int nxt = g.row(g.L.next_op(), j) + 1;
    const int needed = g.row(g.L.needed(), j);
    const bool running = jbf > 0;
    cont = running && nxt < nm;
    m_next = clampi(g.tab(T_OM, j, clampi(nxt, 0, M - 1)), 0, M - 1);
    f_next = t0 + g.row(mbf, m_next);
    mj = clampi(needed, 0, M - 1);
    const bool waiting = !running && needed >= 0 && !g.row(g.L.legal(), j) &&
                         j < g.nj && !g.row(g.L.noop_pin(), j);
    if (cont) return max(t0 + jbf, f_next);
    if (waiting) return max(first_ev, t0 + g.row(mbf, mj));
    return JSS_I32_MAX;
  };

  int t_stop = last_ev;
  JSS_FOR_JOBS(g, j) {
    int m_next, f_next, mj;
    bool cont;
    t_stop = min(t_stop, e_of(j, m_next, f_next, mj, cont));
  }
  const int T_stop = g.min_(t_stop);
  const int span = T_stop - t0;
  g.sync();  // every machine_legal entry value is read

  // per-job update over [t0, T_stop]: no job reads another job's fields, and
  // the machine timers stay at their entry values until every e_j is read
  int d_legal = 0;
  JSS_FOR_JOBS(g, j) {
    int m_next, f_next, mj;
    bool cont;
    const int e = e_of(j, m_next, f_next, mj, cont);
    const int jbf = g.row(g.L.jbf(), j);
    const bool running = jbf > 0;
    const int c = t0 + jbf;
    if (running) {
      g.row(g.L.jbf(), j) = max(0, jbf - span);
      g.row(g.L.work_done(), j) += min(span, jbf);
    }
    int legal = g.row(g.L.legal(), j);
    if (running && c <= T_stop) {
      g.row(g.L.op_end_at(), j) = c;
      const int no = g.row(g.L.next_op(), j) + 1;
      g.row(g.L.next_op(), j) = no;
      if (no < nm) {
        g.row(g.L.needed(), j) = m_next;
        g.row(g.L.wait4(), j) = max(0, f_next - c);
      } else if (no == nm) {
        g.row(g.L.needed(), j) = -1;
        if (legal) {
          legal = 0;
          --d_legal;
        }
      }
    }
    if (e == T_stop) {
      legal = 1;
      ++d_legal;
      g.row(g.L.ml(), cont ? m_next : mj) = 1;  // counted below, once a machine
    }
    g.row(g.L.legal(), j) = legal;
  }
  g.sync();

  int holes = 0, new_ml = 0;
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k) {
    const int m = g.machine(k);
    if (m >= M) continue;
    const int v = g.row(mbf, m);
    if (m < nm) holes += span - min(v, span);
    g.row(mbf, m) = max(0, v - span);
    if (!((ml_entry >> k) & 1u) && g.row(g.L.ml(), m)) ++new_ml;
  }
  holes = g.sum(holes);
  d_legal = g.sum(d_legal);
  new_ml = g.sum(new_ml);
  if (g.leader()) {
    g.at(g.L.time()) = T_stop;
    g.at(g.L.nb_legal()) = g.at(g.L.nb_legal()) + d_legal;
    g.at(g.L.nb_ml()) = g.at(g.L.nb_ml()) + new_ml;
  }
  g.sync();
  return holes;
}

// engine.prioritization_non_final: a per-machine segment min (shared
// atomicMin), then the kill pass.
template <class Grp>
__device__ void prioritization(Grp& g) {
  const int M = g.M, nm = g.nm;
  // only a legal job at its final op, on a legal machine, can be masked
  bool final_op = false;
  JSS_FOR_JOBS(g, j) {
    const int needed = g.row(g.L.needed(), j);
    final_op |= g.row(g.L.legal(), j) && needed >= 0 &&
                g.row(g.L.ml(), clampi(needed, 0, M - 1)) && g.row(g.L.next_op(), j) == nm - 1;
  }
  if (!g.any(final_op)) return;
  int* min_nf = g.scr;
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k)
    if (g.machine(k) < M) min_nf[g.machine(k)] = JSS_I32_MAX;
  g.sync();
  JSS_FOR_JOBS(g, j) {
    const int needed = g.row(g.L.needed(), j);
    if (!g.row(g.L.legal(), j) || needed < 0) continue;
    const int m_of = clampi(needed, 0, M - 1);
    if (!g.row(g.L.ml(), m_of)) continue;
    const int nxo = g.row(g.L.next_op(), j);
    if (nxo == nm - 1) continue;
    const int next_m = g.tab(T_OM, j, clampi(nxo + 1, 0, M - 1));
    if (g.row(g.L.mbf(), next_m) != 0) continue;
    atomicMin(&min_nf[m_of], g.tab(T_OD, j, clampi(nxo, 0, M - 1)));
  }
  g.sync();
  int kills = 0;
  JSS_FOR_JOBS(g, j) {
    const int needed = g.row(g.L.needed(), j);
    if (!g.row(g.L.legal(), j) || needed < 0) continue;
    const int m_of = clampi(needed, 0, M - 1);
    const int nxo = g.row(g.L.next_op(), j);
    if (!g.row(g.L.ml(), m_of) || nxo != nm - 1) continue;
    if (g.tab(T_OD, j, clampi(nxo, 0, M - 1)) > min_nf[m_of]) {
      g.row(g.L.legal(), j) = 0;
      ++kills;
    }
  }
  kills = g.sum(kills);
  if (g.leader()) g.at(g.L.nb_legal()) = g.at(g.L.nb_legal()) - kills;
  g.sync();
}

// engine.check_no_op's decision; every exit is uniform over the group.
template <class Grp>
__device__ int no_op_legal(Grp& g) {
  const int M = g.M, nm = g.nm, mbf = g.L.mbf();
  int busy_min = JSS_I32_MAX;
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k) {
    const int m = g.machine(k);
    if (m >= M) continue;
    const int v = g.row(mbf, m);
    if (v > 0) busy_min = min(busy_min, v);
  }
  const int min_busy = g.min_(busy_min);  // I32_MAX: no machine is busy
  const int nb_ml = g.at(g.L.nb_ml());
  if (!(min_busy != JSS_I32_MAX && nb_ml <= 3 && g.at(g.L.nb_legal()) <= 4)) return 0;
  const int t = g.at(g.L.time());
  const int next_ev = t + min_busy;
  const int cap = t + g.mo;

  // pass 1: per machine, the first legal job on it in index order and the
  // least end of its legal jobs
  int* first = g.scr;
  int* mh_min = g.scr + M;
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k) {
    const int m = g.machine(k);
    if (m < M) first[m] = mh_min[m] = JSS_I32_MAX;
  }
  g.sync();
  bool early = false;  // a legal job ends before the next event
  JSS_FOR_JOBS(g, j) {
    if (!g.row(g.L.legal(), j)) continue;
    const int m1 = clampi(g.row(g.L.needed(), j), 0, M - 1);
    const int end = t + g.tab(T_OD, j, clampi(g.row(g.L.next_op(), j), 0, M - 1));
    early |= end < next_ev;
    atomicMin(&first[m1], j);
    atomicMin(&mh_min[m1], end);
  }
  if (g.any(early)) return 0;
  g.sync();
  int max_h = t;
  int mh[Grp::kMachineSlots];
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k) {
    const int m = g.machine(k);
    mh[k] = 0;
    if (m >= M) continue;
    const int f = first[m];
    if (f != JSS_I32_MAX) {
      const int end = t + g.tab(T_OD, f, clampi(g.row(g.L.next_op(), f), 0, M - 1));
      max_h = max(max_h, min(cap, end));
    }
    mh[k] = min(cap, mh_min[m]);
    first[m] = JSS_I32_MAX;  // from here on: the least tn on m
  }
  max_h = g.max_(max_h);
  g.sync();

  // pass 2: op-chain walk of the illegal jobs over the static tables, each
  // job by its owner. engine.check_no_op tests every machine m whose op
  // comes at or after `start` and before the job's last op; here they are
  // walked in op order (m = op_machine[j][p], whose op_pos is p: a job visits
  // each of its machines once). tn = base + cum_before grows along the walk,
  // so it stops at the first op that does not start before max_h.
  int* tn_min = first;
  JSS_FOR_JOBS(g, j) {
    if (j >= g.nj) break;  // padded jobs (never in a static build)
    if (g.row(g.L.legal(), j)) continue;
    const int jbf = g.row(g.L.jbf(), j);
    const int nxo = g.row(g.L.next_op(), j);
    const bool case1 = jbf > 0 && nxo + 1 < nm;
    const bool case2 = !case1 && !g.row(g.L.noop_pin(), j) && nxo < nm;
    if (!(case1 || case2)) continue;
    const int wd = g.row(g.L.work_done(), j);
    const int base =
        case1 ? t - wd : t + g.row(mbf, clampi(g.row(g.L.needed(), j), 0, M - 1)) - wd;
    for (int p = case1 ? nxo + 1 : nxo; p < nm - 1; ++p) {
      const int m = g.tab(T_OM, j, p);
      const int tn = base + g.tab(T_CB, j, m);
      if (!(max_h > tn)) break;
      atomicMin(&tn_min[m], tn);
    }
  }
  g.sync();
  bool blocked = false;
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k) {
    const int m = g.machine(k);
    if (m < M && g.row(g.L.ml(), m) && !(tn_min[m] < mh[k])) blocked = true;
  }
  if (g.any(blocked)) return 0;
  return nb_ml > 0 ? 1 : 0;
}

// engine.check_no_op
template <class Grp>
__device__ void check_no_op(Grp& g) {
  const int noop = no_op_legal(g);
  if (g.leader()) g.at(g.L.noop_legal()) = noop;
  g.sync();
}

// engine.step: allocate job `action` or wait (action >= nj); returns the raw
// integer reward. `action` is the same in every thread of the group.
template <class Grp>
__device__ int step(Grp& g, int action) {
  const int J = g.J, M = g.M;
  JSS_PASS(g, PASS_ACT);
  g.sync();  // every thread has read the state the action was drawn from
  int raw = 0;
  if (action < g.nj) {
    const int a = clampi(action, 0, J - 1);
    const int op = clampi(g.row(g.L.next_op(), a), 0, M - 1);
    const int needed_a = g.row(g.L.needed(), a);
    const int m = clampi(needed_a, 0, M - 1);
    const int dur = g.tab(T_OD, a, op);
    raw = dur;
    int kills = 0;
    JSS_FOR_JOBS(g, j) {
      const int nd = g.row(g.L.needed(), j);
      if (g.row(g.L.legal(), j) && nd == needed_a) {
        g.row(g.L.legal(), j) = 0;
        ++kills;
      }
      if (clampi(nd, 0, M - 1) == m) g.row(g.L.noop_pin(), j) = 0;
    }
    kills = g.sum(kills);
    if (g.leader()) {
      // fields no other thread touches in this pass
      const int t = g.at(g.L.time());
      g.row(g.L.mbf(), m) = dur;
      g.row(g.L.jbf(), a) = dur;
      const int idle_span = t - g.row(g.L.op_end_at(), a);
      g.row(g.L.idle_frozen(), a) = idle_span;
      g.row(g.L.idle_total(), a) = g.row(g.L.idle_total(), a) + idle_span;
      if (g.sol) g.sol[(size_t)(a * M + op) * g.B] = t;
      g.at(g.L.nb_legal()) = g.at(g.L.nb_legal()) - kills;
      g.row(g.L.ml(), m) = 0;
      g.at(g.L.nb_ml()) = g.at(g.L.nb_ml()) - 1;
    }
  } else {
    // no-op: pin every legal job; its machine loses legality
    JSS_FOR_JOBS(g, j) {
      if (!g.row(g.L.legal(), j)) continue;
      g.row(g.L.noop_pin(), j) = 1;
      g.row(g.L.ml(), clampi(g.row(g.L.needed(), j), 0, M - 1)) = 0;
      g.row(g.L.legal(), j) = 0;
    }
    if (g.leader()) {
      g.at(g.L.nb_legal()) = 0;
      g.at(g.L.nb_ml()) = 0;
    }
  }
  g.sync();
  JSS_PASS(g, PASS_FF);
  raw -= fast_forward(g);
  JSS_PASS(g, PASS_PRIO);
  prioritization(g);
  JSS_PASS(g, PASS_NOOP);
  check_no_op(g);
  return raw;
}

// engine._fresh_state for one lane: padded job rows start finished, padded
// machines are never legal. In a static build every job is valid and the
// compares fold: the counterpart of pallas_rollout._fresh_static.
template <class Grp>
__device__ void fresh(Grp& g) {
  const int J = g.J, M = g.M;
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k) {
    const int m = g.machine(k);
    if (m >= M) continue;
    g.row(g.L.ml(), m) = 0;
    g.row(g.L.mbf(), m) = 0;
  }
  JSS_FOR_JOBS(g, j) {
    const bool valid = j < g.nj;
    g.row(g.L.legal(), j) = valid;
    g.row(g.L.jbf(), j) = 0;
    g.row(g.L.next_op(), j) = valid ? 0 : g.nm;
    g.row(g.L.work_done(), j) = 0;
    g.row(g.L.needed(), j) = valid ? g.tab(T_OM, j, 0) : -1;
    g.row(g.L.op_end_at(), j) = 0;
    g.row(g.L.idle_frozen(), j) = 0;
    g.row(g.L.idle_total(), j) = 0;
    g.row(g.L.noop_pin(), j) = 0;
    g.row(g.L.wait4(), j) = 0;
  }
  if (g.sol)
    for (int x = g.r; x < J * M; x += JSS_WARP) g.sol[(size_t)x * g.B] = -1;
  g.sync();
  JSS_FOR_JOBS(g, j) {
    if (j >= g.nj) break;
    g.row(g.L.ml(), clampi(g.tab(T_OM, j, 0), 0, M - 1)) = 1;
  }
  g.sync();
  int nb_ml = 0;
#pragma unroll
  for (int k = 0; k < Grp::kMachineSlots; ++k)
    if (g.machine(k) < M && g.row(g.L.ml(), g.machine(k))) ++nb_ml;
  nb_ml = g.sum(nb_ml);
  if (g.leader()) {
    g.at(g.L.time()) = 0;
    g.at(g.L.noop_legal()) = 0;
    g.at(g.L.nb_legal()) = g.nj;
    g.at(g.L.nb_ml()) = nb_ml;
  }
  g.sync();
}

// The uniform-over-legal draw: k = (w >>> 1) mod (nb_legal + noop_legal); the
// k-th legal job in index order (ballots over the slots in order), or the
// no-op (nj) when k >= nb_legal.
template <class Grp>
__device__ int sample(Grp& g, uint32_t w) {
  const int nb = g.at(g.L.nb_legal());
  const int n = nb + g.at(g.L.noop_legal());
  const int k = (int)(w >> 1) % max(n, 1);
  if (k >= nb) return g.nj;
  int left = k;
#pragma unroll
  for (int j0 = 0; j0 < g.J; j0 += JSS_WARP) {
    const bool lg = j0 + g.r < g.J && g.row(g.L.legal(), j0 + g.r);
    const unsigned bal = g.ballot(lg);
    const int cnt = __popc(bal);
    if (left < cnt) {
      const bool mine = lg && __popc(bal & ((1u << g.r) - 1u)) == left;
      return j0 + __ffs(g.ballot(mine)) - 1;
    }
    left -= cnt;
  }
  return 0;
}

// Per-lane constants: rows of the (5, B) int32 buffer.
enum { C_INST = 0, C_NJ, C_NM, C_MO, C_SO, C_ROWS };

// The block's lanes and this thread's place among them. The block holds
// blockDim.x / 32 lanes, a warp each; its shared memory is `lanes` state
// slices of `stride` V's, then `lanes` scratch slices of `scr_stride` int32
// words.
struct Place {
  int lanes, lane0, grp, r, b;
};

__device__ Place place() {
  Place p;
  p.lanes = blockDim.x / JSS_WARP;
  p.lane0 = blockIdx.x * p.lanes;
  p.grp = threadIdx.x / JSS_WARP;
  p.r = threadIdx.x % JSS_WARP;
  p.b = p.lane0 + p.grp;
  return p;
}

template <typename V, int SJ, int SM>
__device__ Group<V, SJ, SM> make_group(const Place& p, unsigned char* smem, int* sol, const int* tab,
                                       const int* lanec, int B, int J, int M, int stride,
                                       int scr_stride) {
  Group<V, SJ, SM> g(J, M);
  g.sol = sol;
  g.B = (size_t)B;
  g.r = p.r;
  g.s = (V*)smem + (size_t)p.grp * stride;
  g.scr = (int*)(smem + (size_t)p.lanes * stride * sizeof(V)) + (size_t)p.grp * scr_stride;
  g.tabs = tab + (size_t)lanec[C_INST * B + p.b] * 4 * g.jm;
  if constexpr (!Group<V, SJ, SM>::kStatic) {
    g.nj = lanec[C_NJ * B + p.b];
    g.nm = lanec[C_NM * B + p.b];
  }
  g.mo = lanec[C_MO * B + p.b];
  return g;
}

// A launch's lane strides (state in V's, scratch in int32 words): a static
// build's are its compile-time ones, which the launch checked against the
// wrapper's.
template <typename V, int SJ, int SM>
__device__ __forceinline__ void lane_strides(int& stride, int& scr_stride) {
  if constexpr (SJ > 0) {
    stride = StaticStrides<V, SJ, SM>::state;
    scr_stride = StaticStrides<V, SJ, SM>::scratch;
  }
}

// (R, B) device rows of the block's lanes <-> lane-major shared slices;
// consecutive threads take consecutive lanes of one row (blockDim = lanes*32).
template <typename V>
__device__ void load_lanes(V* dst, const V* src, int R, int B, const Place& p, int stride) {
  const int l = threadIdx.x % p.lanes;
  if (p.lane0 + l >= B) return;
  for (int x = threadIdx.x / p.lanes; x < R; x += JSS_WARP)
    dst[(size_t)l * stride + x] = src[(size_t)x * B + p.lane0 + l];
}

template <typename V>
__device__ void store_lanes(V* dst, const V* src, int R, int B, const Place& p, int stride) {
  const int l = threadIdx.x % p.lanes;
  if (p.lane0 + l >= B) return;
  for (int x = threadIdx.x / p.lanes; x < R; x += JSS_WARP)
    dst[(size_t)x * B + p.lane0 + l] = src[(size_t)l * stride + x];
}

// Philox4x32-10 (Salmon et al., SC'11); returns word 0 for counter
// (t, lane, 0, 0) under the 64-bit key `seed`.
__device__ uint32_t philox_word(unsigned long long seed, uint32_t t, uint32_t lane) {
  uint32_t c0 = t, c1 = lane, c2 = 0, c3 = 0;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  for (int r = 0; r < 10; ++r) {
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

}  // namespace

// Per-lane stats rows of the (4, B) int64 output.
enum { S_EPISODES = 0, S_MK_SUM, S_MK_MIN, S_VIOL };

// The per-step inputs (actions, random words) come 32 steps at a time: rank
// r loads or draws step t + r, and step t takes rank t % 32's by a shuffle.
// `ends` (T, B), where not null: the makespan of the episode a lane finished
// at step t (its time, read before fresh() clears it), else 0. Instantiated
// in the general build only (SJ = SM = 0): driven_static.cu is the static one.
template <int SJ, int SM>
__global__ void __launch_bounds__(JSS_MAX_THREADS, JSS_MIN_BLOCKS) rollout_driven_kernel(
    int* state, const int* tab, const int* lanec, const int* actions, int* rewards, int* ends,
    int B, int J, int M, int T, int with_solution, int stride, int scr_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Place p = place();
  lane_strides<int, SJ, SM>(stride, scr_stride);
  const int R = Layout<SJ, SM>(J, M).light_rows();
  load_lanes((int*)smem, state, R, B, p, stride);
  __syncthreads();
  if (p.b < B) {
    int* sol = with_solution ? state + (size_t)R * B + p.b : nullptr;
    Group<int, SJ, SM> g = make_group<int, SJ, SM>(p, smem, sol, tab, lanec, B, J, M, stride, scr_stride);
    int a_mine = 0;
    for (int t = 0; t < T; ++t) {
      const int q = t & (JSS_WARP - 1);
      if (q == 0 && t + g.r < T) a_mine = actions[(size_t)(t + g.r) * B + p.b];
      const int raw = step(g, __shfl_sync(JSS_FULL, a_mine, q));
      const bool done = g.at(g.L.nb_legal()) == 0;
      if (g.leader()) {
        rewards[(size_t)t * B + p.b] = raw;
        if (ends) ends[(size_t)t * B + p.b] = done ? g.at(g.L.time()) : 0;
      }
      if (done) fresh(g);
    }
  }
  __syncthreads();
  store_lanes(state, (const int*)smem, R, B, p, stride);
}

// V: the state buffer's storage type, int32_t or int16_t (the int16 value
// mode of jssenv_tpu/core/pallas_rollout.py value_dtype, chosen by the
// wrapper only when every stored value fits). The state is read, not written.
// `lane_offset`: this batch's first lane in a larger batch split over ranks; the
// Philox counter takes the global lane, so a shard draws the words that its
// lanes draw in the whole batch (0 for an unsplit batch). The lane's sum_op
// (`so`) and max_time_op are read per lane in both builds.
template <typename V, int SJ, int SM>
__global__ void __launch_bounds__(JSS_MAX_THREADS, JSS_MIN_BLOCKS) rollout_free_kernel(
    const V* state, const int* tab, const int* lanec, const uint32_t* bits,
    unsigned long long seed, long long* stats, float* ret_out, int B, int J, int M, int T,
    int lane_offset, int stride, int scr_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Place p = place();
  lane_strides<V, SJ, SM>(stride, scr_stride);
  // the stats never read the schedule: the state is light (no solution rows)
  load_lanes((V*)smem, state, Layout<SJ, SM>(J, M).light_rows(), B, p, stride);
  __syncthreads();
  if (p.b >= B) return;
  Group<V, SJ, SM> g = make_group<V, SJ, SM>(p, smem, nullptr, tab, lanec, B, J, M, stride, scr_stride);
  const int so = lanec[C_SO * B + p.b];
  const float mo_f = (float)g.mo;
  long long mk_sum = 0;
  int episodes = 0, viol = 0, mk_min = JSS_I32_MAX, ep_raw = 0;
  float ret = 0.f;
  uint32_t w_mine = 0;
#ifdef JSS_PASS_CLOCKS
  PassClock clk;
  g.clk = &clk;
  clk.start();
#endif
  for (int t = 0; t < T; ++t) {
    JSS_PASS(g, PASS_DRAW);
    const int q = t & (JSS_WARP - 1);
    if (q == 0 && t + g.r < T)
      w_mine = bits ? bits[(size_t)(t + g.r) * B + p.b]
                    : philox_word(seed, t + g.r, (uint32_t)(lane_offset + p.b));
    const int raw = step(g, sample(g, __shfl_sync(JSS_FULL, w_mine, q)));
    JSS_PASS(g, PASS_RESET);
    ep_raw += raw;
    ret += (float)raw / mo_f;
    if (g.at(g.L.nb_legal()) == 0) {
      const int mk = g.at(g.L.time());
      ++episodes;
      mk_sum += mk;
      mk_min = min(mk_min, mk);
      if (ep_raw != 2 * so - g.nm * mk) ++viol;
      ep_raw = 0;
      fresh(g);
    }
  }
#ifdef JSS_PASS_CLOCKS
  clk.to(PASS_DRAW);
  if (g.leader())
    for (int i = 0; i < PASSES; ++i) jss_pass_clocks[(size_t)i * B + p.b] = clk.acc[i];
#endif
  if (g.leader()) {
    stats[S_EPISODES * (size_t)B + p.b] = episodes;
    stats[S_MK_SUM * (size_t)B + p.b] = mk_sum;
    stats[S_MK_MIN * (size_t)B + p.b] = mk_min;
    stats[S_VIOL * (size_t)B + p.b] = viol;
    ret_out[p.b] = ret;
  }
}

// ---- host side: launch geometry and the C entry points --------------------

// The geometry comes from fused_rollout.launch_geometry: the lanes of a block
// (a warp each), the state and scratch strides of a lane, the dynamic shared
// bytes. Returns 0 or the CUDA error of the refused launch. A static build
// takes only its own shape and strides (else cudaErrorInvalidValue).
template <typename V, typename K>
static int launch_check(K kernel, int J, int M, int lanes, int stride, int scr_stride, int smem) {
  const int R = 4 + 10 * J + 2 * M, item = (int)sizeof(V);
  if (lanes < 1 || lanes * JSS_WARP > JSS_MAX_THREADS || M > JSS_MAX_M || stride < R ||
      (stride * item) % 4 || scr_stride < 2 * M || smem > JSS_MAX_SHARED ||
      (long long)lanes * ((long long)stride * item + 4LL * scr_stride) > smem)
    return (int)cudaErrorInvalidValue;
  using S = StaticStrides<V, JSS_STATIC_J, JSS_STATIC_M>;
  if (JSS_STATIC_J > 0 && (J != JSS_STATIC_J || M != JSS_STATIC_M || stride != S::state ||
                           scr_stride != S::scratch))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) cudaGetLastError();  // reset it: the next launch reports its own
    return (int)err;
  }
  return 0;
}

// The free kernel: in the general build, and in the (instrumented) static
// build.
template <typename V>
static int launch_free(void* state, const void* tab, const void* lanec, const void* bits,
                       unsigned long long seed, void* stats, void* ret_out, int B, int J, int M,
                       int T, int lane_offset, int lanes, int stride, int scr_stride, int smem,
                       void* stream) {
  auto kernel = rollout_free_kernel<V, JSS_STATIC_J, JSS_STATIC_M>;
  const int err = launch_check<V>(kernel, J, M, lanes, stride, scr_stride, smem);
  if (err || B == 0) return err;
  kernel<<<(B + lanes - 1) / lanes, lanes * JSS_WARP, smem, (cudaStream_t)stream>>>(
      (const V*)state, (const int*)tab, (const int*)lanec, (const uint32_t*)bits, seed,
      (long long*)stats, (float*)ret_out, B, J, M, T, lane_offset, stride, scr_stride);
  return (int)cudaGetLastError();
}

extern "C" {

// The shape of a static build, (0, 0) for the general build: the wrapper
// checks it against the batch it launches.
int jss_static_j(void) { return JSS_STATIC_J; }
int jss_static_m(void) { return JSS_STATIC_M; }
// The machine-slot class: the wrapper checks it against the batch's.
int jss_machine_slots(void) { return JSS_MACHINE_SLOTS; }

#if JSS_STATIC_J == 0
// Each returns 0 when the kernel launched, else the CUDA error (a geometry
// the card refuses: too many threads or too much shared memory).
// `ends` may be null: no episode-end output.
int jss_rollout_driven(void* state, const void* tab, const void* lanec, const void* actions,
                       void* rewards, void* ends, int B, int J, int M, int T, int with_solution,
                       int lanes, int stride, int scr_stride, int smem, void* stream) {
  auto kernel = rollout_driven_kernel<JSS_STATIC_J, JSS_STATIC_M>;
  const int err = launch_check<int32_t>(kernel, J, M, lanes, stride, scr_stride, smem);
  if (err || B == 0) return err;
  kernel<<<(B + lanes - 1) / lanes, lanes * JSS_WARP, smem, (cudaStream_t)stream>>>(
      (int*)state, (const int*)tab, (const int*)lanec, (const int*)actions, (int*)rewards,
      (int*)ends, B, J, M, T, with_solution, stride, scr_stride);
  return (int)cudaGetLastError();
}

int jss_rollout_free(void* state, const void* tab, const void* lanec, const void* bits,
                     unsigned long long seed, void* stats, void* ret_out, int B, int J, int M,
                     int T, int lane_offset, int lanes, int stride, int scr_stride, int smem,
                     void* stream) {
  return launch_free<int32_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J, M, T,
                              lane_offset, lanes, stride, scr_stride, smem, stream);
}

// The same kernel on an (R, B) int16 state buffer.
int jss_rollout_free_i16(void* state, const void* tab, const void* lanec, const void* bits,
                         unsigned long long seed, void* stats, void* ret_out, int B, int J,
                         int M, int T, int lane_offset, int lanes, int stride, int scr_stride,
                         int smem, void* stream) {
  return launch_free<int16_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J, M, T,
                              lane_offset, lanes, stride, scr_stride, smem, stream);
}
#endif

#ifdef JSS_PASS_CLOCKS
// The instrumented free kernel (int16 storage where `i16`), the cycles of
// each pass summed per lane into `clocks` ((PASSES, B) int64): the draw, the
// action's update, fast_forward, prioritization, check_no_op, the episode's
// bookkeeping and reset.
int jss_rollout_free_clocks(void* state, const void* tab, const void* lanec, const void* bits,
                            unsigned long long seed, void* stats, void* ret_out, int B, int J, int M,
                            int T, int lane_offset, int lanes, int stride, int scr_stride, int smem,
                            void* stream, void* clocks, int i16) {
  long long* p = (long long*)clocks;
  const cudaError_t err = cudaMemcpyToSymbolAsync(jss_pass_clocks, &p, sizeof(p), 0,
                                                  cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return i16 ? launch_free<int16_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J, M, T,
                                    lane_offset, lanes, stride, scr_stride, smem, stream)
             : launch_free<int32_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J, M, T,
                                    lane_offset, lanes, stride, scr_stride, smem, stream);
}
int jss_pass_count(void) { return PASSES; }
#endif

}  // extern "C"

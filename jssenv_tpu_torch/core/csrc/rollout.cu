// Fused auto-resetting job-shop rollout for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of jssenv_tpu/core/pallas_rollout.py:
//   * _driven_kernel (:598; caller-supplied actions, per-step raw rewards and
//     the final state)                              -> rollout_driven_kernel;
//   * _free_kernel (:653; in-kernel uniform-over-legal policy, auto-reset,
//     episode stats and the reward-identity check)  -> rollout_free_kernel,
//     instantiated on an int32 state buffer and, for the JAX package's int16
//     value mode (value_dtype, :95), on an int16 one. The int16 one also
//     stands for tools/repro_i16_mosaic.py's one-op kernel, a repro of the
//     TPU compiler crash that keeps that mode off on the TPU;
// both built on the step math _make_step (:243: step, fast_forward,
// prioritization, check_no_op) and the in-kernel reset _fresh (:549). The
// semantics are jssenv_tpu_torch.core.engine.step's, field for field; the
// plain twins in core/fused_rollout.py hold the kernels to them.
//
// Design. One thread per env lane; a lane's whole rollout (T steps) runs in
// one thread with no inter-thread communication. The state lives in device
// memory in the batch-last layout that fused_rollout._to_lanes produces: one
// (R, B) int32 (or int16) buffer whose rows are the fields (offsets below), so
// neighbouring threads touch neighbouring addresses on every access. The
// static tables are one (n_inst, 4, J, M) int32 stack read through a per-lane
// instance index, so ragged batches need no lane grouping, and lanes of one
// instance read the same table addresses (one broadcast load per warp). The
// loops over J and M are plain per-thread loops; per-machine segment
// reductions use small per-thread arrays (at most JSS_MAX_M machines). The
// free kernel writes per-lane stats, which the wrapper reduces with torch.
//
// What bounds it on this card: per step a lane does O(J + M) dependent loads
// and stores of its state column, plus O(J*M) table loads in check_no_op's
// op-chain walk when its gate is open. A lane's state is a few KB and stays
// in L1/L2, so HBM bandwidth is not the limit: the kernel is bound by the
// latency of those dependent accesses, with few warps per SM to hide it
// (16384 lanes are ~4 warps per SM). The design does nothing about that yet
// beyond coalescing: the state in registers/shared memory, a warp per lane
// for J=100 and CUDA graphs are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define JSS_MAX_M 64
#define JSS_I32_MAX 2147483647

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Row offsets of the fields in the (R, B) state buffer; the same order as
// jssenv_tpu_torch.core.fused_rollout._ROWS.
struct Layout {
  int J, M;
  __device__ Layout(int J_, int M_) : J(J_), M(M_) {}
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
  __device__ int solution() const { return jbf() + 9 * J; }  // (J, M) rows
};

// One lane's view: its state column, its instance's tables and bounds. V is
// the storage type of the state buffer (int32_t, or int16_t in the free
// kernel's int16 value mode). A field is read as a V and promoted to int by
// every expression that uses it, and an int is narrowed only where it is
// stored back: all arithmetic stays in 32-bit registers, so no intermediate
// can wrap. The tables and the lane constants stay int32.
template <typename V>
struct Lane {
  V* s;            // state + b; row r of this lane at s[r * B]
  size_t B;
  Layout L;
  const int* om;   // (J, M) op_machine of this lane's instance
  const int* od;   // op_dur
  const int* op;   // op_pos
  const int* cb;   // cum_before
  int J, M, nj, nm, mo;
  bool with_solution;

  __device__ V& at(int row) { return s[(size_t)row * B]; }
  __device__ V& row(int base, int x) { return s[(size_t)(base + x) * B]; }
};

// engine.fast_forward: jump in closed form to the first re-legalization
// time (or the last event); returns the machine idle holes (0 if inactive).
template <typename V>
__device__ int fast_forward(Lane<V>& l) {
  const int J = l.J, M = l.M, nm = l.nm;
  const int mbf = l.L.mbf();
  const int t0 = l.at(l.L.time());
  bool any_busy = false;
  int min_busy = JSS_I32_MAX, max_busy = l.row(mbf, 0);
  for (int m = 0; m < M; ++m) {
    int v = l.row(mbf, m);
    if (v > 0) {
      any_busy = true;
      min_busy = min(min_busy, v);
    }
    max_busy = max(max_busy, v);
  }
  if (!(l.at(l.L.nb_ml()) == 0 && any_busy)) return 0;
  const int first_ev = t0 + min_busy;
  const int last_ev = t0 + max_busy;

  // e_j: the time job j becomes a re-legalization candidate (I32_MAX: never)
  auto e_of = [&](int j, int& m_next, int& f_next, int& mj, bool& cont) {
    int jbf = l.row(l.L.jbf(), j);
    int nxt = l.row(l.L.next_op(), j) + 1;
    int needed = l.row(l.L.needed(), j);
    bool running = jbf > 0;
    cont = running && nxt < nm;
    m_next = clampi(l.om[j * M + clampi(nxt, 0, M - 1)], 0, M - 1);
    f_next = t0 + l.row(mbf, m_next);
    mj = clampi(needed, 0, M - 1);
    bool waiting = !running && needed >= 0 && !l.row(l.L.legal(), j) &&
                   j < l.nj && !l.row(l.L.noop_pin(), j);
    if (cont) return max(t0 + jbf, f_next);
    if (waiting) return max(first_ev, t0 + l.row(mbf, mj));
    return JSS_I32_MAX;
  };

  int T_stop = last_ev;
  for (int j = 0; j < J; ++j) {
    int m_next, f_next, mj;
    bool cont;
    T_stop = min(T_stop, e_of(j, m_next, f_next, mj, cont));
  }
  const int span = T_stop - t0;

  // per-job update over [t0, T_stop]; machine timers stay at their entry
  // values until every e_j has been re-read
  int nb_legal = l.at(l.L.nb_legal());
  int nb_ml = l.at(l.L.nb_ml());
  for (int j = 0; j < J; ++j) {
    int m_next, f_next, mj;
    bool cont;
    const int e = e_of(j, m_next, f_next, mj, cont);
    const int jbf = l.row(l.L.jbf(), j);
    const bool running = jbf > 0;
    const int c = t0 + jbf;
    if (running) {
      l.row(l.L.jbf(), j) = max(0, jbf - span);
      l.row(l.L.work_done(), j) += min(span, jbf);
    }
    int legal = l.row(l.L.legal(), j);
    if (running && c <= T_stop) {
      l.row(l.L.op_end_at(), j) = c;
      const int no = l.row(l.L.next_op(), j) + 1;
      l.row(l.L.next_op(), j) = no;
      if (no < nm) {
        l.row(l.L.needed(), j) = m_next;
        l.row(l.L.wait4(), j) = max(0, f_next - c);
      } else if (no == nm) {
        l.row(l.L.needed(), j) = -1;
        if (legal) {
          legal = 0;
          --nb_legal;
        }
      }
    }
    if (e == T_stop) {
      legal = 1;
      ++nb_legal;
      int mc = cont ? m_next : mj;
      if (!l.row(l.L.ml(), mc)) {
        l.row(l.L.ml(), mc) = 1;
        ++nb_ml;
      }
    }
    l.row(l.L.legal(), j) = legal;
  }

  int holes = 0;
  for (int m = 0; m < M; ++m) {
    int v = l.row(mbf, m);
    if (m < nm) holes += span - min(v, span);
    l.row(mbf, m) = max(0, v - span);
  }
  l.at(l.L.time()) = T_stop;
  l.at(l.L.nb_legal()) = nb_legal;
  l.at(l.L.nb_ml()) = nb_ml;
  return holes;
}

// engine.prioritization_non_final
template <typename V>
__device__ void prioritization(Lane<V>& l) {
  const int J = l.J, M = l.M, nm = l.nm;
  int min_nf[JSS_MAX_M];
  for (int m = 0; m < M; ++m) min_nf[m] = JSS_I32_MAX;
  for (int j = 0; j < J; ++j) {
    const int needed = l.row(l.L.needed(), j);
    if (!l.row(l.L.legal(), j) || needed < 0) continue;
    const int m_of = clampi(needed, 0, M - 1);
    if (!l.row(l.L.ml(), m_of)) continue;
    const int nxo = l.row(l.L.next_op(), j);
    if (nxo == nm - 1) continue;
    const int next_m = l.om[j * M + clampi(nxo + 1, 0, M - 1)];
    if (l.row(l.L.mbf(), next_m) != 0) continue;
    min_nf[m_of] = min(min_nf[m_of], l.od[j * M + clampi(nxo, 0, M - 1)]);
  }
  int kills = 0;
  for (int j = 0; j < J; ++j) {
    const int needed = l.row(l.L.needed(), j);
    if (!l.row(l.L.legal(), j) || needed < 0) continue;
    const int m_of = clampi(needed, 0, M - 1);
    const int nxo = l.row(l.L.next_op(), j);
    if (!l.row(l.L.ml(), m_of) || nxo != nm - 1) continue;
    if (l.od[j * M + clampi(nxo, 0, M - 1)] > min_nf[m_of]) {
      l.row(l.L.legal(), j) = 0;
      ++kills;
    }
  }
  l.at(l.L.nb_legal()) -= kills;
}

// engine.check_no_op
template <typename V>
__device__ void check_no_op(Lane<V>& l) {
  const int J = l.J, M = l.M, nm = l.nm;
  const int mbf = l.L.mbf();
  bool any_busy = false;
  int min_busy = JSS_I32_MAX;
  for (int m = 0; m < M; ++m) {
    int v = l.row(mbf, m);
    if (v > 0) {
      any_busy = true;
      min_busy = min(min_busy, v);
    }
  }
  const int nb_ml = l.at(l.L.nb_ml());
  V& noop = l.at(l.L.noop_legal());
  noop = 0;
  if (!(any_busy && nb_ml <= 3 && l.at(l.L.nb_legal()) <= 4)) return;
  const int t = l.at(l.L.time());
  const int next_ev = t + min_busy;
  const int cap = t + l.mo;

  // pass 1: horizons from the legal jobs
  int first_end[JSS_MAX_M];  // end of the first legal job on m, in index order
  int mh[JSS_MAX_M];         // min end over the legal jobs on m
  for (int m = 0; m < M; ++m) {
    first_end[m] = JSS_I32_MAX;
    mh[m] = JSS_I32_MAX;
  }
  bool has_first[JSS_MAX_M];
  for (int m = 0; m < M; ++m) has_first[m] = false;
  for (int j = 0; j < J; ++j) {
    if (!l.row(l.L.legal(), j)) continue;
    const int m1 = clampi(l.row(l.L.needed(), j), 0, M - 1);
    const int end = t + l.od[j * M + clampi(l.row(l.L.next_op(), j), 0, M - 1)];
    if (end < next_ev) return;  // early out: no-op stays illegal
    if (!has_first[m1]) {
      has_first[m1] = true;
      first_end[m1] = end;
    }
    mh[m1] = min(mh[m1], end);
  }
  int max_h = t;
  for (int m = 0; m < M; ++m) {
    if (has_first[m]) max_h = max(max_h, min(cap, first_end[m]));
    mh[m] = min(cap, mh[m]);
  }

  // pass 2: op-chain walk of the illegal jobs over the static tables
  int* tn_min = first_end;  // reused
  for (int m = 0; m < M; ++m) tn_min[m] = JSS_I32_MAX;
  const int nj = l.nj;
  for (int j = 0; j < nj && j < J; ++j) {
    if (l.row(l.L.legal(), j)) continue;
    const int jbf = l.row(l.L.jbf(), j);
    const int nxo = l.row(l.L.next_op(), j);
    const bool case1 = jbf > 0 && nxo + 1 < nm;
    const bool case2 = !case1 && !l.row(l.L.noop_pin(), j) && nxo < nm;
    if (!(case1 || case2)) continue;
    const int start = case1 ? nxo + 1 : nxo;
    const int wd = l.row(l.L.work_done(), j);
    const int base =
        case1 ? t - wd
              : t + l.row(mbf, clampi(l.row(l.L.needed(), j), 0, M - 1)) - wd;
    const int* pos = l.op + j * M;
    const int* cum = l.cb + j * M;
    for (int m = 0; m < M; ++m) {
      const int tn = base + cum[m];
      if (pos[m] >= start && pos[m] < nm - 1 && max_h > tn)
        tn_min[m] = min(tn_min[m], tn);
    }
  }
  for (int m = 0; m < M; ++m)
    if (l.row(l.L.ml(), m) && !(tn_min[m] < mh[m])) return;
  noop = nb_ml > 0 ? 1 : 0;
}

// engine.step: allocate job `action` or wait (action >= nj); returns the raw
// integer reward.
template <typename V>
__device__ int step(Lane<V>& l, int action) {
  const int J = l.J, M = l.M;
  int raw = 0;
  if (action < l.nj) {
    const int a = clampi(action, 0, J - 1);
    const int op = clampi(l.row(l.L.next_op(), a), 0, M - 1);
    const int needed_a = l.row(l.L.needed(), a);
    const int m = clampi(needed_a, 0, M - 1);
    const int dur = l.od[a * M + op];
    const int t = l.at(l.L.time());
    raw = dur;
    int kills = 0;
    for (int j = 0; j < J; ++j) {
      const int nd = l.row(l.L.needed(), j);
      if (l.row(l.L.legal(), j) && nd == needed_a) {
        l.row(l.L.legal(), j) = 0;
        ++kills;
      }
      if (clampi(nd, 0, M - 1) == m) l.row(l.L.noop_pin(), j) = 0;
    }
    l.row(l.L.mbf(), m) = dur;
    l.row(l.L.jbf(), a) = dur;
    const int idle_span = t - l.row(l.L.op_end_at(), a);
    l.row(l.L.idle_frozen(), a) = idle_span;
    l.row(l.L.idle_total(), a) += idle_span;
    if (l.with_solution) l.row(l.L.solution(), a * M + op) = t;
    l.at(l.L.nb_legal()) -= kills;
    l.row(l.L.ml(), m) = 0;
    l.at(l.L.nb_ml()) -= 1;
  } else {
    // no-op: pin every legal job; its machine loses legality
    for (int j = 0; j < J; ++j) {
      if (!l.row(l.L.legal(), j)) continue;
      l.row(l.L.noop_pin(), j) = 1;
      l.row(l.L.ml(), clampi(l.row(l.L.needed(), j), 0, M - 1)) = 0;
      l.row(l.L.legal(), j) = 0;
    }
    l.at(l.L.nb_legal()) = 0;
    l.at(l.L.nb_ml()) = 0;
  }
  raw -= fast_forward(l);
  prioritization(l);
  check_no_op(l);
  return raw;
}

// engine._fresh_state for one lane: padded job rows start finished, padded
// machines are never legal.
template <typename V>
__device__ void fresh(Lane<V>& l) {
  const int J = l.J, M = l.M;
  l.at(l.L.time()) = 0;
  l.at(l.L.noop_legal()) = 0;
  l.at(l.L.nb_legal()) = l.nj;
  for (int m = 0; m < M; ++m) {
    l.row(l.L.ml(), m) = 0;
    l.row(l.L.mbf(), m) = 0;
  }
  int nb_ml = 0;
  for (int j = 0; j < J; ++j) {
    const bool valid = j < l.nj;
    l.row(l.L.legal(), j) = valid;
    l.row(l.L.jbf(), j) = 0;
    l.row(l.L.next_op(), j) = valid ? 0 : l.nm;
    l.row(l.L.work_done(), j) = 0;
    l.row(l.L.needed(), j) = valid ? l.om[j * M] : -1;
    l.row(l.L.op_end_at(), j) = 0;
    l.row(l.L.idle_frozen(), j) = 0;
    l.row(l.L.idle_total(), j) = 0;
    l.row(l.L.noop_pin(), j) = 0;
    l.row(l.L.wait4(), j) = 0;
    if (valid) {
      const int m = clampi(l.om[j * M], 0, M - 1);
      if (!l.row(l.L.ml(), m)) {
        l.row(l.L.ml(), m) = 1;
        ++nb_ml;
      }
    }
  }
  l.at(l.L.nb_ml()) = nb_ml;
  if (l.with_solution)
    for (int x = 0; x < J * M; ++x) l.row(l.L.solution(), x) = -1;
}

// Per-lane constants: rows of the (5, B) int32 buffer.
enum { C_INST = 0, C_NJ, C_NM, C_MO, C_SO, C_ROWS };

template <typename V>
__device__ Lane<V> make_lane(V* state, const int* tab, const int* lanec, int b,
                             int B, int J, int M, int with_solution) {
  Lane<V> l{state + b, (size_t)B, Layout(J, M), nullptr, nullptr, nullptr, nullptr,
         J, M, 0, 0, 0, with_solution != 0};
  const size_t JM = (size_t)J * M;
  const int* t = tab + (size_t)lanec[C_INST * B + b] * 4 * JM;
  l.om = t;
  l.od = t + JM;
  l.op = t + 2 * JM;
  l.cb = t + 3 * JM;
  l.nj = lanec[C_NJ * B + b];
  l.nm = lanec[C_NM * B + b];
  l.mo = lanec[C_MO * B + b];
  return l;
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

__global__ void rollout_driven_kernel(int* state, const int* tab, const int* lanec,
                                      const int* actions, int* rewards, int B,
                                      int J, int M, int T, int with_solution) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Lane<int> l = make_lane(state, tab, lanec, b, B, J, M, with_solution);
  for (int t = 0; t < T; ++t) {
    rewards[(size_t)t * B + b] = step(l, actions[(size_t)t * B + b]);
    if (l.at(l.L.nb_legal()) == 0) fresh(l);
  }
}

// Per-lane stats rows of the (4, B) int64 output.
enum { S_EPISODES = 0, S_MK_SUM, S_MK_MIN, S_VIOL };

// V: the state buffer's storage type, int32_t or int16_t (the int16 value
// mode of jssenv_tpu/core/pallas_rollout.py value_dtype, chosen by the
// wrapper only when every stored value fits).
template <typename V>
__global__ void rollout_free_kernel(V* state, const int* tab, const int* lanec,
                                    const uint32_t* bits, unsigned long long seed,
                                    long long* stats, float* ret_out, int B, int J,
                                    int M, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // the stats never read the schedule: the state is light (no solution rows)
  Lane<V> l = make_lane(state, tab, lanec, b, B, J, M, 0);
  const int so = lanec[C_SO * B + b];
  const float mo_f = (float)l.mo;
  long long episodes = 0, mk_sum = 0, viol = 0;
  int mk_min = JSS_I32_MAX, ep_raw = 0;
  float ret = 0.f;
  for (int t = 0; t < T; ++t) {
    // uniform over the legal actions: k-th legal job, k >= nb_legal = no-op
    const uint32_t w = bits ? bits[(size_t)t * B + b] : philox_word(seed, t, b);
    const int k31 = (int)(w >> 1);
    const int nb = l.at(l.L.nb_legal());
    const int n = nb + l.at(l.L.noop_legal());
    const int k = k31 % max(n, 1);
    int action = l.nj;
    if (k < nb) {
      action = 0;
      for (int j = 0, cnt = 0; j < J; ++j) {
        if (!l.row(l.L.legal(), j)) continue;
        if (cnt++ == k) {
          action = j;
          break;
        }
      }
    }
    const int raw = step(l, action);
    ep_raw += raw;
    ret += (float)raw / mo_f;
    if (l.at(l.L.nb_legal()) == 0) {
      const int mk = l.at(l.L.time());
      ++episodes;
      mk_sum += mk;
      mk_min = min(mk_min, mk);
      if (ep_raw != 2 * so - l.nm * mk) ++viol;
      ep_raw = 0;
      fresh(l);
    }
  }
  stats[S_EPISODES * (size_t)B + b] = episodes;
  stats[S_MK_SUM * (size_t)B + b] = mk_sum;
  stats[S_MK_MIN * (size_t)B + b] = mk_min;
  stats[S_VIOL * (size_t)B + b] = viol;
  ret_out[b] = ret;
}

constexpr int kBlock = 128;

template <typename V>
static int launch_free(void* state, const void* tab, const void* lanec,
                       const void* bits, unsigned long long seed, void* stats,
                       void* ret_out, int B, int J, int M, int T, void* stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  rollout_free_kernel<V><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (V*)state, (const int*)tab, (const int*)lanec, (const uint32_t*)bits, seed,
      (long long*)stats, (float*)ret_out, B, J, M, T);
  return (int)cudaGetLastError();
}

extern "C" {

int jss_max_machines() { return JSS_MAX_M; }

// Each returns cudaGetLastError() after the launch (0 = launched).
int jss_rollout_driven(void* state, const void* tab, const void* lanec,
                       const void* actions, void* rewards, int B, int J, int M,
                       int T, int with_solution, void* stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  rollout_driven_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (int*)state, (const int*)tab, (const int*)lanec, (const int*)actions,
      (int*)rewards, B, J, M, T, with_solution);
  return (int)cudaGetLastError();
}

int jss_rollout_free(void* state, const void* tab, const void* lanec,
                     const void* bits, unsigned long long seed, void* stats,
                     void* ret_out, int B, int J, int M, int T, void* stream) {
  return launch_free<int32_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J,
                              M, T, stream);
}

// The same kernel on an (R, B) int16 state buffer.
int jss_rollout_free_i16(void* state, const void* tab, const void* lanec,
                         const void* bits, unsigned long long seed, void* stats,
                         void* ret_out, int B, int J, int M, int T, void* stream) {
  return launch_free<int16_t>(state, tab, lanec, bits, seed, stats, ret_out, B, J,
                              M, T, stream);
}

}  // extern "C"

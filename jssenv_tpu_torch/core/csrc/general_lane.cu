// Driven and free rollout kernels for padded and mixed-shape batches, for
// NVIDIA Hopper (sm_90a): a lane's state in registers for the whole launch,
// its boolean rows as warp-wide bitmasks, with the padded shape (J, M) read
// from the launch and each lane's own (nj, nm) from its lane constants.
//
// Replaces rollout.cu's general build for every batch that the static
// builds do not take and whose padded shape is within this source's limits
// (J <= 128, M <= 64; a larger shape runs rollout.cu): the counterparts of
// jssenv_tpu/core/pallas_rollout.py's _driven_kernel (:598, pallas_call
// :1119) and _free_kernel (:653, pallas_call :1214) compiled with
// static_lane=None, and of the in-kernel reset _fresh (:549).
//   * driven_general_kernel: T steps of engine.step on the caller's (T, B)
//     actions with auto-reset; the raw rewards, the episode ends and a new
//     state, read from and written to the EnvState's own tensors
//     (driven_lane.cuh); bit-equal to fused_rollout.rollout_driven_reference.
//   * free_general_kernel: T uniform-over-legal steps drawn in the kernel
//     (Philox counter (step, lane_offset + lane)), auto-reset, per-lane stats,
//     float32 returns and the reward identity, read from the EnvState's own
//     tensors (free_lane.cuh); bit-equal to
//     fused_rollout.free_lane_stats_reference.
//
// Design. The static builds' lane (static_lane.cuh) with Bounds read at run
// time: one library per slot class (-DJSS_SLOTS_J=S -DJSS_SLOTS_M=K), S job
// slots and K machine words a thread, S = ceil(J/32) in 1..4 and
// K = ceil(M/32) in 1..2, so every slot loop still unrolls while the compares
// against the lane's nj and nm, its table strides and its row offsets are
// run-time values. Lanes of different (nj, nm) share a block of kLanes warps;
// nothing crosses a warp, so they need no sync. A padded job is a row of the
// state that starts finished and is never legal; a padded machine is never
// legal and its idle time is not counted (static_lane.cuh, "Bounds").
//
// What bounds it (NVIDIA H100 80GB HBM3; PERF.md): as in the static builds,
// neither bytes nor operations but the instructions each step issues (free)
// and, at T = 1, each warp's chain of dependent memory round trips (driven);
// the run-time bounds cost a few registers and compares a step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "driven_lane.cuh"
#include "free_lane.cuh"

#if !defined(JSS_SLOTS_J) || !defined(JSS_SLOTS_M)
#error "general_lane.cu builds for one slot class: -DJSS_SLOTS_J=S -DJSS_SLOTS_M=K"
#endif

// ---- host side: the C entry points ------------------------------------------

// Whether this slot class takes the padded shape (J, M).
static bool takes(int J, int M) { return J >= 1 && M >= 1 && (J + 31) / 32 == S && (M + 31) / 32 == K; }

extern "C" {

// This build's slot class and lanes a block: the wrapper checks them.
int jss_slots_j(void) { return S; }
int jss_slots_m(void) { return K; }
int jss_general_lanes(void) { return kLanes; }

// Blocks of each kernel resident on one SM of the current device at once, or
// -1 on a CUDA error.
int jss_driven_general_blocks_per_sm(void) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, driven_general_kernel, kLanes * 32, 0);
  return err == cudaSuccess ? n : -1;
}
int jss_free_general_blocks_per_sm(void) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, free_general_kernel, kLanes * 32, 0);
  return err == cudaSuccess ? n : -1;
}

// One driven launch, kLanes lanes a block, no shared memory, on `stream`:
// the arguments of driven_static.cu's jss_driven_static, the padded shape
// (J, M) of this slot class. Returns 0 when the kernel launched, else the
// CUDA error; a shape of another slot class is refused
// (cudaErrorInvalidValue) before anything runs.
int jss_driven_general(const void* time, const void* nb_legal, const void* nb_ml, const void* mbf, const void* jbf,
                       const void* next_op, const void* work_done, const void* needed, const void* op_end_at,
                       const void* idle_frozen, const void* idle_total, const void* wait4, const void* solution,
                       const void* noop_legal, const void* legal, const void* noop_pin, const void* ml,
                       const void* tab, const void* lanec, const void* actions, void* out, void* out8, int B, int J,
                       int M, int T, int with_solution, void* stream) {
  if (!takes(J, M) || B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const DrivenIO io{(const int*)time, (const int*)nb_legal, (const int*)nb_ml, (const int*)mbf,
                    (const int*)jbf, (const int*)next_op, (const int*)work_done, (const int*)needed,
                    (const int*)op_end_at, (const int*)idle_frozen, (const int*)idle_total, (const int*)wait4,
                    (const int*)solution, (const uint8_t*)noop_legal, (const uint8_t*)legal,
                    (const uint8_t*)noop_pin, (const uint8_t*)ml, (const int*)tab, (const int*)lanec,
                    (const int*)actions, (int*)out, (uint8_t*)out8, B, T, with_solution, J, M};
  driven_general_kernel<<<(B + kLanes - 1) / kLanes, kLanes * 32, 0, (cudaStream_t)stream>>>(io);
  return (int)cudaGetLastError();
}

// One free launch, kLanes lanes a block, no shared memory, on `stream`: the
// arguments of free_static.cu's jss_free_static, the padded shape (J, M) of
// this slot class. Returns 0 when the kernel launched, else the CUDA error;
// a shape of another slot class is refused (cudaErrorInvalidValue) before
// anything runs.
int jss_free_general(JSS_FREE_PARAMS, void* stream) {
  if (!takes(J, M) || B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  free_general_kernel<<<(B + kLanes - 1) / kLanes, kLanes * 32, 0, (cudaStream_t)stream>>>(JSS_FREE_IO);
  return (int)cudaGetLastError();
}

}  // extern "C"

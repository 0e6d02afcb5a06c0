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
// change. The kernel's body and its I/O (the EnvState's own batch-first
// tensors in, a new state in two allocations out, the input never written)
// are driven_lane.cuh's, shared with general_lane.cu's slot-class build;
// here every bound is a compile-time constant.
//
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W; PERF.md): at T=1, where
// the main paths run it, neither bytes nor operations but each warp's chain
// of dependent memory round trips, times about 3.4 waves of 36 resident warps
// an SM at B=16384: 0.031 ms for a full ta01 state against the 0.0147 ms its
// 1498 bytes a lane each way (60% of them the solution) take at the card's
// memory rate. So the load issues its reads together (driven_load); more
// warps with fewer registers spilled and ran slower. At large T the
// instructions each step issues, as in the free kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "driven_lane.cuh"

#ifndef JSS_STATIC_J
#error "driven_static.cu builds for one static shape: -DJSS_STATIC_J=J -DJSS_STATIC_M=M"
#endif

// ---- host side: the C entry points ------------------------------------------

extern "C" {

// This build's shape and lanes a block: the wrapper checks them.
int jss_static_j(void) { return Bounds::J; }
int jss_static_m(void) { return Bounds::M; }
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
  if (J_ != Bounds::J || M_ != Bounds::M || B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const DrivenIO io{(const int*)time, (const int*)nb_legal, (const int*)nb_ml, (const int*)mbf,
                    (const int*)jbf, (const int*)next_op, (const int*)work_done, (const int*)needed,
                    (const int*)op_end_at, (const int*)idle_frozen, (const int*)idle_total, (const int*)wait4,
                    (const int*)solution, (const uint8_t*)noop_legal, (const uint8_t*)legal,
                    (const uint8_t*)noop_pin, (const uint8_t*)ml, (const int*)tab, (const int*)lanec,
                    (const int*)actions, (int*)out, (uint8_t*)out8, B, T, with_solution, J_, M_};
  driven_static_kernel<<<(B + kLanes - 1) / kLanes, kLanes * 32, 0, (cudaStream_t)stream>>>(io);
  return (int)cudaGetLastError();
}

}  // extern "C"

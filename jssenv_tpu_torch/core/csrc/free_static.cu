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
// machine_legal as warp-uniform words, nothing in shared memory. The draw,
// the Philox words, the stats and the load of the state's own fields are
// free_lane.cuh's, shared with general_lane.cu's slot-class build; here
// every bound is a compile-time constant.
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

#include "free_lane.cuh"

#ifndef JSS_STATIC_J
#error "free_static.cu builds for one static shape: -DJSS_STATIC_J=J -DJSS_STATIC_M=M"
#endif

// ---- host side: the C entry points ------------------------------------------

// A launch of kLanes lanes a block, no shared memory. Returns 0 or the CUDA
// error; a shape other than this build's is refused (cudaErrorInvalidValue)
// before anything runs.
static int launch(const FreeIO& io, void* stream) {
  if (io.J != Bounds::J || io.M != Bounds::M || io.B < 0 || io.T < 0) return (int)cudaErrorInvalidValue;
  if (io.B == 0) return 0;
  free_static_kernel<<<(io.B + kLanes - 1) / kLanes, kLanes * 32, 0, (cudaStream_t)stream>>>(io);
  return (int)cudaGetLastError();
}

extern "C" {

// This build's shape and lanes a block: the wrapper checks them.
int jss_static_j(void) { return Bounds::J; }
int jss_static_m(void) { return Bounds::M; }
int jss_free_static_lanes(void) { return kLanes; }

// Blocks of the kernel resident on one SM of the current device at once, or
// -1 on a CUDA error.
int jss_free_static_blocks_per_sm(void) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, free_static_kernel, kLanes * 32, 0);
  return err == cudaSuccess ? n : -1;
}

// One launch on `stream`: the input state's fields (in FreeIO's order), the
// tables, the lane constants, the caller's (T, B) words or null, the seed,
// the (4, B) stats and (B,) returns written. 0 when the kernel launched,
// else the CUDA error.
int jss_free_static(JSS_FREE_PARAMS, void* stream) { return launch(JSS_FREE_IO, stream); }

#ifdef JSS_PASS_CLOCKS
// The instrumented kernel, the cycles of each pass summed per lane into
// `clocks` ((PASSES, B) int64): the draw, the action's update, fast_forward,
// prioritization, check_no_op, the episode's bookkeeping and reset.
int jss_free_static_clocks(JSS_FREE_PARAMS, void* stream, void* clocks) {
  long long* p = (long long*)clocks;
  const cudaError_t err = cudaMemcpyToSymbolAsync(jss_pass_clocks, &p, sizeof(p), 0,
                                                  cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return launch(JSS_FREE_IO, stream);
}
int jss_pass_count(void) { return PASSES; }
#endif

}  // extern "C"

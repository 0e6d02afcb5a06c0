// The policy's per-step inputs in one launch, for NVIDIA Hopper (sm_90a):
// from the EnvState's own batch-first tensors, the (B, J, 7) float32
// observation with column 0 set to the legal mask, the (B, J+1) action mask
// (jobs, then the no-op slot) and the (B, J) rows that are real jobs.
//
// Replaces no Pallas kernel: the JAX package leaves the observation
// (jssenv_tpu/core/state.py, EnvState.obs) to XLA's fusion inside jit, while
// eager PyTorch pays a launch for each of its ops (about 44 a step in the
// learner's rollout). Every output is bit-equal to the plain expressions,
// EnvState.observation()["real_obs"], action_mask() and job_valid: int32
// differences and sums wrap as the tensors' do, each column is an int32
// converted to float32 (round to nearest) and divided in IEEE float32, never
// multiplied by a reciprocal (built without --use_fast_math). A finished job
// (needed_machine == -1) reads 1.0 in column 4; a padded job row reads 0.0
// in columns 1-6 and its legal bit in column 0, as the plain expressions set
// it after their where.
//
// Design. One pass, nothing kept between threads: one thread a (lane, job)
// pair, J + 1 threads a lane, consecutive threads on consecutive jobs, so a
// warp's loads of each (B, J) field are coalesced and a lane's scalars are
// one broadcast. The thread at j == J writes the no-op slot of the mask and
// nothing else. A general build: J and B are run-time values, one library
// whatever the shape.
//
// What bounds it: bytes over the card's 3.35 TB/s (NVIDIA H100 80GB HBM3).
// At B = 8192, J = 15: 33 bytes read and 30 written a job, 25 read and one
// written a lane, about 8.0 MB, 2.4 us; a launch costs more than that.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch's tensors: the (B, J) job rows, the (B,) lane scalars, the
// outputs. Every int32 or bool (one byte) tensor is contiguous.
struct ObserveIO {
  const uint8_t* legal;
  const uint8_t* noop_legal;
  const int* job_busy_for;
  const int* next_op;
  const int* work_done;
  const int* needed_machine;
  const int* wait4;
  const int* op_end_at;
  const int* idle_frozen;
  const int* idle_total_alloc;
  const int* time;
  const int* num_jobs;
  const int* num_machines;
  const int* max_time_op;
  const int* max_time_jobs;
  const int* sum_op;
  float* obs;      // (B, J, 7)
  uint8_t* mask;   // (B, J + 1)
  uint8_t* valid;  // (B, J)
  int B, J;
};

constexpr int kObsCols = 7;
constexpr int kObserveThreads = 256;

__global__ void __launch_bounds__(kObserveThreads) observe_kernel(ObserveIO io) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int J1 = io.J + 1;
  if (i >= (long long)io.B * J1) return;
  const int b = (int)(i / J1), j = (int)(i - (long long)b * J1);
  if (j == io.J) {
    io.mask[i] = io.noop_legal[b] != 0;
    return;
  }
  const long long k = (long long)b * io.J + j;  // (b, j) in a (B, J) row
  const uint8_t legal = io.legal[k] != 0;
  io.mask[i] = legal;
  const bool real = j < io.num_jobs[b];
  io.valid[k] = real;
  float* o = io.obs + k * kObsCols;
  o[0] = legal ? 1.0f : 0.0f;
  if (!real) {
    for (int c = 1; c < kObsCols; ++c) o[c] = 0.0f;
    return;
  }
  const int jbf = io.job_busy_for[k], next_op = io.next_op[k], nm = io.num_machines[b];
  const float max_op = (float)io.max_time_op[b], sum_op = (float)io.sum_op[b];
  // EnvState._waiting_span: running, finished and time - op_end_at (wraps)
  const bool running = jbf > 0, finished = next_op >= nm;
  const int span = (int)((unsigned)io.time[b] - (unsigned)io.op_end_at[k]);
  const int idle_since = running ? io.idle_frozen[k] : (finished ? 0 : span);
  const int idle_total = (int)((unsigned)io.idle_total_alloc[k] + (unsigned)(running || finished ? 0 : span));
  o[1] = (float)jbf / max_op;
  o[2] = (float)next_op / (float)nm;
  o[3] = (float)io.work_done[k] / (float)io.max_time_jobs[b];
  o[4] = io.needed_machine[k] == -1 ? 1.0f : (float)io.wait4[k] / max_op;
  o[5] = (float)idle_since / sum_op;
  o[6] = (float)idle_total / sum_op;
}

// ---- host side: the C entry point -------------------------------------------

extern "C" {

// One launch on `stream`, kObserveThreads threads a block, J + 1 threads a
// lane. The pointers are ObserveIO's, in its order. Returns 0 when the
// kernel launched, else the CUDA error; a negative B or a J below 1 is
// refused (cudaErrorInvalidValue) before anything runs.
int jss_observe(const void* legal, const void* noop_legal, const void* job_busy_for, const void* next_op,
                const void* work_done, const void* needed_machine, const void* wait4, const void* op_end_at,
                const void* idle_frozen, const void* idle_total_alloc, const void* time, const void* num_jobs,
                const void* num_machines, const void* max_time_op, const void* max_time_jobs, const void* sum_op,
                void* obs, void* mask, void* valid, int B, int J, void* stream) {
  if (B < 0 || J < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const ObserveIO io{(const uint8_t*)legal, (const uint8_t*)noop_legal, (const int*)job_busy_for,
                     (const int*)next_op, (const int*)work_done, (const int*)needed_machine, (const int*)wait4,
                     (const int*)op_end_at, (const int*)idle_frozen, (const int*)idle_total_alloc,
                     (const int*)time, (const int*)num_jobs, (const int*)num_machines, (const int*)max_time_op,
                     (const int*)max_time_jobs, (const int*)sum_op, (float*)obs, (uint8_t*)mask, (uint8_t*)valid,
                     B, J};
  const long long threads = (long long)B * (J + 1);
  const long long blocks = (threads + kObserveThreads - 1) / kObserveThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  observe_kernel<<<(unsigned)blocks, kObserveThreads, 0, (cudaStream_t)stream>>>(io);
  return (int)cudaGetLastError();
}

}  // extern "C"

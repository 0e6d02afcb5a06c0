// Native single-env job-shop scheduling engine (host/serving runtime path).
//
// Implements exactly the simulator semantics of jssenv_tpu_torch.core.engine
// (which is itself bit-compatible with the reference JSSEnv env; see
// docs/DESIGN.md): event-driven time advance as a min-reduction over busy
// machines, sticky no-op pins, and the two mask-shaping heuristics. The
// scalar formulation here serves the single-env gym wrapper and schedule
// replay at native speed; the torch engine remains the batched/GPU path.
// Exposed as a C ABI consumed via ctypes (jssenv_tpu_torch/native/__init__.py);
// state lives in engine-owned buffers so Python reads it zero-copy. A copy of
// jssenv_tpu/native/jss_engine.cpp with the same code.
//
// All simulation arithmetic is int32 (durations/clock/idle); observations are
// float32 normalized exactly as the JAX engine computes them.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr int32_t kI32Max = INT32_MAX;

struct Engine {
  // instance (owned)
  int32_t jobs = 0;
  int32_t machines = 0;
  int32_t *op_machine = nullptr;  // [jobs*machines]
  int32_t *op_dur = nullptr;      // [jobs*machines]
  int32_t max_time_op = 0;
  int32_t max_time_jobs = 0;
  int32_t sum_op = 0;

  // dynamic state (owned; exposed to Python as numpy views)
  int32_t time = 0;
  int32_t nb_legal = 0;
  int32_t nb_machine_legal = 0;
  uint8_t noop_legal = 0;
  uint8_t *legal = nullptr;            // [jobs]
  uint8_t *machine_legal = nullptr;    // [machines]
  int32_t *machine_busy_for = nullptr; // [machines]
  int32_t *job_busy_for = nullptr;     // [jobs]
  int32_t *next_op = nullptr;          // [jobs]
  int32_t *work_done = nullptr;        // [jobs]
  int32_t *needed_machine = nullptr;   // [jobs]
  int32_t *idle_total = nullptr;       // [jobs]
  int32_t *idle_since_op = nullptr;    // [jobs]
  uint8_t *pin = nullptr;              // [machines*jobs]
  uint8_t *noop_pin = nullptr;         // [jobs]
  int32_t *solution = nullptr;         // [jobs*machines]
  float *obs = nullptr;                // [jobs*7]

  int32_t om(int j, int k) const { return op_machine[j * machines + k]; }
  int32_t od(int j, int k) const { return op_dur[j * machines + k]; }
};

int32_t min_busy(const Engine &e) {
  int32_t m = kI32Max;
  for (int i = 0; i < e.machines; ++i)
    if (e.machine_busy_for[i] > 0) m = std::min(m, e.machine_busy_for[i]);
  return m;  // kI32Max when no machine busy
}

// Advance the clock to the earliest completion event; returns the machine
// idle time ("holes") accrued. Safe no-op when nothing is busy.
int32_t advance_time(Engine &e) {
  int32_t diff = min_busy(e);
  if (diff == kI32Max) return 0;
  e.time += diff;
  const float max_op_f = static_cast<float>(e.max_time_op);
  const float max_jobs_f = static_cast<float>(e.max_time_jobs);
  const float sum_op_f = static_cast<float>(e.sum_op);

  // per-job update
  for (int j = 0; j < e.jobs; ++j) {
    float *ob = e.obs + j * 7;
    const int32_t was_left = e.job_busy_for[j];
    if (was_left > 0) {
      const int32_t performed = std::min(diff, was_left);
      e.job_busy_for[j] = std::max(0, was_left - diff);
      ob[1] = static_cast<float>(e.job_busy_for[j]) / max_op_f;
      e.work_done[j] += performed;
      ob[3] = static_cast<float>(e.work_done[j]) / max_jobs_f;
      if (e.job_busy_for[j] == 0) {
        e.idle_total[j] += diff - was_left;
        ob[6] = static_cast<float>(e.idle_total[j]) / sum_op_f;
        e.idle_since_op[j] = diff - was_left;
        ob[5] = static_cast<float>(e.idle_since_op[j]) / sum_op_f;
        e.next_op[j] += 1;
        ob[2] = static_cast<float>(e.next_op[j]) / static_cast<float>(e.machines);
        if (e.next_op[j] < e.machines) {
          e.needed_machine[j] = e.om(j, e.next_op[j]);
          const int32_t wait =
              std::max(0, e.machine_busy_for[e.needed_machine[j]] - diff);
          ob[4] = static_cast<float>(wait) / max_op_f;
        } else {
          e.needed_machine[j] = -1;
          ob[4] = 1.0f;  // finished sentinel
          if (e.legal[j]) {
            e.legal[j] = 0;
            e.nb_legal -= 1;
          }
        }
      }
    } else if (e.next_op[j] < e.machines) {
      e.idle_total[j] += diff;
      e.idle_since_op[j] += diff;
      ob[5] = static_cast<float>(e.idle_since_op[j]) / sum_op_f;
      ob[6] = static_cast<float>(e.idle_total[j]) / sum_op_f;
    }
  }

  // per-machine update: holes, busy countdown, re-legalization
  int32_t holes = 0;
  for (int m = 0; m < e.machines; ++m) {
    if (e.machine_busy_for[m] < diff) holes += diff - e.machine_busy_for[m];
    e.machine_busy_for[m] = std::max(0, e.machine_busy_for[m] - diff);
    if (e.machine_busy_for[m] == 0) {
      for (int j = 0; j < e.jobs; ++j) {
        if (e.needed_machine[j] == m && !e.legal[j] && !e.pin[m * e.jobs + j]) {
          e.legal[j] = 1;
          e.nb_legal += 1;
          if (!e.machine_legal[m]) {
            e.machine_legal[m] = 1;
            e.nb_machine_legal += 1;
          }
        }
      }
    }
  }
  return holes;
}

// Heuristic 1: prefer fast non-final ops whose next machine is free over
// slower final ops competing for the same machine.
void prioritization_non_final(Engine &e) {
  if (e.nb_machine_legal < 1) return;
  for (int m = 0; m < e.machines; ++m) {
    if (!e.machine_legal[m]) continue;
    int32_t min_non_final = kI32Max;
    bool has_non_final = false;
    for (int j = 0; j < e.jobs; ++j) {
      if (!e.legal[j] || e.needed_machine[j] != m) continue;
      const int32_t op = e.next_op[j];
      if (op == e.machines - 1) continue;  // final op: judged below
      if (e.machine_busy_for[e.om(j, op + 1)] == 0) {
        min_non_final = std::min(min_non_final, e.od(j, op));
        has_non_final = true;
      }
    }
    if (!has_non_final) continue;
    for (int j = 0; j < e.jobs; ++j) {
      if (!e.legal[j] || e.needed_machine[j] != m) continue;
      const int32_t op = e.next_op[j];
      if (op == e.machines - 1 && e.od(j, op) > min_non_final) {
        e.legal[j] = 0;
        e.nb_legal -= 1;
      }
    }
  }
}

// Heuristic 2: the no-op (wait) action is legal iff every currently-legal
// machine would be better used by a job that becomes available soon.
void check_no_op(Engine &e, int32_t *mh /* scratch [machines] */,
                 uint8_t *covered /* scratch [machines] */) {
  e.noop_legal = 0;
  const int32_t nbusy = min_busy(e);
  if (nbusy == kI32Max || e.nb_machine_legal > 3 || e.nb_legal > 4) return;
  const int32_t next_event = e.time + nbusy;
  const int32_t cap = e.time + e.max_time_op;

  // pass 1: per-machine horizons from legal jobs; early-out if any legal job
  // would finish before the next event
  for (int m = 0; m < e.machines; ++m) mh[m] = cap;
  int32_t max_horizon = e.time;
  for (int j = 0; j < e.jobs; ++j) {
    if (!e.legal[j]) continue;
    const int32_t op = e.next_op[j];
    const int32_t m = e.om(j, op);
    const int32_t end = e.time + e.od(j, op);
    if (end < next_event) return;
    mh[m] = std::min(mh[m], end);
    max_horizon = std::max(max_horizon, mh[m]);
  }

  // pass 2: walk future op chains of illegal jobs, collecting legal machines
  // that would be better used by waiting; no-op legal iff all are collected
  int32_t n_covered = 0;
  std::memset(covered, 0, e.machines);
  for (int j = 0; j < e.jobs; ++j) {
    if (e.legal[j]) continue;
    int32_t ts, tn;
    if (e.job_busy_for[j] > 0 && e.next_op[j] + 1 < e.machines) {
      ts = e.next_op[j] + 1;
      tn = e.time + e.job_busy_for[j];
    } else if (!e.noop_pin[j] && e.next_op[j] < e.machines) {
      ts = e.next_op[j];
      tn = e.time + e.machine_busy_for[e.om(j, ts)];
    } else {
      continue;
    }
    while (ts < e.machines - 1 && max_horizon > tn) {
      const int32_t m = e.om(j, ts);
      if (mh[m] > tn && e.machine_legal[m] && !covered[m]) {
        covered[m] = 1;
        if (++n_covered == e.nb_machine_legal) {
          e.noop_legal = 1;
          return;
        }
      }
      tn += e.od(j, ts);
      ts += 1;
    }
  }
}

void epilogue(Engine &e, int32_t *mh, uint8_t *covered) {
  prioritization_non_final(e);
  check_no_op(e, mh, covered);
}

}  // namespace

extern "C" {

struct EngineHandle {
  Engine e;
  int32_t *mh_scratch;
  uint8_t *covered_scratch;
};

EngineHandle *jss_create(int32_t jobs, int32_t machines,
                         const int32_t *op_machine, const int32_t *op_dur) {
  auto *h = new EngineHandle();
  Engine &e = h->e;
  e.jobs = jobs;
  e.machines = machines;
  const size_t n = static_cast<size_t>(jobs) * machines;
  e.op_machine = new int32_t[n];
  e.op_dur = new int32_t[n];
  std::memcpy(e.op_machine, op_machine, n * sizeof(int32_t));
  std::memcpy(e.op_dur, op_dur, n * sizeof(int32_t));
  e.max_time_op = 0;
  e.sum_op = 0;
  e.max_time_jobs = 0;
  for (int j = 0; j < jobs; ++j) {
    int32_t len = 0;
    for (int k = 0; k < machines; ++k) {
      e.max_time_op = std::max(e.max_time_op, e.od(j, k));
      len += e.od(j, k);
    }
    e.max_time_jobs = std::max(e.max_time_jobs, len);
    e.sum_op += len;
  }
  e.legal = new uint8_t[jobs];
  e.machine_legal = new uint8_t[machines];
  e.machine_busy_for = new int32_t[machines];
  e.job_busy_for = new int32_t[jobs];
  e.next_op = new int32_t[jobs];
  e.work_done = new int32_t[jobs];
  e.needed_machine = new int32_t[jobs];
  e.idle_total = new int32_t[jobs];
  e.idle_since_op = new int32_t[jobs];
  e.pin = new uint8_t[static_cast<size_t>(machines) * jobs];
  e.noop_pin = new uint8_t[jobs];
  e.solution = new int32_t[n];
  e.obs = new float[static_cast<size_t>(jobs) * 7];
  h->mh_scratch = new int32_t[machines];
  h->covered_scratch = new uint8_t[machines];
  return h;
}

void jss_destroy(EngineHandle *h) {
  Engine &e = h->e;
  delete[] e.op_machine;
  delete[] e.op_dur;
  delete[] e.legal;
  delete[] e.machine_legal;
  delete[] e.machine_busy_for;
  delete[] e.job_busy_for;
  delete[] e.next_op;
  delete[] e.work_done;
  delete[] e.needed_machine;
  delete[] e.idle_total;
  delete[] e.idle_since_op;
  delete[] e.pin;
  delete[] e.noop_pin;
  delete[] e.solution;
  delete[] e.obs;
  delete[] h->mh_scratch;
  delete[] h->covered_scratch;
  delete h;
}

void jss_reset(EngineHandle *h) {
  Engine &e = h->e;
  e.time = 0;
  e.nb_legal = e.jobs;
  e.nb_machine_legal = 0;
  e.noop_legal = 0;
  std::memset(e.machine_legal, 0, e.machines);
  std::memset(e.machine_busy_for, 0, e.machines * sizeof(int32_t));
  std::memset(e.job_busy_for, 0, e.jobs * sizeof(int32_t));
  std::memset(e.next_op, 0, e.jobs * sizeof(int32_t));
  std::memset(e.work_done, 0, e.jobs * sizeof(int32_t));
  std::memset(e.idle_total, 0, e.jobs * sizeof(int32_t));
  std::memset(e.idle_since_op, 0, e.jobs * sizeof(int32_t));
  std::memset(e.pin, 0, static_cast<size_t>(e.machines) * e.jobs);
  std::memset(e.noop_pin, 0, e.jobs);
  std::memset(e.obs, 0, static_cast<size_t>(e.jobs) * 7 * sizeof(float));
  for (size_t i = 0; i < static_cast<size_t>(e.jobs) * e.machines; ++i)
    e.solution[i] = -1;
  for (int j = 0; j < e.jobs; ++j) {
    e.legal[j] = 1;
    const int32_t m = e.om(j, 0);
    e.needed_machine[j] = m;
    if (!e.machine_legal[m]) {
      e.machine_legal[m] = 1;
      e.nb_machine_legal += 1;
    }
  }
}

// One agent step. action >= jobs means no-op. Returns the raw integer reward;
// *done is set to 1 when no legal job action remains.
//
// Illegal inputs are clamped exactly like the JAX engine (engine.py step):
// negative actions clip to job 0, and a finished job's needed machine (-1)
// and past-the-end op index clip to 0 / machines-1 — garbage-in-garbage-out
// state like stepping an illegal action in the reference, but always
// memory-safe.
int32_t jss_step(EngineHandle *h, int32_t action, uint8_t *done) {
  Engine &e = h->e;
  int32_t reward = 0;
  if (action < 0) action = 0;
  if (action >= e.jobs) {  // no-op: pin every legal job on its machine
    for (int j = 0; j < e.jobs; ++j) {
      if (!e.legal[j]) continue;
      e.legal[j] = 0;
      const int32_t m = e.needed_machine[j];
      e.machine_legal[m] = 0;
      e.pin[m * e.jobs + j] = 1;
      e.noop_pin[j] = 1;
    }
    e.nb_legal = 0;
    e.nb_machine_legal = 0;
    while (e.nb_machine_legal == 0 && min_busy(e) != kI32Max)
      reward -= advance_time(e);
  } else {  // allocation
    const int32_t op = std::min(std::max(e.next_op[action], 0), e.machines - 1);
    const int32_t m = std::min(std::max(e.needed_machine[action], 0), e.machines - 1);
    const int32_t dur = e.od(action, op);
    reward += dur;
    e.machine_busy_for[m] = dur;
    e.job_busy_for[action] = dur;
    e.obs[action * 7 + 1] =
        static_cast<float>(dur) / static_cast<float>(e.max_time_op);
    e.solution[action * e.machines + op] = e.time;
    for (int j = 0; j < e.jobs; ++j) {
      if (e.legal[j] && e.needed_machine[j] == m) {
        e.legal[j] = 0;
        e.nb_legal -= 1;
      }
    }
    e.machine_legal[m] = 0;
    e.nb_machine_legal -= 1;
    for (int j = 0; j < e.jobs; ++j) {
      if (e.pin[m * e.jobs + j]) {
        e.pin[m * e.jobs + j] = 0;
        e.noop_pin[j] = 0;
      }
    }
    while (e.nb_machine_legal == 0 && min_busy(e) != kI32Max)
      reward -= advance_time(e);
  }
  epilogue(e, h->mh_scratch, h->covered_scratch);
  *done = (e.nb_legal == 0) ? 1 : 0;
  return reward;
}

int32_t jss_advance_time(EngineHandle *h) { return advance_time(h->e); }

// state accessors: copy-free pointers into engine-owned buffers
int32_t jss_time(EngineHandle *h) { return h->e.time; }
int32_t jss_nb_legal(EngineHandle *h) { return h->e.nb_legal; }
int32_t jss_nb_machine_legal(EngineHandle *h) { return h->e.nb_machine_legal; }
uint8_t jss_noop_legal(EngineHandle *h) { return h->e.noop_legal; }
int32_t jss_max_time_op(EngineHandle *h) { return h->e.max_time_op; }
uint8_t *jss_legal(EngineHandle *h) { return h->e.legal; }
uint8_t *jss_machine_legal_arr(EngineHandle *h) { return h->e.machine_legal; }
int32_t *jss_machine_busy_for(EngineHandle *h) { return h->e.machine_busy_for; }
int32_t *jss_job_busy_for(EngineHandle *h) { return h->e.job_busy_for; }
int32_t *jss_next_op(EngineHandle *h) { return h->e.next_op; }
int32_t *jss_work_done(EngineHandle *h) { return h->e.work_done; }
int32_t *jss_needed_machine(EngineHandle *h) { return h->e.needed_machine; }
int32_t *jss_idle_total(EngineHandle *h) { return h->e.idle_total; }
int32_t *jss_idle_since_op(EngineHandle *h) { return h->e.idle_since_op; }
uint8_t *jss_pin(EngineHandle *h) { return h->e.pin; }
uint8_t *jss_noop_pin(EngineHandle *h) { return h->e.noop_pin; }
int32_t *jss_solution(EngineHandle *h) { return h->e.solution; }
float *jss_obs(EngineHandle *h) { return h->e.obs; }

}  // extern "C"

"""The least time the rollout kernels can take, counted from shapes.

Frozen copies of ``chip_smoke.py``'s ``launch_timer`` bound (lines 1590-1611
at the benchmark's first version): the same work whatever design implements
it, max(bytes / HBM peak, int32 operations / int32 peak). Seconds.
"""

from __future__ import annotations

from perfbench.counts.peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S


def light_state_bytes(J: int, M: int) -> int:
    """Bytes of one lane's light ``EnvState`` dynamic fields at their own
    dtypes: three int32 counters, ``machine_busy_for`` (M int32), eight
    int32 job rows, and the bool ``noop_legal``, ``legal``, ``noop_pin``
    (J each) and ``machine_legal`` (M)."""
    return 3 * 4 + 4 * M + 8 * 4 * J + 1 + 2 * J + M


def free_bound_s(B: int, T: int, J: int, M: int, value_bytes: int, instances: int) -> float:
    """One free launch (``rollout_free`` with Philox words): the light state
    rows (4 + 10J + 2M a lane) in the storage dtype, read once; the
    (instances, 4, J, M) int32 table stack, the 5 int32 lane constants, the
    4 int64 stats and the float32 return of each lane. ``5J + 2M`` int32
    operations a lane-step, plus 100 for the Philox draw."""
    nbytes = (4 + 10 * J + 2 * M) * B * value_bytes + 4 * (instances * 4 * J * M + 5 * B + 2 * 4 * B + B)
    ops = T * B * (5 * J + 2 * M + 100)
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def driven_bound_s(B: int, T: int, J: int, M: int, instances: int) -> float:
    """One driven launch on a light state with ends (the learner's env
    step): the state's fields read and a new state written
    (``light_state_bytes`` each way), the table stack, and the (T, B) int32
    actions, rewards and ends. ``4J + 2M`` int32 operations a lane-step."""
    nbytes = 2 * light_state_bytes(J, M) * B + 4 * instances * 4 * J * M + 3 * 4 * T * B
    ops = T * B * (4 * J + 2 * M)
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)

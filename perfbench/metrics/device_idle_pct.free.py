"""Share of the traced stretch of a free-rollout window in which no device
operation (kernel, copy, set) ran, in %: one minus the union of the device
intervals over the stretch's host-clock length."""


def read(trace):
    if trace.sizes.get("mode") != "free" or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

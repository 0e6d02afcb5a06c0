"""The free kernel's share of its roofline, in %: the frozen bound of one
free launch at the cell's B, T, J, M, storage dtype and instance count
(``counts/rollout.py``) over the free kernel's mean device time a launch in
the traced stretch (every build: static, slot class, ``rollout.cu``)."""

from perfbench.counts.rollout import free_bound_s

KERNELS = ("free_static_kernel", "free_general_kernel", "rollout_free_kernel")


def read(trace):
    s, launches = trace.sizes, trace.kernels(*KERNELS)
    if s.get("mode") != "free" or not launches:
        return None
    mean_s = sum(e.dur for e in launches) / len(launches) * 1e-6
    return 100.0 * free_bound_s(s["B"], s["T"], s["J"], s["M"], s["value_bytes"], s["instances"]) / mean_s

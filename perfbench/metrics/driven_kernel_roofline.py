"""The driven kernel's share of its roofline at the learner's env step, in
%: the frozen bound of one T=1 launch on a light state with ends at the
cell's B (a card), J, M and instance count (``counts/rollout.py``) over the
driven kernel's mean device time a launch in the traced stretch (every
build)."""

from perfbench.counts.rollout import driven_bound_s

KERNELS = ("driven_static_kernel", "driven_general_kernel", "rollout_driven_kernel")


def read(trace):
    s, launches = trace.sizes, trace.kernels(*KERNELS)
    if s.get("mode") != "train" or not launches:
        return None
    mean_s = sum(e.dur for e in launches) / len(launches) * 1e-6
    return 100.0 * driven_bound_s(s["B"], 1, s["J"], s["M"], s["instances"]) / mean_s

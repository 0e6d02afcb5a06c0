"""Device operations (kernels, copies, sets) a learner update puts on rank
0's card: those inside the traced stretch over the updates it holds."""


def read(trace):
    if trace.sizes.get("mode") != "train" or not trace.device or not trace.units:
        return None
    lo, hi = trace.window
    return sum(lo <= e.ts < hi for e in trace.device) / trace.units

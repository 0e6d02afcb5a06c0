"""Device milliseconds of NCCL kernels a learner update takes on rank 0's
card (the gradient all-reduce and the metrics' reductions), over the
updates of the traced stretch. Nothing on one card, which runs no NCCL
kernel."""


def read(trace):
    nccl = [e for e in trace.device if "nccl" in e.name.lower()]
    if trace.sizes.get("mode") != "train" or not nccl or not trace.units:
        return None
    return sum(e.dur for e in nccl) * 1e-3 / trace.units

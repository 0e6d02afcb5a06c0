"""Host milliseconds of one free call: the mean time of the ``env.free``
spans (``fused_rollout.rollout_free``: the dtype's host read, the lane
buffer, the launch, the stats' reductions) that the port recorded in this
process (``jssenv_tpu_torch.diagnostics.spans()``). The port records
spans while a profiler runs, which in a traced run is the stretch alone.
None on a training cell, or where the program records no such span."""


def _spans():
    from jssenv_tpu_torch import diagnostics

    read = getattr(diagnostics, "spans", None)  # a program without spans records none
    return read() if read is not None else []


def read(trace, spans=None):
    if trace.sizes.get("mode") != "free":
        return None
    calls = [s.end_ns - s.start_ns for s in (_spans() if spans is None else spans)
             if s is not None and s.name == "env.free"]
    return sum(calls) * 1e-6 / len(calls) if calls else None

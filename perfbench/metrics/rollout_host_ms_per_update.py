"""Host milliseconds an update spends in its rollout: the total time of the
``learner.rollout`` spans over the number of ``learner.update`` spans that
the port recorded in this process (rank 0's on a mesh;
``jssenv_tpu_torch.diagnostics.spans()``). The port records spans while a
profiler runs, which in a traced run is the stretch alone. None on a free
cell, or where the program records no such span."""


def _spans():
    from jssenv_tpu_torch import diagnostics

    read = getattr(diagnostics, "spans", None)  # a program without spans records none
    return read() if read is not None else []


def read(trace, spans=None):
    if trace.sizes.get("mode") != "train":
        return None
    spans = [s for s in (_spans() if spans is None else spans) if s is not None]
    updates = sum(s.name == "learner.update" for s in spans)
    rollout_ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "learner.rollout")
    if not updates or not rollout_ns:
        return None
    return rollout_ns * 1e-6 / updates

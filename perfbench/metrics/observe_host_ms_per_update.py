"""Host milliseconds an update spends building the policy's inputs: the
total time of the ``policy.observe`` spans (inside each rollout step's
``policy.forward``: the observation, mask and valid rows, one launch with
reference features, the eager rich observation with rich ones) over the
number of ``learner.update`` spans that the port recorded in this process
(rank 0's on a mesh; ``jssenv_tpu_torch.diagnostics.spans()``). The port
records spans while a profiler runs, which in a traced run is the stretch
alone. None on a free cell, or where the program records no such span."""


def _spans():
    from jssenv_tpu_torch import diagnostics

    read = getattr(diagnostics, "spans", None)  # a program without spans records none
    return read() if read is not None else []


def read(trace, spans=None):
    if trace.sizes.get("mode") != "train":
        return None
    spans = [s for s in (_spans() if spans is None else spans) if s is not None]
    updates = sum(s.name == "learner.update" for s in spans)
    observe_ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "policy.observe")
    if not updates or not observe_ns:
        return None
    return observe_ns * 1e-6 / updates

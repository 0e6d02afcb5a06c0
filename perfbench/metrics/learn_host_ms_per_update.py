"""Host milliseconds an update spends outside its rollout (the returns, the
loss and backward, the all-reduce's enqueue, Adam, the metrics): each
``learner.update`` span's time less its ``learner.rollout`` child's,
summed over the updates the port recorded in this process (rank 0's on a
mesh; ``jssenv_tpu_torch.diagnostics.spans()``), over their number. The
port records spans while a profiler runs, which in a traced run is the
stretch alone. None on a free cell, or where the program records no such
span."""


def _spans():
    from jssenv_tpu_torch import diagnostics

    read = getattr(diagnostics, "spans", None)  # a program without spans records none
    return read() if read is not None else []


def read(trace, spans=None):
    if trace.sizes.get("mode") != "train":
        return None
    spans = _spans() if spans is None else spans
    updates = [i for i, s in enumerate(spans) if s is not None and s.name == "learner.update"]
    if not updates:
        return None
    total = 0
    for i in updates:
        u = spans[i]
        total += u.end_ns - u.start_ns
        total -= sum(s.end_ns - s.start_ns for s in spans
                     if s is not None and s.parent == i and s.name == "learner.rollout")
    return total * 1e-6 / len(updates)

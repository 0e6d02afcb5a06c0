"""Host microseconds of one driven env step of the learner's rollout: the
mean time of the ``env.step`` spans (``fused_rollout.step_autoreset``: the
T=1 launch's wrapper, its inputs and outputs, the stats) that the port
recorded in this process (rank 0's on a mesh;
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
    steps = [s.end_ns - s.start_ns for s in (_spans() if spans is None else spans)
             if s is not None and s.name == "env.step"]
    return sum(steps) * 1e-3 / len(steps) if steps else None

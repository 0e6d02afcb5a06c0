"""Device values a free call reads back to the host (each read waits for
the device): the change of the port's ``host_reads`` counter over the
``env.free`` spans it recorded in this process
(``jssenv_tpu_torch.diagnostics.spans()``), over their number. The port
records spans while a profiler runs, which in a traced run is the stretch
alone. None on a training cell, or where the program records no such
span."""


def _spans():
    from jssenv_tpu_torch import diagnostics

    read = getattr(diagnostics, "spans", None)  # a program without spans records none
    return read() if read is not None else []


def read(trace, spans=None):
    if trace.sizes.get("mode") != "free":
        return None
    calls = [s for s in (_spans() if spans is None else spans) if s is not None and s.name == "env.free"]
    return sum(s.counts.get("host_reads", 0) for s in calls) / len(calls) if calls else None

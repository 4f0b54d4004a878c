"""ATen ops the profiler counts a step (``aten::*`` host events, nested
ones too), over the traced steps."""


def read(run):
    if run.trace is None:
        return None
    n = run.trace.ops_matching("aten::")
    return run.trace.per_step(n) if n else None

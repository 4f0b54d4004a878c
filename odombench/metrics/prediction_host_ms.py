"""Host milliseconds a step inside the program's ``step.prediction`` range,
under the profiler (which slows the host), over the traced steps."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.range_ms_per_step("step.prediction")

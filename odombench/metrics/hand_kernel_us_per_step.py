"""Device microseconds a step of the hand kernels that ``kernels/*.py``
name, from the trace."""


def read(run):
    if not run.kernel_us:
        return None
    return sum(run.kernel_us.values()) / run.trace.steps

"""The share of the traced window in which nothing ran on the device:
1 - (union of the device's activity intervals) / (the traced window).  The
profiler slows the host, so the share reads high against an untraced
window."""


def read(run):
    if run.trace is None or run.trace.busy_us <= 0:
        return None
    return 1.0 - run.trace.busy_us / run.trace.window_us

"""The hand kernels' share of their roofline, in %: the least time their
traced launches need (each launch's bytes at 3.35 TB/s or float32
operations at 67 TFLOP/s, the larger; ``kernels/*.py``) over the device
time they took in the trace."""


def read(run):
    names = [k for k in run.kernel_bound_us if run.kernel_us.get(k)]
    if not names:
        return None
    return 100.0 * sum(run.kernel_bound_us[k] for k in names) / sum(
        run.kernel_us[k] for k in names)

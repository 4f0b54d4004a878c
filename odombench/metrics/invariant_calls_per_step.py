"""Calls of the program's ``superodom::*`` custom operators a step (the
per-instance ops of ``ops.invariant`` and the hand kernels' entries; under
vmap each call runs its rule once), over the traced steps."""


def read(run):
    if run.trace is None:
        return None
    n = run.trace.ops_matching("superodom::")
    return run.trace.per_step(n) if n else None

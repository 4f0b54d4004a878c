"""Seconds from the process's start to the window's: imports, the kernels'
build or load, the trajectories, the runner's input preparation, the pool
on the device and the warm-up step (host clock)."""


def read(run):
    return run.setup_s

"""Peak device memory over the timed window (``max_memory_allocated``
after a reset at the window's start), MiB."""


def read(run):
    if run.peak_window_bytes <= 0:
        return None
    return run.peak_window_bytes / 2 ** 20

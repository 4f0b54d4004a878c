"""Every scan every instance registered in the window, over the window
(host clock, from the clock's start to the synchronise of the last whole
chunk)."""


def read(run):
    return run.instances * run.steps / run.window_s

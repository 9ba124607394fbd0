"""The window's wall (the whole call) over the iterations it completed: what
a user waits per iteration of their search."""


def read(run):
    return 1e3 * run.call_s / run.iterations if run.iterations else None

"""B1 launches in the window (the program's ``fused_loss.launches``) over
the iterations: a count that repeats exactly for one search."""


def read(run):
    n = run.launches.get("B1", 0)
    return n / run.iterations if n and run.iterations else None

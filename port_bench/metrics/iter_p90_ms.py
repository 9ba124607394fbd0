"""The 90th percentile of every iteration's wall in the window (the first
measured from the call's start), by numpy's linear rule."""

import numpy as np


def read(run):
    walls = run.iteration_walls()
    return 1e3 * float(np.percentile(walls, 90)) if walls else None

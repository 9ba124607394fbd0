"""Set-up: from the process's start to the window's start (imports, the
kernels' load or build, the data, the warm-up search)."""


def read(run):
    return run.setup_s

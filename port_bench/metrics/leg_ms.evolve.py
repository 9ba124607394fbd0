"""The evolve leg's mean ms per iteration (the program's StageProfiler stage
``evolve``, fenced at its end)."""


def read(run):
    return run.stage_ms("evolve")

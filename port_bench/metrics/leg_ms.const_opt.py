"""The const-opt leg's mean ms per iteration (stage ``const_opt``)."""


def read(run):
    return run.stage_ms("const_opt")

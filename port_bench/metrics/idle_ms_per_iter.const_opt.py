"""The card's idle ms per iteration inside the const-opt leg: the traced
window's idle gaps laid to the span ``const_opt`` or one of its sub-spans
``const_opt/*`` (trace.py), over the iterations."""


def read(run):
    if run.trace is None or not run.iterations:
        return None
    idle = [s for label, s in run.trace["idle_s_by_host"].items()
            if label == "const_opt" or label.startswith("const_opt/")]
    return 1e3 * sum(idle) / run.iterations if idle else None

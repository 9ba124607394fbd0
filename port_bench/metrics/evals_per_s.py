"""The port's own count of tree evaluations (``SearchResult.num_evals``)
over the traced call's wall."""


def read(run):
    return float(run.result.num_evals) / run.call_s if run.call_s > 0 else None

"""The const-opt leg's deliberate host syncs over the iterations: the
program's own counts at the g_tol gate and the Armijo stop
(``engine_stats["host_syncs"]``, always on)."""


def read(run):
    syncs = (getattr(run.result, "engine_stats", None) or {}).get("host_syncs")
    if syncs is None or not run.iterations:
        return None
    return (syncs.get("g_tol", 0) + syncs.get("armijo", 0)) / run.iterations

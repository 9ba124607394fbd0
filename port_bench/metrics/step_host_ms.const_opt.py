"""The host's ms per const-opt step: the program's span ``const_opt/step``
(the enqueue from one stop test's return to the next stop test) over its
count."""


def read(run):
    spans = (getattr(run.result, "engine_stats", None) or {}).get("spans") or {}
    step = spans.get("const_opt/step")
    if not step or not step["count"]:
        return None
    return 1e3 * step["seconds"] / step["count"]

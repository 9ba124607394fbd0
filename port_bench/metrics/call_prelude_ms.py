"""The call's prelude in ms: the program's span ``prelude``, from the engine
call's entry to its first iteration's legs (state build, upload, initial
scoring)."""


def read(run):
    spans = (getattr(run.result, "engine_stats", None) or {}).get("spans") or {}
    span = spans.get("prelude")
    return None if span is None else 1e3 * span["seconds"]

"""The call's tail in ms: the program's span ``tail``, from the engine loop's
exit to the return (the last readback, the final decode, the hall of
fame)."""


def read(run):
    spans = (getattr(run.result, "engine_stats", None) or {}).get("spans") or {}
    span = spans.get("tail")
    return None if span is None else 1e3 * span["seconds"]

"""Readback and host work, mean ms per iteration: the stages
``readback_pack``, ``readback_d2h``, ``decode_hof``, ``simplify`` and
``migrate`` summed (those the run has)."""

STAGES = ("readback_pack", "readback_d2h", "decode_hof", "simplify", "migrate")


def read(run):
    parts = [run.stage_ms(s) for s in STAGES]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None

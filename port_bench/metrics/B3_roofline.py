"""B3's share of its roofline in the traced window (rooflines.py)."""

from port_bench.rooflines import roofline_pct


def read(run):
    return roofline_pct(run, "B3")

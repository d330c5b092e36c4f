"""Kernel K4's share of its roofline in the traced slice."""

from portbench.lib.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "K4")

"""idle_pct.semantic: the share of the window in which no operation ran on
the device (the union of the trace's device intervals), in %."""
from benchmark import readers


def read(rec):
    return readers.idle_pct(rec)

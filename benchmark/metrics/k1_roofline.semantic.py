"""k1_roofline.semantic: K1's least time (benchmark/counts.py on the window's
own work counts) over its traced device time, summed over the window's
launches, in %."""
from benchmark import readers


def read(rec):
    return readers.roofline(rec, ("K1",))

"""k2_roofline.semantic: K2's and its segment sum's least time over their
traced device time, summed over the window's launches, in %."""
from benchmark import readers


def read(rec):
    return readers.roofline(rec, ("K2", "segment_sum"))

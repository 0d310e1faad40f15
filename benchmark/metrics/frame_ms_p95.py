"""frame_ms_p95: the 95th percentile of every frame's time in the window,
from its pose's submission until its outputs are complete on the device."""
from benchmark import readers


def read(rec):
    return readers.p95_ms(rec)

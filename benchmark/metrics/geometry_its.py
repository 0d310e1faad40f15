"""geometry_its: steps completed in the window ÷ the window's seconds; the window
is closed by a synchronize."""
from benchmark import readers


def read(rec):
    return readers.rate(rec)

"""mfu.geometry: the window's counted FP32 operations (the kernels' by
benchmark/counts.py, the eager work's from shapes) over its seconds at the
67 TFLOP/s FP32 peak, in %."""
from benchmark import readers


def read(rec):
    return readers.mfu(rec)

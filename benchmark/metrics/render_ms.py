"""render_ms: device ms of each render() call (CUDA events around it),
mean per frame."""
from benchmark import readers


def read(rec):
    return readers.mean_ms(rec, "render_ms")

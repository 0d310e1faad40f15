"""torch_launches.geometry: PyTorch's kernels in the trace (every kernel but
the program's own csrc/*.cu ones) per step or frame."""
from benchmark import readers


def read(rec):
    return readers.torch_launches(rec)

"""torch_ops_ms.frame: PyTorch's kernels' traced device ms per step or
frame."""
from benchmark import readers


def read(rec):
    return readers.torch_ops_ms(rec)

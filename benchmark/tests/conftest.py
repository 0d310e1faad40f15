"""The benchmark's own CPU tests (python3 -m pytest benchmark/tests -q).
They drive the harness at a tiny size on the CPU, where the program runs
its kernels' plain PyTorch versions; a test that needs the card carries
the `cuda` marker and decides in its fixture whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (run on the chip with "
        "python3 -m pytest benchmark/tests -m cuda)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda", 0)

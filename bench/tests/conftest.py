"""Fixtures of the benchmark's tests."""

import pytest


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA card (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")

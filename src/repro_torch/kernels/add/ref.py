"""Plain PyTorch version of the Add benchmark (paper section V.D: 'a simple
vector addition with two vectors of size X' — ImageCL treats them as 2-D
images, as do we).  Mirrors ``repro.kernels.add.ref.add_ref``."""

import torch


def add_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b

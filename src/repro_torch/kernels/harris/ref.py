"""Plain PyTorch version of Harris corner detection (paper section V.D),
mirroring ``repro.kernels.harris.ref.harris_ref``.

Pipeline: 3x3 Sobel gradients -> structure-tensor products -> 3x3 box
filter -> Harris response R = det(M) - k * trace(M)^2.  The image is
zero-extended by the total stencil radius (2) once, and both convolution
stages are 'valid'.  ``conv2d`` is a cross-correlation, as the reference's
``lax.conv_general_dilated`` is, so the masks are the reference's as written.
On the card, a float32 ``conv2d`` runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; comparisons turn it off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HARRIS_K = 0.04

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _conv3_valid(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    return F.conv2d(img[None, None], kern[None, None])[0, 0]


def harris_ref(img: torch.Tensor, k: float = HARRIS_K) -> torch.Tensor:
    sobel_x = torch.tensor(_SOBEL_X, dtype=img.dtype, device=img.device)
    box = torch.ones((3, 3), dtype=img.dtype, device=img.device)
    padded = F.pad(img, (2, 2, 2, 2))
    ix = _conv3_valid(padded, sobel_x)      # (x+2, y+2)
    iy = _conv3_valid(padded, sobel_x.T.contiguous())
    sxx = _conv3_valid(ix * ix, box)        # (x, y)
    syy = _conv3_valid(iy * iy, box)
    sxy = _conv3_valid(ix * iy, box)
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace

"""Carry state across from the reference package.

The autotuner has no weights; its state is its input problems and its
measurements.  :func:`inputs_from_numpy` turns the reference's numpy inputs
into the port's tensors byte for byte, and :func:`load_reference_store`
opens a JSON measurement store the reference wrote (formats 1-3: values,
``inf`` penalties, penalty reasons and serving winners).  Both read files and
arrays only; neither imports the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .core.engine import MeasurementStore


def inputs_from_numpy(arrays, device="cpu") -> tuple[torch.Tensor, ...]:
    """Numpy arrays (float32, or the ``ml_dtypes`` bfloat16 JAX hands out)
    as contiguous tensors on ``device``, with identical bytes."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:     # JAX hands out read-only views
            a = a.copy()
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out.append(t.to(device))
    return tuple(out)


def load_reference_store(path: str) -> MeasurementStore:
    """Open a JSON store written by ``repro.core.engine.MeasurementStore``.
    Autosave is off: loading never rewrites the reference's file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return MeasurementStore(path, autosave_every=0)

"""Carry state across from the reference package.

The autotuner's state is its input problems and its measurements.
:func:`inputs_from_numpy` turns the reference's numpy inputs into the port's
tensors byte for byte, and :func:`load_reference_store` opens a JSON
measurement store the reference wrote (formats 1-3: values, ``inf``
penalties, penalty reasons and serving winners).  The model stack's state is
a nested dict of arrays: :func:`params_from_numpy` / :func:`state_from_numpy`
take the reference's parameter or train-state tree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, ...)``) into the port's tensors with
identical bytes, and :func:`params_to_numpy` goes back.  All of them read
files and arrays only; none imports the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .core.engine import MeasurementStore
from .tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    shape = np.shape(a)
    a = np.ascontiguousarray(a).reshape(shape)    # keeps a 0-d array 0-d
    if not a.flags.writeable:     # JAX hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def inputs_from_numpy(arrays, device="cpu") -> tuple[torch.Tensor, ...]:
    """Numpy arrays (float32, or the ``ml_dtypes`` bfloat16 JAX hands out)
    as contiguous tensors on ``device``, with identical bytes."""
    return tuple(_tensor(a, device) for a in arrays)


def params_from_numpy(tree, device) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's on ``device``, leaf for leaf, with identical bytes and shapes."""
    return tree_map(lambda a: _tensor(a, device), tree)


#: the reference's train state (``{"params", "opt": {"m", "v", "step"}}``)
#: converts the same way; ``opt/step`` stays an int32 scalar
state_from_numpy = params_from_numpy


def params_to_numpy(tree) -> dict:
    """The port's tree as numpy arrays on the host (bf16 leaves are not
    supported: numpy has no bfloat16 of its own)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def load_reference_store(path: str) -> MeasurementStore:
    """Open a JSON store written by ``repro.core.engine.MeasurementStore``.
    Autosave is off: loading never rewrites the reference's file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return MeasurementStore(path, autosave_every=0)

"""Minimal parameter-spec system (a port of ``repro.models.param``).

A model is defined by a *spec tree*: nested dicts whose leaves are
:class:`P` — (shape, logical_axes, dtype, init).  From one spec we derive:

  * ``init_params(spec, generator, device)`` — tensors drawn from an
                                               explicit ``torch.Generator``
  * ``abstract_params(spec)``                — ``meta`` tensors (counts and
                                               shapes of a full-size config,
                                               no allocation)
  * ``param_axes(spec)``                     — logical-axis name tree, kept
                                               for sharding (ROADMAP 6c)

Each spec leaf is one tensor; per-layer weights are stacked on a leading
``layers`` dim, as the reference holds them, so the spec, ``param_count``,
the checkpoint keys and weights carried across from the reference map one
to one.  Values drawn here are not the reference's (``torch.Generator``,
not ``jax.random``); tests carry the reference's weights across instead
(``repro_torch.interop.params_from_numpy``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import tree_from_paths, tree_leaves, tree_map, tree_paths


@dataclass(frozen=True)
class P:
    shape: tuple
    axes: tuple               # logical axis name (or None) per dim
    dtype: torch.dtype = torch.float32
    init: str = "normal"      # normal | zeros | ones | scaled (fan-in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _initializer(p: P, generator: torch.Generator, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    draw = torch.randn(p.shape, generator=generator, device=device)
    if p.init == "normal":
        return (0.02 * draw).to(p.dtype)
    if p.init == "scaled":  # fan-in scaled
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        return (draw / math.sqrt(fan_in)).to(p.dtype)
    raise ValueError(f"unknown init {p.init}")


def init_params(spec, generator: torch.Generator, device="cuda"):
    """Draw every leaf in sorted path order from ``generator``, which must
    live on ``device`` (``torch.Generator(device=...).manual_seed(s)``)."""
    return tree_from_paths({path: _initializer(p, generator, device)
                            for path, p in tree_paths(spec).items()})


def abstract_params(spec):
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), spec)


def param_axes(spec):
    return tree_map(lambda p: p.axes, spec)


def param_count(spec) -> int:
    return int(sum(math.prod(p.shape) for p in tree_leaves(spec)))

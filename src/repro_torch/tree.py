"""Nested-dict trees: the model stack's stand-in for ``jax.tree_util``.

Parameters, optimizer state, caches and batches are nested ``dict``s whose
leaves are tensors (or :class:`repro_torch.models.param.P` specs).  Leaves
are visited in sorted key order, as ``jax.tree_util`` flattens a dict, and a
leaf's path is its keys joined by ``/`` (``params/layers/wq``): the
checkpoint names files by these paths, so they must equal the reference's.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = "") -> dict[str, Any]:
    """``{"a/b/c": leaf}`` in sorted key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k in sorted(tree):
        out.update(tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_leaves(tree) -> list:
    return list(tree_paths(tree).values())


def tree_from_paths(flat: dict[str, Any]) -> dict:
    """Inverse of :func:`tree_paths`."""
    out: dict = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out

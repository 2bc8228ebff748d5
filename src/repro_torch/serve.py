"""Stable serving facade: ``repro_torch.serve.best_config(...)`` (a port of
``repro.serve``).

The one-import answer to "give me the best config for this kernel on this
geometry and device" — backed by the winners index
:mod:`repro_torch.serving` maintains inside the measurement store::

    import torch
    import repro_torch.serve

    store, kind = repro_torch.serve.open_serve_store("serve/store.sqlite")
    res = repro_torch.serve.best_config(
        store, "harris", 8192, 8192, torch.cuda.get_device_name(0))
    if res.status in ("hit", "stale", "nearest"):
        out = repro_torch.kernels.harris(image, res.config)

See :mod:`repro_torch.serving` for the query semantics (hit / stale / nearest /
miss), the job queue behind enqueue-on-miss, and the fleet workers that
fill misses in.
"""

from __future__ import annotations

from .serving.api import (
    ServeResult,
    best_config,
    default_miss_spec,
    open_serve_store,
    store_kind_for_path,
)

__all__ = [
    "ServeResult",
    "best_config",
    "default_miss_spec",
    "open_serve_store",
    "store_kind_for_path",
]

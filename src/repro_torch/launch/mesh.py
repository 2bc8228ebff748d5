"""Production meshes (a port of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the "pod" axis only ever carries batch parallelism,
so its collectives are the per-step gradient reductions.

Every mesh is built by a FUNCTION over the default process group, and
nothing here touches distributed state at import.  The group comes first:
``start_process_group`` for the ranks that exist (``nccl`` on the card,
``gloo`` on the CPU), ``start_fake_process_group`` for the dry run's 256 or
512 ranks in one process (``torch``'s fake backend: collectives return at
once and move nothing).
"""

from __future__ import annotations

import math
import os
import tempfile

_FAKE_HINT = ("the dry run's entry point (python -m repro_torch.launch.dryrun) starts a fake "
              "process group of 512 ranks, start_fake_process_group(512), before any mesh")


def device_type() -> str:
    """The device type of the default group's meshes."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type(), ranks, mesh_dim_names=axes)


def start_process_group(device: str = "cuda") -> tuple[int, int]:
    """The default group for the ranks that exist: ``nccl`` on the card,
    ``gloo`` on the CPU.  The world is ``torchrun``'s (``RANK``,
    ``WORLD_SIZE``, its store at ``MASTER_ADDR:MASTER_PORT``) when it set
    one, else this one process over a file store in the temp directory;
    either way the rank and world size are passed explicitly.  Returns
    (rank, world size); a started group is left as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = "nccl" if device.startswith("cuda") else "gloo"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if world > 1:
        init = "env://"          # torchrun's store, at its MASTER_ADDR:MASTER_PORT
    else:
        fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.unlink(path)
        init = f"file://{path}"
    if backend == "nccl":
        import torch

        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    return rank, world


def start_fake_process_group(world_size: int) -> None:
    """``world_size`` ranks in this one process (rank 0's view) on torch's
    fake backend: meshes of any size build, collectives move nothing.  Use
    it in a process of its own, never beside an ``nccl`` group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world_size:
            raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} ranks "
                               f"is running; the fake group of {world_size} needs a process "
                               "of its own")
        return
    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    import torch.distributed as dist

    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} devices for mesh {shape}, have {have} — {_FAKE_HINT}")
    return _mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1):
    """Small (data, model) mesh over the ranks that exist (tests / examples)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    return _mesh((n // mp, mp), ("data", "model"))

"""The device mesh of the port (counterpart of ``llama_swift_tpu/parallel/mesh.py``).

The JAX package lays a ``(dp, tp)`` ``jax.sharding.Mesh`` over the devices
of its process group and serves only ``dp`` = 1 (``serve.py`` builds
``make_mesh(tp, dp=1)``).  The port runs one process per device
(``parallel/multihost.py``), so its mesh is the process group itself: ``tp``
ranks, each holding one shard of every weight, and ``dp`` the constant 1.
``distributed`` says whether collectives run over the default
``torch.distributed`` group; without one they are the identity.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    tp: int
    rank: int  # this process's position on the tp axis
    distributed: bool
    dp: ClassVar[int] = 1  # the only data-parallel degree served


def make_mesh(tp: Optional[int] = None) -> Mesh:
    """The tp mesh over the process group (one process when there is
    none); ``tp`` defaults to every rank and must equal the world size."""
    distributed = dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    if tp is None:
        tp = world
    if tp != world:
        raise ValueError(f"tp = {tp} != world size {world} (dp = 1)")
    return Mesh(tp=tp, rank=dist.get_rank() if distributed else 0, distributed=distributed)


def single_device_mesh() -> Mesh:
    """This process alone: tp = 1, no collectives."""
    return Mesh(tp=1, rank=0, distributed=False)

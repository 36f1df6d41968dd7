"""Process-group set-up for tensor-parallel serving (counterpart of
``llama_swift_tpu/parallel/multihost.py``).

One process per device, all running the same program (``python -m
llama_swift_torch.serve``, identical flags except ``--process-id``):

1. :func:`init_distributed` forms the ``torch.distributed`` group: NCCL
   when the device is the card, gloo on the CPU, rendezvous at
   ``tcp://<coordinator>`` (or any init-method URL, such as ``file://``).
   Rank r runs on ``cuda:{r % local_device_count()}``.
2. ``parallel/mesh.make_mesh`` lays the tp axis over the group,
   ``parallel/tp.shard_params_tp`` keeps each rank's shard.
3. Every rank drives the same step in lockstep; the logits come back whole
   on every rank, and only rank 0 prints.

With no coordinator nothing is formed: a single process, whose collectives
are the identity.  Nothing falls back: asked for the card, the group is
NCCL or the call fails.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from ..models.llama import resolve_device


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Form the process group (a no-op without ``coordinator_address``) and
    return this rank's device: the card unless ``device`` asks for the CPU.
    ``timeout_s`` bounds the rendezvous and every collective."""
    device = resolve_device(device)
    if coordinator_address is None:
        return device
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator needs num_processes and process_id")
    if device.type == "cuda":
        device = torch.device("cuda", process_id % local_device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return device


def shutdown() -> None:
    """Tear the process group down, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device_count() -> int:
    """Cards of this host (one CPU device where there is none)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1

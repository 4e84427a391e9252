"""Process-group bootstrap (the port of ``runbooks_tpu.parallel.distributed``).

The operator's fan-out gives every pod of a multi-host slice
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``;
the port reads the same names (``env_process_info``, ``process_index``),
so one manifest drives either package, and serving refuses a multi-host
mesh by them. ``initialize`` forms a ``torch.distributed`` process group
from an explicit (rank, world size, store): one process starts its own
ranks (the tensor-parallel server: ``serve/api.main`` spawns one process
per GPU).

Every group carries a finite timeout: a rank that dies makes its peers'
next collective fail within it instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

def env_process_info() -> Optional[dict]:
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    num = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if not (addr and num and pid):
        return None
    return {"coordinator_address": addr, "num_processes": int(num),
            "process_id": int(pid)}


def initialize(timeout_s: int, *,
               rank: int, world_size: int, store: dist.Store,
               backend: str = "nccl",
               device: Optional[torch.device] = None) -> None:
    """Form the default process group of ``world_size`` ranks over
    ``store`` (a no-op when one exists). ``backend`` is "nccl" (default;
    the rank's ``device``, ``cuda:rank`` unless given, becomes the current
    CUDA device) or "gloo" (the CPU unless ``device`` names another)."""
    if dist.is_initialized():
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if device is None:
        device = (torch.device("cuda", rank) if backend == "nccl"
                  else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, rank=rank, world_size=world_size, store=store,
        timeout=datetime.timedelta(seconds=timeout_s))


def process_index() -> int:
    if dist.is_initialized():
        return dist.get_rank()
    info = env_process_info()
    return info["process_id"] if info else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and metrics and, in a
    tensor-parallel server, answers HTTP (rank 0)."""
    return process_index() == 0


def shutdown() -> None:
    """Tear the default group down (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()

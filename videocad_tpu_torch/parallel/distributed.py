"""Multi-process initialization on ``torch.distributed``.

Port of ``videocad_tpu/parallel/distributed.py``. One process drives one
rank: ``torchrun`` (or any launcher that exports ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) starts them, and
:func:`initialize` joins the process group from that environment. The mesh
of ``parallel/mesh.py`` then lays the ranks out.

The backend is NCCL for ranks on the card and gloo on the CPU; a caller may
name gloo for ranks on the card, which is how several ranks share one card
(NCCL wants a card a rank). Nothing falls back to another backend or
device: an error of ``init_process_group`` is raised as it is.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def configured() -> bool:
    """True when the launcher's environment names a process group."""
    return all(os.environ.get(k) for k in _ENV)


def initialize(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group that the environment describes; True if
    distributed.

    With nothing configured it stays one process and returns False. A
    second call returns True without joining again. ``device`` is the
    ranks' device type (``"cuda"`` or ``"cpu"``); ``backend`` defaults to
    ``"nccl"`` for CUDA and ``"gloo"`` for the CPU.
    """
    if dist.is_initialized():
        return True
    if not configured():
        return False
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend=backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def local_device(device="cuda") -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    ``cuda:LOCAL_RANK``; an explicit index (ranks that share one card) and
    the CPU stay as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1

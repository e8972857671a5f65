"""Process-group initialisation over ``torch.distributed``.

Port of ``unet_image_segmentation_tpu/parallel/distributed.py``. One
process drives one rank; :func:`initialize` joins the job's process group,
after which :func:`..mesh.create_mesh` lays the ranks out as a ('data',
'spatial') mesh.

Launch, one process a rank: with torchrun's variables (``torchrun
--nproc-per-node 4 script.py``, then ``initialize()``), or with explicit
arguments (``initialize("10.0.0.2:29500", num_processes=8,
process_id=rank, backend="nccl")``; an address without a scheme is taken as ``tcp://``,
and ``file:///path`` rendezvous through a shared file). Nothing on a
machine tells a program of a cluster, so a job with more than one process
always says so: through those variables or those arguments.

The backend follows the device the ranks serve (``device``, the card
unless the caller asks for the CPU): gloo for CPU tensors; for CUDA
tensors NCCL when every rank of the host has a card of its own, gloo when
several ranks share one card (NCCL refuses that). How many ranks share a
host is known from torchrun's ``LOCAL_WORLD_SIZE``; a launch with explicit
arguments and no such variable states ``backend`` itself, as nothing else
tells the ranks of one host from another's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend(device="cuda", local_ranks: Optional[int] = None) -> str:
    """The backend for ranks serving tensors on ``device``: ``gloo`` on the
    CPU; on CUDA ``nccl`` when each of the host's ``local_ranks`` ranks has
    a card of its own, ``gloo`` when they share. Raises where that cannot
    be told: no card, or ``local_ranks`` unknown."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("ranks serving CUDA tensors need a CUDA card; pass device='cpu' "
                           "for CPU ranks")
    if local_ranks is None:
        raise ValueError("cannot tell how many ranks share this host's cards: set "
                         "LOCAL_WORLD_SIZE or pass backend ('nccl' when each rank has a card "
                         "of its own, 'gloo' when ranks share one)")
    return "nccl" if torch.cuda.device_count() >= local_ranks else "gloo"


def _local_ranks() -> Optional[int]:
    local = os.environ.get("LOCAL_WORLD_SIZE")
    return int(local) if local else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join the process group. A no-op when it is already joined, in one
    process (``num_processes`` 1, or no arguments and no ``WORLD_SIZE``
    above 1 in the environment), and never a fallback: a group that cannot
    form raises. ``backend`` defaults to :func:`default_backend` for
    ``device``."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return
        _join(backend or default_backend(device, _local_ranks()), "env://", world,
              int(os.environ["RANK"]))
        return
    if num_processes is None or process_id is None or coordinator_address is None:
        raise ValueError("initialize: give coordinator_address, num_processes and process_id "
                         "together")
    if num_processes <= 1:
        return
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    _join(backend or default_backend(device, _local_ranks()), url, num_processes, process_id)


def _join(backend: str, url: str, world: int, rank: int) -> None:
    """init_process_group; under NCCL each rank first takes its own card
    (``LOCAL_RANK``, else its rank modulo the host's cards)."""
    if backend == "nccl":
        local_rank = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)


def is_multihost() -> bool:
    """More than one process in the job (the JAX name kept)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    joined = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_device_count": torch.cuda.device_count(),
        "backend": dist.get_backend() if joined else None,
    }

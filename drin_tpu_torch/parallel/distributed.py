# -*- coding: utf-8 -*-
"""Several processes on ``torch.distributed`` (port of
``drin_tpu/parallel/distributed.py``).

One process is one rank with one device.  Every rank runs the same program
over the same mesh (``parallel/mesh.py``) and assembles only the rows of the
global batch that its data index owns (:func:`process_row_range`).

Launch, one command a rank (or one a host under a ``torchrun``-style launcher
that sets ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``)::

    python -m drin_tpu_torch.train mesh_data=2 num_processes=2 process_id=$RANK \\
        coordinator_address=host0:29500 device=cuda

NCCL, the default on CUDA, needs a device of its own for every rank of a
host.  Two ranks can share one card over gloo (``dist_backend=gloo``), which
takes CUDA tensors and stages them through the host: that checks the sharded
code on one card, it does not scale.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch

LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "0.0.0.0")
# seconds after which every collective gives up, so that a rank that died
# does not hang the others
TIMEOUT_S = 600


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_world_size(num_processes: int, coordinator_address: str = "") -> int:
    """How many of the ranks run on this host: ``LOCAL_WORLD_SIZE`` when the
    launcher sets it, all of them when the coordinator is this host, else
    one."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    host = coordinator_address.split("://")[-1].rsplit(":", 1)[0].strip("[]")
    if coordinator_address.startswith("file://") or host in LOCAL_HOSTS + (socket.gethostname(),):
        return num_processes
    return 1


def check_backend(backend: str, local_ranks: int, n_devices: int) -> None:
    """NCCL runs one rank a device: refuse, by name, ranks of one host that
    would share a CUDA device under it.  The backend is never switched."""
    if backend == "nccl" and local_ranks > n_devices:
        raise ValueError(
            f"NCCL cannot run two ranks on one device: {local_ranks} ranks on this host, "
            f"{n_devices} CUDA device(s) visible; give every rank its own device, or pass "
            f"dist_backend=gloo to share a device through the host")


def local_device(device, process_id: int = 0) -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK}`` when the launcher sets
    it, else ``cuda:{process_id % device_count}`` (every rank of a one-card
    host gets ``cuda:0``); a CPU device as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if os.environ.get("LOCAL_RANK"):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", process_id % max(torch.cuda.device_count(), 1))


def initialize(cfg=None, coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None) -> bool:
    """Join the process group; idempotent, and a no-op for one process.
    Returns whether a group of several ranks is joined.

    Arguments default to the config's ``coordinator_address`` /
    ``num_processes`` / ``process_id``.  ``coordinator_address`` is
    ``host:port`` (``tcp://`` rendezvous) or a ``file://`` path.  ``backend``
    defaults to NCCL for a CUDA ``device`` (the default) and gloo for the
    CPU.  Every collective gives up after ``TIMEOUT_S`` seconds."""
    import torch.distributed as dist

    if cfg is not None:
        coordinator_address = coordinator_address or (cfg.coordinator_address or None)
        num_processes = num_processes if num_processes is not None else cfg.num_processes
        process_id = process_id if process_id is not None else cfg.process_id
    if not num_processes or num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if not coordinator_address:
        raise ValueError(f"num_processes={num_processes} needs coordinator_address=host:port "
                         "(the same on every rank)")
    device = torch.device(device if device is not None else "cuda")
    backend = backend or default_backend(device)
    if backend == "nccl":
        check_backend(backend, local_world_size(num_processes, coordinator_address),
                      torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device, process_id))
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def shutdown() -> None:
    """Leave the process group (lets the ranks exit cleanly)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_row_range(mesh, n_rows: int) -> tuple:
    """The contiguous [start, stop) rows of the global batch that this rank's
    data index owns (the whole batch without a mesh).  Raises when the rows
    do not split evenly over the data axis."""
    if mesh is None:
        return 0, n_rows
    nd = mesh.shape["data"]
    if n_rows % nd:
        raise ValueError(f"rank {mesh.rank}: a batch of {n_rows} rows does not split evenly "
                         f"over the data axis of {nd} ranks; make batch_size a multiple of "
                         "mesh_data")
    per = n_rows // nd
    return mesh.data_index * per, (mesh.data_index + 1) * per

"""Process-group bootstrap and the chronological edge stream's row slices.

Counterpart of ``dyglib_tpu/parallel/distributed.py``. The contract that
every distribution keeps: GLOBAL chronological batch boundaries. Batch t
precedes batch t+1 in time, and the edges inside a batch are concurrent
(the reference's keep-last aggregation assumes it), so every rank
addresses the SAME global batch and takes a disjoint row slice of it:
data parallelism inside the batch, never across batches.

One process drives one device. On ``cuda`` the process group is NCCL and
rank r takes ``cuda:<r % device_count>``; on the CPU it is gloo. Asking
for NCCL where it is missing raises: a rank never falls back to gloo or
to the CPU.
"""
from __future__ import annotations

import datetime
import socket

import torch
import torch.distributed as dist

# a rank that waits longer than this for its peers raises
TIMEOUT = datetime.timedelta(minutes=10)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[int, int]:
    """``torch.distributed.init_process_group`` from the JAX package's three
    flags; returns (process_index, process_count).

    A no-op with one process and no address (or when a group is already
    up). ``coordinator_address`` is ``host:port`` of rank 0's TCP store (or
    a full ``tcp://`` URL). ``device`` picks the backend: NCCL for
    ``cuda`` (this rank's card becomes the current device), gloo for the
    CPU."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    count = num_processes or 1
    if count == 1 and not coordinator_address:
        return 0, 1
    if not coordinator_address:
        raise ValueError(f"{count} processes need --coordinator_address host:port")
    rank = process_id or 0
    if not 0 <= rank < count:
        raise ValueError(f"process_id {rank} is outside [0, {count})")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
        if not dist.is_nccl_available():
            raise RuntimeError("device cuda needs the NCCL backend, which this torch lacks")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=count, rank=rank,
                            timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed() -> None:
    """Destroy the default process group (and every group made from it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_device() -> torch.device:
    """This rank's device: its card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_batch_slice(
    global_batch_size: int, process_index: int, process_count: int
) -> tuple[int, int]:
    """This host's (offset, length) inside every global chronological batch.

    Rows are distributed as evenly as possible; the first
    ``global_batch_size % process_count`` hosts take one extra row. The
    union over hosts is exactly [0, global_batch_size) with no overlap,
    preserving the global batch boundary contract.
    """
    assert 0 <= process_index < process_count
    base = global_batch_size // process_count
    extra = global_batch_size % process_count
    length = base + (1 if process_index < extra else 0)
    offset = process_index * base + min(process_index, extra)
    return offset, length

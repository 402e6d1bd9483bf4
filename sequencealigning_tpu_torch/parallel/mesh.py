"""Device lists and multi-process initialisation: the port of
parallel/mesh.py.

A JAX mesh becomes an explicit list of ``torch.device``s on one 'data'
axis: each device fills an independent slab of rows, and the only
collective is the result merge.  Processes join with
``torch.distributed`` (NCCL on CUDA, Gloo on the CPU).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

Devices = Sequence[Union[str, torch.device]]


def make_mesh(devices: Optional[Devices] = None) -> List[torch.device]:
    """The runner's devices, in row order.  Default: every local CUDA
    device; with no GPU this raises (the port never falls back to the CPU
    by itself).  A caller may name devices, e.g. ``["cpu"] * 8``: eight
    shards computed one after another on the CPU, as the JAX package's
    tests use eight virtual CPU devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "False); name the devices, e.g. ['cpu'] * k"
            )
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("make_mesh: empty device list")
    for d in out:
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {d}")
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {d} named but no CUDA device exists")
    return out


def multihost_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` for a multi-process run:
    ``coordinator_address`` "host:port" (or a full init URL such as
    ``tcp://localhost:29500``), the world size and this process's rank.
    The backend defaults to NCCL where CUDA is available, else Gloo.  With
    no address the group reads the ``env://`` variables.  Safe to call
    when the group is already initialised."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = "env://"
    if coordinator_address:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend=backend, init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def process_count() -> int:
    """Processes of the run (1 without an initialised group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without an initialised group)."""
    return dist.get_rank() if dist.is_initialized() else 0

"""Device selection and the move of a packed batch onto a device.

The port never picks a device by itself: the caller names one.  ``"cuda"``
with no GPU raises; it does not continue on the CPU."""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from sequencealigning_tpu_torch.io.encode import PairBatch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``"cpu"`` or ``"cuda"`` (``"cuda:N"``) as a ``torch.device``.
    Raises if a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cpu or cuda")
    return dev


class TorchBatch(NamedTuple):
    """A ``PairBatch`` as tensors on one device: (B, Lq) / (B, Ld) int32
    nibble codes and (B,) int32 true lengths."""

    query: torch.Tensor
    db: torch.Tensor
    query_len: torch.Tensor
    db_len: torch.Tensor


def to_device(batch: PairBatch, device: Union[str, torch.device]) -> TorchBatch:
    """Copy the numpy ``PairBatch`` from ``io.encode.pack_batch`` onto
    ``device``, so the port computes from the same inputs as the JAX
    package."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.int32)

    return TorchBatch(
        query=put(batch.query), db=put(batch.db),
        query_len=put(batch.query_len), db_len=put(batch.db_len),
    )

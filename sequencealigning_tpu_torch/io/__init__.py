"""I/O layer: FASTA parsing and sequence encoding/batching (the port's copy
of sequencealigning_tpu/io)."""

from sequencealigning_tpu_torch.io.encode import (
    PairBatch,
    encode_seq,
    pack_batch,
    round_up,
    trim_for_stream,
)
from sequencealigning_tpu_torch.io.fasta import (
    Record,
    Records,
    parse_fasta,
)

__all__ = [
    "Record",
    "Records",
    "parse_fasta",
    "encode_seq",
    "pack_batch",
    "round_up",
    "trim_for_stream",
    "PairBatch",
]

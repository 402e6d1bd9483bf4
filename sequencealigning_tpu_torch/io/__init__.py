"""I/O layer: FASTA parsing and writing, sequence encoding/batching (the
port's copy of sequencealigning_tpu/io)."""

from sequencealigning_tpu_torch.io.encode import (
    PairBatch,
    WireBatch,
    decode_seq,
    encode_seq,
    pack_arrays,
    pack_batch,
    pack_wire,
    round_up,
    trim_for_stream,
    wire_pack_codes,
)
from sequencealigning_tpu_torch.io.fasta import (
    Record,
    Records,
    parse_fasta,
    write_fasta,
)

__all__ = [
    "Record",
    "Records",
    "parse_fasta",
    "write_fasta",
    "encode_seq",
    "decode_seq",
    "pack_batch",
    "round_up",
    "trim_for_stream",
    "pack_arrays",
    "pack_wire",
    "wire_pack_codes",
    "PairBatch",
    "WireBatch",
]

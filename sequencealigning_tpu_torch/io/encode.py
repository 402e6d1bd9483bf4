"""Sequence encoding and fixed-shape batch packing: the port's copy of
sequencealigning_tpu/io/encode.py (the parts the port uses).

The fills take static shapes: sequences are encoded into the 4-bit one-hot
alphabet (config.ENCODE: A=1, C=2, G=4, T=8, N=15, PAD=0) and packed into
(batch, padded_len) int8 arrays with explicit length vectors.  The one-hot
encoding makes "match" a single vector AND -- ``(a & b) != 0`` -- which
implements the reference's N-matches-anything scoring rule
(src/align.rs:298-304) with zero extra ops, and PAD=0 can never match.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from sequencealigning_tpu_torch.config import ENCODE, PAD

_ENCODE_LUT = np.zeros(256, dtype=np.int32)
for _ch, _v in ENCODE.items():
    _ENCODE_LUT[ord(_ch)] = _v


def encode_seq(seq: bytes) -> np.ndarray:
    """bytes -> int32 one-hot-nibble codes.

    Raises ValueError on bytes outside the uppercase {A,C,G,T,N} alphabet:
    mapping them silently to PAD would score them as guaranteed mismatches.
    Strip/clean inputs first (io.fasta.parse_fasta does, with the
    reference's recoverable CharError semantics)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    codes = _ENCODE_LUT[arr]
    if len(seq) and (codes == 0).any():
        bad = sorted({chr(b) for b, c in zip(arr, codes) if c == 0})
        raise ValueError(
            f"invalid sequence characters {bad}; allowed: A,C,G,T,N "
            "(parse_fasta strips and reports invalid bytes)"
        )
    return codes


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class PairBatch:
    """A fixed-shape batch of (query, db) pairs.

    Attributes:
        query:    (B, Lq) int8 nibble codes, PAD-padded.
        db:       (B, Ld) int8 nibble codes, PAD-padded.
        query_len:(B,)    int32 true lengths.
        db_len:   (B,)    int32 true lengths.
        valid:    (B,)    bool, False for pure-padding rows (the batch runner
                  masks these out -- the per-pair failure-isolation semantics
                  of the reference driver loop, src/main.rs:68-76).
    """

    query: np.ndarray
    db: np.ndarray
    query_len: np.ndarray
    db_len: np.ndarray
    valid: np.ndarray

    @property
    def size(self) -> int:
        return self.query.shape[0]


def pack_batch(
    pairs: List[Tuple[bytes, bytes]],
    batch_size: int = 0,
    len_multiple: int = 128,
) -> PairBatch:
    """Pack (query, db) byte-string pairs into one fixed-shape PairBatch.

    Lengths are padded up to a multiple of ``len_multiple`` (lane-aligned for
    the TPU kernels); the batch dimension is padded up to ``batch_size`` if
    given (sublane-aligned / shardable).
    """
    n = len(pairs)
    b = max(batch_size, n) if batch_size else n
    lq = round_up(max((len(q) for q, _ in pairs), default=1) or 1, len_multiple)
    ld = round_up(max((len(d) for _, d in pairs), default=1) or 1, len_multiple)

    query = np.full((b, lq), PAD, dtype=np.int8)
    db = np.full((b, ld), PAD, dtype=np.int8)
    qlen = np.zeros(b, dtype=np.int32)
    dlen = np.zeros(b, dtype=np.int32)
    valid = np.zeros(b, dtype=bool)

    for i, (q, d) in enumerate(pairs):
        query[i, : len(q)] = encode_seq(q)
        db[i, : len(d)] = encode_seq(d)
        qlen[i] = len(q)
        dlen[i] = len(d)
        valid[i] = True

    return PairBatch(query=query, db=db, query_len=qlen, db_len=dlen, valid=valid)


def trim_for_stream(batch: PairBatch) -> PairBatch:
    """Trim padded sequence columns so the streamed kernel's lane width
    P = round_up(Ld + 2, 128) doesn't spill a whole extra 128-lane block
    (one vreg per vector op, ~15-20% of step cost) just to hold the two
    boundary lanes.  Target padded length = 128*k - 2 >= true max length;
    query is trimmed the same way (launch period S = round_up(Lq+1, 128))."""
    def target(lens, pad_to_minus):
        need = int(np.max(lens)) if len(lens) else 1
        return max(round_up(need + pad_to_minus, 128) - pad_to_minus, 2)

    ld = target(batch.db_len, 2)
    lq = target(batch.query_len, 1)
    db = batch.db[:, :ld] if ld < batch.db.shape[1] else batch.db
    query = batch.query[:, :lq] if lq < batch.query.shape[1] else batch.query
    if db is batch.db and query is batch.query:
        return batch
    return PairBatch(
        query=query, db=db, query_len=batch.query_len,
        db_len=batch.db_len, valid=batch.valid,
    )

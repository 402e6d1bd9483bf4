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
from typing import List, Sequence, Tuple

import numpy as np

from sequencealigning_tpu_torch.config import DECODE, ENCODE, PAD

_ENCODE_LUT = np.zeros(256, dtype=np.int32)
for _ch, _v in ENCODE.items():
    _ENCODE_LUT[ord(_ch)] = _v
_ENCODE_LUT_U8 = _ENCODE_LUT.astype(np.uint8)

# Wire format: one-hot nibble code -> 2-bit base index (A=0 C=1 G=2 T=3).
# N (15) and PAD (0) both pack as 0; N is carried in a separate bitmask and
# PAD is re-applied from the length vectors by the device-side unpack.
_NIB2BIT = np.zeros(16, np.uint8)
for _i, _c in enumerate((1, 2, 4, 8)):
    _NIB2BIT[_c] = _i

# Fused ASCII -> wire LUT: bits 0-1 = base index, bit 2 = N, bit 3 = invalid.
# One fancy-index pass replaces the ASCII->nibble and nibble->2-bit passes.
_WIRE_LUT = np.full(256, 8, np.uint8)
for _i, _ch in enumerate("ACGT"):
    _WIRE_LUT[ord(_ch)] = _i
_WIRE_LUT[ord("N")] = 4


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


def decode_seq(codes: Sequence[int]) -> str:
    return "".join(DECODE.get(int(c), "?") for c in codes)


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


def pack_arrays(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    batch_size: int = 0,
    len_multiple: int = 128,
) -> PairBatch:
    """Vectorized pack for callers whose input is already array-shaped:
    (B, L) uint8 ASCII matrices + true lengths -> PairBatch, with no
    per-pair Python loop.

    Columns beyond each row's true length may hold anything; they are
    masked to PAD.  Raises ValueError on invalid characters inside the
    valid region, exactly like encode_seq."""
    query = np.ascontiguousarray(query, np.uint8)
    db = np.ascontiguousarray(db, np.uint8)
    query_len = np.asarray(query_len, np.int32)
    db_len = np.asarray(db_len, np.int32)
    n = query.shape[0]
    b = max(batch_size, n) if batch_size else n

    def enc(arr, lens, label):
        # uint8 end-to-end: an int32 detour costs 4x the memory traffic.
        live = np.arange(arr.shape[1], dtype=np.int32)[None, :] < lens[:, None]
        codes = _ENCODE_LUT_U8[arr]
        bad = (codes == 0) & live
        if bad.any():
            chars = sorted({chr(c) for c in np.unique(arr[bad])})
            raise ValueError(
                f"invalid {label} characters {chars}; allowed: A,C,G,T,N"
            )
        lq = round_up(max(int(lens.max()) if n else 1, 1), len_multiple)
        out = np.zeros((b, lq), np.int8)
        w = min(arr.shape[1], lq)
        np.multiply(codes, live, out=codes)  # PAD (=0) beyond true length
        out[:n, :w] = codes[:, :w]
        return out

    qlen = np.zeros(b, np.int32)
    dlen = np.zeros(b, np.int32)
    qlen[:n] = query_len
    dlen[:n] = db_len
    valid = np.zeros(b, bool)
    valid[:n] = True
    return PairBatch(
        query=enc(query, query_len, "query"),
        db=enc(db, db_len, "db"),
        query_len=qlen, db_len=dlen, valid=valid,
    )


@dataclasses.dataclass
class WireBatch:
    """A fixed-shape batch already in the 2-bit wire format (the exact
    arrays the streamed fill ships to the device -- see
    parallel.runner._unpack_wire).  The vectorized zero-copy-onward input
    type for streaming at scale: build with pack_wire, feed to
    parallel.streaming.stream_align (scores path; the cigar traceback
    needs raw byte sequences, so stream (query, db) tuples for that).

    Attributes:
        q2, d2:   (B, ceil(L/4)) uint8, 4 bases/byte little-endian 2-bit.
        qn, dn:   (B, ceil(L/8)) uint8 N bitmask or None when N-free.
        query_len, db_len: (B,) int32 true lengths.
        l1, l2:   logical padded lengths (stream-trimmed widths).
        valid:    (B,) bool, False for padding rows.
    """

    q2: np.ndarray
    d2: np.ndarray
    qn: object
    dn: object
    query_len: np.ndarray
    db_len: np.ndarray
    l1: int
    l2: int
    valid: np.ndarray

    @property
    def size(self) -> int:
        return self.q2.shape[0]


def _wire_enc(arr, lens, b, pad_to_minus, validate, label):
    n = arr.shape[0]
    v = _WIRE_LUT[np.ascontiguousarray(arr, np.uint8)]
    if validate:
        live = np.arange(arr.shape[1], dtype=np.int32)[None, :] < lens[:, None]
        bad = ((v & 8) != 0) & live
        if bad.any():
            chars = sorted({chr(c) for c in np.unique(arr[bad])})
            raise ValueError(
                f"invalid {label} characters {chars}; allowed: A,C,G,T,N"
            )
    l_target = max(
        round_up(int(lens.max() if n else 1) + pad_to_minus, 128)
        - pad_to_minus,
        2,
    )
    L8 = round_up(l_target, 8)
    c = np.zeros((b, L8), np.uint8)
    w = min(arr.shape[1], l_target)
    c[:n, :w] = v[:, :w]
    b2 = c & 3
    r = b2.reshape(b, L8 // 4, 4)
    packed2 = r[:, :, 0] | (r[:, :, 1] << 2) | (r[:, :, 2] << 4) | (r[:, :, 3] << 6)
    isn = (c & 4) != 0
    nmask = (
        np.packbits(isn, axis=1, bitorder="little") if isn.any() else None
    )
    return np.ascontiguousarray(packed2), nmask, l_target


def pack_wire(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    batch_size: int = 0,
    validate: bool = True,
) -> WireBatch:
    """Fused ASCII -> 2-bit wire pack: (B, L) uint8 ASCII matrices + true
    lengths -> WireBatch, one LUT pass per sequence (no intermediate
    nibble-code matrix, unlike pack_arrays + wire_pack_codes).

    validate=False skips the invalid-character scan for callers whose input
    is already checked -- e.g. sequences from io.fasta.parse_fasta, which
    strips and reports invalid bytes with the reference's recoverable
    CharError semantics.  Garbage beyond
    each row's true length never scores either way: the device-side
    unpack re-applies the length mask."""
    query = np.asarray(query)
    db = np.asarray(db)
    query_len = np.asarray(query_len, np.int32)
    db_len = np.asarray(db_len, np.int32)
    n = query.shape[0]
    b = max(batch_size, n) if batch_size else n
    q2, qn, l1 = _wire_enc(query, query_len, b, 1, validate, "query")
    d2, dn, l2 = _wire_enc(db, db_len, b, 2, validate, "db")
    qlen = np.zeros(b, np.int32)
    dlen = np.zeros(b, np.int32)
    qlen[:n] = query_len
    dlen[:n] = db_len
    valid = np.zeros(b, bool)
    valid[:n] = True
    return WireBatch(
        q2=q2, d2=d2, qn=qn, dn=dn, query_len=qlen, db_len=dlen,
        l1=l1, l2=l2, valid=valid,
    )


def wire_pack_codes(codes: np.ndarray):
    """(B, L) nibble-code matrix -> 2-bit-packed wire bytes.

    Returns (packed2 (B, ceil(L/4)) uint8, nmask (B, ceil(L/8)) uint8 or
    None when the batch has no N).  The host->device sequence traffic
    drops 4x; the device-side unpack (parallel.runner._unpack_wire)
    restores the exact nibble codes including PAD beyond each row's true
    length."""
    B, L = codes.shape
    L8 = round_up(max(L, 1), 8)
    c = np.zeros((B, L8), np.uint8)
    c[:, :L] = codes
    b2 = _NIB2BIT[c]
    r = b2.reshape(B, L8 // 4, 4)
    packed2 = r[:, :, 0] | (r[:, :, 1] << 2) | (r[:, :, 2] << 4) | (r[:, :, 3] << 6)
    isn = c == 15
    if not isn.any():
        return np.ascontiguousarray(packed2), None
    nmask = np.packbits(isn, axis=1, bitorder="little")
    return np.ascontiguousarray(packed2), np.ascontiguousarray(nmask)


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

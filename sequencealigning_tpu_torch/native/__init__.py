"""The port's native (C) host runtime: FASTA scan, the threaded fast4
first-path walker, the decoder of the device walks' packed op codes, the
banded (row layout) fast4 walker, the weighted-A* search and the WFA
engines (compat, the textbook offset-log walker, the exact textbook host
engine).

The port's copy of sequencealigning_tpu/native (the entry points the port
calls).  ``seqalign_native.c`` is compiled with the host C compiler on first
use into ``build/sequencealigning_tpu_torch/`` at the repository root,
rebuilt when the source is newer, and loaded with ctypes.  A missing
compiler or a failed build raises; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
from typing import List, Optional, Tuple

import numpy as np

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.errors import AlignmentError

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "seqalign_native.c")
_LIB = os.path.join(
    csrc.BUILD_DIR, f"libseqalign_native-{sys.implementation.cache_tag}.so"
)

_lib: Optional[ctypes.CDLL] = None

_LP = ctypes.POINTER(ctypes.c_long)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I16P = ctypes.POINTER(ctypes.c_int16)


def _cc() -> str:
    for cc in ("cc", "gcc", "clang"):
        path = shutil.which(cc)
        if path:
            return path
    raise RuntimeError("no C compiler to build the native runtime "
                       "(sequencealigning_tpu_torch/native/seqalign_native.c)")


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first if it is missing or older
    than its source.  Raises if it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    if csrc.stale(_LIB, [_SRC]):
        csrc.compile_library(
            [_cc(), "-O3", "-shared", "-fPIC", "-pthread"], [_SRC], _LIB
        )
    lib = ctypes.CDLL(_LIB)
    lib.fasta_scan.restype = ctypes.c_long
    lib.fasta_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_long, _U8P, _LP, _U8P, _LP, _U8P, _LP,
        ctypes.c_long,
    ]
    lib.fast4_first_path_batch.restype = None
    lib.fast4_first_path_batch.argtypes = [
        _U32P, ctypes.c_long, ctypes.c_long, _LP, _LP, _LP, _LP,
        ctypes.POINTER(ctypes.c_int), ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long, _LP, ctypes.c_int,
    ]
    lib.walk_decode_batch.restype = None
    lib.walk_decode_batch.argtypes = [
        _U32P, ctypes.c_long, _U8P, ctypes.c_long, _U8P, ctypes.c_long,
        _LP, _LP, ctypes.c_long, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_long, _LP, ctypes.c_int,
    ]
    lib.banded_fast4_first_path.restype = ctypes.c_long
    lib.banded_fast4_first_path.argtypes = [
        _U32P, ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_long,
    ]
    lib.astar_align_native.restype = ctypes.c_long
    lib.astar_align_native.argtypes = [
        _U8P, ctypes.c_long, _U8P, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
        _LP, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.astar_align_batch.restype = None
    lib.astar_align_batch.argtypes = [
        _U8P, _LP, _U8P, _LP, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
        _LP, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.wfa_compat_align.restype = ctypes.c_long
    lib.wfa_compat_align.argtypes = [
        _U8P, ctypes.c_long, _U8P, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_char_p, _LP,
    ]
    lib.wfa_textbook_traceback.restype = ctypes.c_long
    lib.wfa_textbook_traceback.argtypes = [
        _I16P, ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        _U8P, ctypes.c_long, _U8P, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
    ]
    lib.wfa_textbook_align_batch.restype = None
    lib.wfa_textbook_align_batch.argtypes = [
        _U8P, _LP, _U8P, _LP, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
        _LP, _LP, ctypes.c_int,
    ]
    _lib = lib
    return lib


def fasta_scan_native(contents: bytes):
    """Native FASTA scan.  Returns (records, err_chars), records a list of
    (seq_bytes, name_bytes) with the throwaway record dropped, or None if
    the record capacity was exceeded."""
    lib = get_lib()
    n = len(contents)
    max_recs = contents.count(b">") + 2
    seq_buf = np.empty(n + 1, np.uint8)
    name_buf = np.empty(n + 2, np.uint8)
    seq_off = np.empty(max_recs + 1, np.int64)
    name_off = np.empty(max_recs + 1, np.int64)
    err_buf = np.empty(n + 1, np.uint8)
    n_err = ctypes.c_long(0)
    n_rec = lib.fasta_scan(
        contents, n,
        seq_buf.ctypes.data_as(_U8P), seq_off.ctypes.data_as(_LP),
        name_buf.ctypes.data_as(_U8P), name_off.ctypes.data_as(_LP),
        err_buf.ctypes.data_as(_U8P), ctypes.byref(n_err), max_recs,
    )
    if n_rec < 0:
        return None
    seqs = seq_buf.tobytes()
    names = name_buf.tobytes()
    records = [
        (seqs[seq_off[i]: seq_off[i + 1]], names[name_off[i]: name_off[i + 1]])
        for i in range(1, n_rec)  # drop the throwaway record 0
    ]
    return records, [chr(c) for c in err_buf[: n_err.value]]


def fast4_first_path_batch_native(
    dirs: np.ndarray,
    finals: np.ndarray,
    rows: np.ndarray,
    d_offs: np.ndarray,
    n1s: np.ndarray,
    n2s: np.ndarray,
    n_threads: int = 8,
) -> List[Optional[str]]:
    """Threaded first-path walks over a (T8, R, P) fast4 dirs tensor (the
    streamed layout).  Returns a forward op string ('M'/'I'/'D') per pair,
    None where the walker failed."""
    lib = get_lib()
    dirs = np.ascontiguousarray(dirs, dtype=np.uint32)
    _t8, r, p = dirs.shape
    b_total = len(rows)
    n1s = np.ascontiguousarray(n1s, np.int64)
    n2s = np.ascontiguousarray(n2s, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    d_offs = np.ascontiguousarray(d_offs, np.int64)
    finals = np.ascontiguousarray(finals, np.int32)
    out_cap = int(n1s.max() + n2s.max() + 8) if b_total else 8
    outs = ctypes.create_string_buffer(b_total * out_cap)
    lens = np.zeros(b_total, np.int64)
    lib.fast4_first_path_batch(
        dirs.ctypes.data_as(_U32P), r, p,
        rows.ctypes.data_as(_LP), d_offs.ctypes.data_as(_LP),
        n1s.ctypes.data_as(_LP), n2s.ctypes.data_as(_LP),
        finals.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), b_total,
        outs, out_cap, lens.ctypes.data_as(_LP), n_threads,
    )
    raw = outs.raw
    return [
        None if lens[b] < 0
        else raw[b * out_cap: b * out_cap + int(lens[b])].decode("ascii")
        for b in range(b_total)
    ]


def walk_decode_batch_native(
    packed: np.ndarray,
    s1p: np.ndarray,
    s2p: np.ndarray,
    n1s: np.ndarray,
    n2s: np.ndarray,
    n_threads: int = 8,
) -> List[Optional[Tuple[str, str]]]:
    """Threaded decode of the device walks' packed 2-bit op codes
    (ops.traceback_device) straight to aligned string pairs: (aligned1,
    aligned2) per pair, None where the codes do not consume exactly the
    pair's sequences."""
    lib = get_lib()
    packed = np.ascontiguousarray(packed, np.uint32)
    s1p = np.ascontiguousarray(s1p, np.uint8)
    s2p = np.ascontiguousarray(s2p, np.uint8)
    n1s = np.ascontiguousarray(n1s, np.int64)
    n2s = np.ascontiguousarray(n2s, np.int64)
    b_total, t16 = packed.shape
    cap = int(n1s.max() + n2s.max() + 8) if b_total else 8
    out1 = ctypes.create_string_buffer(b_total * cap)
    out2 = ctypes.create_string_buffer(b_total * cap)
    lens = np.zeros(b_total, np.int64)
    lib.walk_decode_batch(
        packed.ctypes.data_as(_U32P), t16,
        s1p.ctypes.data_as(_U8P), s1p.shape[1],
        s2p.ctypes.data_as(_U8P), s2p.shape[1],
        n1s.ctypes.data_as(_LP), n2s.ctypes.data_as(_LP),
        b_total, out1, out2, cap, lens.ctypes.data_as(_LP), n_threads,
    )
    r1, r2 = out1.raw, out2.raw
    out: List[Optional[Tuple[str, str]]] = []
    for b in range(b_total):
        n = int(lens[b])
        out.append(None if n < 0 else (
            r1[b * cap: b * cap + n].decode("latin-1"),
            r2[b * cap: b * cap + n].decode("latin-1"),
        ))
    return out


def banded_fast4_first_path_native(
    dirs: np.ndarray,
    b: int,
    k_lo: int,
    n1: int,
    n2: int,
    finals_b,
) -> Optional[str]:
    """Native first-path walk of pair b over an (X8, B, K) banded fast4
    dirs tensor (ops.nw_banded's row layout).  Returns the forward op
    string ('M'/'I'/'D'), or None if the walker failed."""
    lib = get_lib()
    dirs = np.ascontiguousarray(dirs, dtype=np.uint32)
    _, b_dim, k_dim = dirs.shape
    cap = n1 + n2 + 8
    out = ctypes.create_string_buffer(cap)
    n = lib.banded_fast4_first_path(
        dirs.ctypes.data_as(_U32P), b_dim, k_dim, b, k_lo, n1, n2,
        int(finals_b[0]), int(finals_b[1]), int(finals_b[2]), out, cap,
    )
    if n < 0:
        return None
    return out.raw[:n].decode("ascii")


def astar_align_native(
    seq1: bytes,
    seq2: bytes,
    match: int,
    mismatch: int,
    gap_open: int,
    gap_extend: int,
    epsilon: float,
    semi_global: bool = False,
    max_expansions: int = 5_000_000,
):
    """Native weighted-A* search, bit-identical to ops.oracle_astar
    (incl. Rust BinaryHeap pop order).  Returns (score, aligned1,
    aligned2), raises AlignmentError with the oracle's message on
    non-convergence / expansion cap, or returns None on an allocation
    failure (the caller runs the oracle)."""
    lib = get_lib()
    n1, n2 = len(seq1), len(seq2)
    if n1 == 0 or n2 == 0:
        raise AlignmentError(
            "One of the provided sequences was empty. Alignment is skipped"
        )
    cap = n1 + n2 + 8
    out1 = ctypes.create_string_buffer(cap)
    out2 = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_long(0)
    out_score = ctypes.c_int32(0)
    s1 = np.frombuffer(seq1, np.uint8)
    s2 = np.frombuffer(seq2, np.uint8)
    rc = lib.astar_align_native(
        s1.ctypes.data_as(_U8P), n1, s2.ctypes.data_as(_U8P), n2,
        match, mismatch, gap_open, gap_extend,
        float(epsilon), int(bool(semi_global)), max_expansions,
        out1, out2, cap, ctypes.byref(out_len), ctypes.byref(out_score),
    )
    if rc == -1:
        raise AlignmentError("Alignment did not converge")
    if rc == -2:
        raise AlignmentError("A* exceeded max_expansions")
    if rc < 0:
        return None
    n = out_len.value
    return (
        int(out_score.value),
        out1.raw[:n].decode("latin-1"),
        out2.raw[:n].decode("latin-1"),
    )


def astar_align_batch_native(
    seqs1,
    seqs2,
    match: int,
    mismatch: int,
    gap_open: int,
    gap_extend: int,
    epsilon: float,
    semi_global: bool = False,
    max_expansions: int = 5_000_000,
    n_threads: int = 8,
):
    """Threaded batch of native weighted-A* searches (per-pair isolation
    like the reference driver's pair loop).  Returns a list per pair:
    (score, aligned1, aligned2), the oracle's AlignmentError message string
    on a search failure, or None on an allocation failure."""
    lib = get_lib()
    b_total = len(seqs1)
    off1 = np.zeros(b_total + 1, np.int64)
    off2 = np.zeros(b_total + 1, np.int64)
    for b in range(b_total):
        off1[b + 1] = off1[b] + len(seqs1[b])
        off2[b + 1] = off2[b] + len(seqs2[b])
    buf1 = (np.frombuffer(b"".join(seqs1), np.uint8) if off1[-1]
            else np.zeros(1, np.uint8))
    buf2 = (np.frombuffer(b"".join(seqs2), np.uint8) if off2[-1]
            else np.zeros(1, np.uint8))
    lens1 = np.diff(off1)
    lens2 = np.diff(off2)
    cap = int((lens1.max() if b_total else 0)
              + (lens2.max() if b_total else 0) + 8)
    out1 = ctypes.create_string_buffer(b_total * cap)
    out2 = ctypes.create_string_buffer(b_total * cap)
    lens = np.zeros(b_total, np.int64)
    scores = np.zeros(b_total, np.int32)
    lib.astar_align_batch(
        buf1.ctypes.data_as(_U8P), off1.ctypes.data_as(_LP),
        buf2.ctypes.data_as(_U8P), off2.ctypes.data_as(_LP),
        b_total, match, mismatch, gap_open, gap_extend,
        float(epsilon), int(bool(semi_global)), max_expansions,
        out1, out2, cap, lens.ctypes.data_as(_LP),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads,
    )
    r1, r2 = out1.raw, out2.raw
    results = []
    for b in range(b_total):
        n = int(lens[b])
        if n == -1:
            results.append("Alignment did not converge")
        elif n == -2:
            results.append("A* exceeded max_expansions")
        elif n == -4:
            results.append(
                "One of the provided sequences was empty. "
                "Alignment is skipped"
            )
        elif n < 0:
            results.append(None)
        else:
            results.append(
                (
                    int(scores[b]),
                    r1[b * cap: b * cap + n].decode("latin-1"),
                    r2[b * cap: b * cap + n].decode("latin-1"),
                )
            )
    return results


_WFA_ERRORS = {
    -1: "WFA did not converge within max_steps",
    -2: "WFA provably never converges on this pair (the reference binary "
        "would hang: greedy extension overshoots the len-1 convergence "
        "cell, wfa.rs:127-139 vs :189)",
    -3: "empty sequence: the reference never converges (usize wrap)",
    -5: "reference would panic: slice start > end",
    -6: "reference would panic: slice out of range",
    -7: "WFA traceback did not terminate",
}


def _u8(seq: bytes):
    """A uint8 pointer to seq's bytes (a valid pointer for b"" too)."""
    return ctypes.cast(ctypes.c_char_p(seq), _U8P)


def wfa_compat_align_native(seq1: bytes, seq2: bytes, penalties, pruning,
                            max_steps: int):
    """Native compat WFA (the reference's fill and rec_tr walk, quirks
    included).  Returns (score, aligned_seq1, aligned_seq2), None on an
    allocation or capacity failure (the caller runs the oracle), or raises
    AlignmentError with the oracle's message."""
    lib = get_lib()
    n1, n2 = len(seq1), len(seq2)
    cap = n1 + n2 + 16
    a1 = ctypes.create_string_buffer(cap)
    a2 = ctypes.create_string_buffer(cap)
    lens = (ctypes.c_long * 2)()
    r = lib.wfa_compat_align(
        _u8(seq1), n1, _u8(seq2), n2,
        penalties.mismatch, penalties.gap_open, penalties.gap_extend,
        pruning.min_length, pruning.max_diff, max_steps, a1, a2, lens,
    )
    if r < 0:
        if r == -4:
            return None
        raise AlignmentError(_WFA_ERRORS.get(int(r), f"native error {r}"))
    return (int(r), a1.raw[: lens[0]].decode("latin-1"),
            a2.raw[: lens[1]].decode("latin-1"))


def wfa_textbook_align_batch_native(
    pairs,
    penalties,
    s_max: int = 1 << 40,
    budget: int = 1 << 30,
    n_threads: Optional[int] = None,
):
    """Threaded exact textbook WFA, fill and walk, on the host (no band).
    Returns one entry per pair: (penalty, aligned_seq1, aligned_seq2), or
    None where the engine declined the pair (past s_max, or past the memory
    budget); the caller routes those onward."""
    lib = get_lib()
    B = len(pairs)
    buf1 = b"".join(p[0] for p in pairs)
    buf2 = b"".join(p[1] for p in pairs)
    off1 = np.zeros(B + 1, np.int64)
    off2 = np.zeros(B + 1, np.int64)
    np.cumsum([len(p[0]) for p in pairs], out=off1[1:])
    np.cumsum([len(p[1]) for p in pairs], out=off2[1:])
    cap = int(max((len(p[0]) + len(p[1]) for p in pairs), default=0) + 8)
    a1s = ctypes.create_string_buffer(max(1, B * cap))
    a2s = ctypes.create_string_buffer(max(1, B * cap))
    pens = np.zeros(B, np.int64)
    lens = np.zeros(B, np.int64)
    if n_threads is None:
        n_threads = min(32, os.cpu_count() or 8)
    # The C budget is a pair's, and up to min(n_threads, B) pairs fill at
    # once: divide so that the transient memory stays near `budget`.
    per_pair_budget = max(1 << 22, budget // max(1, min(n_threads, B)))
    lib.wfa_textbook_align_batch(
        _u8(buf1), off1.ctypes.data_as(_LP), _u8(buf2),
        off2.ctypes.data_as(_LP), B,
        penalties.mismatch, penalties.gap_open, penalties.gap_extend,
        s_max, per_pair_budget, a1s, a2s, cap,
        pens.ctypes.data_as(_LP), lens.ctypes.data_as(_LP), n_threads,
    )
    r1, r2 = a1s.raw, a2s.raw
    out = []
    for b in range(B):
        if pens[b] < 0:
            out.append(None)
            continue
        n = int(lens[b])
        out.append((int(pens[b]), r1[b * cap: b * cap + n].decode("latin-1"),
                    r2[b * cap: b * cap + n].decode("latin-1")))
    return out


def wfa_textbook_traceback_native(
    hist: np.ndarray,
    b: int,
    k_lo: int,
    score: int,
    seq1: bytes,
    seq2: bytes,
    penalties,
    stride: int = 1,
):
    """Native walk of pair b's textbook WFA alignment over the (S, 3, B, K)
    int16 offset log (row j = score j * stride).  Returns (aligned_seq1,
    aligned_seq2), or None where the walker failed."""
    lib = get_lib()
    hist = np.ascontiguousarray(hist, np.int16)
    S, _, B, K = hist.shape
    n1, n2 = len(seq1), len(seq2)
    cap = n1 + n2 + 8
    a1 = ctypes.create_string_buffer(cap)
    a2 = ctypes.create_string_buffer(cap)
    n = lib.wfa_textbook_traceback(
        hist.ctypes.data_as(_I16P), S, B, K, b, k_lo, score, stride,
        _u8(seq1), n1, _u8(seq2), n2,
        penalties.mismatch, penalties.gap_open, penalties.gap_extend,
        a1, a2, cap,
    )
    if n < 0:
        return None
    return a1.raw[:n].decode("latin-1"), a2.raw[:n].decode("latin-1")

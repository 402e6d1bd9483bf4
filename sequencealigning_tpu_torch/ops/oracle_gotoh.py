"""Affine-gap Needleman-Wunsch (Gotoh 3-matrix) scalar oracle.
(The port's copy of sequencealigning_tpu/ops/oracle_gotoh.py.)

Reference: src/needleman_wunsch_affine.rs.  Two modes:

* ``compat=True`` -- bit-identical to the reference, including its quirks:
    - boundary gap chains score ``open + (k+1) * extend`` (one extra extend
      vs. textbook Gotoh; needleman_wunsch_affine.rs:195, 207);
    - the x=0 row chain is stored in the *D* plane and the y=0 column chain
      in the *I* plane -- inverted w.r.t. the planes' own semantics
      (InD consumes seq2/x, InI consumes seq1/y; :183-216) -- which leaks into
      interior D/I values at x=1 / y=1;
    - "-infinity" is exactly ``i16::MIN = -32768`` (:174) with ordinary i32
      arithmetic (no saturation);
    - match is plain char equality -- **no** N-wildcard here (:220), unlike
      the A* aligner's get_cost (src/align.rs:298-304).
* ``compat=False`` -- textbook Gotoh: boundary chains ``open + k*extend``
  stored in the semantically-correct planes (row 0 in I, column 0 in D),
  same interior recurrence.

Indexing follows the reference: x in 0..=len(seq2) (db, rows),
y in 0..=len(seq1) (query, cols).  seq1 = query, seq2 = db.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
from sequencealigning_tpu_torch.errors import AlignmentError

# Plane ids (used in the packed direction encoding shared with the kernels).
M, I, D = 0, 1, 2


def gotoh_fill(
    seq1: bytes,
    seq2: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    model: str = "ref",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fill the three DP planes; returns (m, i, d) int32 arrays of shape
    (len(seq2)+1, len(seq1)+1).  Reference: fill(), :169-241.

    model="std" opens gaps from H = max(M, I, D) instead of the M plane
    -- the STANDARD gap-affine model (WFA's merged M-wavefront,
    wfa.rs:353-398); textbook boundaries only (compat is a
    reference-model notion).  The two models coincide iff
    mismatch <= 2*gap_extend in penalty terms (PARITY.md)."""
    if model not in ("ref", "std"):
        raise ValueError(f"unknown affine model {model!r}")
    if model == "std" and compat:
        raise ValueError("model='std' requires compat=False")
    n1, n2 = len(seq1), len(seq2)
    o, e = scheme.gap_open, scheme.gap_extend
    mat = scheme.match_
    mis = scheme.mismatch

    m = np.full((n2 + 1, n1 + 1), NEG_INF, dtype=np.int64)
    i_ = np.full((n2 + 1, n1 + 1), NEG_INF, dtype=np.int64)
    d = np.full((n2 + 1, n1 + 1), NEG_INF, dtype=np.int64)

    m[0, 0] = 0
    js = np.arange(1, n1 + 1, dtype=np.int64)
    xs = np.arange(1, n2 + 1, dtype=np.int64)
    if compat:
        # Row 0 chain lives in D, column 0 chain in I, each with the extra
        # extend (:183-216).
        if n1:
            d[0, 1:] = o + (js + 1) * e
        if n2:
            i_[1:, 0] = o + (xs + 1) * e
    else:
        # Textbook: row 0 = horizontal moves = I plane; column 0 = D plane.
        if n1:
            i_[0, 1:] = o + js * e
        if n2:
            d[1:, 0] = o + xs * e

    s1 = np.frombuffer(seq1, dtype=np.uint8)
    s2 = np.frombuffer(seq2, dtype=np.uint8)
    std = model == "std"
    for x in range(1, n2 + 1):
        mp = m[x - 1]
        ip = i_[x - 1]
        dp = d[x - 1]
        mc = m[x]
        ic = i_[x]
        dc = d[x]
        hp = np.maximum(np.maximum(mp, ip), dp)  # H at row x-1
        # D depends only on the previous row: vectorize over y.
        dc[1:] = np.maximum((hp if std else mp)[1:] + o, dp[1:]) + e
        sub = np.where(s1 == s2[x - 1], mat, mis)
        mc[1:] = hp[:-1] + sub
        # I has the in-row dependency; scalar loop (oracle = clarity first).
        for y in range(1, n1 + 1):
            open_src = max(mc[y - 1], ic[y - 1], dc[y - 1]) if std else mc[y - 1]
            ic[y] = max(open_src + o, ic[y - 1]) + e
    return (
        m.astype(np.int32),
        i_.astype(np.int32),
        d.astype(np.int32),
    )


def gotoh_score(
    seq1: bytes,
    seq2: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    model: str = "ref",
) -> int:
    """Final global score = max over the three planes at (len2, len1)
    (reference: traceback seed, :247-250)."""
    m, i_, d = gotoh_fill(seq1, seq2, scheme, compat, model=model)
    return int(max(m[-1, -1], i_[-1, -1], d[-1, -1]))


def _parents(
    m: np.ndarray,
    i_: np.ndarray,
    d: np.ndarray,
    x: int,
    y: int,
    plane: int,
    sub: int,
    o: int,
    e: int,
) -> List[int]:
    """Reproduce the reference's pointer recomputation (m/i/d_pointer,
    :96-153): the parent set of cell (x, y, plane), in the reference's push
    order.  Returns a list of plane ids."""
    p: List[int] = []
    if plane == M:
        v = m[x, y]
        if v == m[x - 1, y - 1] + sub:
            p.append(M)
        if v == i_[x - 1, y - 1] + sub:
            p.append(I)
        if v == d[x - 1, y - 1] + sub:
            p.append(D)
    elif plane == I:
        v = i_[x, y]
        if v == i_[x, y - 1] + e:
            p.append(I)
        if v == m[x, y - 1] + o + e:
            p.append(M)
    else:
        v = d[x, y]
        if v == d[x - 1, y] + e:
            p.append(D)
        if v == m[x - 1, y] + o + e:
            p.append(M)
    return p


def gotoh_traceback_all(
    seq1: bytes,
    seq2: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    max_alignments: int = 64,
) -> Tuple[int, List[Tuple[str, str]]]:
    """Enumerate co-optimal global alignments in the reference's exact print
    order (LIFO stack, seeds pushed I, M, D; parents pushed in m/i/d_pointer
    order; reference: traceback(), :242-334).

    Returns (score, [(aligned_seq1, aligned_seq2), ...]).

    Boundary-chain parents: cells on the x=0 row of the compat D plane (and
    y=0 column of the compat I plane) carry chain parents
    (:196, :208).  Walking such a cell indexes ``seq2[x-1]`` with ``x == 0``,
    which in the Rust reference is a usize-underflow panic.  Here it raises
    ``AlignmentError`` so callers can isolate the pair -- the one deliberate
    deviation (a crash is not an output to be bit-matched).
    """
    n1, n2 = len(seq1), len(seq2)
    o, e = scheme.gap_open, scheme.gap_extend
    m, i_, d = gotoh_fill(seq1, seq2, scheme, compat)
    planes = {M: m, I: i_, D: d}
    score = int(max(m[n2, n1], i_[n2, n1], d[n2, n1]))

    # Chain-parent bookkeeping for boundary cells (which have parents in the
    # reference via Rc links rather than pointer recomputation).
    def cell_parents(x: int, y: int, plane: int) -> List[int]:
        if compat:
            if x == 0 and y > 0 and plane == D:
                return [D]
            if y == 0 and x > 0 and plane == I:
                return [I]
            if x == 0 or y == 0:
                return []
        else:
            if x == 0 and y > 0 and plane == I:
                return [I]
            if y == 0 and x > 0 and plane == D:
                return [D]
            if x == 0 or y == 0:
                return []
        sub = scheme.match_ if seq1[y - 1] == seq2[x - 1] else scheme.mismatch
        return _parents(m, i_, d, x, y, plane, sub, o, e)

    # Stack entries mirror TraceBackInfo (:373-380).
    stack: List[Tuple[bytes, bytes, int, int, int]] = []
    end = (n2, n1)
    for plane in (I, M, D):  # push order :251-280 (I, M, D)
        if planes[plane][end] == score:
            stack.append((b"", b"", plane, n2, n1))

    out: List[Tuple[str, str]] = []
    while stack:
        a1, a2, plane, x, y = stack.pop()
        if x == 0 and y == 0:
            out.append((a1.decode("latin-1"), a2.decode("latin-1")))
            if len(out) >= max_alignments:
                break
        for parent in cell_parents(x, y, plane):
            if plane == M:
                if x == 0 or y == 0:
                    raise AlignmentError(
                        "reference would panic: M-cell traceback at boundary"
                    )
                s1c, s2c, nx, ny = seq1[y - 1 : y], seq2[x - 1 : x], x - 1, y - 1
            elif plane == D:
                if x == 0:
                    raise AlignmentError(
                        "reference would panic: boundary-chain traceback "
                        "(seq2 indexed at -1)"
                    )
                s1c, s2c, nx, ny = b"-", seq2[x - 1 : x], x - 1, y
            else:  # I
                if y == 0:
                    raise AlignmentError(
                        "reference would panic: boundary-chain traceback "
                        "(seq1 indexed at -1)"
                    )
                s1c, s2c, nx, ny = seq1[y - 1 : y], b"-", x, y - 1
            stack.append((s1c + a1, s2c + a2, parent, nx, ny))
    return score, out


def gotoh_align_first(
    seq1: bytes,
    seq2: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
) -> Tuple[int, str, str]:
    """Score + the FIRST co-optimal alignment in reference print order --
    the canonical single-alignment answer used for CIGAR output."""
    score, alns = gotoh_traceback_all(seq1, seq2, scheme, compat, max_alignments=1)
    if not alns:
        raise AlignmentError("traceback produced no complete alignment")
    return score, alns[0][0], alns[0][1]

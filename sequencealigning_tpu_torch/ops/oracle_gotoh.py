"""Affine-gap Needleman-Wunsch (Gotoh 3-matrix) scalar oracle.
(The port's copy of the fill and score of
sequencealigning_tpu/ops/oracle_gotoh.py.)

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

from typing import Tuple

import numpy as np

from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme

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

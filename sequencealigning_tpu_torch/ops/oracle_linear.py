"""Linear/gap-state Needleman-Wunsch scalar oracle.
(The port's copy of sequencealigning_tpu/ops/oracle_linear.py.)

Reference: src/needleman_wunsch.rs (dead code -- ``mod needleman_wunsch`` is
commented out of src/main.rs:4 -- but it is the only linear-gap and the only
Smith-Waterman-style *local* implementation in the reference, so this
framework revives it as ``Algo.NW_LINEAR``).

Semantics preserved exactly (compat=True):

* Per-cell ``Gap`` flag: a move is charged ``gap_extension`` if the source
  cell's flag is set, else ``gap_opening`` -- affine-ish with one cell of
  memory, NOT true affine (:73-87).  The flag is set when the max came from
  down OR right (:85-87).
* Global boundary quirk: the init loops add ``i*ext + open`` to row 0 AND
  column 0 *including the origin twice*, so scores[0][0] == 2*open and
  row/col 0 start at ``open`` (:43-64 -- both loops enumerate from 0).
* paths[0][0] gets both Right and Down seeds; row 0 = Right, col 0 = Down.
* Local mode: negative cells keep score 0 (never written) and empty paths
  (:88-90); traceback starts from every argmax cell (:106-116, 256-272).
* Match is plain char equality (the Rust compares ``chars().nth()``).
* Traceback: DFS over per-cell multi-paths in Down, Right, Diag order,
  emitting a Hit when reaching (0,0) or an empty-path cell (:205-254).

compat=False: textbook linear-gap NW -- a single gap cost per gapped column
(``gap_extend``), boundary ``j*gap_extend``, no flags.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sequencealigning_tpu_torch.config import ScoringScheme

DOWN, RIGHT, DIAG = 0, 1, 2


def linear_fill(
    seq1: bytes,
    seq2: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    local: bool = False,
    compat: bool = True,
) -> Tuple[np.ndarray, List[List[List[int]]], np.ndarray]:
    """Returns (scores, paths, gaps). scores: (len1+1, len2+1) int32 --
    NOTE the transposed orientation vs. the Gotoh oracle: this module indexes
    rows by seq1 like the reference (:38, seq1 = rows)."""
    n1, n2 = len(seq1), len(seq2)
    o, e = scheme.gap_open, scheme.gap_extend
    scores = np.zeros((n1 + 1, n2 + 1), dtype=np.int64)
    paths: List[List[List[int]]] = [[[] for _ in range(n2 + 1)] for _ in range(n1 + 1)]
    gaps = np.zeros((n1 + 1, n2 + 1), dtype=bool)

    if not local:
        if compat:
            # Both init loops start at index 0 (:50, :60): origin gets 2*open.
            for j in range(n2 + 1):
                scores[0, j] += j * e + o
                paths[0][j].append(RIGHT)
                gaps[0, j] = True
            for i in range(n1 + 1):
                scores[i, 0] += i * e + o
                paths[i][0].append(DOWN)
                gaps[i, 0] = True
        else:
            for j in range(1, n2 + 1):
                scores[0, j] = j * e
                paths[0][j].append(RIGHT)
            for i in range(1, n1 + 1):
                scores[i, 0] = i * e
                paths[i][0].append(DOWN)

    for i in range(1, n1 + 1):
        for j in range(1, n2 + 1):
            diag = scores[i - 1, j - 1] + (
                scheme.match_ if seq1[i - 1] == seq2[j - 1] else scheme.mismatch
            )
            if compat:
                down = scores[i - 1, j] + (e if gaps[i - 1, j] else o)
                right = scores[i, j - 1] + (e if gaps[i, j - 1] else o)
            else:
                down = scores[i - 1, j] + e
                right = scores[i, j - 1] + e
            mx = max(diag, down, right)
            if mx == down or mx == right:
                gaps[i, j] = True
            if local and mx < 0:
                paths[i][j] = []
            else:
                scores[i, j] = mx
                if mx == down:
                    paths[i][j].append(DOWN)
                if mx == right:
                    paths[i][j].append(RIGHT)
                if mx == diag:
                    paths[i][j].append(DIAG)
    return scores.astype(np.int32), paths, gaps


def linear_score(
    seq1: bytes,
    seq2: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    local: bool = False,
    compat: bool = True,
) -> int:
    scores, _, _ = linear_fill(seq1, seq2, scheme, local, compat)
    if local:
        return int(scores.max())
    return int(scores[-1, -1])


def _argmax_cells(scores: np.ndarray) -> List[Tuple[int, int]]:
    """All argmax cells in row-major encounter order (reference argmax,
    :256-272)."""
    mx = scores.max()
    cells = np.argwhere(scores == mx)
    return [(int(i), int(j)) for i, j in cells]


def linear_traceback(
    seq1: bytes,
    seq2: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    local: bool = False,
    compat: bool = True,
    max_hits: int = 64,
) -> List[Tuple[str, str, int, int]]:
    """Enumerate hits in the reference's DFS emit order.

    Returns [(aligned_seq1, aligned_seq2, start_in_seq1, start_in_seq2)].
    Start coordinates replicate the reference's quirk of being set from the
    cell one step above the path end (:214-216 set them per stack frame, so
    the printed value is from the frame preceding termination).
    """
    scores, paths, _ = linear_fill(seq1, seq2, scheme, local, compat)
    starts = _argmax_cells(scores) if local else [(len(seq1), len(seq2))]
    hits: List[Tuple[str, str, int, int]] = []

    s1 = seq1.decode("latin-1")
    s2 = seq2.decode("latin-1")

    import sys

    # The oracle stays recursive for spec clarity (production walkers in
    # ops.traceback use explicit stacks); bump the limit once for all
    # starts rather than per start cell.
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, len(seq1) + len(seq2) + 1000))
    try:
        for start in starts:
            q: List[str] = []
            db: List[str] = []
            state = {"siq": 0, "sid": 0}

            def rec(cur: Tuple[int, int]) -> None:
                if len(hits) >= max_hits:
                    return
                i, j = cur
                if cur == (0, 0) or not paths[i][j]:
                    hits.append(
                        ("".join(reversed(q)), "".join(reversed(db)),
                         state["siq"], state["sid"])
                    )
                    return
                for p in paths[i][j]:
                    state["siq"] = max(i, 1) - 1
                    state["sid"] = max(j, 1) - 1
                    if p == DOWN:
                        q.append(s1[i - 1])
                        db.append("-")
                        nxt = (i - 1, j)
                    elif p == RIGHT:
                        q.append("-")
                        db.append(s2[j - 1])
                        nxt = (i, j - 1)
                    else:
                        q.append(s1[i - 1])
                        db.append(s2[j - 1])
                        nxt = (i - 1, j - 1)
                    rec(nxt)
                    q.pop()
                    db.pop()

            rec(start)
    finally:
        sys.setrecursionlimit(old)
    return hits

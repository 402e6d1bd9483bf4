"""Weighted-A* aligner scalar oracle.
(The port's copy of sequencealigning_tpu/ops/oracle_astar.py.)

Reference: src/align.rs.  Best-first search over the edit graph with a
dynamically-decaying epsilon-weighted heuristic, gap-state-aware affine gap
costs, and NO closed set (re-expansion possible).  Quirks preserved:

* The heuristic ``get_h`` (align.rs:196-199) is evaluated at the PARENT's
  position when pushing successors (align.rs:70, 90, 110, ...), not the
  successor's.
* ``h = (1 + eps*w) * -(remaining_y + remaining_x)`` truncated toward zero
  (Rust ``as i32``), with ``w = 1 - max(x,y)/target_len`` (align.rs:201-214).
  This h is a *lower* bound on the remaining score in a maximization
  problem, so the search is not admissible-optimal -- it is a deterministic
  greedy-ish best-first whose result depends on exact pop order.
* Pop order: Rust ``std::collections::BinaryHeap`` (max-heap) with
  ``State``'s Ord = f = cost+reach_cost, then position (x, y), then the
  parent chain compared recursively (align.rs:277-284); ``None < Some``.
  The heap's sift algorithms (documented std behaviour: sift_up on push
  with strict-greater promotion; pop swaps the last element to the root and
  sifts it to the bottom always, preferring the right child on ties, then
  sifts back up) are replicated so that tie-breaking -- and therefore which
  alignment is found first -- is bit-identical.
* N matches anything (get_cost, align.rs:298-304) -- unlike the NW aligners.
* ``main`` always calls A* with ``local=false`` regardless of --mode
  (src/main.rs:64); the semi-global expansion (free end-gaps at x in
  {0, len2} / y in {0, len1}, align.rs:59-123) is reachable here via
  ``semi_global=True``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.errors import AlignmentError


class State:
    __slots__ = ("f", "reach", "x", "y", "parent", "in_q_gap", "in_db_gap")

    def __init__(self, cost, reach, x, y, parent, in_q_gap, in_db_gap):
        self.f = cost + reach
        self.reach = reach
        self.x = x
        self.y = y
        self.parent = parent
        self.in_q_gap = in_q_gap
        self.in_db_gap = in_db_gap


def _cmp(a: State, b: State) -> int:
    """State::cmp (align.rs:277-284): f, then (x, y), then parent chain.
    Iterative descent through parents (Option ordering: None < Some)."""
    while True:
        if a is b:
            return 0
        if a.f != b.f:
            return -1 if a.f < b.f else 1
        if a.x != b.x:
            return -1 if a.x < b.x else 1
        if a.y != b.y:
            return -1 if a.y < b.y else 1
        pa, pb = a.parent, b.parent
        if pa is None and pb is None:
            return 0
        if pa is None:
            return -1
        if pb is None:
            return 1
        a, b = pa, pb


class RustBinaryHeap:
    """Max-heap with Rust std's exact sift semantics (see module docstring)."""

    def __init__(self):
        self.data: List[State] = []

    def __len__(self):
        return len(self.data)

    def push(self, item: State) -> None:
        self.data.append(item)
        self._sift_up(0, len(self.data) - 1)

    def pop(self) -> Optional[State]:
        d = self.data
        if not d:
            return None
        last = d.pop()
        if not d:
            return last
        item = d[0]
        d[0] = last
        self._sift_down_to_bottom(0)
        return item

    def _sift_up(self, start: int, pos: int) -> None:
        d = self.data
        element = d[pos]
        while pos > start:
            parent = (pos - 1) >> 1
            if _cmp(element, d[parent]) <= 0:
                break
            d[pos] = d[parent]
            pos = parent
        d[pos] = element

    def _sift_down_to_bottom(self, pos: int) -> None:
        d = self.data
        end = len(d)
        start = pos
        element = d[pos]
        child = 2 * pos + 1
        while child + 1 < end:
            # Prefer the right child when left <= right.
            if _cmp(d[child], d[child + 1]) <= 0:
                child += 1
            d[pos] = d[child]
            pos = child
            child = 2 * pos + 1
        if child == end - 1:
            d[pos] = d[child]
            pos = child
        d[pos] = element
        self._sift_up(start, pos)


def _get_h(len1: int, len2: int, x: int, y: int, target_len: int, eps: float) -> int:
    """get_h + dynamic_weight + heuristic_d (align.rs:196-214)."""
    mx = max(x, y)
    w = 1.0 - mx / target_len if mx <= target_len else 0.0
    h = (1.0 + eps * w) * (-float((len1 - y) + (len2 - x)))
    return int(h)  # trunc toward zero == Rust `as i32`


def astar_align(
    seq1: bytes,
    seq2: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    semi_global: bool = False,
    max_expansions: int = 5_000_000,
) -> Tuple[int, str, str]:
    """Run the search (align(), align.rs:19-57).

    Returns (score, aligned_seq1, aligned_seq2) for the first-converged
    state, reconstructed like pprint (align.rs:231-265).
    """
    if len(seq1) == 0 or len(seq2) == 0:
        raise AlignmentError(
            "One of the provided sequences was empty. Alignment is skipped"
        )
    len1, len2 = len(seq1), len(seq2)
    target_len = max(len1, len2)
    o, e = scheme.gap_open, scheme.gap_extend
    eps = scheme.epsilon

    def get_cost(c1: int, c2: int) -> int:
        if c1 == c2 or c1 == 0x4E or c2 == 0x4E:  # b'N'
            return scheme.match_
        return scheme.mismatch

    heap = RustBinaryHeap()
    heap.push(
        State(_get_h(len1, len2, 0, 0, target_len, eps), 0, 0, 0, None, False, False)
    )

    expansions = 0
    while True:
        s = heap.pop()
        if s is None:
            raise AlignmentError("Alignment did not converge")
        if s.x == len2 and s.y == len1:
            return s.reach, *_reconstruct(s, seq1, seq2)
        expansions += 1
        if expansions > max_expansions:
            raise AlignmentError("A* exceeded max_expansions")
        x, y = s.x, s.y
        h = _get_h(len1, len2, x, y, target_len, eps)
        # Push order: x-move, y-move, diag (align.rs:134-182).
        if x < len2:
            if semi_global and (y == 0 or y == len1):
                step = 0
            elif s.in_q_gap:
                step = e
            else:
                step = o + e
            heap.push(State(h, s.reach + step, x + 1, y, s, True, s.in_db_gap))
        if y < len1:
            if semi_global and (x == 0 or x == len2):
                step = 0
            elif s.in_db_gap:
                step = e
            else:
                step = o + e
            heap.push(State(h, s.reach + step, x, y + 1, s, s.in_q_gap, True))
        if x < len2 and y < len1:
            heap.push(
                State(
                    h,
                    s.reach + get_cost(seq1[y], seq2[x]),
                    x + 1,
                    y + 1,
                    s,
                    False,
                    False,
                )
            )


def _reconstruct(state: State, seq1: bytes, seq2: bytes) -> Tuple[str, str]:
    """pprint's parent-chain walk (align.rs:231-265), returning
    (query_line, db_line) forward-ordered."""
    db: List[str] = []
    q: List[str] = []
    x, y = state.x, state.y
    cur = state.parent
    while cur is not None:
        if cur.x == x:
            y -= 1
            db.append("-")
            q.append(chr(seq1[y]))
        elif cur.y == y:
            x -= 1
            db.append(chr(seq2[x]))
            q.append("-")
        else:
            x -= 1
            y -= 1
            db.append(chr(seq2[x]))
            q.append(chr(seq1[y]))
        cur = cur.parent
    return "".join(reversed(q)), "".join(reversed(db))

"""Wavefront alignment (WFA, gap-affine, adaptive) scalar oracle.
(The port's copy of sequencealigning_tpu/ops/oracle_wfa.py.)

Reference: src/wfa.rs.  This is a faithful behavioural emulation (compat
mode) of the reference's WFA, preserving its documented-by-code quirks:

* Penalties minimized, defaults x=4 (mismatch), o=2 (gap-open), e=6
  (gap-extend) -- note o < e (wfa.rs:17-21).
* Coordinates: diag k = y - x, offset = min(x, y);
  x = offset - min(k,0), y = offset + max(k,0) (wfa.rs:85-90).
* The s=0 seed is NOT greedily extended (Ocean::global, wfa.rs:450-465), so
  even identical sequences pay one mismatch-step before any extension.
* Convergence tested only on the NEWEST tensor, and at x == len2-1 &&
  y == len1-1 (one short of the full lengths; wfa.rs:180-191, 625-632).
* The reported score is ``len(wavefront_vector)`` == true penalty + 1
  (wfa.rs:31-36).
* Adaptive trim (wfa.rs:490-623): ``min_d`` is initialised to 0 and only
  ever lowered (wfa.rs:511-517), and every real distance is >= 1, so the
  baseline is always 0 and the trim drops boundary diagonals of M whose
  distance-to-target exceeds MAXDIFF=20 -- collapsing the M band to (nearly)
  a single diagonal until the alignment is within ~20 cells of the end.
  I/D spans are then clamped to M's (with release-mode wrapping semantics on
  the truncate length).  Skipped while hi-lo <= MINLENGTH=5.
* Traceback (rec_tr, wfa.rs:654-853) returns ONE alignment and starts from
  current_score == len(wfs) (one past the final tensor index, verbatim from
  Ocean::traceback passing ``l = wfs.len()``), so it probes predecessor
  tensors off by one.  **Consequence at the default penalties** (x=4, o=2,
  e=6 -- all reachable scores are even): every probe (s-4 / s-6 / s-8 from
  an odd start) lands on an always-empty odd slot, the first iteration
  falls through to the "huh" partial return, and the printed alignment is
  EMPTY.  That is what the Rust binary does too; odd user penalties make
  the branches reachable.  Branch dispatch is by penalty VALUE (matching
  the Rust's ``if next_score_d == m`` chain), so colliding penalties shadow
  later branches identically.  Rust slice panics (start > end) and usize
  underflow surface here as ``AlignmentError``.

The textbook implementation (correct scores, proper adaptive heuristic)
lives in wfa_textbook_* functions below and is the default for
``compat=False``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from sequencealigning_tpu_torch.config import WfaPenalties, WfaPruning
from sequencealigning_tpu_torch.errors import AlignmentError

# State ids, matching ops.oracle_gotoh plane ids.
M, I, D = 0, 1, 2


@dataclasses.dataclass
class Element:
    offset: int
    parents: List[int]
    state: int

    def x(self, diag: int) -> int:
        return self.offset - min(diag, 0)

    def y(self, diag: int) -> int:
        return self.offset + max(diag, 0)

    def distance(self, len1: int, len2: int, diag: int) -> int:
        """Chebyshev-ish distance to target (wfa.rs:96-102)."""
        return max(len1 - self.offset - diag, len2 - self.offset)

    def clone(self) -> "Element":
        return Element(self.offset, list(self.parents), self.state)


@dataclasses.dataclass
class WaveFront:
    hi: int
    lo: int
    elements: List[Optional[Element]]

    def get_element(self, idx: int) -> Optional[Element]:
        pos = idx - self.lo
        if 0 <= pos < len(self.elements):
            return self.elements[pos]
        return None

    def get_offset(self, idx: int) -> Optional[int]:
        el = self.get_element(idx)
        return el.offset if el is not None else None

    def expand(self, seq1: bytes, seq2: bytes) -> None:
        """Greedy match extension -- the hot loop (wfa.rs:127-139)."""
        for i, el in enumerate(self.elements):
            if el is None:
                continue
            diag = self.lo + i
            while (
                el.y(diag) < len(seq1)
                and el.x(diag) < len(seq2)
                and seq1[el.y(diag)] == seq2[el.x(diag)]
            ):
                el.offset += 1

    def converged_element(self, seq1: bytes, seq2: bytes) -> Optional[Element]:
        """First element (index order) at (len2-1, len1-1) (wfa.rs:180-191)."""
        for i, el in enumerate(self.elements):
            if el is None:
                continue
            diag = self.lo + i
            if el.x(diag) == len(seq2) - 1 and el.y(diag) == len(seq1) - 1:
                return el
        return None


@dataclasses.dataclass
class Tensor:
    i: Optional[WaveFront] = None
    d: Optional[WaveFront] = None
    m: Optional[WaveFront] = None

    def converged_element(self, seq1: bytes, seq2: bytes) -> Optional[Element]:
        # Check order i, d, m (wfa.rs:422-439).
        for wf in (self.i, self.d, self.m):
            if wf is not None:
                el = wf.converged_element(seq1, seq2)
                if el is not None:
                    return el
        return None


def _opt_max(*vals: Optional[int]) -> Optional[int]:
    present = [v for v in vals if v is not None]
    return max(present) if present else None


def tensor_new(
    open_t: Optional[Tensor],   # s - o - e
    ext_t: Optional[Tensor],    # s - e
    mis_t: Optional[Tensor],    # s - x
) -> Optional[Tensor]:
    """WaveFrontTensor::new (wfa.rs:225-420), verbatim semantics."""
    his = [
        open_t.m.hi if open_t and open_t.m else None,
        mis_t.m.hi if mis_t and mis_t.m else None,
        ext_t.i.hi if ext_t and ext_t.i else None,
        ext_t.d.hi if ext_t and ext_t.d else None,
    ]
    los = [
        open_t.m.lo if open_t and open_t.m else None,
        mis_t.m.lo if mis_t and mis_t.m else None,
        ext_t.i.lo if ext_t and ext_t.i else None,
        ext_t.d.lo if ext_t and ext_t.d else None,
    ]
    hi = _opt_max(*his)
    lo_candidates = [v for v in los if v is not None]
    if hi is None or not lo_candidates:
        return None
    hi += 1
    lo = min(lo_candidates) - 1

    i_wf = WaveFront(hi=hi, lo=lo, elements=[])
    d_wf = WaveFront(hi=hi, lo=lo, elements=[])
    m_wf = WaveFront(hi=hi, lo=lo, elements=[])
    trk = {k: {"hi": hi, "lo": lo, "set": False} for k in ("i", "d", "m")}

    def track(k: str, idx: int) -> None:
        trk[k]["hi"] = idx
        if not trk[k]["set"]:
            trk[k]["lo"] = idx
            trk[k]["set"] = True

    open_m = open_t.m if open_t else None
    ext_i = ext_t.i if ext_t else None
    ext_d = ext_t.d if ext_t else None
    mis_m = mis_t.m if mis_t else None

    for idx in range(lo, hi + 1):
        # D wavefront: same offset from open.m[idx+1] / ext.d[idx+1]
        # (wfa.rs:269-311).
        off = _opt_max(
            open_m.get_offset(idx + 1) if open_m else None,
            ext_d.get_offset(idx + 1) if ext_d else None,
        )
        if off is not None:
            cand = [
                w.get_element(idx + 1)
                for w in (open_m, ext_d)
                if w is not None
            ]
            parents = [el.state for el in cand if el is not None and el.offset == off]
            d_wf.elements.append(Element(offset=off, parents=parents, state=D))
            track("d", idx)
        else:
            d_wf.elements.append(None)

        # I wavefront: offset+1 from open.m[idx-1] / ext.i[idx-1]
        # (wfa.rs:313-351); parent match tested against the PRE-increment
        # offset.
        off = _opt_max(
            open_m.get_offset(idx - 1) if open_m else None,
            ext_i.get_offset(idx - 1) if ext_i else None,
        )
        if off is not None:
            cand = [
                w.get_element(idx - 1)
                for w in (open_m, ext_i)
                if w is not None
            ]
            parents = [el.state for el in cand if el is not None and el.offset == off]
            i_wf.elements.append(Element(offset=off + 1, parents=parents, state=I))
            track("i", idx)
        else:
            i_wf.elements.append(None)

        # M wavefront: max of mis.m[idx]+1 and the NEW i/d at idx
        # (wfa.rs:353-398).
        mis_off = mis_m.get_offset(idx) if mis_m else None
        off = _opt_max(
            mis_off + 1 if mis_off is not None else None,
            i_wf.get_offset(idx),
            d_wf.get_offset(idx),
        )
        if off is not None:
            cand: List[Optional[Element]] = []
            if mis_m is not None:
                el = mis_m.get_element(idx)
                if el is not None:
                    cand.append(Element(offset=el.offset + 1, parents=[], state=M))
            cand.append(i_wf.get_element(idx))
            cand.append(d_wf.get_element(idx))
            parents = [el.state for el in cand if el is not None and el.offset == off]
            m_wf.elements.append(Element(offset=off, parents=parents, state=M))
            track("m", idx)
        elif trk["m"]["set"]:
            # Nones before the first Some are never pushed for M
            # (wfa.rs:396-398).
            m_wf.elements.append(None)

    for wf, k in ((i_wf, "i"), (d_wf, "d"), (m_wf, "m")):
        wf.lo, wf.hi = trk[k]["lo"], trk[k]["hi"]

    # rotate_left + truncate to the tracked span (wfa.rs:405-409).
    for wf in (i_wf, d_wf):
        k = abs(lo - wf.lo)
        wf.elements = wf.elements[k:] + wf.elements[:k]
        wf.elements = wf.elements[: abs(wf.hi - wf.lo) + 1]
    m_wf.elements = m_wf.elements[: abs(m_wf.hi - m_wf.lo) + 1]

    return Tensor(
        i=i_wf if trk["i"]["set"] else None,
        d=d_wf if trk["d"]["set"] else None,
        m=m_wf if trk["m"]["set"] else None,
    )


@dataclasses.dataclass
class Ocean:
    """Score-indexed wavefront history (Ocean::Global, wfa.rs:442-465)."""

    wfs: List[Optional[Tensor]]
    penalties: WfaPenalties
    pruning: WfaPruning

    @classmethod
    def global_(
        cls,
        penalties: WfaPenalties = WfaPenalties(),
        pruning: WfaPruning = WfaPruning(),
    ) -> "Ocean":
        seed = Tensor(
            m=WaveFront(hi=0, lo=0, elements=[Element(offset=0, parents=[], state=M)])
        )
        return cls(wfs=[seed], penalties=penalties, pruning=pruning)

    def _get(self, k: int) -> Optional[Tensor]:
        if 0 <= k < len(self.wfs):
            return self.wfs[k]
        return None

    def expand(self, seq1: bytes, seq2: bytes) -> None:
        """One score step (wfa.rs:467-488)."""
        p = self.penalties
        s = len(self.wfs)
        t = tensor_new(
            self._get(s - p.gap_open - p.gap_extend),
            self._get(s - p.gap_extend),
            self._get(s - p.mismatch),
        )
        self.wfs.append(t)
        if t is not None and t.m is not None:
            t.m.expand(seq1, seq2)
        self.trim(seq1, seq2)

    def trim(self, seq1: bytes, seq2: bytes) -> None:
        """Adaptive pruning (wfa.rs:490-623), verbatim incl. min_d=0 quirk."""
        if not self.wfs or self.wfs[-1] is None:
            return
        current = self.wfs[-1]
        m = current.m
        if m is None:
            return
        if abs(m.lo - m.hi) <= self.pruning.min_length:
            return
        len1, len2 = len(seq1), len(seq2)
        maxdiff = self.pruning.max_diff

        min_d = 0
        for diag in range(m.lo, m.hi + 1):
            el = m.get_element(diag)
            if el is not None:
                min_d = min(min_d, el.distance(len1, len2, diag))

        def first_d() -> int:
            el = m.elements[0]
            assert el is not None, "first element is ensured to be Some"
            return el.distance(len1, len2, m.lo)

        def last_d() -> int:
            el = m.elements[-1]
            assert el is not None
            return el.distance(len1, len2, m.hi)

        next_d = first_d()
        while m.lo < m.hi and abs(next_d - min_d) > maxdiff:
            m.lo += 1
            m.elements.pop(0)
            while m.get_element(m.lo) is None:
                if m.lo == m.hi:
                    break
                m.lo += 1
                m.elements.pop(0)
            next_d = first_d()
        next_d = last_d()
        while m.hi > m.lo and abs(next_d - min_d) > maxdiff:
            m.hi -= 1
            m.elements.pop()
            while m.get_element(m.hi) is None:
                if m.lo == m.hi:
                    break
                m.hi -= 1
                m.elements.pop()
            next_d = last_d()

        # Clamp I/D spans to M's (wfa.rs:574-622).  The Rust computes
        # ``elements.truncate(len - t)`` with wrapping usize arithmetic in
        # release mode: t > len makes the truncate a no-op.
        for wf in (current.i, current.d):
            if wf is None:
                continue
            if wf.lo < m.lo:
                k = abs(wf.lo - m.lo)
                wf.elements = wf.elements[k:] + wf.elements[:k]
                t = k + (abs(wf.hi - m.hi) if wf.hi > m.hi else 0)
            elif wf.hi > m.hi:
                t = abs(wf.hi - m.hi)
            else:
                t = 0
            new_len = len(wf.elements) - t
            if new_len >= 0:
                wf.elements = wf.elements[:new_len]
            wf.hi = min(wf.hi, m.hi)
            wf.lo = max(wf.lo, m.lo)

    def converged_element(self, seq1: bytes, seq2: bytes) -> Optional[Element]:
        if self.wfs and self.wfs[-1] is not None:
            return self.wfs[-1].converged_element(seq1, seq2)
        return None


def wfa_align(
    seq1: bytes,
    seq2: bytes,
    penalties: WfaPenalties = WfaPenalties(),
    pruning: WfaPruning = WfaPruning(),
    max_steps: int = 1_000_000,
) -> Tuple[int, "Ocean"]:
    """Run the score loop (wfa_align, wfa.rs:23-42).  Returns
    (reported_score, ocean) where reported_score == len(wfs), the
    reference's off-by-one report (wfa.rs:31-36).

    Deviation: the reference hangs forever on empty sequences (convergence
    tests x == len-1 with usize wrap); here that's an AlignmentError, as is
    exceeding ``max_steps``.
    """
    if len(seq1) == 0 or len(seq2) == 0:
        raise AlignmentError(
            "empty sequence: the reference never converges (usize wrap)"
        )
    # Provable non-convergence bound: any complete alignment has at most
    # n1+n2 columns, each costing at most max(x, o+e), so every reachable
    # corner landing happens at penalty <= (n1+n2)*(x+o+e).  Past that,
    # the reference's loop (which would run forever -- the greedy-extension
    # overshoot, wfa.rs:127-139 vs :189) can be declared divergent exactly.
    p = penalties
    provable = (len(seq1) + len(seq2)) * (p.mismatch + p.gap_open + p.gap_extend) + 4
    cap = min(max_steps, provable)
    ocean = Ocean.global_(penalties, pruning)
    steps = 0
    while ocean.converged_element(seq1, seq2) is None:
        ocean.expand(seq1, seq2)
        steps += 1
        if steps > cap:
            raise AlignmentError(
                "WFA did not converge within max_steps"
                if cap == max_steps
                else "WFA provably never converges on this pair (the "
                "reference binary would hang: greedy extension overshoots "
                "the len-1 convergence cell, wfa.rs:127-139 vs :189)"
            )
    return len(ocean.wfs), ocean


def wfa_traceback(
    ocean: "Ocean", seq1: bytes, seq2: bytes
) -> Tuple[str, str]:
    """Emulate rec_tr (wfa.rs:654-853) iteratively (it is tail-recursive).

    Returns the single (aligned_seq1, aligned_seq2) pair in forward order.
    Rust panics (slice start > end) surface as AlignmentError.
    """
    p = ocean.penalties
    len1, len2 = len(seq1), len(seq2)
    diag = len1 - len2
    next_e = ocean.converged_element(seq1, seq2)
    if next_e is None:
        return "", ""
    next_e = next_e.clone()
    current_score = len(ocean.wfs)
    a1: List[int] = []  # built reversed, like Alignment.seq1 (wfa.rs:944-948)
    a2: List[int] = []

    def ext(dst: List[int], seq: bytes, start: int, stop: int) -> None:
        if start > stop:
            raise AlignmentError("reference would panic: slice start > end")
        if start < 0 or stop > len(seq):
            raise AlignmentError("reference would panic: slice out of range")
        dst.extend(reversed(seq[start:stop]))

    guard = 0
    while not (diag == 0 and next_e.offset == 0):
        guard += 1
        if guard > len1 + len2 + 16 + len(ocean.wfs):
            raise AlignmentError("WFA traceback did not terminate")
        moved = False
        for d_pen in (p.mismatch, p.gap_extend, p.gap_open + p.gap_extend):
            if d_pen > current_score:
                continue
            next_score = current_score - d_pen
            tensor = ocean._get(next_score)
            if tensor is None:
                continue
            if d_pen == p.mismatch:
                if next_e.state != M and M in next_e.parents:
                    wf = tensor.m.get_element(diag) if tensor.m else None
                    if wf is not None:
                        ext(a1, seq1, wf.y(diag), next_e.y(diag))
                        ext(a2, seq2, wf.x(diag), next_e.x(diag))
                        next_e, current_score, moved = wf.clone(), next_score, True
                        break
            elif d_pen == p.gap_extend:
                if D in next_e.parents:
                    wf = tensor.d.get_element(diag - 1) if tensor.d else None
                    if wf is not None:
                        ext(a1, seq1, wf.y(diag), next_e.y(diag))
                        a2.append(ord("-"))
                        ext(a2, seq2, wf.x(diag), next_e.x(diag))
                        diag -= 1
                        next_e, current_score, moved = wf.clone(), next_score, True
                        break
                wf = tensor.i.get_element(diag + 1) if tensor.i else None
                if wf is not None:
                    a1.append(ord("-"))
                    ext(a1, seq1, wf.y(diag), next_e.y(diag))
                    ext(a2, seq2, wf.x(diag), next_e.x(diag))
                    diag += 1
                    next_e, current_score, moved = wf.clone(), next_score, True
                    break
            elif M in next_e.parents:
                if next_e.state == D:
                    wf = tensor.d.get_element(diag - 1) if tensor.d else None
                    if wf is not None:
                        ext(a1, seq1, wf.y(diag), next_e.y(diag))
                        a2.append(ord("-"))
                        ext(a2, seq2, wf.x(diag), next_e.x(diag))
                        diag -= 1
                        next_e, current_score, moved = wf.clone(), next_score, True
                        break
                elif next_e.state == I:
                    wf = tensor.i.get_element(diag + 1) if tensor.i else None
                    if wf is not None:
                        a1.append(ord("-"))
                        ext(a1, seq1, wf.y(diag), next_e.y(diag))
                        ext(a2, seq2, wf.x(diag), next_e.x(diag))
                        diag += 1
                        next_e, current_score, moved = wf.clone(), next_score, True
                        break
                else:  # state M: try I then D (wfa.rs:801-842)
                    wf = tensor.i.get_element(diag + 1) if tensor.i else None
                    if wf is not None:
                        a1.append(ord("-"))
                        ext(a1, seq1, wf.y(diag), next_e.y(diag))
                        ext(a2, seq2, wf.x(diag), next_e.x(diag))
                        diag += 1
                        next_e, current_score, moved = wf.clone(), next_score, True
                        break
                    wf = tensor.d.get_element(diag - 1) if tensor.d else None
                    if wf is not None:
                        ext(a1, seq1, wf.y(diag), next_e.y(diag))
                        a1.append(ord("-"))  # sic: the reference pushes the
                        # gap onto seq1 here, not seq2 (wfa.rs:829) -- bug
                        # preserved for parity.
                        ext(a2, seq2, wf.x(diag), next_e.x(diag))
                        diag -= 1
                        next_e, current_score, moved = wf.clone(), next_score, True
                        break
        if not moved:
            # "huh": no branch taken; reference returns the partial alignment
            # (wfa.rs:851-852).
            break

    return (
        bytes(reversed(a1)).decode("latin-1"),
        bytes(reversed(a2)).decode("latin-1"),
    )


# ---------------------------------------------------------------------------
# Textbook WFA (compat=False): correct gap-affine wavefront alignment.
# ---------------------------------------------------------------------------


def wfa_textbook_score(
    seq1: bytes,
    seq2: bytes,
    penalties: WfaPenalties = WfaPenalties(),
) -> int:
    """Exact gap-affine WFA penalty (no pruning): the minimum penalty of a
    global alignment under cost(match)=0, cost(mismatch)=x,
    cost(gap of length L)=o+e*L.  Classic WFA recurrence (Marco-Sola et
    al. 2021, public algorithm), in the clean convention:
    diag k = y - x (query minus db consumed), offset t = x (db consumed),
    so y = t + k.  Moves: M: (k, t+1); I consumes seq1: (k+1, t);
    D consumes seq2: (k-1, t+1).  Validated against the Gotoh DP in tests."""
    n1, n2 = len(seq1), len(seq2)
    if n1 == 0 or n2 == 0:
        # Pure gap (or empty-empty).
        longest = max(n1, n2)
        return 0 if longest == 0 else penalties.gap_open + penalties.gap_extend * longest
    x, o, e = penalties.mismatch, penalties.gap_open, penalties.gap_extend
    NEG = -(10**9)

    def extend(t: int, k: int) -> int:
        while t < n2 and t + k < n1 and seq2[t] == seq1[t + k]:
            t += 1
        return t

    def ok(t: int, k: int) -> bool:
        return 0 <= t <= n2 and 0 <= t + k <= n1

    m_hist: List[dict] = [{0: extend(0, 0)}]
    i_hist: List[dict] = [{}]
    d_hist: List[dict] = [{}]
    target_k = n1 - n2

    def done(mm: dict) -> bool:
        return mm.get(target_k, -1) >= n2

    if done(m_hist[0]):
        return 0

    s = 0
    limit = x * min(n1, n2) + 2 * (o + e * (abs(n1 - n2) + min(n1, n2))) + 16
    while s < limit:
        s += 1

        def get(hist: List[dict], sc: int) -> dict:
            return hist[sc] if 0 <= sc < len(hist) else {}

        m_oe = get(m_hist, s - o - e)
        m_x = get(m_hist, s - x)
        i_e = get(i_hist, s - e)
        d_e = get(d_hist, s - e)

        ks = set()
        for src, deltas in ((m_oe, (-1, 0, 1)), (m_x, (0,)), (i_e, (1,)), (d_e, (-1,))):
            for k in src:
                ks.update(k + dd for dd in deltas)

        mi: dict = {}
        di: dict = {}
        mm: dict = {}
        for k in sorted(ks):
            ival = max(m_oe.get(k - 1, NEG), i_e.get(k - 1, NEG))
            if ival > NEG and ok(ival, k):
                mi[k] = ival
            dval = max(m_oe.get(k + 1, NEG), d_e.get(k + 1, NEG)) + 1
            if dval > NEG + 1 and ok(dval, k):
                di[k] = dval
            mval = max(m_x.get(k, NEG) + 1, mi.get(k, NEG), di.get(k, NEG))
            if mval > NEG + 1 and ok(mval, k):
                mm[k] = extend(mval, k)
        m_hist.append(mm)
        i_hist.append(mi)
        d_hist.append(di)
        if done(mm):
            return s
    raise AlignmentError("textbook WFA did not converge (limit hit)")

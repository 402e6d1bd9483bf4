"""Debug guards: score-sanity and overflow checks (SURVEY.md §5).
(The port's copy of sequencealigning_tpu/utils/guards.py.)

The reference's safety net is Rust's type system; the SPMD kernels' analog
is invariant checking on results: every admissible global-alignment score
is bracketed by closed-form bounds, and the int32 lanes must stay far from
the NEG_INF sentinel region.  Enabled via AlignConfig(debug=True) or the
CLI --debug flag; violations raise GuardError naming the pair, so a kernel
regression (or a corrupted lane in a long streaming run) is caught at the
batch boundary instead of silently producing wrong CIGARs.
"""

from __future__ import annotations

from typing import Sequence

from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
from sequencealigning_tpu_torch.errors import AlignmentError


class GuardError(AlignmentError):
    """A debug invariant failed (kernel bug or data corruption)."""


def score_bounds(n1: int, n2: int, scheme: ScoringScheme):
    """(lower, upper) bound on any global affine alignment score.

    upper: min(n1, n2) matches plus one gap covering the length difference.
    lower: all-mismatch on the overlap plus the length-difference gap, or
    the two-full-gaps alignment -- both are achievable alignments, so the
    optimum is >= each of them: take the max (the tighter bound).
    """
    o, e, m, x = scheme.gap_open, scheme.gap_extend, scheme.match_, scheme.mismatch
    diff = abs(n1 - n2)
    gap_diff = (o + diff * e) if diff else 0
    upper = min(n1, n2) * m + gap_diff
    lower = max(
        min(n1, n2) * x + gap_diff,
        (o + n1 * e) + (o + n2 * e),
    )
    return lower, upper


def check_finals(
    finals,
    query_len: Sequence[int],
    db_len: Sequence[int],
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    label: str = "finals",
) -> None:
    """Validate a (B, 3) M/I/D finals array: best plane within the
    closed-form score bounds (compat's extra boundary extension widens the
    lower bound by 2*gap_extend) and no value in the sentinel underflow
    region."""
    import numpy as np

    finals = np.asarray(finals)
    best = finals.max(axis=1)
    slack = 2 * abs(scheme.gap_extend) if compat else 0
    for b, (n1, n2) in enumerate(zip(query_len, db_len)):
        n1, n2 = int(n1), int(n2)
        if n1 == 0 or n2 == 0:
            continue
        lo, hi = score_bounds(n1, n2, scheme)
        s = int(best[b])
        if not (lo - slack <= s <= hi):
            raise GuardError(
                f"{label}[{b}]: score {s} outside admissible "
                f"[{lo - slack}, {hi}] for lengths ({n1}, {n2})"
            )
        # Sentinel-underflow check per plane: a legitimate plane value is
        # either a real score (>= lo - slack) or the -inf sentinel minus at
        # most the same worst-case gap run; anything below means sentinel
        # arithmetic leaked and kept decrementing.
        floor = NEG_INF + (lo - slack)
        if (finals[b] < floor).any():
            raise GuardError(
                f"{label}[{b}]: sentinel underflow (plane below {floor})"
            )


def check_offsets(offsets, n2v, label: str = "wfa offsets") -> None:
    """WFA furthest-reaching offsets must stay within [0, n2] where
    present (textbook engine invariant)."""
    import numpy as np

    o = np.asarray(offsets)
    present = o > -(2 ** 19)
    n2 = np.asarray(n2v).reshape(-1, 1)
    bad = np.logical_and(present, np.logical_or(o < 0, o > n2))
    if bad.any():
        raise GuardError(f"{label}: offset outside [0, n2]")

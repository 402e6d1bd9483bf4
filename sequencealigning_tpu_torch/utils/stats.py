"""Alignment statistics.
(The port's copy of sequencealigning_tpu/utils/stats.py.)

The reference reserves Karlin-Altschul constants (``_lambda = 0.039``,
``_k = 0.11``, src/align.rs:15-16) but never uses them; this module makes
them functional: E-values and bit scores for local alignment hits.
"""

from __future__ import annotations

import math

from sequencealigning_tpu_torch.config import ScoringScheme


def e_value(
    score: float,
    query_len: int,
    db_len: int,
    scheme: ScoringScheme = ScoringScheme(),
) -> float:
    """Karlin-Altschul expect value: E = K * m * n * exp(-lambda * S).

    Computed in log space and capped at the float maximum so strongly
    negative global scores (exp argument > 709) return a finite huge E
    instead of raising OverflowError."""
    log_e = (
        math.log(scheme.k * max(query_len, 1) * max(db_len, 1))
        - scheme.lambda_ * score
    )
    return math.exp(min(log_e, 709.0))


def bit_score(score: float, scheme: ScoringScheme = ScoringScheme()) -> float:
    """S' = (lambda * S - ln K) / ln 2."""
    return (scheme.lambda_ * score - math.log(scheme.k)) / math.log(2.0)

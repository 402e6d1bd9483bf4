"""CIGAR string utilities.
(The port's copy of sequencealigning_tpu/utils/cigar.py.)

Conventions (matching the reference's plane semantics,
src/needleman_wunsch_affine.rs:292-319):

* ``M`` -- both sequences consume one char (match or mismatch; ``=``/``X``
  variants available via ``expand_eq``).
* ``I`` -- query (seq1) consumes, db (seq2) gapped   (reference ``InI``).
* ``D`` -- db (seq2) consumes, query (seq1) gapped   (reference ``InD``).
"""

from __future__ import annotations

import itertools
import re
from typing import Iterable, List, Tuple

_CIGAR_RE = re.compile(r"(\d+)([MIDX=])")


class Cigar(str):
    """A CIGAR string with helpers."""

    @property
    def ops(self) -> List[Tuple[int, str]]:
        return [(int(n), op) for n, op in _CIGAR_RE.findall(self)]

    def query_len(self) -> int:
        return sum(n for n, op in self.ops if op in "MIX=")

    def db_len(self) -> int:
        return sum(n for n, op in self.ops if op in "MDX=")


def cigar_from_ops(ops: Iterable[str]) -> Cigar:
    """Run-length encode a per-column op sequence ('M','I','D','=','X')."""
    return Cigar(
        "".join(
            f"{len(list(g))}{k}" for k, g in itertools.groupby(ops)
        )
    )


def ops_from_pair(aln_query: str, aln_db: str) -> List[str]:
    """Column ops from a gapped alignment pair ('-' = gap)."""
    out = []
    for q, d in zip(aln_query, aln_db):
        if q == "-":
            out.append("D")
        elif d == "-":
            out.append("I")
        else:
            out.append("M")
    return out


def cigar_from_pair(aln_query: str, aln_db: str) -> Cigar:
    return cigar_from_ops(ops_from_pair(aln_query, aln_db))

"""Alignment pretty-printing in the reference's formats.
(The port's copy of sequencealigning_tpu/utils/pprint.py.)

Three sequence lines styles exist in the reference:

* A*:  db line, bar line, query line (src/align.rs:231-265).
* affine NW: "\\nseq1: ..\\n      bars\\nseq2: .." via Display for
  TraceBackInfo (src/needleman_wunsch_affine.rs:390-411).
* WFA: seq1 line, bars, seq2 line (src/wfa.rs:950-980).

The bar rule everywhere is: '|' when the two alignment characters are EQUAL
(including '-' == '-' which cannot occur, and N=='N' only) -- a plain char
compare, not a scoring-level match.
"""

from __future__ import annotations


def bars(a: str, b: str) -> str:
    return "".join("|" if x == y else " " for x, y in zip(a, b))


def format_alignment(aln_query: str, aln_db: str, style: str = "nw") -> str:
    """Render a gapped pair.

    style "nw":    reference affine-NW format (seq1/bars/seq2 with labels).
    style "astar": reference A* format (db, bars vs query order, query).
    style "wfa":   reference WFA format (seq1, bars, seq2, no labels).
    """
    if style == "nw":
        return (
            f"\nseq1: {aln_query}\n      {bars(aln_query, aln_db)}\nseq2: {aln_db}"
        )
    if style == "astar":
        return f"{aln_db}\n{bars(aln_query, aln_db)}\n{aln_query}"
    if style == "wfa":
        return f"{aln_query}\n{bars(aln_query, aln_db)}{aln_db}\n"
    raise ValueError(f"unknown style {style!r}")

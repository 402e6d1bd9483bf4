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

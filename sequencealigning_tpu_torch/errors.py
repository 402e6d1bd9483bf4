"""Error hierarchy for the framework.
(The port's copy of sequencealigning_tpu/errors.py.)

Mirrors the reference's error surface (reference: src/errors.rs:1-15):

* ``FastaError``      -- unrecoverable I/O / file-format problems
  (reference: ``AlignerError::FastaError(io::Error)``).
* ``AlignmentError``  -- a single pair failed to align
  (reference: ``AlignerError::AlignmentError(&str)``).
* ``CharError``       -- *recoverable* parse error carrying both the offending
  characters and the usable cleaned records
  (reference: ``AlignerError::CharError {res, chars}``, src/errors.rs:13-14).

The generic-payload trick of the Rust enum (an error that also carries a
usable result) is expressed here as an exception holding ``res``: callers that
want the reference's "warn and continue" behaviour catch ``CharError`` and use
``err.res`` (reference: src/main.rs:29-35, 49-55).
"""

from __future__ import annotations

from typing import Any, List


class AlignerError(Exception):
    """Base class for all framework errors."""


class FastaError(AlignerError):
    """Input file is not a parseable FASTA file (reference: src/parse.rs:55-60)."""


class AlignmentError(AlignerError):
    """A single alignment failed (reference: src/errors.rs:11-12)."""


class CharError(AlignerError):
    """Recoverable parse error: invalid characters were stripped.

    Attributes:
        res:   the cleaned, usable parse result (``Records``).
        chars: the invalid characters, in encounter order, as 1-char strings
               (reference: src/parse.rs:84-97 collects them the same way).
    """

    def __init__(self, res: Any, chars: List[str]):
        super().__init__(
            f"invalid characters {chars!r} detected; cleaned result available as .res"
        )
        self.res = res
        self.chars = chars

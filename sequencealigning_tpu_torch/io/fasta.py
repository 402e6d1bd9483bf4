"""FASTA reader/writer with the reference's exact semantics (the port's
copy of sequencealigning_tpu/io/fasta.py).

Reference: src/parse.rs:52-154.  The semantics preserved bit-for-bit:

* Extension gate: the file name's last extension must be exactly ``fa``,
  ``fasta`` or ``fna`` (case-sensitive) or ``FastaError`` is raised
  (parse.rs:55-60, 101-106).
* Alphabet ``{A, G, C, T, N}`` (parse.rs:52).
* Byte-level state machine: ``>`` starts a new record and *is kept as the
  first byte of the name* (parse.rs:67-74); name runs to the first newline;
  newlines elsewhere are skipped; any other byte outside the alphabet is
  dropped from the sequence and collected (parse.rs:84-88).
* Content before the first ``>`` is accumulated into a throwaway record that
  is removed at the end (parse.rs:61-63, 90-91) -- so a headerless leading
  block merges into nothing, and a *missing* ``>`` on a later header merges
  that record's sequence into the previous record (asserted by the
  reference's own ``parse_bad_header`` test, parse.rs:189-215).
* If any invalid characters were seen, a recoverable ``CharError`` is raised
  carrying both the char list and the cleaned ``Records`` (parse.rs:92-97).
  Undecodable bytes map to ``'?'`` like ``char::from_u32(..).unwrap_or('?')``
  (parse.rs:85).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Union

from sequencealigning_tpu_torch.errors import CharError, FastaError

ALLOWED_CHARS = frozenset(b"AGCTN")
_VALID_EXTENSIONS = ("fa", "fasta", "fna")


@dataclasses.dataclass
class Record:
    """One FASTA record (reference: src/parse.rs:135-139).

    ``name`` includes the leading ``>`` byte, exactly like the reference
    (parse.rs:69-72).  ``seq`` holds only alphabet bytes.
    """

    seq: bytes = b""
    name: bytes = b""

    def display(self) -> str:
        """Round-trip text form (reference: Display impl, parse.rs:141-154).

        The reference writes a second ``>`` in front of the stored name (which
        already starts with ``>``); preserved here for output parity.
        """
        return ">" + self.name.decode("latin-1") + "\n" + self.seq.decode("latin-1") + "\n"

    def __len__(self) -> int:
        return len(self.seq)


@dataclasses.dataclass
class Records:
    """A parsed FASTA file (reference: src/parse.rs:107-133)."""

    records: List[Record] = dataclasses.field(default_factory=list)

    def display(self) -> str:
        return "".join(r.display() for r in self.records)

    def __iter__(self) -> Iterator[Record]:
        return iter(self.records)

    def drain(self) -> Iterator[Record]:
        """Consume records back-to-front (reference: the ``Iterator`` impl
        for ``Records`` pops from the back, src/parse.rs:121-126; unused by
        the reference's own main).  ``__iter__`` stays front-to-back so the
        driver loop order matches src/main.rs:61-78."""
        while self.records:
            yield self.records.pop()

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Record:
        return self.records[i]


def _has_extension(path: Union[str, os.PathLike], ext: str) -> bool:
    """Mirror of Rust ``Path::extension`` comparison (parse.rs:101-106):
    the extension is everything after the *last* dot of the final
    component, unless that dot is the component's first character.  Done
    by hand because os.path.splitext never splits leading-dot runs, so it
    rejects names like '..fa' that Rust accepts."""
    base = os.path.basename(os.fspath(path))
    i = base.rfind(".")
    if i <= 0:
        return False
    return base[i + 1 :] == ext


def parse_bytes(contents: bytes) -> Records:
    """Parse raw FASTA bytes (the state machine of parse.rs:61-98).

    Raises ``CharError`` (carrying the cleaned ``Records``) if any
    out-of-alphabet sequence bytes were encountered.

    Uses the native C scanner (sequencealigning_tpu_torch.native, which
    raises if it cannot be built); the Python state machine below is the
    semantic reference (tests assert byte equality), taken only when
    SEQALIGN_NO_NATIVE=1 is set.
    """
    if not os.environ.get("SEQALIGN_NO_NATIVE"):
        from sequencealigning_tpu_torch import native

        scanned = native.fasta_scan_native(contents)
        if scanned is not None:
            rec_pairs, err_chars = scanned
            result = Records(
                records=[Record(seq=s, name=n) for s, n in rec_pairs]
            )
            if err_chars:
                raise CharError(res=result, chars=err_chars)
            return result

    recs: List[Record] = []
    cur_seq = bytearray()
    cur_name = bytearray()
    in_name = False
    err_chars: List[str] = []

    for c in contents:
        if c == 0x3E:  # b'>'
            recs.append(Record(seq=bytes(cur_seq), name=bytes(cur_name)))
            cur_seq = bytearray()
            cur_name = bytearray([c])
            in_name = True
            continue
        if in_name:
            if c == 0x0A:  # b'\n'
                in_name = False
                continue
            cur_name.append(c)
        elif c == 0x0A:
            continue
        elif c not in ALLOWED_CHARS:
            # char::from_u32(c).unwrap_or('?') can only fail for surrogates,
            # unreachable for single bytes; kept for shape parity.
            err_chars.append(chr(c))
        else:
            cur_seq.append(c)

    recs.append(Record(seq=bytes(cur_seq), name=bytes(cur_name)))
    # Drop the throwaway record that accumulated pre-'>' content
    # (parse.rs:90-91).
    recs.pop(0)
    result = Records(records=recs)
    if err_chars:
        raise CharError(res=result, chars=err_chars)
    return result


def parse_fasta(path: Union[str, os.PathLike]) -> Records:
    """Parse a FASTA file (reference: ``parse_fasta``, src/parse.rs:54-99).

    Raises:
        FastaError: wrong extension or unreadable file.
        CharError:  invalid characters found (``.res`` holds the cleaned
                    records -- callers may warn and continue,
                    like src/main.rs:29-35).
    """
    if not any(_has_extension(path, e) for e in _VALID_EXTENSIONS):
        raise FastaError(f"invalid input: {os.fspath(path)!r} does not have a "
                         f"fasta extension {_VALID_EXTENSIONS}")
    try:
        with open(path, "rb") as f:
            contents = f.read()
    except OSError as e:
        raise FastaError(str(e)) from e
    return parse_bytes(contents)

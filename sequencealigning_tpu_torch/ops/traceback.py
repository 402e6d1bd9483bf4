"""Host-side traceback from packed direction words (the port's copy of
sequencealigning_tpu/ops/traceback.py).

The TPU kernel emits one byte of direction bits per DP cell (ops.dirbits);
traceback is O(n+m) pointer-chasing per alignment -- inherently sequential
and data-dependent, so it runs on the host (SURVEY.md §7 "hard parts"),
reading the packed words the fill streamed to HBM.  The first-only batch
walkers use the native C walkers (native.*_first_path_native) unless the
environment sets SEQALIGN_NO_NATIVE, as the JAX package's do.

The walk replicates the reference's LIFO co-optimal enumeration
(needleman_wunsch_affine.rs:242-334) exactly, like ops.oracle_gotoh's
score-recomputing walker -- the two walkers validate each other in tests.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from sequencealigning_tpu_torch.errors import AlignmentError
from sequencealigning_tpu_torch.ops import dirbits

M, I, D = 0, 1, 2


def _use_native() -> bool:
    """The native walkers, unless SEQALIGN_NO_NATIVE is set (the JAX
    package's switch to its Python walkers)."""
    return not os.environ.get("SEQALIGN_NO_NATIVE")


def _byte(dirs_b: np.ndarray, d: int, x: int) -> int:
    return int(dirs_b[d >> 2, x] >> (8 * (d & 3))) & 0xFF


def traceback_pair(
    dirs_b: np.ndarray,
    finals_b: np.ndarray,
    seq1: bytes,
    seq2: bytes,
    compat: bool = True,
    max_alignments: int = 64,
    d_offset: int = 0,
) -> Tuple[int, List[Tuple[str, str]]]:
    """Co-optimal global traceback for one pair (anti-diagonal dirs layout).

    dirs_b: (D4, P) uint32 slice for this pair; finals_b: (3,) int32 M/I/D
    at (n2, n1).  d_offset: diagonal offset of this pair's bytes in the
    word stream (slot*s for ops.nw_affine_stream layouts, 0 otherwise).
    Returns (score, [(aligned_seq1, aligned_seq2), ...]) in the
    reference's print order.
    """
    return _gotoh_walk(
        lambda x, y: _byte(dirs_b, x + y + d_offset, x),
        finals_b, seq1, seq2, compat, max_alignments,
    )


def banded_traceback_pair(
    dirs_b: np.ndarray,
    finals_b: np.ndarray,
    seq1: bytes,
    seq2: bytes,
    k_lo: int,
    compat: bool = True,
    max_alignments: int = 64,
) -> Tuple[int, List[Tuple[str, str]]]:
    """Traceback for ops.nw_banded's row-packed band-coordinate layout:
    byte(x, y) lives at word dirs[x//4, (y-x) - k_lo], shift 8*(x%4)."""

    def byte_at(x: int, y: int) -> int:
        k = (y - x) - k_lo
        if k < 0 or k >= dirs_b.shape[1]:
            return 0  # out of band: no parents
        return int(dirs_b[x >> 2, k] >> (8 * (x & 3))) & 0xFF

    return _gotoh_walk(byte_at, finals_b, seq1, seq2, compat, max_alignments)


def banded_diag_traceback_pair(
    dirs_b: np.ndarray,
    finals_b: np.ndarray,
    seq1: bytes,
    seq2: bytes,
    k_lo_even: int,
    compat: bool = True,
    max_alignments: int = 64,
) -> Tuple[int, List[Tuple[str, str]]]:
    """Co-optimal traceback for ops.nw_banded_diag's full 7-bit wavefront
    layout: byte(x, y) lives at word dirs[(x+y-1)//4, (y-x-k_lo_even)//2],
    shift 8*((x+y-1)%4).  Same bit semantics (and therefore the same
    enumeration order) as the row layout."""

    def byte_at(x: int, y: int) -> int:
        if x == 0 and y == 0:
            # Wavefront 0 (the origin) is never emitted; its H-argmax is
            # always the M plane (H(0,0) = M = 0, I/D = -inf).
            return dirbits.HM
        l = ((y - x) - k_lo_even) >> 1
        if l < 0 or l >= dirs_b.shape[1]:
            return 0  # out of band: no parents
        aidx = x + y - 1
        if aidx < 0 or (aidx >> 2) >= dirs_b.shape[0]:
            return 0
        return int(dirs_b[aidx >> 2, l] >> (8 * (aidx & 3))) & 0xFF

    return _gotoh_walk(byte_at, finals_b, seq1, seq2, compat, max_alignments)


def _gotoh_walk(
    byte_at,
    finals_b: np.ndarray,
    seq1: bytes,
    seq2: bytes,
    compat: bool,
    max_alignments: int,
) -> Tuple[int, List[Tuple[str, str]]]:
    n1, n2 = len(seq1), len(seq2)
    score = int(finals_b.max())

    def parents(x: int, y: int, plane: int) -> List[int]:
        if x == 0 or y == 0:
            # Boundary chains (closed-form; the kernel's boundary bits for
            # IEXT..DOPEN are not meaningful there).
            if compat:
                if x == 0 and y > 0 and plane == D:
                    return [D]
                if y == 0 and x > 0 and plane == I:
                    return [I]
            else:
                if x == 0 and y > 0 and plane == I:
                    return [I]
                if y == 0 and x > 0 and plane == D:
                    return [D]
            return []
        if plane == M:
            b = byte_at(x - 1, y - 1)  # H-argmax of cell (x-1, y-1)
            out = []
            if b & dirbits.HM:
                out.append(M)
            if b & dirbits.HI:
                out.append(I)
            if b & dirbits.HD:
                out.append(D)
            return out
        if plane == I:
            b = byte_at(x, y)
            out = []
            if b & dirbits.IEXT:
                out.append(I)
            if b & dirbits.IOPEN:
                out.append(M)
            return out
        b = byte_at(x, y)
        out = []
        if b & dirbits.DEXT:
            out.append(D)
        if b & dirbits.DOPEN:
            out.append(M)
        return out

    stack: List[Tuple[bytes, bytes, int, int, int]] = []
    for plane in (I, M, D):  # seed push order (reference :251-280)
        if int(finals_b[plane]) == score:
            stack.append((b"", b"", plane, n2, n1))

    out: List[Tuple[str, str]] = []
    while stack:
        a1, a2, plane, x, y = stack.pop()
        if x == 0 and y == 0:
            out.append((a1.decode("latin-1"), a2.decode("latin-1")))
            if len(out) >= max_alignments:
                break
        for parent in parents(x, y, plane):
            if plane == M:
                if x == 0 or y == 0:
                    raise AlignmentError(
                        "reference would panic: M-cell traceback at boundary"
                    )
                s1c, s2c, nx, ny = seq1[y - 1 : y], seq2[x - 1 : x], x - 1, y - 1
            elif plane == D:
                if x == 0:
                    raise AlignmentError(
                        "reference would panic: boundary-chain traceback"
                    )
                s1c, s2c, nx, ny = b"-", seq2[x - 1 : x], x - 1, y
            else:
                if y == 0:
                    raise AlignmentError(
                        "reference would panic: boundary-chain traceback"
                    )
                s1c, s2c, nx, ny = seq1[y - 1 : y], b"-", x, y - 1
            stack.append((s1c + a1, s2c + a2, parent, nx, ny))
    return score, out


def _walk_from(
    byte_at,
    x: int,
    y: int,
    seq1: bytes,
    seq2: bytes,
    stop,
) -> Tuple[List[str], int, int]:
    """Single-path backward walk from cell (x, y) (plane chosen by the
    cell's H-argmax bits, priority M > I > D; within-plane parent priority
    M > I > D / ext-before-open is fixed and documented).  ``stop(x, y,
    plane)`` ends the walk.  Returns (forward ops, stop_x, stop_y)."""
    b = byte_at(x, y)
    if b & dirbits.HM:
        plane = M
    elif b & dirbits.HI:
        plane = I
    else:
        plane = D
    ops: List[str] = []
    guard = len(seq1) + len(seq2) + 4
    while not stop(x, y, plane):
        guard -= 1
        if guard < 0:
            raise AlignmentError("traceback did not terminate")
        if plane == M:
            ops.append("M")
            nx, ny = x - 1, y - 1
            pb = byte_at(nx, ny)
            if pb & dirbits.HM:
                nplane = M
            elif pb & dirbits.HI:
                nplane = I
            elif pb & dirbits.HD:
                nplane = D
            else:
                raise AlignmentError("broken parent bits in traceback")
        elif plane == I:
            ops.append("I")
            pb = byte_at(x, y)
            nplane = I if pb & dirbits.IEXT else M
            nx, ny = x, y - 1
        else:
            ops.append("D")
            pb = byte_at(x, y)
            nplane = D if pb & dirbits.DEXT else M
            nx, ny = x - 1, y
        x, y, plane = nx, ny, nplane
    ops.reverse()
    return ops, x, y


def semi_global_traceback_pair(
    dirs_b: np.ndarray,
    end_x: int,
    end_y: int,
    seq1: bytes,
    seq2: bytes,
    d_offset: int = 0,
) -> Tuple[str, str]:
    """Semi-global alignment reconstruction (free end gaps both sides):
    walk from the best last-row/last-column cell to a boundary, then add the
    free leading and trailing gap columns.  d_offset: the pair's diagonal
    offset in a streamed dirs layout (slot * plan.s), 0 for per-pair
    layouts."""
    n1, n2 = len(seq1), len(seq2)

    def byte_at(x, y):
        return _byte(dirs_b, x + y + d_offset, x)

    ops, sx, sy = _walk_from(
        byte_at, end_x, end_y, seq1, seq2,
        stop=lambda x, y, p: x == 0 or y == 0,
    )
    lead = ["I"] * sy + ["D"] * sx
    trail = ["I"] * (n1 - end_y) + ["D"] * (n2 - end_x)
    all_ops = lead + ops + trail
    return _apply_ops("".join(all_ops), seq1, seq2)


def local_affine_traceback_pair(
    dirs_b: np.ndarray,
    end_x: int,
    end_y: int,
    seq1: bytes,
    seq2: bytes,
    d_offset: int = 0,
) -> Tuple[str, str, int, int]:
    """Local (SW-affine) reconstruction: walk from the argmax M cell until
    the previous cell's M is a restart (LSTART) or a boundary zero.
    Returns (aligned_seq1, aligned_seq2, start_in_seq1, start_in_seq2),
    starts 0-based.  d_offset: the pair's diagonal offset in a streamed
    dirs layout (slot * plan.s), 0 for per-pair layouts."""

    def byte_at(x, y):
        return _byte(dirs_b, x + y + d_offset, x)

    def stop(x, y, plane):
        return plane == M and bool(byte_at(x, y) & dirbits.LSTART)

    ops, sx, sy = _walk_from(byte_at, end_x, end_y, seq1, seq2, stop=stop)
    # The stop cell (sx, sy) is the zero-restart; emitted columns start at
    # (sx+1, sy+1) -- consume seq1[sy:], seq2[sx:].
    a1, a2 = _apply_ops("".join(ops), seq1[sy:], seq2[sx:])
    return a1, a2, sy, sx


def traceback_batch(
    dirs: np.ndarray,
    finals: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    compat: bool = True,
    max_alignments: int = 64,
    first_only: bool = False,
):
    """Traceback for a whole per-pair (D4, B, P) batch.  Returns a list of
    per-pair results: (score, alignments) or an AlignmentError instance
    (per-pair failure isolation, as the reference CLI's pair loop,
    src/main.rs:68-76).  first_only walks the first co-optimal path with
    the native walker (native.gotoh_first_path_native), the Python walker
    for a pair it fails."""
    from sequencealigning_tpu_torch import native

    dirs = np.asarray(dirs)
    finals = np.asarray(finals)
    use_native = first_only and _use_native()
    results = []
    for b, (s1, s2) in enumerate(zip(seqs1, seqs2)):
        try:
            if use_native:
                ops = native.gotoh_first_path_native(
                    dirs[:, b, :], finals[b], len(s1), len(s2), compat
                )
                if ops is not None:
                    results.append(
                        (int(finals[b].max()), [_apply_ops(ops, s1, s2)])
                    )
                    continue
            results.append(
                traceback_pair(
                    dirs[:, b, :], finals[b], s1, s2, compat=compat,
                    max_alignments=1 if first_only else max_alignments,
                )
            )
        except AlignmentError as e:
            results.append(e)
    return results


def _nibble(dirs_b: np.ndarray, d: int, x: int) -> int:
    return int(dirs_b[d >> 3, x] >> (4 * (d & 7))) & 0xF


def fast4_traceback_pair(
    dirs_b: np.ndarray,
    finals_b: np.ndarray,
    seq1: bytes,
    seq2: bytes,
    compat: bool = True,
    d_offset: int = 0,
) -> Tuple[int, List[Tuple[str, str]]]:
    """First-path traceback from the 4-bit 'fast4' dirs layout (8 cells per
    u32 word; bits [0:2] = H-argmax plane code with M > I > D priority,
    bit 2 = I-extend, bit 3 = D-extend).

    Returns (score, [(aligned_seq1, aligned_seq2)]) -- one optimal
    alignment (documented plane priority, not the reference's co-optimal
    LIFO order; use the full 7-bit mode for that)."""
    n1, n2 = len(seq1), len(seq2)
    score = int(finals_b.max())

    # Seed plane from the corner finals (priority M > I > D).
    if int(finals_b[M]) == score:
        plane = M
    elif int(finals_b[I]) == score:
        plane = I
    else:
        plane = D

    ops: List[str] = []
    x, y = n2, n1
    guard = n1 + n2 + 4
    while x > 0 or y > 0:
        guard -= 1
        if guard < 0:
            raise AlignmentError("traceback did not terminate")
        if x == 0:
            # Row chain: compat keeps it in D, textbook in I -- either way
            # the only move left is consuming seq1.
            ops.append("I")
            y -= 1
            continue
        if y == 0:
            ops.append("D")
            x -= 1
            continue
        b = _nibble(dirs_b, x + y + d_offset, x)
        if plane == M:
            ops.append("M")
            x, y = x - 1, y - 1
            if x == 0 and y == 0:
                break
            # Clamp code 3 (never emitted by the fast4 kernel, but possible
            # when walking a mismatched layout) to D, like the C walker.
            plane = (M, I, D)[min(_nibble(dirs_b, x + y + d_offset, x) & 3, 2)]
        elif plane == I:
            ops.append("I")
            plane = I if b & 4 else M
            y -= 1
        else:
            ops.append("D")
            plane = D if b & 8 else M
            x -= 1
    ops.reverse()
    return score, [_apply_ops("".join(ops), seq1, seq2)]


def _banded_fast4_walk(
    nib, finals_b, n1: int, n2: int, std: bool = False
) -> str:
    """Shared first-path walk over any 4-bit banded dirs layout (`nib`
    resolves cell (x, y) to its code).  Returns the forward op string.

    std=True walks the STANDARD gap-affine model (gaps open from
    H = max(M, I, D), ops.nw_banded_diag model='std'): a gap OPEN
    continues on the predecessor cell's H-argmax plane -- read from that
    cell's own code, like the M move -- instead of jumping to M."""
    score = int(finals_b.max())
    if int(finals_b[M]) == score:
        plane = M
    elif int(finals_b[I]) == score:
        plane = I
    else:
        plane = D

    def resolve(x: int, y: int) -> int:
        return (M, I, D)[min(nib(x, y) & 3, 2)]

    ops: List[str] = []
    x, y = n2, n1
    guard = n1 + n2 + 4
    while x > 0 or y > 0:
        guard -= 1
        if guard < 0:
            raise AlignmentError("banded fast4 traceback did not terminate")
        if x == 0:
            ops.append("I")
            y -= 1
            continue
        if y == 0:
            ops.append("D")
            x -= 1
            continue
        b = nib(x, y)
        if plane == M:
            ops.append("M")
            x, y = x - 1, y - 1
            if x == 0 and y == 0:
                break
            plane = resolve(x, y)
        elif plane == I:
            ops.append("I")
            y -= 1
            plane = I if b & 4 else (resolve(x, y) if std else M)
        else:
            ops.append("D")
            x -= 1
            plane = D if b & 8 else (resolve(x, y) if std else M)
    ops.reverse()
    return "".join(ops)


def banded_fast4_traceback_pair(
    dirs_b: np.ndarray,
    finals_b: np.ndarray,
    seq1: bytes,
    seq2: bytes,
    k_lo: int,
    compat: bool = True,
) -> Tuple[int, List[Tuple[str, str]]]:
    """First-path traceback for ops.nw_banded's fast4 layout: the 4-bit
    code of cell (x, y) lives at word dirs[x//8, (y-x)-k_lo], shift
    4*(x%8).  Same code semantics as fast4_traceback_pair."""
    n1, n2 = len(seq1), len(seq2)

    def nib(x: int, y: int) -> int:
        k = (y - x) - k_lo
        if k < 0 or k >= dirs_b.shape[1]:
            return 0
        return int(dirs_b[x >> 3, k] >> (4 * (x & 7))) & 0xF

    ops = _banded_fast4_walk(nib, finals_b, n1, n2)
    return int(finals_b.max()), [_apply_ops(ops, seq1, seq2)]


def banded_diag_fast4_traceback_pair(
    dirs_b: np.ndarray,
    finals_b: np.ndarray,
    seq1: bytes,
    seq2: bytes,
    k_lo_even: int,
    compat: bool = True,
    std: bool = False,
) -> Tuple[int, List[Tuple[str, str]]]:
    """First-path traceback for ops.nw_banded_diag's wavefront fast4
    layout: cell (x, y) lives at word dirs[(x+y-1)//8, (y-x-k_lo_even)//2],
    shift 4*((x+y-1)%8).  std walks the any-state-open model
    (nw_banded_diag model='std')."""
    n1, n2 = len(seq1), len(seq2)

    def nib(x: int, y: int) -> int:
        l = ((y - x) - k_lo_even) >> 1
        if l < 0 or l >= dirs_b.shape[1]:
            return 0
        aidx = x + y - 1
        if aidx < 0 or (aidx >> 3) >= dirs_b.shape[0]:
            return 0
        return int(dirs_b[aidx >> 3, l] >> (4 * (aidx & 7))) & 0xF

    ops = _banded_fast4_walk(nib, finals_b, n1, n2, std=std)
    return int(finals_b.max()), [_apply_ops(ops, seq1, seq2)]


def _banded_batch_walks(
    dirs, finals, seqs1, seqs2, k_origin, compat, native_name: str, pair_fn,
):
    """Shared scaffolding for the banded batch walkers: the native C walker
    (looked up by name on the native module; none under
    SEQALIGN_NO_NATIVE), the Python pair walker for a pair it fails;
    per-pair AlignmentError isolation."""
    from sequencealigning_tpu_torch import native

    native_fn = getattr(native, native_name) if _use_native() else None
    out = []
    dirs = np.ascontiguousarray(dirs, np.uint32)
    for b, (s1, s2) in enumerate(zip(seqs1, seqs2)):
        try:
            score = int(finals[b].max())
            ops = None
            if native_fn is not None:
                ops = native_fn(dirs, b, k_origin, len(s1), len(s2),
                                finals[b])
            if ops is not None:
                out.append((score, [_apply_ops(ops, s1, s2)]))
            else:
                out.append(
                    pair_fn(
                        dirs[:, b, :], finals[b], s1, s2, k_origin,
                        compat=compat,
                    )
                )
        except AlignmentError as e:
            out.append(e)
    return out


def banded_fast4_traceback_batch(
    dirs: np.ndarray,
    finals: np.ndarray,
    seqs1,
    seqs2,
    k_lo: int,
    compat: bool = True,
):
    """Batch first-path walks over an (X8, B, K) banded fast4 dirs tensor
    (row layout): the native walker (native.banded_fast4_first_path_native),
    the Python one for a pair it fails.  Returns (score, [(a1, a2)]) or
    AlignmentError per pair."""
    return _banded_batch_walks(
        dirs, finals, seqs1, seqs2, k_lo, compat,
        "banded_fast4_first_path_native", banded_fast4_traceback_pair,
    )


def banded_diag_fast4_traceback_batch(
    dirs: np.ndarray,
    finals: np.ndarray,
    seqs1,
    seqs2,
    k_lo_even: int,
    compat: bool = True,
):
    """Batch first-path walks over an (Aw, B, L) wavefront-packed fast4
    dirs tensor (ops.nw_banded_diag's layout): the native walker
    (native.banded_diag_fast4_first_path_native), the Python one for a
    pair it fails.  Returns (score, [(a1, a2)]) or AlignmentError per
    pair."""
    return _banded_batch_walks(
        dirs, finals, seqs1, seqs2, k_lo_even, compat,
        "banded_diag_fast4_first_path_native",
        banded_diag_fast4_traceback_pair,
    )


def _linear_bits(dirs_b: np.ndarray, x: int, y: int) -> int:
    return _byte(dirs_b, x + y, x)


def _linear_ismax_starts(dirs_b: np.ndarray, n1: int, n2: int):
    """The cells (x, y) whose ISMAX bit is set, in the reference argmax's
    row-major (seq1-major) order: y ascending, then x (vectorised; the same
    cells in the same order as a scan of _linear_bits)."""
    from sequencealigning_tpu_torch.ops.nw_linear import LISMAX

    y, x = np.meshgrid(np.arange(n1 + 1), np.arange(n2 + 1), indexing="ij")
    d = x + y
    words = dirs_b[d >> 2, x].astype(np.uint64)
    bits = (words >> (8 * (d & 3)).astype(np.uint64)) & LISMAX
    ys, xs = np.nonzero(bits)
    return [(int(a), int(b)) for b, a in zip(ys, xs)]


def linear_traceback_pair(
    dirs_b: np.ndarray,
    seq1: bytes,
    seq2: bytes,
    local: bool = False,
    max_hits: int = 64,
) -> List[Tuple[str, str, int, int]]:
    """Linear-NW traceback from ops.nw_linear path bits.

    Replicates the reference's DFS (needleman_wunsch.rs:205-254): explores
    path bits in DOWN, RIGHT, DIAG order, emits a hit at (0,0) or at an
    empty-path cell, and reproduces the start-coordinate quirk (the printed
    start is set by the frame *above* the terminating cell).  Local mode
    seeds from every ISMAX cell in the reference argmax's row-major
    (seq1-major) encounter order (:256-272).

    Returns [(aligned_seq1, aligned_seq2, start_in_seq1, start_in_seq2)].
    """
    from sequencealigning_tpu_torch.ops.nw_linear import LDIAG, LDOWN, LRIGHT

    n1, n2 = len(seq1), len(seq2)
    if local:
        starts = _linear_ismax_starts(dirs_b, n1, n2)
    else:
        starts = [(n2, n1)]

    hits: List[Tuple[str, str, int, int]] = []
    s1 = seq1.decode("latin-1")
    s2 = seq2.decode("latin-1")

    branch_order = (LDOWN, LRIGHT, LDIAG)
    for start in starts:
        if len(hits) >= max_hits:
            break
        q: List[str] = []
        db: List[str] = []
        state = {"siq": 0, "sid": 0}
        # Explicit-stack DFS (no recursion: a 100 kb pair would otherwise
        # walk n1+n2 frames deep).  Frame = [cell, branch cursor, bits];
        # chars pushed when descending into a child are popped when that
        # child's frame is removed -- identical order to the reference's
        # recursion (needleman_wunsch.rs:205-254).
        frames: List[list] = [[start, 0, None]]
        while frames:
            frame = frames[-1]
            (x, y) = frame[0]
            if frame[1] == 0:
                # Frame entry (the reference's function prologue).
                if len(hits) >= max_hits:
                    frames.pop()
                    if frames:
                        q.pop()
                        db.pop()
                    continue
                bits = _linear_bits(dirs_b, x, y) & (LDOWN | LRIGHT | LDIAG)
                frame[2] = bits
                if (x, y) == (0, 0) or not bits:
                    hits.append(
                        ("".join(reversed(q)), "".join(reversed(db)),
                         state["siq"], state["sid"])
                    )
                    frames.pop()
                    if frames:
                        q.pop()
                        db.pop()
                    continue
            descended = False
            while frame[1] < 3:
                bit = branch_order[frame[1]]
                frame[1] += 1
                if not frame[2] & bit:
                    continue
                state["siq"] = max(y, 1) - 1
                state["sid"] = max(x, 1) - 1
                if bit == LDOWN:
                    q.append(s1[y - 1])
                    db.append("-")
                    nxt = (x, y - 1)
                elif bit == LRIGHT:
                    q.append("-")
                    db.append(s2[x - 1])
                    nxt = (x - 1, y)
                else:
                    q.append(s1[y - 1])
                    db.append(s2[x - 1])
                    nxt = (x - 1, y - 1)
                frames.append([nxt, 0, None])
                descended = True
                break
            if not descended:
                frames.pop()
                if frames:
                    q.pop()
                    db.pop()
    return hits


def traceback_stream_batch(
    dirs: np.ndarray,
    finals: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    plan,
    compat: bool = True,
    max_alignments: int = 64,
    first_only: bool = False,
    dirs_mode: str = "full",
):
    """Traceback for streamed fills: pairs share dirs rows (pair b = slot
    b % np_slots of row b // np_slots, diagonal offset slot*s).  Per-pair
    failure isolation as the reference CLI's pair loop (src/main.rs:68-76):
    (score, alignments) or an AlignmentError per pair.  dirs_mode "full"
    is the co-optimal enumeration of the 7-bit codes (first_only: the first
    path, by the native walker where it succeeds); "fast4" walks the 4-bit
    first-path layout with the threaded native walker.  As
    sequencealigning_tpu/ops/traceback.py::traceback_stream_batch."""
    from sequencealigning_tpu_torch import native

    dirs = np.asarray(dirs)
    finals = np.asarray(finals)
    coords = [plan.pair_coords(b) for b in range(len(seqs1))]
    if dirs_mode == "fast4" and _use_native():
        ops_list = native.fast4_first_path_batch_native(
            dirs, finals, np.asarray([c[0] for c in coords]),
            np.asarray([c[2] for c in coords]),
            np.asarray([len(s) for s in seqs1]),
            np.asarray([len(s) for s in seqs2]),
        )
        return [
            AlignmentError("traceback did not terminate") if ops is None
            else (int(finals[b].max()), [_apply_ops(ops, seqs1[b], seqs2[b])])
            for b, ops in enumerate(ops_list)
        ]
    if dirs_mode not in ("fast4", "full"):
        raise ValueError(f"unknown dirs mode {dirs_mode!r}")
    use_native = first_only and _use_native()
    rows = {}
    results = []
    for b, (s1, s2) in enumerate(zip(seqs1, seqs2)):
        row, _slot, off = coords[b]
        try:
            if dirs_mode == "fast4":
                results.append(fast4_traceback_pair(
                    dirs[:, row, :], finals[b], s1, s2, compat=compat,
                    d_offset=off))
                continue
            if use_native:
                if row not in rows:
                    rows[row] = np.ascontiguousarray(dirs[:, row, :])
                ops = native.gotoh_first_path_native(
                    rows[row], finals[b], len(s1), len(s2), compat,
                    d_offset=off,
                )
                if ops is not None:
                    results.append(
                        (int(finals[b].max()), [_apply_ops(ops, s1, s2)])
                    )
                    continue
            results.append(
                traceback_pair(
                    dirs[:, row, :], finals[b], s1, s2, compat=compat,
                    max_alignments=1 if first_only else max_alignments,
                    d_offset=off,
                )
            )
        except AlignmentError as e:
            results.append(e)
    return results


def _apply_ops(ops: str, seq1: bytes, seq2: bytes) -> Tuple[str, str]:
    """Expand a forward op string ('M'/'I'/'D' per column) into the gapped
    alignment pair."""
    a1 = []
    a2 = []
    y = x = 0
    for op in ops:
        if op == "M":
            a1.append(chr(seq1[y]))
            a2.append(chr(seq2[x]))
            y += 1
            x += 1
        elif op == "I":
            a1.append(chr(seq1[y]))
            a2.append("-")
            y += 1
        else:
            a1.append("-")
            a2.append(chr(seq2[x]))
            x += 1
    return "".join(a1), "".join(a2)

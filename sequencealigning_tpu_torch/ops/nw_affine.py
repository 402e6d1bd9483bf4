"""The per-diagonal Gotoh step with its boundary-mode hook: the port of
ops/nw_affine.py's ``_boundary_scalars`` and ``_gotoh_step``.

A per-pair anti-diagonal fill keeps each pair's db on the lane axis: lane x
of diagonal d is cell (x, y = d - x), lane 0 and lane d are the boundaries.
The ``mode`` hook is the only recurrence difference between the affine
modes: "global" writes the compat/textbook gap chains on the boundaries,
"semi" free end gaps (M = 0, I = D = -inf), and "local" adds the
Smith-Waterman clamp M = max(M, 0) with each restart recorded as the LSTART
direction bit.
"""

from __future__ import annotations

import torch

from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
from sequencealigning_tpu_torch.ops import dirbits

MODES = ("global", "semi", "local")


def _boundary_scalars(p: int, scheme: ScoringScheme, compat: bool):
    """Boundary cells at anti-diagonal p as ((M, I, D) of row-0 cell
    (x=0, y=p), (M, I, D) of column-0 cell (x=p, y=0)): compat keeps the
    chain o+(p+1)e in D on row 0 and in I on column 0, textbook keeps
    o+p*e in the other plane; p == 0 is the origin (M=0, I=D=-inf).  As
    ops/nw_affine.py::_boundary_scalars."""
    o, e = scheme.gap_open, scheme.gap_extend
    neg = NEG_INF
    m_b = 0 if p == 0 else neg
    chain = neg if p == 0 else (o + (p + 1) * e if compat else o + p * e)
    if compat:
        return (m_b, neg, chain), (m_b, chain, neg)
    return (m_b, chain, neg), (m_b, neg, chain)


def _bit(mask: torch.Tensor, value: int) -> torch.Tensor:
    return mask.to(torch.int32) * value


def _roll(a: torch.Tensor) -> torch.Tensor:
    """The lane shift x-1 -> x on a torus (lane 0 receives lane P-1), as
    jnp.roll(a, 1, axis=1)."""
    return torch.roll(a, 1, dims=1)


def _to_u32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same bits as a uint32 tensor."""
    wrapped = words - ((words >> 31) & 1) * (1 << 32)
    return wrapped.to(torch.int32).view(torch.uint32)


class DirsPacker:
    """Packs one (R, P) direction code a step into u32 words of ``per``
    codes (8 fast4 nibbles or 4 full bytes), little-endian in the step:
    the code of step t lands in ``dirs[t // per]``.  A last, partial word
    is written by flush() with zeros above its codes."""

    def __init__(self, dirs: torch.Tensor, per: int):
        self.dirs = dirs
        self.per = per
        self.bits = 32 // per
        self.acc = None
        self.last = -1

    @classmethod
    def for_stream(cls, dirs_mode, plan, device) -> "DirsPacker | None":
        """The packer of a streamed fill's (t_total / per, R, P) tensor, or
        None when no dirs are asked for."""
        if not dirs_mode:
            return None
        per = 8 if dirs_mode == "fast4" else 4
        dirs = torch.empty((plan.t_total // per, plan.n_rows, plan.p),
                           dtype=torch.uint32, device=device)
        return cls(dirs, per)

    def add(self, t: int, code: torch.Tensor) -> None:
        u = t % self.per
        word = code.to(torch.int64) << (self.bits * u)
        self.acc = word if u == 0 else self.acc | word
        self.last = t
        if u == self.per - 1:
            self.dirs[t // self.per] = _to_u32(self.acc)

    def flush(self) -> torch.Tensor:
        if self.last >= 0 and self.last % self.per != self.per - 1:
            self.dirs[self.last // self.per] = _to_u32(self.acc)
        return self.dirs


def apply_boundaries(M, I, D, restart, lanes, p: int, scheme: ScoringScheme,
                     compat: bool, mode: str):
    """Write the boundary cells of local diagonal p into M/I/D (in place):
    ``lanes`` are the boundary lanes (lane p first, then lane 0, so the
    origin wins at p == 0).  Global mode writes the gap chains; semi and
    local write M = 0, I = D = -inf, and local marks them restarts."""
    P = M.shape[1]
    row0, col0 = _boundary_scalars(p, scheme, compat)
    for lane in lanes:
        if lane >= P:
            continue
        if mode == "global":
            vals = row0 if lane == 0 else col0
        else:
            vals = (0, NEG_INF, NEG_INF)
            if restart is not None:
                restart[:, lane] = 1
        M[:, lane], I[:, lane], D[:, lane] = vals


def gotoh_step_torch(
    H2, H1, M1, I1, D1, s1d, seq1_col, s2v, d: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, with_dirs: bool,
    mode: str = "global",
):
    """Diagonal d from diagonals d-1 (M1/I1/D1, H1) and d-2 (H2): the twin
    of ops/nw_affine.py::_gotoh_step.  All state (B, P) int32, seq1_col
    (B,) the query code entering at lane 0.  Returns (M, I, D, H, s1d_new,
    byte) with byte None when with_dirs is False."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    o, e = scheme.gap_open, scheme.gap_extend
    s1d_new = _roll(s1d)
    s1d_new[:, 0] = seq1_col
    eq = (s1d_new & s2v) != 0 if wildcard else s1d_new == s2v
    sub = scheme.mismatch + _bit(eq, scheme.match_ - scheme.mismatch)
    M = _roll(H2) + sub
    restart = None
    if mode == "local":
        restart = (M < 0).to(torch.int32)
        M = torch.clamp(M, min=0)
    dd = _roll(M1) + o
    D1r = _roll(D1)
    D = torch.maximum(dd, D1r) + e
    ii = M1 + o
    I = torch.maximum(ii, I1) + e
    apply_boundaries(M, I, D, restart, (d, 0), d, scheme, compat, mode)
    H = torch.maximum(M, torch.maximum(I, D))

    byte = None
    if with_dirs:
        b = _bit(M == H, dirbits.HM) | _bit(I == H, dirbits.HI)
        b |= _bit(D == H, dirbits.HD)
        b |= _bit(I1 >= ii, dirbits.IEXT) | _bit(ii >= I1, dirbits.IOPEN)
        b |= _bit(D1r >= dd, dirbits.DEXT) | _bit(dd >= D1r, dirbits.DOPEN)
        if restart is not None:
            b |= restart * dirbits.LSTART
        byte = b
    return M, I, D, H, s1d_new, byte

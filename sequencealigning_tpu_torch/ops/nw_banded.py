"""Banded affine-gap NW fill swept a row at a time in band coordinates: the
port of ops/nw_banded.py (the banded family's independent cross-check
engine).

Work in (x, k) with k = y - x in a fixed static range [k_lo, k_hi] that
holds every pair's global diagonal +/- the band.  Sweeping rows
x = 0 .. L2 (the padded db width):

  * M(x,k) <- H(x-1, k)          -- same lane, previous row
  * D(x,k) <- M/D(x-1, k+1)      -- lane k+1, previous row
  * I(x,k) <- M/I(x, k-1)        -- same row: I[k] = max(c[k], I[k-1]+e)
    linearises to I[k] = k*e + prefixmax_{j<=k}(c[j] - j*e)

Cells with y = x + k outside [0, n1] (or x past n2) are masked to NEGBIG.
The query rides a lane window (s1w) that shifts one lane a row, qin[:, x]
entering at lane K-1; dcs[:, x] = seq2[x-1] is row x's db code.  Direction
codes of row x: "fast4" packs 8 rows of 4-bit first-path codes a word
(dirs[x // 8, b, k - k_lo], shift 4 * (x % 8)), "full" 4 rows of the 7-bit
co-optimal bytes (ops.dirbits), in ceil((L2 + 1) / upack) words (the lax
twin's length).

Two implementations of the fill, chosen by the tensors' device:

* ``banded_row_fill_torch`` -- plain PyTorch, the twin of _row0_values,
  _banded_row_step and _banded_fill_lax (torch.roll and torch.cummax; CPU
  tensors, and the reference the kernel is checked against);
* ``banded_row_fill_cuda`` -- the hand-written kernel (CUDA tensors only):
  bands of up to 512 lanes on its warp route (``csrc/nw_banded_warp.cu``:
  a warp a pair, the band in registers, no barrier), wider ones on its
  block route (``csrc/nw_banded.cu``: a block a pair, the row swept in
  chunks of up to 2048 lanes with the scan's maximum carried between
  them), so no band width is refused.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
from sequencealigning_tpu_torch.io.encode import round_up as _round_up
from sequencealigning_tpu_torch.ops import dirbits
from sequencealigning_tpu_torch.ops.nw_affine import _bit
from sequencealigning_tpu_torch.ops.nw_banded_diag import _norm_dirs, _upack
from sequencealigning_tpu_torch.ops.step_graph import CounterPacker, run_steps

NEGBIG = -(2 ** 24)  # band-mask -inf, must stay << any score
_DIRS_CODES = {False: 0, "fast4": 1, "full": 2}


class BandedResult(NamedTuple):
    finals: np.ndarray               # (B, 3) M/I/D at (n2, n1)
    dirs: Optional[torch.Tensor]     # (Xw, B, K) uint32 on the fill's device
    k_lo: int


def band_range(query_len, db_len, band: int):
    """(k_lo, K): the batch's static lane range, as nw_banded_batch at
    :578-582 -- k_lo = min(0, min(n1 - n2)) - band, K lanes rounded up to
    128 past k_hi = max(0, max(n1 - n2)) + band."""
    diff = (np.asarray(query_len).astype(np.int64)
            - np.asarray(db_len).astype(np.int64))
    k_lo = int(min(0, diff.min()) - band)
    k_hi = int(max(0, diff.max()) + band)
    return k_lo, _round_up(k_hi - k_lo + 1, 128)


def row_streams(seq1, seq2, k_lo: int, K: int):
    """The row-sweep inputs of (B, L1) / (B, L2) code batches, as
    _device_row_streams with xp = L2 + 1: (s1w0 (B, K) the row-0 query
    window, qin (B, L2 + 1) the query code entering lane K-1 at row x, dcs
    (B, L2 + 1) the db code of row x, -1 at row 0), int32 with -1
    padding."""
    assert k_lo <= 0, k_lo
    q = seq1.to(torch.int32)
    d = seq2.to(torch.int32)
    L1, L2 = q.shape[1], d.shape[1]
    xp = L2 + 1
    pad_l = 1 - k_lo
    pad_r = max(0, (K - 1 + xp) - (pad_l + L1), K - pad_l - L1)
    s1p = F.pad(q, (pad_l, pad_r), value=-1)
    s1w0 = s1p[:, :K]
    qin = s1p[:, K - 1: K - 1 + xp]
    dcs = F.pad(d, (1, 0), value=-1)
    return s1w0.contiguous(), qin.contiguous(), dcs.contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch fill
# ---------------------------------------------------------------------------


def row0_values(kv, n1v, scheme: ScoringScheme, compat: bool, dirs_mode):
    """Boundary row x = 0 (cell (0, y = k)), band-masked: (M0, I0, D0, H0,
    b0) with b0 the row-0 code (H-argmax bits; fast4: the plane), as
    _row0_values."""
    o, e = scheme.gap_open, scheme.gap_extend
    y = kv
    on = (y >= 0) & (y <= n1v)
    origin = y == 0
    m0 = torch.where(origin, 0, NEG_INF)
    if compat:
        i0 = torch.full_like(kv, NEG_INF)
        d0 = torch.where(origin, NEG_INF, o + (y + 1) * e)
    else:
        i0 = torch.where(origin, NEG_INF, o + y * e)
        d0 = torch.full_like(kv, NEG_INF)
    M0, I0, D0 = (torch.where(on, t, NEGBIG).to(torch.int32)
                  for t in (m0, i0, d0))
    H0 = torch.maximum(M0, torch.maximum(I0, D0))
    b0 = None
    if dirs_mode == "fast4":
        b0 = torch.where(M0 == H0, 0, torch.where(I0 == H0, 1, 2)).to(
            torch.int32)
    elif dirs_mode:
        b0 = _bit(M0 == H0, dirbits.HM) | _bit(I0 == H0, dirbits.HI)
        b0 |= _bit(D0 == H0, dirbits.HD)
    return M0, I0, D0, H0, b0


def banded_row_step_torch(
    Mp, Dp, Hp, s1w, qin_c, dc_c, x: torch.Tensor, kv, lane, n1v, n2v,
    scheme: ScoringScheme, compat: bool, wildcard: bool, dirs_mode,
):
    """Row x >= 1 (a 0-d tensor: the plain loop's row counter,
    ops.step_graph) from row x-1, the twin of _banded_row_step: state
    (B, K) int32, qin_c / dc_c (B, 1) the query code entering lane K-1 and
    seq2[x-1].  Returns (M, I, D, H, s1w, code) with code None for no
    dirs."""
    K = kv.shape[1]
    o, e = scheme.gap_open, scheme.gap_extend
    le = lane * e
    lane_last = lane == K - 1
    lane_0 = lane == 0

    s1w_new = torch.where(lane_last, qin_c, torch.roll(s1w, -1, 1))
    y = x + kv
    valid = (y >= 1) & (y <= n1v) & (x <= n2v)
    eq = (s1w_new & dc_c) != 0 if wildcard else s1w_new == dc_c
    M = Hp + torch.where(eq, scheme.match_, scheme.mismatch)
    Mp_r = torch.where(lane_last, NEGBIG, torch.roll(Mp, -1, 1))
    Dp_r = torch.where(lane_last, NEGBIG, torch.roll(Dp, -1, 1))
    dd = Mp_r + o
    D = torch.maximum(dd, Dp_r) + e
    Mv = torch.where(valid, M, NEGBIG)
    Dv = torch.where(valid, D, NEGBIG)

    # Column 0 (y == 0): the compat chain in I, the textbook one in D
    # (rows x >= 1; row 0 is row0_values).
    if compat:
        i_c, d_c = o + (x + 1) * e, NEG_INF
    else:
        i_c, d_c = NEG_INF, o + x * e
    m_c = NEG_INF

    is_col0 = y == 0
    M = torch.where(is_col0, m_c, Mv).to(torch.int32)
    D = torch.where(is_col0, d_c, Dv).to(torch.int32)
    M_l = torch.where(lane_0, NEGBIG, torch.roll(M, 1, 1))
    # The lane right of column 0 is seeded with the chain plus e.
    right_of_col0 = ~lane_0 & (y == 1)
    v = torch.where(right_of_col0, i_c + e - le, M_l + (o + e - le))
    I = torch.cummax(v.to(torch.int32), 1).values + le
    I = torch.where(is_col0, i_c, torch.where(valid, I, NEGBIG)).to(
        torch.int32)
    H = torch.maximum(M, torch.maximum(I, D))

    code = None
    if dirs_mode:
        I_l = torch.where(lane_0, NEGBIG, torch.roll(I, 1, 1))
        if dirs_mode == "full":
            code = _bit(M == H, dirbits.HM) | _bit(I == H, dirbits.HI)
            code |= _bit(D == H, dirbits.HD)
            code |= _bit(I == I_l + e, dirbits.IEXT)
            code |= _bit(I == M_l + o + e, dirbits.IOPEN)
            code |= _bit(D == Dp_r + e, dirbits.DEXT)
            code |= _bit(D == dd + e, dirbits.DOPEN)
        else:
            code = torch.where(M == H, 0, torch.where(I == H, 1, 2)).to(
                torch.int32)
            code |= _bit(I == I_l + e, 4) | _bit(D == Dp_r + e, 8)
    return M, I, D, H, s1w_new, code


def _check_fill_args(s1w0, qin, dcs, n1v, n2v, k_lo: int):
    B, K = s1w0.shape
    xp = qin.shape[1]
    for name, t, shape in (
        ("s1w0", s1w0, (B, K)), ("qin", qin, (B, xp)), ("dcs", dcs, (B, xp)),
        ("n1v", n1v, (B,)), ("n2v", n2v, (B,)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != s1w0.device:
            raise ValueError(f"{name} is on {t.device}, not {s1w0.device}")
    if K % 128 or K < 128 or k_lo > 0 or xp < 1:
        raise ValueError(f"bad band layout: K {K}, k_lo {k_lo}, rows {xp}")


def banded_row_fill_torch(
    s1w0, qin, dcs, n1v, n2v, k_lo: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, dirs_mode,
):
    """Plain PyTorch twin of _banded_fill_lax: a loop over the rows x = 1 ..
    l2 (l2 + 1 = qin.shape[1]).  s1w0: (B, K) int32 row-0 query window;
    qin/dcs: (B, l2 + 1) int32 (row_streams); n1v/n2v: (B,) int32 lengths.
    Returns (finals (B, 3) int32, dirs (ceil((l2+1)/upack), B, K) uint32 or
    None).  The row is a device counter and the state updates in place, so
    on the card the loop replays as CUDA graphs (ops.step_graph)."""
    dirs_mode = _norm_dirs(dirs_mode)
    _check_fill_args(s1w0, qin, dcs, n1v, n2v, k_lo)
    B, K = s1w0.shape
    l2 = qin.shape[1] - 1
    dev = s1w0.device
    lane = torch.arange(K, dtype=torch.int32, device=dev)[None, :].expand(
        B, K)
    kv = k_lo + lane
    n1, n2 = n1v[:, None], n2v[:, None]
    M, I, D, H, b0 = row0_values(kv, n1, scheme, compat, dirs_mode)
    cap0 = (n2 == 0) & (kv == n1)
    finals = torch.stack([torch.where(cap0, t, 0).sum(1) for t in (M, I, D)],
                         dim=1)
    x = torch.zeros((), dtype=torch.int64, device=dev)
    pack = None
    if dirs_mode:
        per = _upack(dirs_mode)
        pack = CounterPacker(torch.empty((-(-(l2 + 1) // per), B, K),
                                         dtype=torch.uint32, device=dev), per)
        pack.add(x, b0)
    state = [M, D, H, s1w0.clone()]

    def row():
        at = x.view(1)
        M, I, D, H, s1w, code = banded_row_step_torch(
            *state, qin.index_select(1, at), dcs.index_select(1, at), x, kv,
            lane, n1, n2, scheme, compat, wildcard, dirs_mode)
        cap = (x == n2) & (kv == n1 - n2)
        finals.add_(torch.stack(
            [torch.where(cap, t, 0).sum(1) for t in (M, I, D)], dim=1))
        if pack is not None:
            pack.add(x, code)
        for dst, src in zip(state, (M, D, H, s1w)):
            dst.copy_(src)

    x.fill_(1)
    run_steps(row, x, l2)
    return finals.to(torch.int32), pack.dirs if pack is not None else None


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def banded_row_fill_cuda(
    s1w0, qin, dcs, n1v, n2v, k_lo: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, dirs_mode,
    chunk_lanes: int = 0,
):
    """Kernel #8 on CUDA tensors: same arguments and results as
    banded_row_fill_torch.  chunk_lanes 0 lets the rule pick the route:
    the warp route (csrc/nw_banded_warp.cu) for bands of up to 512 lanes,
    else the block route (csrc/nw_banded.cu); chunk_lanes > 0 forces the
    block route with that chunk width (a multiple of 128 up to 2048, for
    testing the route and its scan's carry at small widths).  A block-route
    band whose state passes the shared memory gets a device scratch buffer
    of 36 bytes a lane.  The route taken is left in last_launch.  Raises
    ValueError on a CPU tensor, a non-contiguous input or a chunk width
    out of range, RuntimeError on a failed launch."""
    dirs_mode = _norm_dirs(dirs_mode)
    _check_fill_args(s1w0, qin, dcs, n1v, n2v, k_lo)
    if not s1w0.is_cuda:
        raise ValueError("banded_row_fill_cuda needs CUDA tensors")
    ins = (s1w0, qin, dcs, n1v, n2v)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("banded row fill inputs must be contiguous")
    lib = csrc.kernels()
    B, K = s1w0.shape
    xp = qin.shape[1]
    if lib.sa_banded_row_threads(K, chunk_lanes) == 0:
        raise ValueError(f"band of {K} lanes (chunk width {chunk_lanes}) is "
                         "out of the CUDA row sweep's range")
    dev = s1w0.device
    finals = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    dirs = None
    if dirs_mode:
        dirs = torch.empty((-(-xp // _upack(dirs_mode)), B, K),
                           dtype=torch.uint32, device=dev)
    words = lib.sa_banded_row_scratch_words(K)
    scratch = (torch.empty((B * words,), dtype=torch.int32, device=dev)
               if words else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sa_banded_row_fill(
            *(t.data_ptr() for t in ins), finals.data_ptr(),
            dirs.data_ptr() if dirs is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            B, K, xp, xp - 1, k_lo, scheme.match_, scheme.mismatch,
            scheme.gap_open, scheme.gap_extend, _DIRS_CODES[dirs_mode],
            int(compat), int(wildcard), chunk_lanes, stream,
        )
    if rc != 0:
        raise csrc.launch_error("sa_banded_row_fill", rc)
    banded_row_fill_cuda.launches += 1
    lpt = lib.sa_banded_row_warp_lanes(K, chunk_lanes)
    banded_row_fill_cuda.last_launch = (
        dict(route="warp", lanes_per_thread=lpt, threads=32) if lpt else
        dict(route="block", lanes_per_thread=4,
             threads=lib.sa_banded_row_threads(K, chunk_lanes),
             scratch=bool(words)))
    return finals, dirs


banded_row_fill_cuda.launches = 0
banded_row_fill_cuda.last_launch = {}


def banded_row_fill(s1w0, qin, dcs, n1v, n2v, k_lo, scheme, compat,
                    wildcard, dirs_mode):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (s1w0, qin, dcs, n1v, n2v, k_lo, scheme, compat, wildcard,
            dirs_mode)
    if s1w0.is_cuda:
        return banded_row_fill_cuda(*args)
    if s1w0.device.type != "cpu":
        raise ValueError(f"unsupported device {s1w0.device}")
    return banded_row_fill_torch(*args)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def row_inputs(query, db, query_len, db_len, band: int):
    """The band's range and the row sweep's inputs of a padded batch held
    as tensors (device.to_device), on the batch's device: (k_lo, (s1w0,
    qin, dcs, n1v, n2v))."""
    k_lo, K = band_range(query_len.cpu().numpy(), db_len.cpu().numpy(), band)
    s1w0, qin, dcs = row_streams(query, db, k_lo, K)
    n1v = query_len.to(torch.int32).contiguous()
    n2v = db_len.to(torch.int32).contiguous()
    return k_lo, (s1w0, qin, dcs, n1v, n2v)


def nw_banded_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    band: int = 128,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    with_dirs=True,
) -> BandedResult:
    """Banded Gotoh row sweep of a padded batch held as tensors
    (device.to_device).  band = half-width around each pair's global
    diagonal corridor; the lane range covers [min(0, n1-n2) - band,
    max(0, n1-n2) + band] over the batch.  with_dirs: True/"full" (7 tie
    bits a cell, ops.traceback.banded_traceback_pair), "fast4"
    (banded_fast4_traceback_pair / _batch) or False.  The finals come to
    the host; the dirs stay on the batch's device."""
    dirs_mode = _norm_dirs(with_dirs)
    k_lo, ins = row_inputs(query, db, query_len, db_len, band)
    finals, dirs = banded_row_fill(*ins, k_lo, scheme, compat, wildcard,
                                   dirs_mode)
    return BandedResult(finals=finals.cpu().numpy(), dirs=dirs, k_lo=k_lo)

"""Banded affine-gap NW fill over anti-diagonal wavefronts: the port of
ops/nw_banded_diag.py.

Sweeping anti-diagonals a = x + y makes every Gotoh dependency local:

    M(x,y) <- H(x-1,y-1) + sub      -- wavefront a-2, same diagonal k
    I(x,y) <- M/I(x,y-1) + gap      -- wavefront a-1, diagonal k-1
    D(x,y) <- M/D(x-1,y) + gap      -- wavefront a-1, diagonal k+1

Lane l holds diagonal k = k_lo_even + 2l + parity(a), so every lane is a
live cell on every step and the k+-1 neighbours sit at lane offsets {0, 1}
that alternate with the parity: on odd wavefronts D (and the query window
s1w) read lane l+1, on even ones I (and the db window s2w) read lane l-1;
the edge lanes take NEGBIG or the entering character.  With he =
k_lo_even / 2 <= 0:

    q  = (a - par) / 2 - he,   x(l) = q - l,   y(l) = a - x(l)

``model="std"`` opens gaps from H = max(M, I, D) instead of M (the standard
gap-affine model WFA computes); it takes textbook boundaries and fast4 or no
dirs only.  Direction codes are keyed by aidx = a - 1: "fast4" packs 8
wavefronts of 4-bit first-path codes a word (dirs[aidx // 8, b, l], shift
4 * (aidx % 8)), "full" 4 wavefronts of the 7-bit co-optimal bytes
(ops.dirbits) a word.  The layout is the lax twin's: n_iters = n_need
iterations of two wavefronts, ceil(2 * n_need / upack) words.

Two implementations of the fill, chosen by the tensors' device:

* ``banded_diag_fill_torch`` -- plain PyTorch, the twin of
  _banded_diag_lax (CPU tensors, and the reference the kernel is checked
  against);
* ``banded_diag_fill_cuda`` -- the hand-written kernel
  (``csrc/nw_banded_diag.cu``; CUDA tensors only), one tiled route for
  every band width and batch: each pair's band in strips of lanes x blocks
  of iterations, every tile computing its strip plus a halo as wide as its
  block, from the lanes' state at the block's start, the tiles handed out
  over the whole card by a global ticket (``band_tiles``).
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
from sequencealigning_tpu_torch.ops.nw_affine_tiled import _SM_WORDS, _popcounts
from sequencealigning_tpu_torch.ops.step_graph import CounterPacker, run_steps

NEGBIG = -(2 ** 24)  # band-mask -inf
_DIRS_CODES = {False: 0, "fast4": 1, "full": 2}


def _norm_dirs(want_dirs):
    """A dirs mode as False | "fast4" | "full" (True means "full")."""
    if want_dirs is True:
        return "full"
    if want_dirs in (False, None):
        return False
    if want_dirs in ("fast4", "full"):
        return want_dirs
    raise ValueError(f"unknown dirs mode {want_dirs!r}")


def _upack(want_dirs) -> int:
    """Wavefronts per packed uint32 dirs word: fast4 8, full 4."""
    return 8 if want_dirs == "fast4" else 4


class BandedDiagResult(NamedTuple):
    finals: np.ndarray               # (B, 3) M/I/D at (n2, n1)
    dirs: Optional[torch.Tensor]     # (Aw, B, L) uint32 on the fill's device
    k_lo_even: int
    k_lo: int


class BandPlan(NamedTuple):
    """The band of a batch (nw_banded_diag_batch's plan): diagonals
    k = y - x in [k_lo, k_hi], lanes from k_lo_even (k_lo rounded down to
    even), L lanes; k_hi_eff clips the band to the row kernel's padded
    range; n_need iterations of two wavefronts cover a = 1 .. L1 + L2."""

    k_lo: int
    k_hi: int
    k_lo_even: int
    L: int
    k_hi_eff: int
    n_need: int

    @property
    def he(self) -> int:
        return self.k_lo_even // 2

    def lane_limit(self, par: int) -> int:
        """Last lane inside the effective band at wavefront parity par."""
        return (self.k_hi_eff - self.k_lo_even - par) // 2


def plan_band(query_len, db_len, band: int, l1: int, l2: int) -> BandPlan:
    """The band plan of a padded batch with widths l1 / l2 (as
    ops/nw_banded_diag.py::nw_banded_diag_batch, lax layout)."""
    qlen = np.asarray(query_len).astype(np.int64)
    dlen = np.asarray(db_len).astype(np.int64)
    diff = qlen - dlen
    k_lo = int(min(0, diff.min()) - band)
    k_hi = int(max(0, diff.max()) + band)
    k_lo_even = k_lo - (k_lo & 1)
    L = _round_up((k_hi - k_lo_even + 2) // 2, 128)
    # The effective band is the row kernel's padded range, so every banded
    # engine reports the same scores; L grows one block where the diag span
    # would fall short of it (odd k_lo, span mod 256 near 0).
    k_hi_eff = k_lo + _round_up(k_hi - k_lo + 1, 128) - 1
    if k_lo_even + 2 * L - 1 < k_hi_eff:
        L += 128
    return BandPlan(k_lo=k_lo, k_hi=k_hi, k_lo_even=k_lo_even, L=L,
                    k_hi_eff=k_hi_eff, n_need=(l1 + l2 + 1) // 2 + 1)


def init_windows(seq1, seq2, he: int, L: int):
    """Wavefront-0 character windows, each (B, L) int32 with -1 padding:
    s1w0[l] = seq1[l + he - 1] and the lane-reversed s2w0[l] =
    seq2[-he - l - 1] (as _init_state)."""
    seq1 = seq1.to(torch.int32)
    seq2 = seq2.to(torch.int32)
    pad1l = max(0, 1 - he)
    pad1r = max(0, (L - 1 + he - 1) - (seq1.shape[1] - 1))
    s1p = F.pad(seq1, (pad1l, pad1r), value=-1)
    s1w0 = s1p[:, pad1l + he - 1: pad1l + he - 1 + L]
    pad2l = max(0, L + he)
    pad2r = max(0, -he)
    s2p = F.pad(seq2, (pad2l, pad2r), value=-1)
    lo = pad2l + (-he - L)
    s2w0 = s2p[:, lo: lo + L].flip(1)
    return s1w0.contiguous(), s2w0.contiguous()


def entering_streams(seq1, seq2, he: int, L: int, n_iters: int):
    """(c1s, c2s), each (B, n_iters) int32 with -1 padding: c1s[:, i] =
    seq1[i + he + L - 1] enters s1w at a = 2i+1, c2s[:, i] = seq2[i - he]
    enters s2w at a = 2i+2 (as _entering_streams)."""
    seq1 = seq1.to(torch.int32)
    seq2 = seq2.to(torch.int32)
    start1 = he + L - 1
    pad1l = max(0, -start1)
    pad1r = max(0, start1 + n_iters - seq1.shape[1])
    s1p = F.pad(seq1, (pad1l, pad1r), value=-1)
    c1s = s1p[:, pad1l + start1: pad1l + start1 + n_iters]
    start2 = -he
    pad2r = max(0, start2 + n_iters - seq2.shape[1])
    s2p = F.pad(seq2, (0, pad2r), value=-1)
    c2s = s2p[:, start2: start2 + n_iters]
    return c1s.contiguous(), c2s.contiguous()


def _check_model(model: str, compat: bool, dirs_mode) -> None:
    if model not in ("ref", "std"):
        raise ValueError(f"unknown affine model {model!r}")
    if model == "std" and (compat or dirs_mode == "full"):
        raise ValueError(
            "model='std' (any-state gap opens) supports textbook "
            "boundaries and fast4/score-only dirs; compat and the full "
            "co-optimal layout are reference-model semantics"
        )


# ---------------------------------------------------------------------------
# Plain PyTorch fill
# ---------------------------------------------------------------------------


def diag_step_torch(
    par: int, a: int, M1, I1, D1, H2, H1, s1w, s2w, c, lane, n1v, n2v,
    he: int, lane_lim: int, scheme: ScoringScheme, compat: bool,
    wildcard: bool, dirs_mode, model: str = "ref",
):
    """One wavefront a of parity par, the twin of
    ops/nw_banded_diag.py::_diag_step (boundary variant): M1/I1/D1 and H1
    are wavefront a-1, H2 wavefront a-2, all (B, L) int32; c (B,) the
    entering character (query on odd wavefronts, db on even ones).
    Returns (M, I, D, H, s1w, s2w, code) with code None for no dirs."""
    o, e = scheme.gap_open, scheme.gap_extend
    L = lane.shape[1]
    lane_0 = lane == 0
    lane_last = lane == L - 1
    if par == 1:
        s1w = torch.where(lane_last, c[:, None], torch.roll(s1w, -1, 1))
    else:
        s2w = torch.where(lane_0, c[:, None], torch.roll(s2w, 1, 1))
    q = (a - par) // 2 - he
    xv = q - lane
    yv = a - xv
    eq = (s1w & s2w) != 0 if wildcard else s1w == s2w
    M = H2 + scheme.mismatch + _bit(eq, scheme.match_ - scheme.mismatch)
    M1o = (H1 if model == "std" else M1) + o
    if par == 0:
        # I reads lane l-1 of a-1; D reads lane l.
        I_src = torch.where(lane_0, NEGBIG, torch.roll(I1, 1, 1))
        M_src_i = torch.where(lane_0, NEGBIG, torch.roll(M1o, 1, 1))
        D_src, M_src_d = D1, M1o
    else:
        # I reads lane l; D reads lane l+1.
        I_src, M_src_i = I1, M1o
        D_src = torch.where(lane_last, NEGBIG, torch.roll(D1, -1, 1))
        M_src_d = torch.where(lane_last, NEGBIG, torch.roll(M1o, -1, 1))
    I = torch.maximum(M_src_i, I_src) + e
    D = torch.maximum(M_src_d, D_src) + e
    valid = ((xv >= 1) & (xv <= n2v) & (lane <= lane_lim)
             & (yv >= 1) & (yv <= n1v))
    M = torch.where(valid, M, NEGBIG)
    I = torch.where(valid, I, NEGBIG)
    D = torch.where(valid, D, NEGBIG)
    # Boundary cells: compat stores the x=0 chain in D and the y=0 chain in
    # I with one extra extension (the reference's quirk); textbook I / D.
    row0 = (xv == 0) & (yv >= 0) & (yv <= n1v)
    col0 = (yv == 0) & (xv >= 1) & (xv <= n2v)
    if compat:
        row0_i, row0_d = NEG_INF, o + (yv + 1) * e
        col0_i, col0_d = o + (xv + 1) * e, NEG_INF
    else:
        row0_i, row0_d = o + yv * e, NEG_INF
        col0_i, col0_d = NEG_INF, o + xv * e
    origin = row0 & (yv == 0)
    M = torch.where(row0, torch.where(origin, 0, NEG_INF), M)
    I = torch.where(row0, torch.where(origin, NEG_INF, row0_i), I)
    D = torch.where(row0, torch.where(origin, NEG_INF, row0_d), D)
    M = torch.where(col0, NEG_INF, M)
    I = torch.where(col0, col0_i, I)
    D = torch.where(col0, col0_d, D)
    M, I, D = (t.to(torch.int32) for t in (M, I, D))
    H = torch.maximum(M, torch.maximum(I, D))

    code = None
    if dirs_mode == "fast4":
        code = torch.where(M == H, 0, torch.where(I == H, 1, 2)).to(
            torch.int32)
        code |= _bit(I == I_src + e, 4) | _bit(D == D_src + e, 8)
    elif dirs_mode == "full":
        code = _bit(M == H, dirbits.HM) | _bit(I == H, dirbits.HI)
        code |= _bit(D == H, dirbits.HD)
        code |= _bit(I == I_src + e, dirbits.IEXT)
        code |= _bit(I == M_src_i + e, dirbits.IOPEN)
        code |= _bit(D == D_src + e, dirbits.DEXT)
        code |= _bit(D == M_src_d + e, dirbits.DOPEN)
    return M, I, D, H, s1w, s2w, code


def _check_fill_args(s1w0, s2w0, c1s, c2s, n1v, n2v, plan: BandPlan):
    B = s1w0.shape[0]
    n_iters = c1s.shape[1]
    for name, t, shape in (
        ("s1w0", s1w0, (B, plan.L)), ("s2w0", s2w0, (B, plan.L)),
        ("c1s", c1s, (B, n_iters)), ("c2s", c2s, (B, n_iters)),
        ("n1v", n1v, (B,)), ("n2v", n2v, (B,)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != s1w0.device:
            raise ValueError(f"{name} is on {t.device}, not {s1w0.device}")


def banded_diag_fill_torch(
    s1w0, s2w0, c1s, c2s, n1v, n2v, plan: BandPlan,
    scheme: ScoringScheme, compat: bool, wildcard: bool, dirs_mode,
    model: str = "ref",
):
    """Plain PyTorch twin of _banded_diag_lax: a loop over the n_iters =
    c1s.shape[1] iterations of two wavefronts.  s1w0/s2w0: (B, L) int32
    windows (init_windows); c1s/c2s: (B, n_iters) int32 entering
    characters (entering_streams); n1v/n2v: (B,) int32 lengths.  Returns
    (finals (B, 3) int32, dirs (ceil(2 n_iters / upack), B, L) uint32 or
    None).  The iteration is a device counter and the state updates in
    place, so on the card the loop replays as CUDA graphs
    (ops.step_graph)."""
    dirs_mode = _norm_dirs(dirs_mode)
    _check_model(model, compat, dirs_mode)
    _check_fill_args(s1w0, s2w0, c1s, c2s, n1v, n2v, plan)
    B, L = s1w0.shape
    n_iters = c1s.shape[1]
    dev = s1w0.device
    he = plan.he
    lane = torch.arange(L, dtype=torch.int32, device=dev)[None, :].expand(
        B, L)
    n1, n2 = n1v[:, None], n2v[:, None]
    m0 = torch.where(lane == -he, 0, NEGBIG).to(torch.int32)
    negs = torch.full((B, L), NEGBIG, dtype=torch.int32, device=dev)
    M1, I1, D1, H1, H2 = (t.clone() for t in (m0, negs, negs, m0, negs))
    s1w, s2w = s1w0.clone(), s2w0.clone()
    finals = torch.zeros((B, 3), dtype=torch.int64, device=dev)
    pack = None
    if dirs_mode:
        upack = _upack(dirs_mode)
        pack = CounterPacker(torch.empty((-(-2 * n_iters // upack), B, L),
                                         dtype=torch.uint32, device=dev),
                             upack)
    i = torch.zeros((), dtype=torch.int64, device=dev)

    def iteration():
        for par, cs in ((1, c1s), (0, c2s)):
            a = 2 * i + (2 - par)
            c = cs.index_select(1, i.view(1))[:, 0]
            M, I, D, H, s1n, s2n, code = diag_step_torch(
                par, a, M1, I1, D1, H2, H1, s1w, s2w, c, lane, n1, n2, he,
                plan.lane_limit(par), scheme, compat, wildcard, dirs_mode,
                model,
            )
            xv = (a - par) // 2 - he - lane
            hit = (xv == n2) & (a - xv == n1)
            finals.add_(torch.stack(
                [torch.where(hit, t, 0).sum(1) for t in (M, I, D)], dim=1))
            if pack is not None:
                pack.add(a - 1, code)
            H2.copy_(H1)
            for dst, src in ((M1, M), (I1, I), (D1, D), (H1, H), (s1w, s1n),
                             (s2w, s2n)):
                dst.copy_(src)

    run_steps(iteration, i, n_iters)
    return finals.to(torch.int32), pack.dirs if pack is not None else None


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


class BandTiles(NamedTuple):
    """The tiled route's shape (csrc/nw_banded_diag.cuh, BandTiles): strips
    of strip_lanes lanes a pair (strips of them), blocks of block_iters
    iterations (rows of them), halo lanes a side, lanes_per_thread and
    threads a CTA; order 1 reverses the tickets (a schedule that cannot be
    met)."""

    strip_lanes: int
    block_iters: int
    strips: int
    rows: int
    halo: int
    lanes_per_thread: int
    threads: int
    order: int = 0


# The tile rule's constants: a pair's band fits one CTA up to ONE_TILE_LANES
# lanes; a split band's strips are MIN_STRIP_LANES to MAX_STRIP_LANES wide
# (a multiple of 32) in blocks of BLOCK_ITERS iterations (csrc/band_sweep.py
# on the card chose them).
ONE_TILE_LANES = 2048
MIN_STRIP_LANES = 128
MAX_STRIP_LANES = 512
BLOCK_ITERS = 64
# Threads a CTA at most at 2, 4 or 8 lanes a thread (csrc: max_threads).
_MAX_THREADS = {2: 512, 4: 512, 8: 256}


def band_tiles(B: int, L: int, n_iters: int, sms: int,
               strip_lanes: int = 0, block_iters: int = 0) -> BandTiles:
    """The tiles of a batch of B pairs of L lanes and n_iters iterations on
    a card of `sms` SMs.  A batch of at least one pair an SM whose band fits
    one CTA takes one tile a pair (all its iterations, no halo, one warp
    at 8 lanes a thread where it can).  Otherwise each pair's band is cut
    into strips in blocks of BLOCK_ITERS iterations at 2 lanes a thread
    (4 past 1024 lanes a tile): strips of MIN_STRIP_LANES while the batch
    has at most two of them an SM (a band of fewer than 3 stays one tile),
    else as many strips as give about one tile an SM, MIN_STRIP_LANES to
    MAX_STRIP_LANES wide.
    strip_lanes / block_iters force the strip width (a multiple of 8) and
    the block (a multiple of 4 when there are several)."""
    if strip_lanes:
        W = min(strip_lanes, L)
    elif B >= sms and L <= ONE_TILE_LANES:
        W = L
    elif B * -(-L // MIN_STRIP_LANES) <= 2 * sms:
        # Few strips even at the narrowest: the narrowest, whose tile (the
        # strip and its halos) is four warps; a band that would take fewer
        # than 3 stays one tile (two strips and their halos take longer).
        W = MIN_STRIP_LANES if L > 2 * MIN_STRIP_LANES else L
    else:
        want = max(1, sms // max(B, 1))
        W = _round_up(-(-L // want), 32)
        W = min(max(W, MIN_STRIP_LANES), MAX_STRIP_LANES, L)
    S = -(-L // W)
    T = block_iters or (n_iters if S == 1 else BLOCK_ITERS)
    rows = -(-n_iters // T)
    halo = _round_up(min(T, n_iters), 8) if S > 1 else 0
    window = min(L, W + 2 * halo)
    if S == 1 and B >= sms:
        lpt = 8 if window >= 256 else 4
    else:
        lpt = next((n for n in (2, 4, 8)
                    if -(-window // n) <= _MAX_THREADS[n]), 8)
    threads = _round_up(-(-window // lpt), 32)
    return BandTiles(W, T, S, rows, halo, lpt, threads)


def _check_tiles(tiles: BandTiles, L: int, n_iters: int) -> None:
    """The shapes the kernel takes (csrc: band_tiles_ok, the instances)."""
    W, T = tiles.strip_lanes, tiles.block_iters
    if W <= 0 or W % 8:
        raise ValueError(f"strip width {W}: not a positive multiple of 8")
    if T <= 0 or (tiles.rows > 1 and T % 4):
        raise ValueError(f"block of {T} iterations: not a positive "
                         "multiple of 4")
    if tiles.halo > W:
        raise ValueError(f"a block of {T} iterations needs a halo of "
                         f"{tiles.halo} lanes, wider than strips of {W}")
    if tiles.threads > _MAX_THREADS.get(tiles.lanes_per_thread, 0):
        raise ValueError(f"tiles of {min(L, W + 2 * tiles.halo)} lanes "
                         "exceed a CTA")


def banded_diag_fill_cuda(
    s1w0, s2w0, c1s, c2s, n1v, n2v, plan: BandPlan,
    scheme: ScoringScheme, compat: bool, wildcard: bool, dirs_mode,
    model: str = "ref", strip_lanes: int = 0, block_iters: int = 0,
):
    """The banded fill kernel (csrc/nw_banded_diag.cu) on CUDA tensors:
    same arguments and results as banded_diag_fill_torch, at any band
    width.  Each pair's band is tiled into strips x blocks of iterations
    (band_tiles' rule from the batch and the card's SMs; strip_lanes /
    block_iters force them, for testing), handed out over a persistent
    grid; the launch's shape, the SMs each pair ran on included, is left in
    ``banded_diag_fill_cuda.last_launch``.  Raises ValueError on a CPU
    tensor, a non-contiguous input or tiles out of range, RuntimeError on a
    failed launch or a tile that waited on its neighbours past the spin
    limit."""
    dirs_mode = _norm_dirs(dirs_mode)
    _check_model(model, compat, dirs_mode)
    _check_fill_args(s1w0, s2w0, c1s, c2s, n1v, n2v, plan)
    if not s1w0.is_cuda:
        raise ValueError("banded_diag_fill_cuda needs CUDA tensors")
    ins = (s1w0, s2w0, c1s, c2s, n1v, n2v)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("banded fill inputs must be contiguous")
    B, L = s1w0.shape
    n_iters = c1s.shape[1]
    lib = csrc.kernels()
    tiles = band_tiles(B, L, n_iters, lib.sa_sm_count(), strip_lanes,
                       block_iters)
    _check_tiles(tiles, L, n_iters)
    dcode = _DIRS_CODES[dirs_mode]
    resident = lib.sa_banded_resident_ctas(
        tiles.lanes_per_thread, tiles.threads, dcode, int(wildcard),
        int(model == "std"))
    if resident <= 0:
        raise RuntimeError(f"banded_diag_fill_cuda: no CTA of "
                           f"{tiles.threads} threads fits on the card")
    per_row = B * tiles.strips
    ctas = min(resident, per_row)
    dev = s1w0.device
    finals = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    dirs = None
    if dirs_mode:
        dirs = torch.empty((-(-2 * n_iters // _upack(dirs_mode)), B, L),
                           dtype=torch.uint32, device=dev)
    state = None
    if tiles.rows > 1:
        state = torch.empty((2, B, L, 4), dtype=torch.int32, device=dev)
    head = 2 + _SM_WORDS * B
    ctr = torch.zeros(head + per_row, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sa_banded_fill(
            *(t.data_ptr() for t in ins), finals.data_ptr(),
            dirs.data_ptr() if dirs is not None else None,
            state.data_ptr() if state is not None else None,
            ctr.data_ptr(), B, L, n_iters, plan.he, plan.lane_limit(1),
            plan.lane_limit(0), scheme.match_, scheme.mismatch,
            scheme.gap_open, scheme.gap_extend, dcode, int(compat),
            int(wildcard), int(model == "std"), tiles.strip_lanes,
            tiles.block_iters, tiles.order, tiles.lanes_per_thread,
            tiles.threads, ctas, stream,
        )
    if rc != 0:
        raise csrc.launch_error("sa_banded_fill", rc)
    banded_diag_fill_cuda.launches += 1
    got = ctr[:head].cpu().numpy()
    if got[1] != 0:
        raise RuntimeError(
            "banded_diag_fill_cuda: a tile waited on its neighbours past the "
            f"spin limit (status {int(got[1])}); its results are incomplete")
    masks = got[2:].view(np.uint32).reshape(B, _SM_WORDS)
    banded_diag_fill_cuda.last_launch = dict(
        tiles._asdict(), tiles=per_row * tiles.rows, ctas=ctas,
        resident=resident,
        sms=int(_popcounts(np.bitwise_or.reduce(masks, 0))),
        sms_per_pair=[int(n) for n in _popcounts(masks)])
    return finals, dirs


banded_diag_fill_cuda.launches = 0
banded_diag_fill_cuda.last_launch = {}


def banded_diag_fill(s1w0, s2w0, c1s, c2s, n1v, n2v, plan, scheme, compat,
                     wildcard, dirs_mode, model="ref"):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (s1w0, s2w0, c1s, c2s, n1v, n2v, plan, scheme, compat, wildcard,
            dirs_mode, model)
    if s1w0.is_cuda:
        return banded_diag_fill_cuda(*args)
    if s1w0.device.type != "cpu":
        raise ValueError(f"unsupported device {s1w0.device}")
    return banded_diag_fill_torch(*args)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def band_inputs(query, db, query_len, db_len, band: int):
    """Plan the band of a padded batch held as tensors (device.to_device)
    and lay out the kernel's inputs on the batch's device.  Returns (plan,
    (s1w0, s2w0, c1s, c2s, n1v, n2v))."""
    plan = plan_band(query_len.cpu().numpy(), db_len.cpu().numpy(), band,
                     query.shape[1], db.shape[1])
    s1w0, s2w0 = init_windows(query, db, plan.he, plan.L)
    c1s, c2s = entering_streams(query, db, plan.he, plan.L, plan.n_need)
    n1v = query_len.to(torch.int32).contiguous()
    n2v = db_len.to(torch.int32).contiguous()
    return plan, (s1w0, s2w0, c1s, c2s, n1v, n2v)


def nw_banded_diag_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    band: int = 128,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    with_dirs=False,
    *,
    model: str = "ref",
) -> BandedDiagResult:
    """Anti-diagonal banded Gotoh fill of a padded batch held as tensors
    (device.to_device); with_dirs False, "fast4" or "full"/True.  The
    finals come to the host; the dirs stay on the batch's device."""
    dirs_mode = _norm_dirs(with_dirs)
    _check_model(model, compat, dirs_mode)
    plan, ins = band_inputs(query, db, query_len, db_len, band)
    finals, dirs = banded_diag_fill(*ins, plan, scheme, compat, wildcard,
                                    dirs_mode, model)
    return BandedDiagResult(finals=finals.cpu().numpy(), dirs=dirs,
                            k_lo_even=plan.k_lo_even, k_lo=plan.k_lo)

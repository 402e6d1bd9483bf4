"""Tiled affine-gap NW (Gotoh) fill for pairs of any length: the port of
ops/nw_affine_tiled.py.

The DP matrix is cut into tiles of W lanes along the db (x) axis; each tile
is swept anti-diagonal by anti-diagonal (lane l holds x = x0 + l, step g
holds y = g - l) with the merged-roll Gotoh recurrence, and the only
coupling between consecutive tiles is the boundary column at the tile edge
-- M/D/H at x = x0 - 1 for every query position y, O(n1) values a pair:

  * lane 0 reads the carried column: M(x0, y) = H_b(y-1) + sub,
    D(x0, y) = max(M_b(y) + o, D_b(y)) + e;
  * lane l == g is cell (x, 0): the x-chain boundary (compat keeps it in
    the I plane with one extra extension, textbook in D);
  * lane W-1's M/D/H are emitted every step as the next tile's column.

Score-only: each pair's M/I/D corner finals at (n2, n1).  They are the
exact Gotoh corner values whatever the tiling, so the CUDA kernels choose
their own strip widths; the plain versions follow the JAX package's lax
layout at ``tile_lanes`` so the tests compare like with like.

Implementations, chosen by the tensors' device:

* ``tiled_fill_torch`` / ``tiled_fold_fill_torch`` -- plain PyTorch, the
  twins of _jitted_tiled / _jitted_tiled_folded over _tile_fill_lax /
  _tile_fill_folded_lax (CPU tensors, and the references the kernels are
  checked against);
* ``gotoh_finals_rows_torch`` -- plain PyTorch, the same finals by a row
  sweep in the reference fill's order: the kernels' plain check at 100 kb,
  where the lax-layout twins take too many steps;
* ``tiled_fill_cuda`` -- kernel #4 (``csrc/nw_affine_tiled.cu``,
  sa_tiled_fill), replacing the TPU's _tile_kernel;
* ``tiled_fold_fill_cuda`` -- kernel #5 (sa_tiled_fold_fill), replacing the
  TPU's _folded_kernel for 1-4 pairs;
* ``shard_fill_torch`` / ``tiled_shard_fill_cuda`` -- one pair's db axis
  over a mesh's devices (parallel/seqpar.py): the plain twin of
  parallel/seqpar.py::_jitted_seqpar's rounds (tile by tile, the column
  moved to the next device), and the shard fill (sa_tiled_shard_fill),
  kernel #4's strips over each device's segments, one launch a device.

Both CUDA kernels are one strip pipeline.  On the TPU a tile is a (rows,
lanes) block swept by one core, and the folded kernel folds a pair over
sublanes to fill the vector unit.  On the H100 what bounds the fill is the
integer work a cell and how many of the 132 SMs a pair keeps busy: a pair's
db axis is cut into strips of W lanes (``STRIP_LANES``), one CTA a strip,
and strip s + 1 runs about W + CHUNK_ROWS steps behind strip s, reading
its carried column from a ring slot in global memory as strip s publishes
it, CHUNK_ROWS rows at a time (a release store of the row count, an acquire
wait by the reader).  The (pair, strip) items go out by a global ticket,
strip-major (``strip_schedule``), over a persistent grid of co-resident
CTAs (``strip_plan``), so every wait is on an earlier ticket held by a
running CTA; a wait that stalls past the kernels' spin limit makes the
wrapper raise.  The cell uses Hopper's DPX instructions.  The two entries
differ only in their CTAs: #4 8 lanes a thread, #5 4.

The shard fill runs kernel #4's strips with the segments of a mesh's
devices: a pair's db axis in segments of ``seg_lanes`` lanes (the lanes a
device owns a round in the JAX package's seqpar), segment k on device
k % D, each segment in strips of ``shard_strip_lanes``.  All D launches run
at once, on the same card (each on its own stream, sharing its CTAs) or on
distinct cards with peer access.  Inside a segment a strip hands its
column to the next through a whole column of its launch; between segments
through a boundary buffer on the consumer's card, with a row count the
producer publishes at system scope.  The work items go segment-major
(``shard_schedule``), so a wait points at a lower segment or an earlier
ticket of the same launch and the launches cannot wait on each other in a
cycle.  Across processes (a ``group``, parallel/mesh.seqpar_group) every
rank holds some of the D devices -- global device starts[rank] + i is its
device i (parallel/mesh.rank_span) -- and launches only its own; a column
between two ranks goes from an outbox in the producer's host memory to an
inbox in the consumer's, moved by parallel/relay.ColumnRelay, and the
finals are summed over the group.
"""
from __future__ import annotations

import bisect
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.io.encode import round_up as _round_up
from sequencealigning_tpu_torch.ops.nw_affine import _bit, _roll
from sequencealigning_tpu_torch.ops.step_graph import run_steps

# The CUDA kernels' default strip widths (lanes): kernel #4 at 8 lanes a
# thread, kernel #5 at 4; a CTA takes at most 512 threads.
STRIP_LANES = {"sa_tiled_fill": 1024, "sa_tiled_fold_fill": 512}
# Rows of the carried column a strip stages (and publishes) at a time.
CHUNK_ROWS = 128
# The ring slots' bytes at most (8 bytes a row a slot): fewer CTAs a pair
# past it.
RING_BYTES = 4 << 30
# SM bitmap words a pair in the launch's counters (256 SMs).
_SM_WORDS = 8

# The plain fills round a tile's steps up to this, as the lax layout does.
_CHUNK = 128


# ---------------------------------------------------------------------------
# Plain PyTorch fill (the lax layout)
# ---------------------------------------------------------------------------


def _col0_vals(x0: int, col_iota, scheme: ScoringScheme, compat: bool):
    """(M, I, D) at cells (x = x0 + lane, y = 0); x >= 1 always."""
    o, e = scheme.gap_open, scheme.gap_extend
    xg = x0 + col_iota
    if compat:
        return NEG_INF, o + (xg + 1) * e, NEG_INF
    return NEG_INF, NEG_INF, o + xg * e


def tile_step_torch(H2, H1, M1, I1, D1, s1d, qc, hb1, mb, db_, g: int, s2v,
                    col_iota, lane_0, col0_m, col0_i, col0_d,
                    scheme: ScoringScheme, wildcard: bool, roll=_roll):
    """One anti-diagonal step of a tile, the twin of
    ops/nw_affine_tiled.py::_tile_step.  qc/hb1/mb/db_: (B, 1) this step's
    query code y-1 and boundary H(y-1), M(y), D(y) at x0-1; col0_*: the
    lanes' x-chain values.  Returns (M, I, D, H, s1d_new)."""
    o, e = scheme.gap_open, scheme.gap_extend
    s1d_n = torch.where(lane_0, qc, roll(s1d))
    eq = (s1d_n & s2v) != 0 if wildcard else s1d_n == s2v
    sub = scheme.mismatch + _bit(eq, scheme.match_ - scheme.mismatch)
    t0 = M1 + o
    M = roll(H2) + sub
    D = roll(torch.maximum(t0, D1)) + e
    I = torch.maximum(t0, I1) + e
    # Lane 0: the carried boundary column replaces the rolled-in values.
    M = torch.where(lane_0, hb1 + sub, M)
    D = torch.where(lane_0, torch.maximum(mb + o, db_) + e, D)
    # Lane l == g is cell (x, 0): the x-chain boundary.
    lane_g = col_iota == g
    M = torch.where(lane_g, col0_m, M)
    I = torch.where(lane_g, col0_i, I)
    D = torch.where(lane_g, col0_d, D)
    H = torch.maximum(M, torch.maximum(I, D))
    return M, I, D, H, s1d_n


def tile_fill_torch(db_tile, qs, hb1s, mbs, dbs, n1v, n2v, x0: int,
                    ngc: int, scheme: ScoringScheme, compat: bool,
                    wildcard: bool):
    """Fill one tile, the twin of _tile_fill_lax.  db_tile: (B, W) lane
    codes; qs/hb1s/mbs/dbs: (B, ngc) per-step columns; n1v/n2v: (B,)
    lengths.  Returns (finals (B, 3) of the pairs whose corner lies in this
    tile, else 0; br_m, br_d, br_h (B, ngc) lane W-1's emissions by step)."""
    B, W = db_tile.shape
    dev = db_tile.device
    i32 = torch.int32
    col_iota = torch.arange(W, dtype=i32, device=dev)[None, :].expand(B, W)
    lane_0 = col_iota == 0
    c_m, c_i, c_d = _col0_vals(x0, col_iota, scheme, compat)
    neg = torch.full((B, W), NEG_INF, dtype=i32, device=dev)
    H2 = H1 = M1 = I1 = D1 = neg
    s1d = torch.zeros((B, W), dtype=i32, device=dev)
    # The capture schedule: step -> (rows, lanes); each pair's corner is
    # cell (n2, n1), at lane n2 - x0 and step n2 - x0 + n1 of one tile.
    lcap = n2v.cpu().numpy().astype(np.int64) - x0
    gcap = lcap + n1v.cpu().numpy().astype(np.int64)
    events: dict = {}
    for r in range(B):
        if 0 <= lcap[r] < W and gcap[r] < ngc:
            events.setdefault(int(gcap[r]), []).append((r, int(lcap[r])))
    finals = torch.zeros((B, 3), dtype=i32, device=dev)
    br = torch.empty((3, B, ngc), dtype=i32, device=dev)
    for g in range(ngc):
        M, I, D, H, s1d = tile_step_torch(
            H2, H1, M1, I1, D1, s1d, qs[:, g:g + 1], hb1s[:, g:g + 1],
            mbs[:, g:g + 1], dbs[:, g:g + 1], g, db_tile, col_iota, lane_0,
            c_m, c_i, c_d, scheme, wildcard,
        )
        for r, lane in events.get(g, ()):
            finals[r] = torch.stack([M[r, lane], I[r, lane], D[r, lane]])
        br[0, :, g] = M[:, -1]
        br[1, :, g] = D[:, -1]
        br[2, :, g] = H[:, -1]
        H2, H1, M1, I1, D1 = H1, H, M, I, D
    return finals, br[0], br[1], br[2]


def _boundary0(B: int, ngc: int, scheme: ScoringScheme, compat: bool,
               device):
    """The closed-form x = 0 boundary column (tile 0's left edge) as the
    three (B, ngc) step-indexed arrays (hb1 pre-shifted by one), as
    ops/nw_affine_tiled.py::_boundary0, except that H is the maximum of
    the three planes there, as in every other engine and the scalar
    oracle: a gap chain below NEG_INF leaves H at NEG_INF.  The JAX
    package's H is the raw chain, so its tiled fills score below the
    oracle once a query's chain passes NEG_INF (5461 bp under the default
    scheme)."""
    o, e = scheme.gap_open, scheme.gap_extend
    y = torch.arange(ngc, dtype=torch.int32, device=device)[None, :].expand(
        B, ngc)
    m_b = torch.where(y == 0, 0, NEG_INF)
    if compat:
        d_b = torch.where(y == 0, NEG_INF, o + (y + 1) * e)
        h_b = torch.where(y == 0, 0, o + (y + 1) * e)
    else:
        d_b = torch.full_like(y, NEG_INF)
        h_b = torch.where(y == 0, 0, o + y * e)
    h_b = h_b.clamp(min=NEG_INF)
    hb1 = F.pad(h_b[:, :-1], (1, 0), value=NEG_INF)
    return (t.to(torch.int32) for t in (hb1, m_b, d_b))


def _query_steps(query, ngc: int):
    """qs[:, g] = query[:, g-1] (0 at g = 0 and past the query), (B, ngc)."""
    qs = F.pad(query.to(torch.int32),
               (1, max(0, ngc - 1 - query.shape[1])))
    return qs[:, :ngc].contiguous()


def _next_column(brm, brd, brh, w: int, ngc: int):
    """Re-index lane W-1's emissions (by step g) to y for the next tile:
    the value at y sits at g = y + W - 1; hb1 needs y - 1."""
    pad = lambda a: F.pad(a, (0, w))  # noqa: E731
    return (pad(brh)[:, w - 2: w - 2 + ngc], pad(brm)[:, w - 1: w - 1 + ngc],
            pad(brd)[:, w - 1: w - 1 + ngc])


def _empty_db_corners(finals: torch.Tensor, n1v, n2v,
                      scheme: ScoringScheme, compat: bool) -> torch.Tensor:
    """Pairs with n2 == 0 never reach a tile lane: their corner (0, n1) is
    the x = 0 boundary column in closed form."""
    o, e = scheme.gap_open, scheme.gap_extend
    n1s = n1v.cpu().numpy()
    for b, n2 in enumerate(n2v.cpu().numpy()):
        if int(n2) != 0:
            continue
        n1 = int(n1s[b])
        if n1 == 0:
            vals = (0, NEG_INF, NEG_INF)
        elif compat:
            vals = (NEG_INF, NEG_INF, o + (n1 + 1) * e)
        else:
            vals = (NEG_INF, o + n1 * e, NEG_INF)
        finals[b] = torch.tensor(vals, dtype=torch.int32)
    return finals


def tiled_fill_torch(query, db, n1v, n2v, scheme: ScoringScheme,
                     compat: bool, wildcard: bool,
                     tile_lanes: int = 4096) -> torch.Tensor:
    """Plain PyTorch twin of nw_affine_tiled_batch's fill (lax layout):
    the batch padded to a multiple of 8 (pad rows of length 1), tiles of W
    = round_up(min(tile_lanes, max(L2, 128)), 128) lanes, ngc = n1p + W
    steps a tile.  query: (B, L1), db: (B, L2) int32 codes; n1v/n2v: (B,)
    int32.  Returns the (B, 3) int32 corner finals."""
    B, L1 = query.shape
    L2 = db.shape[1]
    dev = query.device
    W = _round_up(min(tile_lanes, max(L2, 128)), 128)
    T = max(1, -(-L2 // W))
    Bp = _round_up(max(B, 8), 8)
    ngc = _round_up(L1 + 1, _CHUNK) + W
    q = torch.zeros((Bp, L1), dtype=torch.int32, device=dev)
    q[:B] = query
    d_all = torch.zeros((Bp, T * W), dtype=torch.int32, device=dev)
    d_all[:B, :L2] = db
    qlen = torch.ones(Bp, dtype=torch.int32, device=dev)
    dlen = torch.ones(Bp, dtype=torch.int32, device=dev)
    qlen[:B] = n1v
    dlen[:B] = n2v
    qs = _query_steps(q, ngc)
    hb1, mb, db_b = _boundary0(Bp, ngc, scheme, compat, dev)
    finals = torch.zeros((Bp, 3), dtype=torch.int32, device=dev)
    for t in range(T):
        f_t, brm, brd, brh = tile_fill_torch(
            d_all[:, t * W:(t + 1) * W], qs, hb1, mb, db_b, qlen, dlen,
            t * W + 1, ngc, scheme, compat, wildcard,
        )
        finals += f_t
        hb1, mb, db_b = _next_column(brm, brd, brh, W, ngc)
    return _empty_db_corners(finals[:B], n1v, n2v, scheme, compat)


# ---------------------------------------------------------------------------
# Plain PyTorch folded fill (the lax layout: 8 rows, `fold` rows a pair)
# ---------------------------------------------------------------------------


def _shift_x(a, lane_0):
    """The x-1 neighbour of every (row s, lane l): lane l-1 within the row,
    lane W-1 of row s-1 across the seam (as ops/nw_affine_tiled.py::
    _shift_x; (0, 0)'s wrapped value is overridden by the carried
    column)."""
    up = torch.roll(a, 1, dims=0)
    return torch.where(lane_0, up[:, -1:], _roll(a))


def folded_step_torch(H2, H1, M1, I1, D1, qw, qc, hb1, mb, db_, g: int, s2v,
                      lane_iota, sub_off, s0l0, lane_0, x0: int,
                      scheme: ScoringScheme, compat: bool, wildcard: bool):
    """One anti-diagonal step of the folded tile (shapes (8, W)), the twin
    of ops/nw_affine_tiled.py::_folded_step.  qc/hb1/mb/db_: (8, 1) this
    step's columns; sub_off = (row % fold) * W.  Returns (M, I, D, H,
    qw_new)."""
    o, e = scheme.gap_open, scheme.gap_extend
    sx = lambda a: _shift_x(a, lane_0)  # noqa: E731
    qw_n = torch.where(s0l0, qc, sx(qw))
    eq = (qw_n & s2v) != 0 if wildcard else qw_n == s2v
    sub = scheme.mismatch + _bit(eq, scheme.match_ - scheme.mismatch)
    t0 = M1 + o
    M = sx(H2) + sub
    D = sx(torch.maximum(t0, D1)) + e
    I = torch.maximum(t0, I1) + e
    # Fold-origin cell (s % fold = 0, l = 0) = x = x0: the carried column.
    M = torch.where(s0l0, hb1 + sub, M)
    D = torch.where(s0l0, torch.maximum(mb + o, db_) + e, D)
    # y == 0 chain cell (x0 + g, 0): lane l = g - s*W of one row.
    l0mask = lane_iota == (g - sub_off)
    xg = x0 + g
    if compat:
        i_c, d_c = o + (xg + 1) * e, NEG_INF
    else:
        i_c, d_c = NEG_INF, o + xg * e
    M = torch.where(l0mask, NEG_INF, M)
    I = torch.where(l0mask, i_c, I)
    D = torch.where(l0mask, d_c, D)
    H = torch.maximum(M, torch.maximum(I, D))
    return M, I, D, H, qw_n


def tile_fill_folded_torch(db_tile, qs, hb1s, mbs, dbs, n2c, n12c, x0: int,
                           ngc: int, fold: int, scheme: ScoringScheme,
                           compat: bool, wildcard: bool):
    """The twin of _tile_fill_folded_lax.  db_tile: (8, W), rows
    p*fold..(p+1)*fold-1 holding pair p's fold*W db lanes; qs/hb1s/mbs/dbs:
    (8, ngc) per-step columns (equal within a group); n2c/n12c: (8,) per-row
    n2 / n1+n2.  Returns (finals (8, 3) at each group's corner row, else 0;
    br_m, br_d, br_h (8, ngc) per-row last-lane emissions)."""
    S, W = db_tile.shape
    dev = db_tile.device
    i32 = torch.int32
    lane_iota = torch.arange(W, dtype=i32, device=dev)[None, :].expand(S, W)
    sub_off = (torch.arange(S, dtype=i32, device=dev)[:, None]
               & (fold - 1)) * W
    lane_0 = lane_iota == 0
    s0l0 = lane_0 & (sub_off == 0)
    neg = torch.full((S, W), NEG_INF, dtype=i32, device=dev)
    H2 = H1 = M1 = I1 = D1 = neg
    qw = torch.zeros((S, W), dtype=i32, device=dev)
    # Capture schedule: row s holds the corner of its group's pair when
    # x0 + (s % fold) * W + l == n2 for a lane l, at step n1 + n2 - x0.
    xs = x0 + sub_off[:, 0].cpu().numpy().astype(np.int64)
    lcap = n2c.cpu().numpy().astype(np.int64) - xs
    gcap = n12c.cpu().numpy().astype(np.int64) - x0
    events: dict = {}
    for r in range(S):
        if 0 <= lcap[r] < W and 0 <= gcap[r] < ngc:
            events.setdefault(int(gcap[r]), []).append((r, int(lcap[r])))
    finals = torch.zeros((S, 3), dtype=i32, device=dev)
    br = torch.empty((3, S, ngc), dtype=i32, device=dev)
    for g in range(ngc):
        M, I, D, H, qw = folded_step_torch(
            H2, H1, M1, I1, D1, qw, qs[:, g:g + 1], hb1s[:, g:g + 1],
            mbs[:, g:g + 1], dbs[:, g:g + 1], g, db_tile, lane_iota, sub_off,
            s0l0, lane_0, x0, scheme, compat, wildcard,
        )
        for r, lane in events.get(g, ()):
            finals[r] = torch.stack([M[r, lane], I[r, lane], D[r, lane]])
        br[0, :, g] = M[:, -1]
        br[1, :, g] = D[:, -1]
        br[2, :, g] = H[:, -1]
        H2, H1, M1, I1, D1 = H1, H, M, I, D
    return finals, br[0], br[1], br[2]


def _fold_groups(B: int):
    """(G, fold): pair groups and rows a pair, G = ceil_pow2(B) for B <= 4."""
    G = 1 if B == 1 else (2 if B == 2 else 4)
    return G, 8 // G


def tiled_fold_fill_torch(query, db, n1v, n2v, scheme: ScoringScheme,
                          compat: bool, wildcard: bool,
                          tile_lanes: int = 8192) -> torch.Tensor:
    """Plain PyTorch twin of nw_affine_tiled_fold_batch's fill (lax layout)
    for B <= 4 pairs: G groups of fold = 8 // G rows, each pair on `fold`
    consecutive rows of W lanes (a virtual tile of fold * W lanes); pad
    groups reuse pair 0's lengths.  Returns the (B, 3) int32 finals."""
    B, L1 = query.shape
    L2 = db.shape[1]
    if not 1 <= B <= 4:
        raise ValueError(f"the folded fill takes 1-4 pairs, not {B}")
    dev = query.device
    G, fold = _fold_groups(B)
    W = _round_up(min(tile_lanes, max(-(-max(L2, 1) // fold), 128)), 128)
    WV = fold * W
    T = max(1, -(-L2 // WV))
    ngc = _round_up(_round_up(L1 + 1, _CHUNK) + WV, _CHUNK)
    q = torch.zeros((G, L1), dtype=torch.int32, device=dev)
    q[:B] = query
    d_all = torch.zeros((G, T * WV), dtype=torch.int32, device=dev)
    d_all[:B, :L2] = db
    db_tiles = d_all.reshape(G, T, fold, W).permute(1, 0, 2, 3).reshape(
        T, 8, W)
    qlen = torch.full((G,), int(n1v[0]), dtype=torch.int32, device=dev)
    dlen = torch.full((G,), int(n2v[0]), dtype=torch.int32, device=dev)
    qlen[:B] = n1v
    dlen[:B] = n2v

    def rep(a):
        return torch.repeat_interleave(a, fold, dim=0)

    qs = rep(_query_steps(q, ngc))
    hb1, mb, db_b = (rep(t) for t in _boundary0(G, ngc, scheme, compat, dev))
    n2c, n12c = rep(dlen), rep(qlen + dlen)
    finals = torch.zeros((8, 3), dtype=torch.int32, device=dev)
    for t in range(T):
        f_t, brm, brd, brh = tile_fill_folded_torch(
            db_tiles[t], qs, hb1, mb, db_b, n2c, n12c, t * WV + 1, ngc, fold,
            scheme, compat, wildcard,
        )
        finals += f_t
        # Each group's virtual tile edge is its last row (x = x0 + WV - 1):
        # select the edge rows, refan them to the group's rows.
        edge = lambda a: rep(a[fold - 1::fold])  # noqa: E731
        hb1, mb, db_b = _next_column(edge(brm), edge(brd), edge(brh), WV,
                                     ngc)
    finals = finals.reshape(G, fold, 3).sum(1)
    return _empty_db_corners(finals[:B], n1v, n2v, scheme, compat)


# ---------------------------------------------------------------------------
# Plain PyTorch row sweep (the reference fill's order)
# ---------------------------------------------------------------------------


def gotoh_finals_rows_torch(query, db, n1v, n2v, scheme: ScoringScheme,
                            compat: bool, wildcard: bool) -> torch.Tensor:
    """The same (B, 3) M/I/D corner finals by a row sweep in the reference
    fill's order (ops/oracle_gotoh.py: one db position x a step, a row over
    the query; the in-row I chain linearised by a prefix maximum).  About
    half the steps of the lax-layout twins, so the kernels' finals can be
    held against a plain version at 100 kb; it shares no code with them.
    The row x is a device counter and the rows update in place, so on the
    card the sweep replays as CUDA graphs (ops.step_graph)."""
    B, L1 = query.shape
    dev = query.device
    o, e = scheme.gap_open, scheme.gap_extend
    y = torch.arange(L1 + 1, dtype=torch.int32, device=dev)[None, :]
    ye = y * e
    neg = torch.full((B, L1 + 1), NEG_INF, dtype=torch.int32, device=dev)
    m, i_, d = neg.clone(), neg.clone(), neg.clone()
    m[:, 0] = 0
    if compat:
        d[:, 1:] = o + (y[:, 1:] + 1) * e
    else:
        i_[:, 1:] = o + ye[:, 1:]
    q = query.to(torch.int32)
    dbc = db.to(torch.int32)
    rows = torch.arange(B, device=dev)
    cols = n1v.to(torch.int64)
    n2 = n2v.to(torch.int64)
    finals = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    x = torch.zeros((), dtype=torch.int64, device=dev)

    def capture():
        # Pair b's corner is row n2[b], column n1[b].
        at = torch.stack([m[rows, cols], i_[rows, cols], d[rows, cols]], 1)
        finals.copy_(torch.where((n2 == x)[:, None], at, finals))

    def row():
        c = dbc.index_select(1, (x - 1).view(1))
        eq = (q & c) != 0 if wildcard else q == c
        sub = scheme.mismatch + _bit(eq, scheme.match_ - scheme.mismatch)
        h = torch.maximum(m, torch.maximum(i_, d))
        d.copy_(torch.maximum(m + o, d) + e)
        if not compat:
            d[:, 0] = o + x * e
        else:
            d[:, 0] = NEG_INF
        m.copy_(F.pad(h[:, :-1] + sub, (1, 0), value=NEG_INF))
        # I[y] = max(M[y-1] + o, I[y-1]) + e = y*e + max over y' <= y of
        # (I[0] at y' = 0, M[y'-1] + o + e - y'*e past it).
        i0 = (o + (x + 1) * e if compat else torch.full_like(x, NEG_INF))
        chain = torch.cat([i0.to(torch.int32).expand(B, 1),
                           m[:, :-1] + (o + e) - ye[:, 1:]], dim=1)
        i_.copy_(torch.cummax(chain, dim=1).values + ye)
        capture()

    capture()
    x.fill_(1)
    run_steps(row, x, int(n2v.max()) if B else 0)
    return finals


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_fill_args(query, db, n1v, n2v):
    B = query.shape[0]
    for name, t, dims in (("query", query, 2), ("db", db, 2),
                          ("n1v", n1v, 1), ("n2v", n2v, 1)):
        if t.dtype != torch.int32 or t.dim() != dims or t.shape[0] != B:
            raise ValueError(f"{name}: expected int32 with {dims} dims and "
                             f"{B} rows, got {t.dtype} {tuple(t.shape)}")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, not {query.device}")
    for name, lens, width in (("n1v", n1v, query.shape[1]),
                              ("n2v", n2v, db.shape[1])):
        if B and not 0 <= int(lens.min()) <= int(lens.max()) <= width:
            raise ValueError(f"{name} reaches outside its {width} columns")


def strip_schedule(n2s, strip_lanes: int):
    """The CUDA kernels' work items for db lengths n2s and strips of
    strip_lanes lanes: (items, strips) -- items (n, 3) int32 rows (pair b,
    strip s, gs) in ticket order, strip-major then by pair, so a strip's
    producer (strip s - 1) and its ring slot's last reader hold earlier
    tickets; gs indexes the strip counters, a pair's strips consecutive.
    strips: (B,) strips a pair (0 for n2 = 0: the host's closed form)."""
    n2s = np.asarray(n2s, np.int64)
    strips = np.where(n2s > 0, -(-n2s // strip_lanes), 0)
    base = np.cumsum(strips) - strips
    b = np.repeat(np.arange(len(strips)), strips)
    gs = np.arange(int(strips.sum()))
    s = gs - base[b]
    order = np.lexsort((b, s))
    items = np.stack([b, s, gs], 1)[order].astype(np.int32)
    return np.ascontiguousarray(items), strips


def strip_plan(strips, n1_max: int, L1: int, strip_lanes: int,
               chunk_rows: int, resident: int, ctas_per_pair: int = 0):
    """(ctas_per_pair, ring, ctas) of a launch: CTAs a pair in flight (by
    default the resident CTAs shared over the pairs with strips, at most a
    pair's strips, at most the strips its rows keep busy -- strip s + 1
    trails strip s by W + R steps -- and at most what RING_BYTES of ring
    slots allow), ring slots a pair (CTAs a pair + 1, at most the strips,
    at least 2) and the persistent grid (at most the resident CTAs)."""
    active = int((strips > 0).sum())
    most = int(strips.max())
    W, R = strip_lanes, chunk_rows
    if not ctas_per_pair:
        depth = -(-(n1_max + W) // (W + R)) + 1
        fit = RING_BYTES // (len(strips) * 8 * (L1 + 1)) - 1
        ctas_per_pair = max(1, min(most, depth, -(-resident // active), fit))
    ring = max(2, min(ctas_per_pair + 1, most))
    ctas = max(1, min(int(strips.sum()), resident, active * ctas_per_pair))
    return ctas_per_pair, ring, ctas


def _popcounts(words: np.ndarray) -> np.ndarray:
    """Set bits of each row of uint32 words."""
    return np.unpackbits(words.view(np.uint8), axis=-1).sum(-1)


def _cuda_fill(entry: str, query, db, n1v, n2v, scheme, compat, wildcard,
               strip_lanes: int, chunk_rows: int):
    """Launch a tiled fill entry (sa_tiled_fill or sa_tiled_fold_fill);
    returns the (B, 3) finals and the launch's shape: strip width, chunk
    rows, lanes a thread, strips, CTAs a pair, ring slots, grid CTAs,
    resident CTAs, the SMs that ran strips (all pairs, and each pair)."""
    _check_fill_args(query, db, n1v, n2v)
    fold = entry == "sa_tiled_fold_fill"
    W = strip_lanes or min(STRIP_LANES[entry],
                           _round_up(max(db.shape[1], 1), 128))
    lpt = 8 if not fold and W % 256 == 0 else 4
    if W % 128 or not 0 < W <= 512 * lpt:
        raise ValueError(f"strip width {W} is out of {entry}'s range (a "
                         f"multiple of 128, at most {512 * lpt})")
    R = chunk_rows or CHUNK_ROWS
    if not 2 <= R <= CHUNK_ROWS or R & (R - 1):
        raise ValueError(f"chunk rows {R}: not a power of two in 2.."
                         f"{CHUNK_ROWS}")
    ins = (query, db, n1v, n2v)
    if not all(t.is_cuda for t in ins):
        raise ValueError(f"{entry} needs CUDA tensors")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("tiled fill inputs must be contiguous")
    B, L1 = query.shape
    dev = query.device
    finals = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    n1s, n2s = n1v.cpu().numpy(), n2v.cpu().numpy()
    items, strips = strip_schedule(n2s, W)
    shape = dict(strip_lanes=W, chunk_rows=R, lanes_per_thread=lpt,
                 strips=len(items), ctas_per_pair=0, ring=0, ctas=0,
                 resident=0, sms=0, sms_per_pair=[0] * B)
    if len(items) == 0:
        return _empty_db_corners(finals, n1v, n2v, scheme, compat), shape
    lib = csrc.kernels()
    resident = lib.sa_tiled_resident_ctas(W, int(fold), int(compat),
                                          int(wildcard))
    if resident <= 0:
        raise RuntimeError(f"{entry}: no CTA of {W} lanes fits on the card")
    cpp, ring, ctas = strip_plan(strips, int(n1s.max()), L1, W, R, resident)
    col = torch.empty(B * ring * 2 * (L1 + 1), dtype=torch.int32, device=dev)
    head = 2 + _SM_WORDS * B
    ctr = torch.zeros(head + 2 * len(items), dtype=torch.int32, device=dev)
    items_d = torch.from_numpy(items).to(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in ins), finals.data_ptr(), col.data_ptr(),
            ctr.data_ptr(), items_d.data_ptr(), B, L1, db.shape[1],
            len(items), len(items), scheme.match_, scheme.mismatch,
            scheme.gap_open, scheme.gap_extend, int(compat), int(wildcard),
            W, R, ring, ctas, stream,
        )
    if rc != 0:
        raise csrc.launch_error(entry, rc)
    got = ctr[:head].cpu().numpy()
    if got[1] != 0:
        raise RuntimeError(
            f"{entry}: a strip waited on its neighbour past the spin limit "
            f"(status {int(got[1])}); its finals are incomplete")
    masks = got[2:].view(np.uint32).reshape(B, _SM_WORDS)
    shape.update(ctas_per_pair=cpp, ring=ring, ctas=ctas, resident=resident,
                 sms=int(_popcounts(np.bitwise_or.reduce(masks, 0))),
                 sms_per_pair=[int(n) for n in _popcounts(masks)])
    return _empty_db_corners(finals, n1v, n2v, scheme, compat), shape


def tiled_fill_cuda(query, db, n1v, n2v, scheme: ScoringScheme,
                    compat: bool, wildcard: bool, strip_lanes: int = 0,
                    chunk_rows: int = 0) -> torch.Tensor:
    """Kernel #4 (csrc/nw_affine_tiled.cu, sa_tiled_fill) on CUDA tensors:
    same arguments and finals as tiled_fill_torch.  Each pair's db axis in
    strips of strip_lanes lanes (default 1024, 8 lanes a thread where the
    width allows), pipelined over the card's CTAs (strip_plan's) with the
    carried column handed over every chunk_rows rows (default 128).  The
    launch's shape is left in ``tiled_fill_cuda.last_launch``.  Raises on a CPU
    tensor, a non-contiguous input, a width out of range, a failed launch
    or a stalled wait."""
    out, tiled_fill_cuda.last_launch = _cuda_fill(
        "sa_tiled_fill", query, db, n1v, n2v, scheme, compat, wildcard,
        strip_lanes, chunk_rows)
    if tiled_fill_cuda.last_launch["ctas"]:
        tiled_fill_cuda.launches += 1
    return out


tiled_fill_cuda.launches = 0
tiled_fill_cuda.last_launch = None


def tiled_fold_fill_cuda(query, db, n1v, n2v, scheme: ScoringScheme,
                         compat: bool, wildcard: bool, strip_lanes: int = 0,
                         chunk_rows: int = 0) -> torch.Tensor:
    """Kernel #5 (sa_tiled_fold_fill) on CUDA tensors for 1-4 pairs: the
    strip pipeline of tiled_fill_cuda at 4 lanes a thread (strips of 512
    lanes by default, at most 2048), so the few pairs' rows spread over
    twice the threads.  Same finals as tiled_fold_fill_torch; the launch's
    shape in ``tiled_fold_fill_cuda.last_launch``."""
    B = query.shape[0]
    if not 1 <= B <= 4:
        raise ValueError(f"the folded fill takes 1-4 pairs, not {B}")
    out, tiled_fold_fill_cuda.last_launch = _cuda_fill(
        "sa_tiled_fold_fill", query, db, n1v, n2v, scheme, compat, wildcard,
        strip_lanes, chunk_rows)
    if tiled_fold_fill_cuda.last_launch["ctas"]:
        tiled_fold_fill_cuda.launches += 1
    return out


tiled_fold_fill_cuda.launches = 0
tiled_fold_fill_cuda.last_launch = None


# ---------------------------------------------------------------------------
# The shard fill: one pair's db axis over a mesh's devices
# ---------------------------------------------------------------------------

# int32 words before a boundary buffer's column: [0] the rows published
# (nw_affine_tiled.cuh::kShardHead).
SHARD_HEAD = 32


def seqpar_lanes(L2: int, n_dev: int, tile_lanes: int) -> int:
    """Lanes a device owns in one round: the JAX package's rule
    (parallel/seqpar.py:254), round_up(min(tile_lanes, max(ceil(L2 / D),
    128)), 128)."""
    return _round_up(min(tile_lanes, max(-(-L2 // n_dev), 128)), 128)


def shard_strip_lanes(seg_lanes: int) -> int:
    """The shard fill's strips inside a segment of seg_lanes lanes (a
    multiple of 128): the widest of 1024, 512, 256 and 128 lanes that
    divides it."""
    return next(w for w in (1024, 512, 256, 128) if seg_lanes % w == 0)


def shard_schedule(n2s, n_dev: int, seg_lanes: int, strip_lanes: int):
    """The shard fill's work items for db lengths n2s over n_dev launches:
    (items, strips, nseg).  Pair b's db axis is cut into strips of
    strip_lanes lanes (strips[b] of them), seg_lanes // strip_lanes strips
    a segment, segment k in launch k % n_dev; nseg: segments of the longest
    pair (the boundary table's stride).  items[d]: launch d's (pair b,
    strip s, gs) int32 rows in ticket order -- segment-major, then by strip
    within the segment, then by pair -- gs the strip's index in the
    launch's counters and columns, a pair's strips of one segment
    consecutive."""
    S = seg_lanes // strip_lanes
    n2s = np.asarray(n2s, np.int64)
    strips = np.where(n2s > 0, -(-n2s // strip_lanes), 0)
    nseg = max(1, int(-(-int(strips.max(initial=0)) // S)))
    items = []
    for d in range(n_dev):
        rows = []
        for b, nst in enumerate(strips):
            for k in range(d, -(-int(nst) // S), n_dev):
                for j in range(min(S, int(nst) - k * S)):
                    rows.append((k, j, b, k * S + j, len(rows)))
        rows.sort()
        items.append(np.asarray([r[2:] for r in rows],
                                np.int32).reshape(-1, 3))
    return items, strips, nseg


def shard_boundaries(strips, seg_strips: int, n_dev: int):
    """The boundary buffers a mesh's launches hold: per launch d the (pair
    b, segment k) whose column enters segment k >= 1 of pair b, k % n_dev ==
    d (the consumer's launch), in order."""
    out = [[] for _ in range(n_dev)]
    for b, nst in enumerate(strips):
        for k in range(1, -(-int(nst) // seg_strips)):
            out[k % n_dev].append((b, k))
    return out


def check_peer_access(devices, nseg: int, can_access=None, first: int = 0,
                      total: int = 0):
    """The (producer, consumer) cards whose boundary buffers cross cards
    (segment k - 1's launch writes into segment k's, for k < nseg; two
    launches of one card need nothing), after checking that each producer
    can write into its consumer's memory (can_access(a, b), by default
    torch.cuda.can_device_access_peer).  Across processes devices are this
    rank's, global devices first .. first + len(devices) - 1 of total; a
    column to or from another rank goes through host buffers and is not
    checked here.  Raises RuntimeError naming the two cards otherwise:
    between the cards of one process the column goes by peer access only,
    never through the host."""
    if can_access is None:
        can_access = torch.cuda.can_device_access_peer
    D = len(devices)
    total = total or D
    pairs = []
    for k in range(1, nseg):
        gp, gc = (k - 1) % total - first, k % total - first
        if not (0 <= gp < D and 0 <= gc < D):
            continue
        a, b = devices[gp], devices[gc]
        if a == b or (a, b) in pairs:
            continue
        if not can_access(a, b):
            raise RuntimeError(
                f"seqpar: {a} cannot write into {b}'s memory (no peer "
                "access); between the cards of one process the shard fill "
                "hands its column over through peer access only")
        pairs.append((a, b))
    return pairs


def _rank_of(starts, g: int) -> int:
    """The rank holding global device g (parallel/mesh.rank_span's starts)."""
    return bisect.bisect_right(starts, g) - 1


def shard_buffers(strips, seg_strips: int, nseg: int, devices, nrow: int,
                  starts=None, rank: int = 0):
    """This rank's boundary buffers, zeroed: (bufs, table, inbox, outbox).
    bufs: per device the buffers of the columns produced and consumed on
    this rank, on the consumer's device (None where it holds none); table:
    the (B * nseg) int64 addresses every launch of this rank reads (0 for
    segment 0's entry, the closed form, and for columns this rank neither
    produces nor consumes).  Across processes (starts, rank: see
    parallel/mesh.rank_span; one process by default) a column from another
    rank lands in an inbox, one to another rank leaves from an outbox, both
    host tensors (pinned for CUDA devices, whose kernels reach them through
    unified addressing) listed as parallel/relay.RelayEdge."""
    from sequencealigning_tpu_torch.parallel.relay import RelayEdge

    starts = starts or [0, len(devices)]
    first, total = starts[rank], starts[-1]
    table = np.zeros(len(strips) * nseg, np.int64)
    words = SHARD_HEAD + 2 * nrow
    bufs = [[] for _ in devices]
    relayed = {"in": [], "out": []}
    for g, held in enumerate(shard_boundaries(strips, seg_strips, total)):
        for b, k in held:
            src = (k - 1) % total
            r_src, r_dst = _rank_of(starts, src), _rank_of(starts, g)
            if r_dst == rank:
                if r_src == rank:
                    bufs[g - first].append((b, k))
                else:
                    relayed["in"].append((b, k, src, g, r_src))
            elif r_src == rank:
                relayed["out"].append((b, k, src, g, r_dst))

    def place(held, device, pin_it=False):
        t = torch.zeros(len(held) * words, dtype=torch.int32, device=device,
                        pin_memory=pin_it)
        for i, (b, k, *_rest) in enumerate(held):
            table[b * nseg + k] = t.data_ptr() + 4 * i * words
        return t

    bufs = [place(held, dev) if held else None
            for dev, held in zip(devices, bufs)]
    pin = torch.device(devices[0]).type == "cuda"
    edges = {}
    for side, held in relayed.items():
        t = place(held, "cpu", pin) if held else None
        edges[side] = [RelayEdge(b, k, src, dst, peer,
                                 t[i * words:(i + 1) * words])
                       for i, (b, k, src, dst, peer) in enumerate(held)]
    return bufs, table, edges["in"], edges["out"]


def shard_fill_torch(query, db, n1v, n2v, devices, seg_lanes: int,
                     chunk: int, scheme: ScoringScheme, compat: bool,
                     wildcard: bool, group=None) -> torch.Tensor:
    """Plain PyTorch twin of parallel/seqpar.py::_jitted_seqpar's rounds
    with the phases collapsed: round r, device d fills segment k = r * D +
    d (lanes k * W + 1 .. k * W + W, W = seg_lanes) as one tile of
    tile_fill_torch on devices[d], ngc = round_up(L1 + 1, chunk) + W steps,
    and its last lane's column (_next_column) moves to devices[(d + 1) %
    D] (segments past every pair's db are skipped: they hold no corner).
    query: (B, L1), db: (B, L2) int32 codes; n1v/n2v: (B,) int32, on
    devices[0].  Returns the (B, 3) int32 corner finals on devices[0]
    (each pair's corner from the one segment that holds lane n2; the
    n2 = 0 corners in closed form).

    group (parallel/mesh.seqpar_group): every rank of it calls this with
    the same batch and its own devices; D counts every rank's devices
    (parallel/mesh.rank_span), each rank fills its own devices' segments
    in order, a column whose next segment is on another rank is sent there
    (parallel/relay.send_column / recv_column), and the finals are summed
    over the group: every rank returns the same."""
    from sequencealigning_tpu_torch.parallel import relay
    from sequencealigning_tpu_torch.parallel.mesh import rank_span

    starts, me = rank_span(len(devices), group)
    first, D = starts[me], starts[-1]
    tag = relay.next_tag() if group is not None else 0
    W = seg_lanes
    B, L1 = query.shape
    L2 = db.shape[1]
    home = query.device
    n_rounds = max(1, -(-L2 // (D * W)))
    ngc = _round_up(L1 + 1, chunk) + W
    d_all = torch.zeros((B, n_rounds * D * W), dtype=torch.int32,
                        device=home)
    d_all[:, :L2] = db
    qs = _query_steps(query, ngc)
    col = None
    if first == 0:
        col = tuple(t.to(devices[0]) for t in _boundary0(B, ngc, scheme,
                                                          compat, home))
    finals = torch.zeros((B, 3), dtype=torch.int32, device=home)
    # Segments past every pair's last lane hold no corner and feed none.
    n2_max = int(n2v.max()) if B else 0
    for r in range(n_rounds):
        for g in range(D):
            k = r * D + g
            if k * W >= n2_max:
                break
            if not first <= g < first + len(devices):
                continue
            dev = devices[g - first]
            if col is None:
                src = (g - 1) % D
                col = tuple(relay.recv_column(
                    (3, B, ngc), _rank_of(starts, src), group, tag,
                    f"the column entering segment {k} (shard {src} -> "
                    f"shard {g})").to(dev).unbind(0))
            f, brm, brd, brh = tile_fill_torch(
                d_all[:, k * W:(k + 1) * W].to(dev), qs.to(dev), *col,
                n1v.to(dev), n2v.to(dev), k * W + 1, ngc, scheme, compat,
                wildcard)
            finals += f.to(home)
            col = _next_column(brm, brd, brh, W, ngc)
            nxt = (g + 1) % D
            if first <= nxt < first + len(devices):
                col = tuple(t.to(devices[nxt - first]) for t in col)
            else:
                if (k + 1) * W < n2_max:
                    relay.send_column(torch.stack(col), _rank_of(starts, nxt),
                                      group, tag)
                col = None
    if group is not None:
        total, _ = relay.exchange_finals(finals.cpu().numpy(), None, group)
        finals = torch.from_numpy(total.astype(np.int32)).to(home)
    return _empty_db_corners(finals, n1v, n2v, scheme, compat)


def tiled_shard_fill_cuda(query, db, n1v, n2v, devices, seg_lanes: int,
                          scheme: ScoringScheme, compat: bool,
                          wildcard: bool, chunk_rows: int = 0, group=None
                          ) -> torch.Tensor:
    """The shard fill (csrc/nw_affine_tiled.cu, sa_tiled_shard_fill) over
    the CUDA devices of a mesh, one launch a device, all at once: the same
    finals as shard_fill_torch.  query/db/n1v/n2v on devices[0], copied to
    the others; segments of seg_lanes lanes (a multiple of 128) in strips
    of shard_strip_lanes(seg_lanes), the column staged and published every
    chunk_rows rows (default 128).  Each launch runs on a
    stream of its own that waits for its device's current stream, which
    then waits for it.  A device named several times shares its card's
    resident CTAs among its launches, so they are all resident together;
    distinct consecutive cards need peer access (check_peer_access).  The
    devices' finals are added on the host (the psum of the JAX package).

    group (parallel/mesh.seqpar_group): every rank of it calls this with
    the same batch and its own devices, which hold global shards
    starts[rank] .. (parallel/mesh.rank_span); this rank launches only its
    own shards' items, its columns to and from other ranks pass through
    pinned host buffers moved by a parallel/relay.ColumnRelay, the ranks
    meet at a barrier just before the launches (so no launch waits on a
    peer that has not started), and the finals are summed over the group:
    every rank returns the same.

    Raises on a CPU device, a width out of range, a failed launch, or a
    wait that stalled (naming the shards, and across processes the ranks
    whose columns they waited on); across processes every rank raises when
    one fails.  Each launch adds one to ``tiled_shard_fill_cuda.launches``;
    the launches' shapes are left in ``last_launch`` (with each launch's
    CUDA-event ms, and across processes the relay's messages and the
    spread of the ranks' launch times)."""
    from sequencealigning_tpu_torch.parallel.mesh import rank_span
    from sequencealigning_tpu_torch.parallel.relay import (
        ColumnRelay,
        exchange_finals,
        next_tag,
    )

    _check_fill_args(query, db, n1v, n2v)
    devices = [torch.device(d) for d in devices]
    if not devices or any(d.type != "cuda" for d in devices) or not all(
            t.is_cuda for t in (query, db, n1v, n2v)):
        raise ValueError("sa_tiled_shard_fill needs CUDA devices and tensors")
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.index is None else d for d in devices]
    if not all(t.is_contiguous() for t in (query, db, n1v, n2v)):
        raise ValueError("shard fill inputs must be contiguous")
    if seg_lanes <= 0 or seg_lanes % 128:
        raise ValueError(f"segments of {seg_lanes} lanes: not a positive "
                         "multiple of 128")
    W = shard_strip_lanes(seg_lanes)
    R = chunk_rows or CHUNK_ROWS
    if not 2 <= R <= CHUNK_ROWS or R & (R - 1):
        raise ValueError(f"chunk rows {R}: not a power of two in 2.."
                         f"{CHUNK_ROWS}")
    B, L1 = query.shape
    nrow = L1 + 1
    S = seg_lanes // W
    D = len(devices)
    starts, me = rank_span(D, group)
    first, Dg = starts[me], starts[-1]
    n1s, n2s = n1v.cpu().numpy(), n2v.cpu().numpy()
    items, strips, nseg = shard_schedule(n2s, Dg, seg_lanes, W)
    items = items[first:first + D]
    shape = dict(seg_lanes=seg_lanes, strip_lanes=W, seg_strips=S,
                 chunk_rows=R, lanes_per_thread=8 if W % 256 == 0 else 4,
                 shards=D, segments=nseg, strips=[len(i) for i in items],
                 ctas=[0] * D, resident=[0] * D, sms=[0] * D, peers=[],
                 launch_ms=[None] * D)
    if group is not None:
        shape.update(rank=me, ranks=len(starts) - 1, first_shard=first,
                     global_shards=Dg)
    finals = torch.zeros((B, 3), dtype=torch.int32, device=query.device)
    tiled_shard_fill_cuda.last_launch = shape
    if not strips.sum():
        return _empty_db_corners(finals, n1v, n2v, scheme, compat)
    lib = csrc.kernels()
    pairs = check_peer_access(devices, nseg, first=first, total=Dg)
    for a, b in pairs:
        rc = lib.sa_enable_peer(a.index, b.index)
        if rc != 0:
            raise RuntimeError(f"seqpar: enabling {a}'s access to {b} "
                               f"failed (error {rc})")
    shape["peers"] = [f"{a}->{b}" for a, b in pairs]
    # bufs and the relay's edges hold the boundary buffers (the table only
    # their addresses) until the launches are joined.
    bufs, table, inbox, outbox = shard_buffers(  # noqa: F841
        strips, S, nseg, devices, nrow, starts, me)
    relay = None
    if group is not None:
        relay = ColumnRelay(group, inbox, outbox, n1s + 1, next_tag())
    uses = {d: devices.count(d) for d in devices}
    head = 2 + _SM_WORDS * B
    ins, resident_on, runs = {}, {}, []
    failure, stamp = None, 0
    try:
        for d, dev in enumerate(devices):
            if dev not in ins:
                ins[dev] = [t.to(dev) for t in (query, db, n1v, n2v)] + [
                    torch.from_numpy(table).to(dev)]
                with torch.cuda.device(dev):
                    resident_on[dev] = lib.sa_tiled_resident_ctas(
                        W, 2, int(compat), int(wildcard))
            resident = shape["resident"][d] = resident_on[dev]
            if resident < uses[dev]:
                raise RuntimeError(
                    f"sa_tiled_shard_fill: {resident} resident CTAs of {W} "
                    f"lanes on {dev} for {uses[dev]} shards")
        if relay is not None:
            for dev in ins:
                torch.cuda.synchronize(dev)
            dist.barrier(group=group)
            relay.start()
            stamp = time.time_ns()
        for d, dev in enumerate(devices):
            if len(items[d]) == 0:
                continue
            n = len(items[d])
            ctas = shape["ctas"][d] = max(1, min(n, shape["resident"][d]
                                                 // uses[dev]))
            run = dict(dev=dev, shard=first + d,
                       fin=torch.zeros((B, 3), dtype=torch.int32, device=dev),
                       col=torch.empty(n * 2 * nrow, dtype=torch.int32,
                                       device=dev),
                       ctr=torch.zeros(head + 2 * n, dtype=torch.int32,
                                       device=dev),
                       items=torch.from_numpy(items[d]).to(dev),
                       stream=torch.cuda.Stream(device=dev),
                       start=torch.cuda.Event(enable_timing=True),
                       end=torch.cuda.Event(enable_timing=True))
            run["stream"].wait_stream(torch.cuda.current_stream(dev))
            q, dbd, n1d, n2d, tab = ins[dev]
            run["start"].record(run["stream"])
            with torch.cuda.device(dev):
                rc = lib.sa_tiled_shard_fill(
                    q.data_ptr(), dbd.data_ptr(), n1d.data_ptr(),
                    n2d.data_ptr(), run["fin"].data_ptr(),
                    run["col"].data_ptr(), run["ctr"].data_ptr(),
                    run["items"].data_ptr(), tab.data_ptr(), B, L1,
                    db.shape[1], n, n, scheme.match_, scheme.mismatch,
                    scheme.gap_open, scheme.gap_extend, int(compat),
                    int(wildcard), W, S, nseg, R, ctas,
                    run["stream"].cuda_stream)
            if rc != 0:
                raise csrc.launch_error("sa_tiled_shard_fill", rc)
            run["end"].record(run["stream"])
            tiled_shard_fill_cuda.launches += 1
            runs.append(run)
        # Across processes the host waits here, the interpreter left to
        # the relay's threads meanwhile.
        while relay is not None and not all(run["end"].query()
                                            for run in runs):
            time.sleep(1e-3)
    except RuntimeError as e:
        if relay is None:
            raise
        failure = f"seqpar rank {me}: {e}"
    finally:
        # The buffers are freed on the current streams: they wait for
        # every launch made, also when a later one failed.
        for run in runs:
            torch.cuda.current_stream(run["dev"]).wait_stream(run["stream"])
    stalled = []
    total = np.zeros((B, 3), np.int64)
    for run in runs:
        got = run["ctr"][:head].cpu().numpy()
        if got[1] != 0:
            stalled.append(run["shard"])
        masks = got[2:].view(np.uint32).reshape(B, _SM_WORDS)
        d = run["shard"] - first
        shape["sms"][d] = int(_popcounts(np.bitwise_or.reduce(masks, 0)))
        shape["launch_ms"][d] = run["start"].elapsed_time(run["end"])
        total += run["fin"].cpu().numpy()
    if stalled and failure is None:
        waits = [e.name() + f" from rank {e.peer}" for e in inbox
                 if e.dst in stalled
                 and int(e.buf[0]) < int(n1s[e.b]) + 1]
        failure = (
            f"sa_tiled_shard_fill: shard(s) {stalled} of {Dg}"
            + (f" (rank {me})" if group is not None else "")
            + " waited on a neighbour past the spin limit; the finals are "
            "incomplete"
            + (f"; columns from other ranks not complete: {waits}"
               if waits else ""))
    if relay is None:
        if failure is not None:
            raise RuntimeError(failure)
    else:
        relay.finish(failure is None)
        if relay.errors and failure is None:
            failure = f"seqpar rank {me} relay: " + "; ".join(relay.errors)
        shape["relay"] = dict(sent=relay.sent, received=relay.received,
                              block_rows=relay.block, inboxes=len(inbox),
                              outboxes=len(outbox))
        total, stamps = exchange_finals(total, failure, group, stamp)
        shape["launch_skew_ms"] = (max(stamps) - min(stamps)) / 1e6
    finals.copy_(torch.from_numpy(total.astype(np.int32)))
    return _empty_db_corners(finals, n1v, n2v, scheme, compat)


tiled_shard_fill_cuda.launches = 0
tiled_shard_fill_cuda.last_launch = None


def _on_device(tensor, cuda_fn, torch_fn):
    if tensor.is_cuda:
        return cuda_fn()
    if tensor.device.type != "cpu":
        raise ValueError(f"unsupported device {tensor.device}")
    return torch_fn()


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------


def nw_affine_tiled_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    tile_lanes: int = 4096,
) -> np.ndarray:
    """Exact Gotoh corner finals (B, 3) for pairs of any length, from a
    padded batch held as tensors (device.to_device): kernel #4 on CUDA
    tensors, the plain fill at tile_lanes on CPU tensors."""
    args = (query, db, query_len, db_len, scheme, compat, wildcard)
    finals = _on_device(
        query, lambda: tiled_fill_cuda(*args),
        lambda: tiled_fill_torch(*args, tile_lanes=tile_lanes))
    return finals.cpu().numpy()


def nw_affine_tiled_fold_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    tile_lanes: int = 8192,
) -> np.ndarray:
    """Exact Gotoh corner finals (B, 3) for a small batch (B <= 4) of long
    pairs in one launch: kernel #5 on CUDA tensors, the plain folded fill on
    CPU tensors; more pairs raise.  Every pair runs to the longest pair's
    tile grid in the plain fill and to its own on the card."""
    args = (query, db, query_len, db_len, scheme, compat, wildcard)
    finals = _on_device(
        query, lambda: tiled_fold_fill_cuda(*args),
        lambda: tiled_fold_fill_torch(*args, tile_lanes=tile_lanes))
    return finals.cpu().numpy()


def nw_affine_tiled_single(
    query: bytes,
    db: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    tile_lanes: int = 8192,
    *,
    device="cuda",
) -> np.ndarray:
    """Exact Gotoh corner finals (3,) for one pair of any length on
    ``device``: the B = 1 case of nw_affine_tiled_fold_batch.  The pair is
    packed unpadded (an empty sequence as one PAD column), as the JAX
    package packs it."""
    tb = to_device(pack_batch([(query, db)], len_multiple=1), device)
    return nw_affine_tiled_fold_batch(
        *tb, scheme=scheme, compat=compat, wildcard=wildcard,
        tile_lanes=tile_lanes,
    )[0]

"""Batched linear/gap-state Needleman-Wunsch fill (anti-diagonal): the port
of ops/nw_linear.py.

The reference's linear module (src/needleman_wunsch.rs, revived as
Algo.NW_LINEAR): one score plane plus a per-cell gap flag, swept along
anti-diagonals with each pair's db on the lane axis (lane x of diagonal d is
cell (x, d - x); lanes 0 and d are the boundaries).  Global mode keeps the
reference's double-initialised origin (2*o, compat); local mode is its
Smith-Waterman-style variant (negative cells keep score 0 with cleared
paths, and traceback starts from every cell scoring the pair's maximum,
needleman_wunsch.rs:88-90, 106-116).

Path bits per cell, byte d & 3 of word dirs[d >> 2, b, x] (4 diagonals a
word, as ops.dirbits packs them):
  bit0 DOWN  (consume seq1/query, gap in db)
  bit1 RIGHT (consume seq2/db, gap in query)
  bit2 DIAG
  bit3 ISMAX (local mode only: the cell scores the pair's maximum)

Local mode runs two passes: pass 1 computes each pair's maximum, pass 2
writes the bits with ISMAX.  Two implementations of the fill, chosen by the
tensors' device:

* ``linear_fill_torch`` -- plain PyTorch, the twin of _linear_fill_lax
  (CPU tensors, and the reference the kernel is checked against);
* ``linear_fill_cuda`` -- the hand-written kernel (``csrc/nw_linear.cu``;
  CUDA tensors only): each pair's lanes over a cluster of a few CTAs, up to
  CUDA_LINEAR_LANES lanes, the warps handing their edge lanes over through
  rings, each sweeping only the steps that hold cells of the pair's matrix
  (every other path-bit byte 0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.errors import AlignmentError
from sequencealigning_tpu_torch.io.encode import round_up as _round_up
from sequencealigning_tpu_torch.ops.nw_affine import (
    _bit,
    pair_launch_shape,
    query_column,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream import (
    check_stream_stalls,
    forced_knobs,
    watch_status,
)
from sequencealigning_tpu_torch.ops.step_graph import CounterPacker, run_steps

LDOWN, LRIGHT, LDIAG, LISMAX = 1, 2, 4, 8
NEGBIG = -(2 ** 30)
# The widest row the kernel takes: a cluster of 16 CTAs of 8192 lanes
# (csrc/cluster_split.cuh).  Past it one pair's bytes alone pass ~34 GB.
CUDA_LINEAR_LANES = 16 * 8192


class LinearResult(NamedTuple):
    """score: (B,) int32 on the host -- the corner score (global) or the
    matrix maximum (local).  dirs: (ceil(D_total/4), B, P) uint32 path bits
    on the fill's device (None in score-only mode)."""

    score: np.ndarray
    dirs: Optional[torch.Tensor]


def _check_args(seq1, s2v, n1v, n2v, maxv, l1: int, l2: int):
    B, P = s2v.shape
    for name, t, shape in (
        ("seq1", seq1, (B, seq1.shape[1])), ("s2v", s2v, (B, P)),
        ("n1v", n1v, (B,)), ("n2v", n2v, (B,)), ("maxv", maxv, (B,)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != s2v.device:
            raise ValueError(f"{name} is on {t.device}, not {s2v.device}")
    if seq1.shape[1] < 1 or P % 128 or P < l2 + 1 or l1 < 0 or l2 < 0:
        raise ValueError(f"bad linear layout: L1p {seq1.shape[1]}, P {P}, "
                         f"l1 {l1}, l2 {l2}")


# ---------------------------------------------------------------------------
# Plain PyTorch fill
# ---------------------------------------------------------------------------


def linear_step_torch(S2, S1, G1, s1d, col, s2v, d: torch.Tensor, lane, n1,
                      n2, maxv, scheme: ScoringScheme, compat: bool,
                      local: bool, with_dirs: bool):
    """Diagonal d (a 0-d tensor: the plain loop's counter, ops.step_graph)
    of the twin of _linear_fill_lax's body: S2/S1 (B, P) int32 scores two
    and one diagonals back, G1 the gap flags, s1d the query codes on the
    lanes, col (B,) the code entering lane 0; n1/n2/maxv (B, 1).  Returns
    (s_new, gap_new, s1d_new, valid, bits or None)."""
    o, e = scheme.gap_open, scheme.gap_extend
    lane_0 = lane == 0
    s1d_new = torch.where(lane_0, col[:, None], torch.roll(s1d, 1, 1))
    sub = torch.where(s1d_new == s2v, scheme.match_, scheme.mismatch)
    diag = torch.roll(S2, 1, 1) + sub
    right_src = torch.roll(S1, 1, 1)
    if compat:
        down = S1 + torch.where(G1, e, o)
        right = right_src + torch.where(torch.roll(G1, 1, 1), e, o)
    else:
        down = S1 + e
        right = right_src + e
    mx = torch.maximum(diag, torch.maximum(down, right)).to(torch.int32)
    gap_new = (mx == down) | (mx == right)
    s_new = torch.where(mx < 0, 0, mx) if local else mx

    on_boundary = lane_0 | (lane == d)
    origin = d == 0
    if local:
        bscal, bgap = 0, False
    elif compat:
        bscal, bgap = torch.where(origin, 2 * o, d * e + o), True
    else:
        bscal, bgap = torch.where(origin, 0, d * e), True
    s_new = torch.where(on_boundary, bscal, s_new).to(torch.int32)
    gap_new = torch.where(on_boundary, bgap, gap_new)
    valid = (lane <= n2) & (lane >= d - n1) & (lane <= d) & (d <= n1 + n2)

    bits = None
    if with_dirs:
        bits = _bit(mx == down, LDOWN) | _bit(mx == right, LRIGHT)
        bits |= _bit(mx == diag, LDIAG)
        if local:
            ismax = _bit((s_new == maxv) & valid, LISMAX)
            bits = torch.where(mx < 0, 0, bits) | ismax
            b_bound = ismax
        else:
            b_bound = torch.where(origin, LRIGHT | LDOWN,
                                  torch.where(lane_0, LDOWN, LRIGHT))
        bits = torch.where(on_boundary, b_bound, bits).to(torch.int32)
    return s_new, gap_new, s1d_new, valid, bits


def linear_fill_torch(
    seq1, s2v, n1v, n2v, maxv, l1: int, l2: int,
    scheme: ScoringScheme, compat: bool, local: bool, with_dirs: bool,
):
    """Plain PyTorch twin of _linear_fill_lax: a loop over the D_total =
    l1 + l2 + 1 diagonals.  seq1: (B, L1p) int32 query codes; s2v: (B, P)
    int32 db codes at lanes 1..l2; n1v/n2v: (B,) int32 lengths (the corner
    is lane n2 of diagonal n1 + n2); maxv: (B,) int32, pass 1's maxima
    (local with dirs).  Returns (corner (B,) int32, run_max (B,) int32,
    dirs (ceil(D_total/4), B, P) uint32 or None).  The diagonal is a device
    counter and the state updates in place, so on the card the loop
    replays as CUDA graphs (ops.step_graph)."""
    _check_args(seq1, s2v, n1v, n2v, maxv, l1, l2)
    B, P = s2v.shape
    dev = s2v.device
    D_total = l1 + l2 + 1
    lane = torch.arange(P, dtype=torch.int32, device=dev)[None, :].expand(
        B, P)
    n1, n2, mv = n1v[:, None], n2v[:, None], maxv[:, None]
    S2, S1, runmax = (torch.full((B, P), NEGBIG, dtype=torch.int32,
                                 device=dev) for _ in range(3))
    G1 = torch.zeros((B, P), dtype=torch.bool, device=dev)
    s1d = torch.zeros((B, P), dtype=torch.int32, device=dev)
    corner = torch.zeros((B,), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    n2l = n2v.long()
    pack = None
    if with_dirs:
        pack = CounterPacker(torch.empty((-(-D_total // 4), B, P),
                                         dtype=torch.uint32, device=dev), 4)
    d = torch.zeros((), dtype=torch.int64, device=dev)

    def diagonal():
        s_new, gap, s1d_new, valid, bits = linear_step_torch(
            S2, S1, G1, s1d, query_column(seq1, d), s2v, d, lane, n1, n2, mv,
            scheme, compat, local, with_dirs)
        # Each pair's corner: lane n2 on its diagonal n1 + n2.
        corner.add_(torch.where(n1v + n2v == d, s_new[rows, n2l], 0))
        runmax.copy_(torch.maximum(runmax,
                                   torch.where(valid, s_new, NEGBIG)))
        if pack is not None:
            pack.add(d, bits)
        S2.copy_(S1)
        for dst, src in ((S1, s_new), (G1, gap), (s1d, s1d_new)):
            dst.copy_(src)

    run_steps(diagonal, d, D_total)
    return (corner.to(torch.int32), runmax.max(1).values,
            pack.dirs if pack is not None else None)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def linear_fill_cuda(
    seq1, s2v, n1v, n2v, maxv, l1: int, l2: int,
    scheme: ScoringScheme, compat: bool, local: bool, with_dirs: bool,
    cta_lanes: int = 0,
):
    """The linear kernel (csrc/nw_linear.cu) on CUDA tensors: the corners
    and maxima of linear_fill_torch, and its path bits on every cell of each
    pair's matrix, every other byte 0.  Each pair is split over a few CTAs
    (cta_lanes > 0 forces their width, a multiple of 128), the rings as
    forced_ring leaves them; the launch's shape is left in
    ``linear_fill_cuda.last_launch``.  Returns without waiting for the
    kernel; raises ValueError on a CPU tensor, a non-contiguous input or a
    lane width past CUDA_LINEAR_LANES, RuntimeError on a failed launch, and
    check_stream_stalls raises for a stalled wait."""
    _check_args(seq1, s2v, n1v, n2v, maxv, l1, l2)
    if not s2v.is_cuda:
        raise ValueError("linear_fill_cuda needs CUDA tensors")
    ins = (seq1, s2v, n1v, n2v, maxv)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("linear fill inputs must be contiguous")
    check_stream_stalls()
    lib = csrc.kernels()
    B, P = s2v.shape
    shape = pair_launch_shape(lib, P, B, cta_lanes, kernel="linear",
                              **forced_knobs())
    dev = s2v.device
    D_total = l1 + l2 + 1
    corner = torch.zeros((B,), dtype=torch.int32, device=dev)
    runmax = torch.full((B,), NEGBIG, dtype=torch.int32, device=dev)
    dirs = None
    if with_dirs:
        dirs = torch.empty((-(-D_total // 4), B, P), dtype=torch.uint32,
                           device=dev)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = lib.sa_linear_fill(
            *(t.data_ptr() for t in ins), corner.data_ptr(),
            runmax.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            B, seq1.shape[1], P, D_total, scheme.match_, scheme.mismatch,
            scheme.gap_open, scheme.gap_extend, int(with_dirs), int(compat),
            int(local), cta_lanes, status.data_ptr(),
            shape["lanes_per_thread"], shape["chunk"], shape["ring_slots"],
            stream.cuda_stream,
        )
        if rc != 0:
            raise csrc.launch_error("sa_linear_fill", rc, shape["ctas"])
        watch_status("sa_linear_fill", status, stream)
    linear_fill_cuda.last_launch = shape
    linear_fill_cuda.launches += 1
    return corner, runmax, dirs


linear_fill_cuda.launches = 0
linear_fill_cuda.last_launch = None


def linear_fill(seq1, s2v, n1v, n2v, maxv, l1, l2, scheme, compat, local,
                with_dirs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (seq1, s2v, n1v, n2v, maxv, l1, l2, scheme, compat, local,
            with_dirs)
    if s2v.is_cuda:
        return linear_fill_cuda(*args)
    if s2v.device.type != "cpu":
        raise ValueError(f"unsupported device {s2v.device}")
    return linear_fill_torch(*args)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def linear_inputs(query, db, query_len, db_len):
    """The fill's inputs of a padded batch held as tensors, on its device:
    (seq1, s2v (P = round_up(L2 + 1, 128) lanes, db at lanes 1..L2), n1v,
    n2v)."""
    B, L2 = db.shape
    P = _round_up(L2 + 1, 128)
    s2v = torch.zeros((B, P), dtype=torch.int32, device=db.device)
    s2v[:, 1: L2 + 1] = db
    return (query.to(torch.int32).contiguous(), s2v,
            query_len.to(torch.int32).contiguous(),
            db_len.to(torch.int32).contiguous())


def nw_linear_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    local: bool = False,
    with_dirs: bool = True,
) -> LinearResult:
    """Batched linear/gap-state NW fill of a padded batch held as tensors
    (device.to_device).  The scores come to the host; the path bits stay
    on the batch's device.  On CUDA a row past CUDA_LINEAR_LANES lanes
    raises AlignmentError naming its lane count."""
    seq1, s2v, n1v, n2v = linear_inputs(query, db, query_len, db_len)
    if s2v.is_cuda and s2v.shape[1] > CUDA_LINEAR_LANES:
        raise AlignmentError(
            f"the linear fill's row of {s2v.shape[1]} lanes passes the CUDA "
            f"kernel's {CUDA_LINEAR_LANES}")
    a = (seq1, s2v, n1v, n2v)
    l1, l2 = query.shape[1], db.shape[1]
    zeros = torch.zeros_like(n1v)
    if local:
        _, run_max, _ = linear_fill(*a, zeros, l1, l2, scheme, compat, True,
                                    False)
        _, score, dirs = linear_fill(*a, run_max.contiguous(), l1, l2,
                                     scheme, compat, True, with_dirs)
    else:
        score, _, dirs = linear_fill(*a, zeros, l1, l2, scheme, compat,
                                     False, with_dirs)
    score = score.cpu().numpy()
    check_stream_stalls()
    return LinearResult(score=score, dirs=dirs)

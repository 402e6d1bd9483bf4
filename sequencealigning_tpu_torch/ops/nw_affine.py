"""Per-pair batched Gotoh fill (kernel #7) and the per-diagonal Gotoh step
with its boundary-mode hook: the port of ops/nw_affine.py.

A per-pair anti-diagonal fill keeps each pair's db on the lane axis: lane x
of diagonal d is cell (x, y = d - x), lane 0 and lane d are the boundaries.
The ``mode`` hook is the only recurrence difference between the affine
modes: "global" writes the compat/textbook gap chains on the boundaries,
"semi" free end gaps (M = 0, I = D = -inf), and "local" adds the
Smith-Waterman clamp M = max(M, 0) with each restart recorded as the LSTART
direction bit.

The global fill of a batch (``nw_affine_batch``) sweeps each pair's
D_total = L1 + L2 + 1 anti-diagonals over P = round_up(L2 + 1, 128) lanes
with ``s2v[:, 1:L2+1] = db`` preloaded, captures M/I/D on each pair's
diagonal dsum = n1 + n2 at the lanes of n2mask (lane n2), and on request
keeps the full 7-bit direction bytes (ops.dirbits), byte d & 3 of word
``dirs[d >> 2, b, x]``, in ceil(D_total / 4) words (the lax twin's length),
the layout ops.traceback.traceback_pair reads.  Two implementations of the
fill, chosen by the tensors' device:

* ``gotoh_fill_torch`` -- plain PyTorch, the twin of _gotoh_fill_lax (CPU
  tensors, and the reference the kernel is checked against);
* ``gotoh_fill_cuda`` -- the hand-written kernel (``csrc/nw_affine.cu``;
  CUDA tensors only): each pair's lanes over a cluster of a few CTAs, the
  warps handing their edge lanes over through rings, each sweeping only the
  steps that hold cells of the pair's matrix (every other dirs byte 0).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
from sequencealigning_tpu_torch.io.encode import round_up as _round_up
from sequencealigning_tpu_torch.ops import dirbits
from sequencealigning_tpu_torch.ops.step_graph import (
    CounterPacker,
    run_steps,
    to_i32,
)

MODES = ("global", "semi", "local")


def _bit(mask: torch.Tensor, value: int) -> torch.Tensor:
    return mask.to(torch.int32) * value


def _roll(a: torch.Tensor) -> torch.Tensor:
    """The lane shift x-1 -> x on a torus (lane 0 receives lane P-1), as
    jnp.roll(a, 1, axis=1)."""
    return torch.roll(a, 1, dims=1)


def apply_boundaries(M, I, D, restart, p: torch.Tensor,
                     scheme: ScoringScheme, compat: bool, mode: str,
                     neg: Optional[int] = None):
    """Write the boundary cells of local diagonal p (a 0-d tensor: the step
    counter of the plain loops, ops.step_graph) into M/I/D in place: lanes
    p and 0, lane 0 winning at p == 0 (the origin).  Global mode writes the
    gap chains of the JAX package's _boundary_scalars (compat: o+(p+1)e in
    D on row 0 and in I on column 0; textbook: o+p*e in the other plane);
    semi and local write M = 0, I = D = -inf, and local marks them
    restarts.  A lane p at or past the lane width does not exist and takes
    nothing.  neg: the int16 stream state's sentinel -- the -inf of the
    modes, and the floor of every global boundary value -- or None for
    int32 state (NEG_INF, no floor)."""
    lane = torch.arange(M.shape[1], device=M.device)[None, :]
    at_0, at_p = lane == 0, lane == p
    if mode != "global":
        edge = at_0 | at_p
        inf = NEG_INF if neg is None else neg
        for t, v in ((M, 0), (I, inf), (D, inf)):
            t.masked_fill_(edge, v)
        if restart is not None:
            restart.masked_fill_(edge, 1)
        return
    o, e = scheme.gap_open, scheme.gap_extend
    origin = p == 0
    m_b = torch.where(origin, 0, NEG_INF)
    chain = torch.where(origin, NEG_INF,
                        o + (p + 1) * e if compat else o + p * e)
    neg_b = torch.full_like(m_b, NEG_INF)
    row0, col0 = ((m_b, neg_b, chain), (m_b, chain, neg_b)) if compat else (
        (m_b, chain, neg_b), (m_b, neg_b, chain))
    if neg is not None:
        row0, col0 = ([v.clamp(min=neg) for v in vs] for vs in (row0, col0))
    for t, v0, vp in zip((M, I, D), row0, col0):
        t.copy_(torch.where(at_0, v0, torch.where(at_p, vp, t)).to(t.dtype))


def gotoh_step_torch(
    H2, H1, M1, I1, D1, s1d, seq1_col, s2v, d: torch.Tensor,
    scheme: ScoringScheme, compat: bool, wildcard: bool, with_dirs: bool,
    mode: str = "global",
):
    """Diagonal d from diagonals d-1 (M1/I1/D1, H1) and d-2 (H2): the twin
    of ops/nw_affine.py::_gotoh_step.  All state (B, P) int32, seq1_col
    (B,) the query code entering at lane 0, d a 0-d tensor.  Returns (M, I,
    D, H, s1d_new, byte) with byte None when with_dirs is False."""
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
    apply_boundaries(M, I, D, restart, d, scheme, compat, mode)
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


def diag_state(B: int, P: int, device):
    """The rolling state of a per-pair plain fill: H2, H1, M1, I1, D1 (at
    NEG_INF) and s1d (at 0), each its own (B, P) int32 tensor."""
    state = [torch.full((B, P), NEG_INF, dtype=torch.int32, device=device)
             for _ in range(5)]
    return state + [torch.zeros((B, P), dtype=torch.int32, device=device)]


def advance_diag(state, M, I, D, H, s1d):
    """Shift a diagonal's results into the rolling state, in place."""
    H2, H1, M1, I1, D1, s1d_old = state
    H2.copy_(H1)
    for dst, src in ((H1, H), (M1, M), (I1, I), (D1, D), (s1d_old, s1d)):
        dst.copy_(src)


def query_column(seq1, d: torch.Tensor):
    """(B,) the query code entering lane 0 on diagonal d:
    seq1[:, clip(d - 1, 0, L1p - 1)]."""
    at = (d - 1).clamp(0, seq1.shape[1] - 1).view(1)
    return seq1.index_select(1, at)[:, 0]


# ---------------------------------------------------------------------------
# The per-pair global fill (kernel #7)
# ---------------------------------------------------------------------------


class GotohResult(NamedTuple):
    """finals: (B, 3) int32 -- M/I/D at (n2[b], n1[b]), on the host.
    dirs: (ceil(D_total/4), B, P) uint32 direction bytes on the fill's
    device (None in score-only mode)."""

    finals: np.ndarray
    dirs: Optional[torch.Tensor]


def _check_gotoh_args(seq1, s2v, dsum, n2mask, l1: int, l2: int):
    B = seq1.shape[0]
    P = s2v.shape[1]
    for name, t, shape in (
        ("seq1", seq1, (B, seq1.shape[1])), ("s2v", s2v, (B, P)),
        ("dsum", dsum, (B, 1)), ("n2mask", n2mask, (B, P)),
    ):
        if t.dtype != torch.int32 or t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != seq1.device:
            raise ValueError(f"{name} is on {t.device}, not {seq1.device}")
    if seq1.shape[1] < 1 or P % 128 or P < l2 + 1 or l1 < 0 or l2 < 0:
        raise ValueError(f"bad per-pair layout: L1p {seq1.shape[1]}, P {P}, "
                         f"l1 {l1}, l2 {l2}")


def gotoh_fill_torch(
    seq1, s2v, dsum, n2mask, l1: int, l2: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, with_dirs: bool,
):
    """Plain PyTorch twin of _gotoh_fill_lax: a loop over the D_total =
    l1 + l2 + 1 diagonals.  seq1: (B, L1p) int32 query codes; s2v: (B, P)
    int32 db codes at lanes 1..l2; dsum: (B, 1) int32 n1 + n2; n2mask:
    (B, P) int32, non-zero at the capture lane.  Returns (finals (B, 3)
    int32, dirs (ceil(D_total/4), B, P) uint32 or None).  The diagonal is
    a device counter and the state updates in place, so on the card the
    loop replays as CUDA graphs (ops.step_graph)."""
    _check_gotoh_args(seq1, s2v, dsum, n2mask, l1, l2)
    B, P = s2v.shape
    dev = s2v.device
    D_total = l1 + l2 + 1
    state = diag_state(B, P, dev)
    mask = (n2mask != 0).to(torch.int32)
    finals = torch.zeros((B, 3), dtype=torch.int64, device=dev)
    pack = None
    if with_dirs:
        pack = CounterPacker(torch.empty((-(-D_total // 4), B, P),
                                         dtype=torch.uint32, device=dev), 4)
    d = torch.zeros((), dtype=torch.int64, device=dev)

    def diagonal():
        M, I, D, H, s1d, byte = gotoh_step_torch(
            *state, query_column(seq1, d), s2v, d, scheme, compat, wildcard,
            with_dirs,
        )
        # Each pair's corner lies on its diagonal dsum, at the lanes of
        # n2mask.
        got = torch.stack([(t * mask).sum(1, dtype=torch.int64)
                           for t in (M, I, D)], dim=1)
        finals.add_(torch.where(dsum == d, got, 0))
        if pack is not None:
            pack.add(d, byte)
        advance_diag(state, M, I, D, H, s1d)

    run_steps(diagonal, d, D_total)
    finals = to_i32(finals & 0xFFFFFFFF)
    return finals, pack.dirs if pack is not None else None


def _ring_helpers():
    """ops.nw_affine_stream's (check_stream_stalls, forced_knobs,
    watch_status), imported on use: that module imports this one."""
    from sequencealigning_tpu_torch.ops import nw_affine_stream as ring

    return ring.check_stream_stalls, ring.forced_knobs, ring.watch_status


def pair_launch_shape(lib, P: int, B: int, cta_lanes: int = 0,
                      lanes_per_thread: int = 0, chunk: int = 0,
                      ring_slots: int = 0, wrap_words: int = 0,
                      kernel: str = "per-pair") -> dict:
    """The per-pair fills' launch shape (kernels #6 and #7 and the linear
    fill) for B pairs of P lanes, the defaults resolved
    (stream_ring.cuh::pair_launch_shape, through ``lib.sa_pair_plan`` or
    the host build's ``hc_pair_plan``; the split follows the card's SM
    count).  wrap_words is accepted for forced_ring's sake and unused.
    Raises ValueError, naming ``kernel``, when the shape is out of range."""
    shape = (ctypes.c_int * 5)()
    plan_fn = getattr(lib, "sa_pair_plan", None) or lib.hc_pair_plan
    if plan_fn(P, B, cta_lanes, lanes_per_thread, chunk, ring_slots,
               shape) != 0:
        raise ValueError(
            f"lane width {P} (CTA width {cta_lanes}, {lanes_per_thread} "
            f"lanes a thread, ring {chunk}/{ring_slots}) is out of the CUDA "
            f"{kernel} kernel's range")
    return dict(zip(("lanes_per_thread", "threads", "ctas", "chunk",
                     "ring_slots"), shape))


def corner_lanes(dsum, n2mask):
    """The corners of a per-pair layout on its device, as (n1, n2) (B,)
    int32: n2 the first lane of n2mask (-1 where none is set) and n1 =
    dsum - n2."""
    hit = n2mask != 0
    n2 = torch.where(hit.any(1), hit.to(torch.int32).argmax(1), -1)
    n2 = n2.to(torch.int32).contiguous()
    return (dsum[:, 0] - n2).to(torch.int32).contiguous(), n2


def gotoh_fill_cuda(
    seq1, s2v, dsum, n2mask, l1: int, l2: int,
    scheme: ScoringScheme, compat: bool, wildcard: bool, with_dirs: bool,
    cta_lanes: int = 0,
):
    """The per-pair global kernel (csrc/nw_affine.cu) on CUDA tensors: the
    finals of gotoh_fill_torch for a layout with one n2mask lane a pair
    (corner_lanes; every caller's), and its dirs on every cell of each
    pair's matrix, but lane 0's D bits and every byte outside the matrix 0.
    Each pair is split over a few CTAs (cta_lanes > 0 forces their width, a
    multiple of 128), the rings as forced_ring leaves them; the launch's
    shape is left in ``gotoh_fill_cuda.last_launch``.  Returns without
    waiting for the kernel; raises on a CPU tensor, a non-contiguous input,
    an unsupported shape or a failed launch, and check_stream_stalls raises
    for a stalled wait."""
    check_stream_stalls, forced_knobs, watch_status = _ring_helpers()
    _check_gotoh_args(seq1, s2v, dsum, n2mask, l1, l2)
    if not seq1.is_cuda:
        raise ValueError("gotoh_fill_cuda needs CUDA tensors")
    if not all(t.is_contiguous() for t in (seq1, s2v, dsum, n2mask)):
        raise ValueError("gotoh fill inputs must be contiguous")
    check_stream_stalls()
    lib = csrc.kernels()
    B, P = s2v.shape
    shape = pair_launch_shape(lib, P, B, cta_lanes, kernel="global",
                              **forced_knobs())
    dev = s2v.device
    D_total = l1 + l2 + 1
    n1, n2 = corner_lanes(dsum, n2mask)
    finals = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    dirs = None
    if with_dirs:
        dirs = torch.empty((-(-D_total // 4), B, P), dtype=torch.uint32,
                           device=dev)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = lib.sa_gotoh_fill(
            seq1.data_ptr(), s2v.data_ptr(), n1.data_ptr(), n2.data_ptr(),
            finals.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            B, seq1.shape[1], P, D_total,
            scheme.match_, scheme.mismatch, scheme.gap_open,
            scheme.gap_extend, 2 if with_dirs else 0, int(compat),
            int(wildcard), cta_lanes, status.data_ptr(),
            shape["lanes_per_thread"], shape["chunk"], shape["ring_slots"],
            stream.cuda_stream,
        )
        if rc != 0:
            raise csrc.launch_error("sa_gotoh_fill", rc, shape["ctas"])
        watch_status("sa_gotoh_fill", status, stream)
    gotoh_fill_cuda.last_launch = shape
    gotoh_fill_cuda.launches += 1
    return finals, dirs


gotoh_fill_cuda.launches = 0
gotoh_fill_cuda.last_launch = None


def gotoh_fill(seq1, s2v, dsum, n2mask, l1, l2, scheme, compat, wildcard,
               with_dirs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (seq1, s2v, dsum, n2mask, l1, l2, scheme, compat, wildcard,
            with_dirs)
    if seq1.is_cuda:
        return gotoh_fill_cuda(*args)
    if seq1.device.type != "cpu":
        raise ValueError(f"unsupported device {seq1.device}")
    return gotoh_fill_torch(*args)


def gotoh_layout(db: torch.Tensor, query_len: torch.Tensor,
                 db_len: torch.Tensor):
    """(B, L2) db codes and (B,) lengths -> the fill's (s2v, dsum, n2mask)
    on the batch's device: P = round_up(L2 + 1, 128) lanes with db at
    lanes 1..L2, dsum = n1 + n2 as (B, 1), n2mask one-hot at lane n2."""
    B, L2 = db.shape
    P = _round_up(L2 + 1, 128)
    dev = db.device
    s2v = torch.zeros((B, P), dtype=torch.int32, device=dev)
    s2v[:, 1: L2 + 1] = db
    dlen = db_len.to(device=dev, dtype=torch.int32)
    dsum = (query_len.to(device=dev, dtype=torch.int32) + dlen)[:, None]
    lanes = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    n2mask = (lanes == dlen[:, None]).to(torch.int32)
    return s2v, dsum.contiguous(), n2mask


def nw_affine_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    with_dirs: bool = True,
) -> GotohResult:
    """Batched Gotoh fill of a padded batch held as tensors
    (device.to_device): finals (B, 3) = M/I/D at each pair's true corner on
    the host, plus the full direction bytes on the batch's device for
    ops.traceback.traceback_pair."""
    query = query.to(torch.int32).contiguous()
    s2v, dsum, n2mask = gotoh_layout(db, query_len, db_len)
    finals, dirs = gotoh_fill(query, s2v, dsum, n2mask, query.shape[1],
                              db.shape[1], scheme, compat, wildcard,
                              with_dirs)
    finals = finals.cpu().numpy()
    check_stream_stalls, _, _ = _ring_helpers()
    check_stream_stalls()
    return GotohResult(finals=finals, dirs=dirs)

"""Per-pair semi-global and local Gotoh fill (textbook semantics): the port
of ops/nw_affine_modes.py.

Each pair keeps its db on the lane axis, P = round_up(L2 + 1, 128) lanes
with ``s2v[:, 1:L2+1] = db`` preloaded, and the sweep runs over the
D_total = L1 + L2 + 1 anti-diagonals; lane 0 and lane d are the
boundaries (ops.nw_affine.gotoh_step_torch, mode "semi" or "local").
Instead of corner finals the fill keeps a per-lane running argmax (best
score, its diagonal) over the mode's eligible cells, and ``modes_reduce``
turns it into each pair's end cell.  Direction codes are full bytes
(ops.dirbits plus LSTART), byte d & 3 of word ``dirs[d >> 2, b, x]``, in
ceil(D_total / 4) words (the lax twin's length; the TPU kernel pads to
whole 128-diagonal chunks).

Two implementations of the fill, chosen by the tensors' device:

* ``fill_modes_torch`` -- plain PyTorch, the twin of _fill_modes_lax (CPU
  tensors, and the reference the kernel is checked against);
* ``modes_fill_cuda`` -- the hand-written kernel (``csrc/nw_affine_modes.cu``;
  CUDA tensors only): each pair's lanes over a cluster of a few CTAs, the
  warps handing their edge lanes over through rings, each sweeping only the
  steps that hold cells of the pair's matrix (every other dirs byte 0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.io.encode import round_up as _round_up
from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.ops.nw_affine import (
    advance_diag,
    diag_state,
    gotoh_step_torch,
    pair_launch_shape,
    query_column,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream import (
    check_stream_stalls,
    forced_knobs,
    watch_status,
)
from sequencealigning_tpu_torch.ops.step_graph import CounterPacker, run_steps

# Initial value of the running argmax (below every reachable score).
NEGBIG = -(2 ** 24)


class ModesResult(NamedTuple):
    """best/best_x/best_y: (B,) per-pair end cell (score, x, y), reduced on
    the fill's device; dirs: (ceil(D_total/4), B, P) uint32 full bytes on
    that device, or None."""

    best: np.ndarray
    best_x: np.ndarray
    best_y: np.ndarray
    dirs: Optional[torch.Tensor]


def modes_reduce(bv: torch.Tensor, bd: torch.Tensor):
    """Per-pair end cell (score, x, y), each (B,) int32 on the buffers'
    device, from (B, P) per-lane running argmax buffers.  Ties go to the
    smallest lane (torch.argmax returns the first maximal index, as
    jnp.argmax does), then to that lane's recorded diagonal, the earliest
    since the fills update on strict > only.  As
    ops/nw_affine_modes.py::modes_reduce."""
    best = bv.max(dim=1).values.to(torch.int32)
    lane = torch.argmax(bv, dim=1)
    d = torch.gather(bd, 1, lane[:, None])[:, 0]
    lane = lane.to(torch.int32)
    return best, lane, (d - lane).to(torch.int32)


def mode_candidates(mode: str, M, H, x_iota, pd: int, n1, n2):
    """(eligible mask, score) of the running argmax at local diagonal pd
    of pairs with lengths n1/n2 (broadcastable to M; n2 = -1 for no pair):
    local takes M on 1 <= x <= n2, 1 <= y <= n1; semi takes H on the valid
    cells of the last row or column.  As _fill_modes_lax and
    ops/nw_affine_stream_modes.py::_mode_candidates."""
    y = pd - x_iota
    if mode == "local":
        elig = (x_iota >= 1) & (x_iota <= n2) & (y >= 1) & (y <= n1)
        return elig, M
    valid = (x_iota >= 0) & (x_iota <= n2) & (y >= 0) & (y <= n1)
    return valid & ((x_iota == n2) | (y == n1)), H


def _check_modes_args(seq1, s2v, n1v, n2v, l2: int):
    B = seq1.shape[0]
    for name, t, shape in (
        ("seq1", seq1, (B, seq1.shape[1])), ("s2v", s2v, (B, s2v.shape[1])),
        ("n1v", n1v, (B,)), ("n2v", n2v, (B,)),
    ):
        if t.dtype != torch.int32 or t.dim() != len(shape) or (
                tuple(t.shape) != shape):
            raise ValueError(f"{name}: expected int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != seq1.device:
            raise ValueError(f"{name} is on {t.device}, not {seq1.device}")
    if seq1.shape[1] < 1 or s2v.shape[1] % 128 or s2v.shape[1] < l2 + 1:
        raise ValueError(f"bad per-pair layout: L1 {seq1.shape[1]}, P "
                         f"{s2v.shape[1]}, L2 {l2}")


def fill_modes_torch(
    seq1, s2v, n1v, n2v, l1: int, l2: int,
    scheme: ScoringScheme, wildcard: bool, local: bool, with_dirs: bool,
):
    """Plain PyTorch twin of _fill_modes_lax: a loop over the D_total
    diagonals.  seq1: (B, L1) int32 codes; s2v: (B, P) int32 db codes at
    lanes 1..L2; n1v/n2v: (B,) int32 lengths.  Returns (bv, bd) (B, P)
    int32 running argmax buffers and the dirs or None.  The diagonal is a
    device counter and the state updates in place, so on the card the loop
    replays as CUDA graphs (ops.step_graph)."""
    _check_modes_args(seq1, s2v, n1v, n2v, l2)
    B, P = s2v.shape
    dev = s2v.device
    mode = "local" if local else "semi"
    D_total = l1 + l2 + 1
    state = diag_state(B, P, dev)
    bv = torch.full((B, P), NEGBIG, dtype=torch.int32, device=dev)
    bd = torch.zeros((B, P), dtype=torch.int32, device=dev)
    x_iota = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    n1, n2 = n1v[:, None], n2v[:, None]
    pack = None
    if with_dirs:
        pack = CounterPacker(torch.empty((-(-D_total // 4), B, P),
                                         dtype=torch.uint32, device=dev), 4)
    d = torch.zeros((), dtype=torch.int64, device=dev)

    def diagonal():
        M, I, D, H, s1d, byte = gotoh_step_torch(
            *state, query_column(seq1, d), s2v, d, scheme, False, wildcard,
            with_dirs, mode=mode,
        )
        elig, score = mode_candidates(mode, M, H, x_iota, d, n1, n2)
        upd = elig & (score > bv)
        bv.copy_(torch.where(upd, score, bv))
        bd.copy_(torch.where(upd, d, bd))
        if pack is not None:
            pack.add(d, byte)
        advance_diag(state, M, I, D, H, s1d)

    run_steps(diagonal, d, D_total)
    return bv, bd, pack.dirs if pack is not None else None


def modes_fill_cuda(
    seq1, s2v, n1v, n2v, l1: int, l2: int,
    scheme: ScoringScheme, wildcard: bool, local: bool, with_dirs: bool,
    cta_lanes: int = 0,
):
    """The per-pair modes kernel (csrc/nw_affine_modes.cu) on CUDA tensors:
    the same bv, bd and dirs as fill_modes_torch on every cell of each
    pair's matrix, but lane 0's D bits and every byte outside the matrix 0.
    Each pair is split over a few CTAs (cta_lanes > 0 forces their width, a
    multiple of 128), the rings as forced_ring leaves them; the launch's
    shape is left in ``modes_fill_cuda.last_launch``.  Returns without
    waiting for the kernel; raises on a CPU tensor, a non-contiguous input,
    an unsupported shape or a failed launch, and check_stream_stalls raises
    for a stalled wait."""
    _check_modes_args(seq1, s2v, n1v, n2v, l2)
    if not seq1.is_cuda:
        raise ValueError("modes_fill_cuda needs CUDA tensors")
    if not all(t.is_contiguous() for t in (seq1, s2v, n1v, n2v)):
        raise ValueError("modes fill inputs must be contiguous")
    check_stream_stalls()
    lib = csrc.kernels()
    B, P = s2v.shape
    shape = pair_launch_shape(lib, P, B, cta_lanes, kernel="modes",
                              **forced_knobs())
    dev = s2v.device
    D_total = l1 + l2 + 1
    best = torch.empty((2, B, P), dtype=torch.int32, device=dev)
    dirs = None
    if with_dirs:
        dirs = torch.empty((-(-D_total // 4), B, P), dtype=torch.uint32,
                           device=dev)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = lib.sa_modes_fill(
            seq1.data_ptr(), s2v.data_ptr(), n1v.data_ptr(), n2v.data_ptr(),
            best.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            B, seq1.shape[1], P, D_total,
            scheme.match_, scheme.mismatch, scheme.gap_open,
            scheme.gap_extend, 2 if with_dirs else 0, int(local),
            int(wildcard), cta_lanes, status.data_ptr(),
            shape["lanes_per_thread"], shape["chunk"], shape["ring_slots"],
            stream.cuda_stream,
        )
        if rc != 0:
            raise csrc.launch_error("sa_modes_fill", rc, shape["ctas"])
        watch_status("sa_modes_fill", status, stream)
    modes_fill_cuda.last_launch = shape
    modes_fill_cuda.launches += 1
    return best[0], best[1], dirs


modes_fill_cuda.launches = 0
modes_fill_cuda.last_launch = None


def modes_fill(seq1, s2v, n1v, n2v, l1, l2, scheme, wildcard, local,
               with_dirs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (seq1, s2v, n1v, n2v, l1, l2, scheme, wildcard, local, with_dirs)
    if seq1.is_cuda:
        return modes_fill_cuda(*args)
    if seq1.device.type != "cpu":
        raise ValueError(f"unsupported device {seq1.device}")
    return fill_modes_torch(*args)


def modes_layout(db: torch.Tensor) -> torch.Tensor:
    """(B, L2) db codes -> the (B, P) lane layout, P = round_up(L2 + 1,
    128), db at lanes 1..L2 and zeros elsewhere."""
    B, L2 = db.shape
    s2v = torch.zeros((B, _round_up(L2 + 1, 128)), dtype=torch.int32,
                      device=db.device)
    s2v[:, 1: L2 + 1] = db
    return s2v


def nw_affine_modes_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    local: bool,
    scheme: ScoringScheme = ScoringScheme(),
    wildcard: bool = False,
    with_dirs: bool = True,
) -> ModesResult:
    """Batched semi-global (local=False) or local (local=True) affine fill
    of a padded batch held as tensors (device.to_device).  The (B,) end
    cells come to the host; the dirs stay on the batch's device."""
    query = query.to(torch.int32).contiguous()
    bv, bd, dirs = modes_fill(
        query, modes_layout(db), query_len.to(torch.int32).contiguous(),
        db_len.to(torch.int32).contiguous(), query.shape[1], db.shape[1],
        scheme, wildcard, local, with_dirs,
    )
    best, x, y = (t.cpu().numpy() for t in modes_reduce(bv, bd))
    check_stream_stalls()
    return ModesResult(best=best, best_x=x, best_y=y, dirs=dirs)


def modes_end_cell(result: ModesResult, b: int) -> Tuple[int, int, int]:
    """(score, x, y) of pair b's best end cell."""
    return (
        int(result.best[b]), int(result.best_x[b]), int(result.best_y[b])
    )

"""Streamed-pair Gotoh fill in semi-global and local modes: the port of
ops/nw_affine_stream_modes.py.

The streamed layout of ops.nw_affine_stream (a new pair enters each row
every S steps) with the boundary hook of the textbook modes: lanes 0 and p
hold M = 0, I = D = -inf, local mode clamps M at 0 and records restarts as
the LSTART bit.  The corner capture becomes a per-slot, per-lane running
argmax (best score, pair-local diagonal) over the mode's eligible cells,
reduced per pair by ops.nw_affine_modes.modes_reduce.  Direction codes are
full bytes in the streamed layout (word (k*S + x + y) >> 2).

At step t lane x holds a cell of the younger pair (slot t // S, x <= p) or
of the older one (slot t // S - 1, x > p): every other slot's cells at
step t lie outside its pair's rectangle (local diagonal < 0 or >= 2S >
n1 + n2), so only those two slots' argmax can move.

Two implementations of the fill, chosen by the tensors' device:

* ``gotoh_fill_stream_modes_torch`` -- plain PyTorch, the twin of
  gotoh_fill_stream_modes_lax (CPU tensors, and the kernel's reference);
* ``gotoh_fill_stream_modes_cuda`` -- the hand-written kernel, template
  instances of the global fill's kernel (``csrc/nw_affine_stream.cu``, and
  ``csrc/nw_affine_stream_i16.cu`` for int16 state).

As in the JAX package, int32 state starts at NEGBIG = -2**24 with NEG_INF
on the boundaries; int16 state (ops.nw_affine_stream.resolve_stream_state)
starts at its sentinel, which the boundaries hold too.  The argmax values
and steps are int32 either way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.ops.nw_affine_modes import (
    NEGBIG,
    mode_candidates,
    modes_reduce,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream import (
    StreamPlan,
    _check_fill_args,
    advance,
    check_stream_stalls,
    resolve_stream_state,
    state_sentinel,
    stream_fill_launch,
    stream_inputs,
    stream_state,
    stream_step_torch,
)
from sequencealigning_tpu_torch.ops.step_graph import CounterPacker, run_steps

MODES = ("semi", "local")


class StreamModesResult(NamedTuple):
    """best/best_x/best_y: (B,) per-pair end cell (score, x, y), reduced on
    the fill's device; dirs: (t_total/4, n_rows, P) uint32 full bytes on
    that device, or None."""

    best: np.ndarray
    best_x: np.ndarray
    best_y: np.ndarray
    dirs: Optional[torch.Tensor]
    plan: StreamPlan


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def gotoh_fill_stream_modes_torch(
    qstream, dstream, dsums, n2s,
    plan: StreamPlan, scheme: ScoringScheme,
    wildcard: bool, mode: str, with_dirs: bool, state_dtype=torch.int32,
):
    """Plain PyTorch twin of gotoh_fill_stream_modes_lax.  qstream/dstream:
    (R, t_total) int32; dsums/n2s: (np_slots, R) int32 (n1+n2 and n2 of
    each slot's pair); state_dtype: torch.int32 or torch.int16 (an
    uncertified int16 shape raises ValueError).  Returns ((bv, bd) each
    (np_slots, R, P) int32, dirs uint32 or None).  The step is a device
    counter and the state updates in place, so on the card the loop
    replays as CUDA graphs (ops.step_graph)."""
    _check_mode(mode)
    _check_fill_args(qstream, dstream, dsums, n2s, plan,
                     "full" if with_dirs else None)
    neg = state_sentinel(state_dtype, scheme, plan)
    R, P, S, NP = plan.n_rows, plan.p, plan.s, plan.np_slots
    dev = qstream.device
    state = stream_state(R, P, NEGBIG if neg is None else neg, dev,
                         state_dtype)
    bv = torch.full((NP, R, P), NEGBIG, dtype=torch.int32, device=dev)
    bd = torch.zeros((NP, R, P), dtype=torch.int32, device=dev)
    x_iota = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    n2k = n2s[:, :, None]
    n1k = dsums[:, :, None] - n2k
    pack = None
    if with_dirs:
        pack = CounterPacker(torch.empty((plan.t_total // 4, R, P),
                                         dtype=torch.uint32, device=dev), 4)
    t = torch.zeros((), dtype=torch.int64, device=dev)

    def step():
        at = t.view(1)
        M, I, D, H, s1d, code = stream_step_torch(
            *state[:6], state[6], qstream.index_select(1, at)[:, 0],
            dstream.index_select(1, at)[:, 0], t % S, scheme, False,
            wildcard, "full" if with_dirs else None, mode=mode, neg=neg,
        )
        # The slots whose pairs lie on this step: t // S - 1 and t // S
        # (a slot out of 0..NP-1 updates nothing).
        for back in (1, 0):
            k = t // S - back
            kc = k.clamp(0, NP - 1).view(1)
            pk = t - k * S
            elig, score = mode_candidates(
                mode, M, H, x_iota, pk, n1k.index_select(0, kc)[0],
                n2k.index_select(0, kc)[0])
            score = score.to(torch.int32)
            bvk = bv.index_select(0, kc)[0]
            upd = elig & (score > bvk) & (k >= 0) & (k < NP)
            bv.index_copy_(0, kc, torch.where(upd, score, bvk)[None])
            bd.index_copy_(0, kc, torch.where(
                upd, pk.to(torch.int32), bd.index_select(0, kc)[0])[None])
        if pack is not None:
            pack.add(t, code)
        advance(state, M, I, D, H, s1d)

    run_steps(step, t, plan.t_total)
    return (bv, bd), pack.dirs if pack is not None else None


def gotoh_fill_stream_modes_cuda(
    qstream, dstream, dsums, n2s,
    plan: StreamPlan, scheme: ScoringScheme,
    wildcard: bool, mode: str, with_dirs: bool, cta_lanes: int = 0,
    state_dtype=torch.int32,
):
    """The streamed modes kernel on CUDA tensors: same arguments and
    results as gotoh_fill_stream_modes_torch; int32 state launches the
    instances of csrc/nw_affine_stream.cu (``launches``), int16 those of
    csrc/nw_affine_stream_i16.cu (``launches_i16``).  Rows past 8192 lanes
    are split over a cluster, cta_lanes > 0 forces the split's CTA width,
    and ``last_launch`` and the stall check are as gotoh_fill_stream_cuda's.
    Raises on a CPU tensor, a non-contiguous input, an unsupported shape or
    state (an uncertified int16 one: ValueError) or a failed launch."""
    _check_mode(mode)
    _check_fill_args(qstream, dstream, dsums, n2s, plan,
                     "full" if with_dirs else None)
    neg = state_sentinel(state_dtype, scheme, plan)
    if not qstream.is_cuda:
        raise ValueError("gotoh_fill_stream_modes_cuda needs CUDA tensors")
    if not all(t.is_contiguous() for t in (qstream, dstream, dsums, n2s)):
        raise ValueError("stream modes fill inputs must be contiguous")
    R, P, NP = plan.n_rows, plan.p, plan.np_slots
    dev = qstream.device
    # Lanes at or past S never hold an eligible cell and are never written
    # by the kernel: they keep the initial (NEGBIG, 0).
    best = torch.empty((2, NP, R, P), dtype=torch.int32, device=dev)
    best[0].fill_(NEGBIG)
    best[1].zero_()
    dirs = None
    if with_dirs:
        dirs = torch.empty((plan.t_total // 4, R, P), dtype=torch.uint32,
                           device=dev)
    gotoh_fill_stream_modes_cuda.last_launch = stream_fill_launch(
        "sa_stream_modes_fill", int(mode == "local"), qstream, dstream,
        dsums, n2s, best, dirs, plan, scheme, 2 if with_dirs else 0,
        wildcard, True, cta_lanes, neg)
    if neg is None:
        gotoh_fill_stream_modes_cuda.launches += 1
    else:
        gotoh_fill_stream_modes_cuda.launches_i16 += 1
    return (best[0], best[1]), dirs


gotoh_fill_stream_modes_cuda.launches = 0
gotoh_fill_stream_modes_cuda.launches_i16 = 0
gotoh_fill_stream_modes_cuda.last_launch = None


def gotoh_fill_stream_modes(qstream, dstream, dsums, n2s, plan, scheme,
                            wildcard, mode, with_dirs,
                            state_dtype=torch.int32):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (qstream, dstream, dsums, n2s, plan, scheme, wildcard, mode,
            with_dirs)
    if qstream.is_cuda:
        return gotoh_fill_stream_modes_cuda(*args, state_dtype=state_dtype)
    if qstream.device.type != "cpu":
        raise ValueError(f"unsupported device {qstream.device}")
    return gotoh_fill_stream_modes_torch(*args, state_dtype=state_dtype)


def nw_affine_stream_modes_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    mode: str,
    scheme: ScoringScheme = ScoringScheme(),
    wildcard: bool = False,
    with_dirs: bool = True,
    np_slots: Optional[int] = None,
    chunk: int = 128,
    state_dtype="i32",
) -> StreamModesResult:
    """Streamed batched semi-global/local fill (mode "semi" or "local") of
    a padded batch held as tensors (device.to_device); padding pairs are
    stripped.  The (B,) end cells come to the host; the dirs stay on the
    batch's device.  Use stream_modes_best() per pair.  state_dtype: as
    ops.nw_affine_stream.nw_affine_stream_batch."""
    _check_mode(mode)
    B = query.shape[0]
    plan, ins = stream_inputs(query, db, query_len, db_len, np_slots, chunk)
    (bv, bd), dirs = gotoh_fill_stream_modes(
        *ins, plan, scheme, wildcard, mode, with_dirs,
        resolve_stream_state(state_dtype, scheme, plan),
    )
    P = plan.p
    best, x, y = modes_reduce(bv.transpose(0, 1).reshape(-1, P),
                              bd.transpose(0, 1).reshape(-1, P))
    best, x, y = (t[:B].cpu().numpy() for t in (best, x, y))
    check_stream_stalls()
    return StreamModesResult(best=best, best_x=x, best_y=y, dirs=dirs,
                             plan=plan)


def stream_modes_best(result: StreamModesResult, b: int) -> Tuple[int, int, int]:
    """(score, x, y) of pair b's best end cell."""
    return (
        int(result.best[b]), int(result.best_x[b]), int(result.best_y[b])
    )

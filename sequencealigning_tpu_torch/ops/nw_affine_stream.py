"""Streamed-pair batched Gotoh fill: the port of ops/nw_affine_stream.py.

Each stream row pipelines ``np_slots`` pairs along the lane axis: a new
pair enters every S = round_up(max(L1, L2) + 1, chunk) steps, its query
codes entering at lane 0 and its db codes at the moving boundary lane
p = t mod S.  Per-pair corner finals (M/I/D at (n2, n1)) and, on request,
the direction codes are written in the JAX package's layout: the code of
cell (x, y) of slot k lies at step d = k*S + x + y, in word
``dirs[d >> 3, row, x]`` nibble ``d & 7`` (fast4) or word
``dirs[d >> 2, row, x]`` byte ``d & 3`` (full, ops.dirbits bits).

Two implementations of the fill, chosen by the tensors' device:

* ``gotoh_fill_stream_torch`` -- the plain PyTorch version (CPU tensors,
  and the reference the CUDA kernel is checked against);
* ``gotoh_fill_stream_cuda`` -- the hand-written kernel
  (``csrc/nw_affine_stream.cu``; CUDA tensors only): each warp sweeps its
  lanes at its own pace, its first lane fed through a ring in shared memory
  a chunk of steps at a time (``csrc/stream_ring.cuh``).

The score state is int32, or int16 where ``stream_i16_neg`` certifies the
scheme and shape (``resolve_stream_state``): the plain version then runs
on int16 tensors with the JAX package's sentinel and floor clamp, and the
kernel's int16 instances (``csrc/nw_affine_stream_i16.cu``) hold two lanes
a 32-bit word.  Finals are int32 and the direction words keep their layout
either way; for a certified shape the finals and walks equal int32's.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
from sequencealigning_tpu_torch.io.encode import round_up as _round_up
from sequencealigning_tpu_torch.ops import dirbits
from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.ops.nw_affine import (
    _bit,
    _roll,
    apply_boundaries,
)
from sequencealigning_tpu_torch.ops.step_graph import CounterPacker, run_steps

_DIRS_CODES = {None: 0, "fast4": 1, "full": 2}


class StreamPlan(NamedTuple):
    """Layout of a streamed fill.  Pair b is slot (b % np_slots) of row
    (b // np_slots); its direction codes use d_offset = slot * s."""

    n_pairs: int      # true pair count (before padding)
    np_slots: int     # pairs per row (pipeline depth)
    n_rows: int       # rows (>= n_pairs_padded / np_slots, multiple of 8)
    s: int            # launch period in steps (multiple of chunk, > L1)
    chunk: int
    n_slots_g: int    # np_slots + drain slots
    t_total: int      # total sweep steps = n_slots_g * s
    l1: int
    l2: int
    p: int            # lane width (multiple of 128, >= l2 + 2)

    def pair_coords(self, b: int) -> Tuple[int, int, int]:
        """(row, slot, d_offset) for pair b."""
        r, k = divmod(b, self.np_slots)
        return r, k, k * self.s


def plan_stream(
    n_pairs: int, l1: int, l2: int,
    chunk: int = 128, np_slots: Optional[int] = None,
) -> StreamPlan:
    if np_slots is None:
        np_slots = max(1, min(8, n_pairs // 8))
    n_padded = _round_up(n_pairs, np_slots * 8)
    n_rows = n_padded // np_slots
    s = _round_up(max(l1, l2) + 1, chunk)
    # The last pair (slot np_slots-1) finishes at t = (np_slots-1)*s +
    # l1 + l2; round the sweep up to whole slots.
    t_need = (np_slots - 1) * s + l1 + l2 + 1
    n_slots_g = -(-t_need // s)
    p = _round_up(l2 + 2, 128)
    return StreamPlan(
        n_pairs=n_pairs, np_slots=np_slots, n_rows=n_rows, s=s, chunk=chunk,
        n_slots_g=n_slots_g, t_total=n_slots_g * s, l1=l1, l2=l2, p=p,
    )


class StreamResult(NamedTuple):
    finals: np.ndarray               # (B, 3) int32 -- M/I/D at (n2, n1)
    dirs: Optional[torch.Tensor]     # (T/8 or T/4, n_rows, P) uint32, or None
    plan: StreamPlan


def stream_i16_neg(scheme: ScoringScheme, plan: StreamPlan) -> Optional[int]:
    """The -inf sentinel of int16 stream state, or None if the scheme x
    shape cannot be certified to fit int16 (closed form, as
    ops/nw_affine_stream.py::stream_i16_neg): every real cell lies above
    the sentinel, which sits 64 below the worst real cell; one step before
    the floor clamp dips at most |o| + |e| + max(|mismatch|, |match|)
    below it, and a stale lane grows at most max(match, mismatch, 0) a
    step, all inside int16."""
    o, e = scheme.gap_open, scheme.gap_extend
    mm, mt = scheme.mismatch, scheme.match_
    per_char = min(mm, e, 0)
    min_cell = (plan.l1 + plan.l2) * per_char + 2 * min(o, 0)
    chain_min = min(o, 0) + (plan.s + 1) * min(e, 0)
    neg = min(min_cell, chain_min) - 64
    dip = abs(o) + abs(e) + max(abs(mm), abs(mt))
    max_cell = max(mt, mm, 0) * (min(plan.l1, plan.l2) + plan.s) + dip
    if neg - dip <= -(1 << 15) or max_cell >= (1 << 15):
        return None
    return neg


_STATES = {None: torch.int32, "i32": torch.int32, "i16": torch.int16,
           "auto": None, torch.int32: torch.int32, torch.int16: torch.int16}


def check_stream_state(state_dtype) -> None:
    """Raise ValueError for a stream-state request resolve_stream_state
    does not take."""
    if state_dtype not in _STATES:
        raise ValueError(f"unknown stream state {state_dtype!r}")


def resolve_stream_state(state_dtype, scheme: ScoringScheme,
                         plan: StreamPlan) -> torch.dtype:
    """A stream-state request as a dtype: "i32" and None give int32, "i16"
    int16 (the fill raises if stream_i16_neg does not certify the scheme x
    shape), "auto" int16 exactly when it does; a torch dtype (int32 or
    int16) passes through.  As the JAX package's resolve_stream_state off
    the TPU, where its Mosaic probe always passes."""
    check_stream_state(state_dtype)
    if state_dtype == "auto":
        return torch.int32 if stream_i16_neg(scheme, plan) is None \
            else torch.int16
    return _STATES[state_dtype]


def state_sentinel(state, scheme: ScoringScheme, plan: StreamPlan):
    """The int16 state's sentinel (stream_i16_neg), or None for int32
    state; raises ValueError naming int16 when the scheme x shape is not
    certified (as gotoh_fill_stream_lax)."""
    if state == torch.int32:
        return None
    if state != torch.int16:
        raise ValueError(f"unknown stream state {state!r}")
    neg = stream_i16_neg(scheme, plan)
    if neg is None:
        raise ValueError("scheme x shape does not fit int16 state")
    return neg


def _dirs_mode(with_dirs):
    """with_dirs True/"full" -> "full", "fast4" -> "fast4", False/None ->
    None."""
    if with_dirs is True or with_dirs == "full":
        return "full"
    if with_dirs == "fast4":
        return "fast4"
    if not with_dirs:
        return None
    raise ValueError(f"unknown dirs mode {with_dirs!r}")


# ---------------------------------------------------------------------------
# Stream inputs
# ---------------------------------------------------------------------------


def build_stream_inputs(query, db, query_len, db_len, plan: StreamPlan):
    """Lay the padded batch (plan.n_rows * plan.np_slots pairs, tensors on
    any device) out as per-row code streams plus per-slot capture params.
    Returns int32 tensors (qstream, dstream, dsy, n2y, dso, n2o) on the
    batch's device; slot k's codes start at step k*s + 1."""
    NP, R, S = plan.np_slots, plan.n_rows, plan.s
    L1 = query.shape[1]
    L2 = db.shape[1]
    dev = query.device
    q_r = query.to(torch.int32).reshape(R, NP, L1)
    d_r = db.to(torch.int32).reshape(R, NP, L2)
    qstream = torch.zeros((R, plan.t_total), dtype=torch.int32, device=dev)
    dstream = torch.zeros((R, plan.t_total), dtype=torch.int32, device=dev)
    for k in range(NP):
        qstream[:, k * S + 1 : k * S + 1 + L1] = q_r[:, k]
        dstream[:, k * S + 1 : k * S + 1 + L2] = d_r[:, k]
    return (qstream, dstream) + capture_params(query_len, db_len, plan)


def capture_params(query_len, db_len, plan: StreamPlan):
    """Per-slot capture parameters (dsy, n2y, dso, n2o), each (G, R, 1)
    int32: the younger and older (shifted by one slot) views of each pair's
    n1+n2 and n2, -1 for the drain slots."""
    NP, R, G = plan.np_slots, plan.n_rows, plan.n_slots_g
    ql = torch.as_tensor(query_len).to(torch.int32)
    dl = torch.as_tensor(db_len).to(torch.int32)
    dev = ql.device
    dsum_k = (ql + dl).reshape(R, NP).T
    n2_k = dl.reshape(R, NP).T
    fill = torch.full((G, R, 1), -1, dtype=torch.int32, device=dev)
    dsy, n2y, dso, n2o = (fill.clone() for _ in range(4))
    dsy[:NP, :, 0] = dsum_k
    n2y[:NP, :, 0] = n2_k
    hi = min(NP + 1, G)
    dso[1:hi, :, 0] = dsum_k[: hi - 1]
    n2o[1:hi, :, 0] = n2_k[: hi - 1]
    return dsy, n2y, dso, n2o


# ---------------------------------------------------------------------------
# Plain PyTorch fill
# ---------------------------------------------------------------------------


def stream_step_torch(
    H2, H1, M1, I1, D1, s1d, s2v, qc, dc, p: torch.Tensor,
    scheme: ScoringScheme, compat: bool, wildcard: bool, dirs_mode,
    mode: str = "global", neg: Optional[int] = None,
):
    """One step of a streamed fill, the twin of
    ops/nw_affine_stream.py::_stream_step: the query code qc
    (R,) enters at lane 0, the db code dc (R,) at lane p = t mod S (written
    into s2v in place), and the merged-roll D recurrence shares its
    compares with the extend flags.  ``mode`` is the boundary hook of
    ops.nw_affine.apply_boundaries at lanes 0 and p; a lane p at or past
    the lane width P does not exist and takes neither code nor boundary.
    Returns (M, I, D, H, s1d_new, code) with code the fast4 or full
    direction code, or None.  p is a 0-d tensor (the step counter of the
    plain loops, ops.step_graph).  The scores take the state's dtype: for
    int16 state (H2 int16, neg its sentinel) I and D are floored at neg
    after their flags are taken and the boundaries clamped to it, as the
    JAX package's int16 step; int16 arithmetic wraps as numpy's."""
    o, e = scheme.gap_open, scheme.gap_extend
    sdt = H2.dtype
    P = s2v.shape[1]
    s1d = _roll(s1d)
    s1d[:, 0] = qc
    lane = torch.arange(P, device=s2v.device)[None, :]
    s2v.copy_(torch.where(lane == p, dc[:, None], s2v))
    eq = (s1d & s2v) != 0 if wildcard else s1d == s2v
    sub = (scheme.mismatch
           + _bit(eq, scheme.match_ - scheme.mismatch)).to(sdt)
    t0 = M1 + o
    M = _roll(H2) + sub
    restart = None
    if mode == "local":
        restart = (M < 0).to(torch.int32)
        M = torch.clamp(M, min=0)
    ci = I1 >= t0
    cd = D1 >= t0
    D = _roll(torch.where(cd, D1, t0)) + e
    I = torch.where(ci, I1, t0) + e
    if neg is not None:
        I = torch.clamp(I, min=neg)
        D = torch.clamp(D, min=neg)
    apply_boundaries(M, I, D, restart, p, scheme, compat, mode, neg)
    H = torch.maximum(M, torch.maximum(I, D))

    code = None
    if dirs_mode == "full":
        code = _bit(M == H, dirbits.HM) | _bit(I == H, dirbits.HI)
        code |= _bit(D == H, dirbits.HD) | _bit(ci, dirbits.IEXT)
        code |= _bit(t0 >= I1, dirbits.IOPEN)
        dpre = _bit(cd, dirbits.DEXT) | _bit(t0 >= D1, dirbits.DOPEN)
        code |= _roll(dpre)
        if restart is not None:
            code |= restart * dirbits.LSTART
    elif dirs_mode == "fast4":
        code = torch.where(M == H, 0, torch.where(I == H, 1, 2)).to(torch.int32)
        code |= _bit(ci, 4) | _roll(_bit(cd, 8))
    return M, I, D, H, s1d, code


def _check_fill_args(qstream, dstream, dsums, n2s, plan: StreamPlan,
                     dirs_mode):
    R = plan.n_rows
    for name, t, shape in (
        ("qstream", qstream, (R, plan.t_total)),
        ("dstream", dstream, (R, plan.t_total)),
        ("dsums", dsums, (plan.np_slots, R)),
        ("n2s", n2s, (plan.np_slots, R)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected int32 {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != qstream.device:
            raise ValueError(f"{name} is on {t.device}, not {qstream.device}")
    if dirs_mode not in _DIRS_CODES:
        raise ValueError(f"unknown dirs mode {dirs_mode!r}")
    upack = 8 if dirs_mode == "fast4" else 4
    if dirs_mode and plan.t_total % upack:
        raise ValueError(f"t_total {plan.t_total} is not a multiple of {upack}")


def stream_state(R: int, P: int, neg: int, device, dtype=torch.int32):
    """The rolling state of a streamed plain fill: H2, H1, M1, I1, D1 (at
    neg, of the state's dtype), s1d and s2v (at 0, int32), each its own
    (R, P) tensor."""
    full = [torch.full((R, P), neg, dtype=dtype, device=device)
            for _ in range(5)]
    zeros = [torch.zeros((R, P), dtype=torch.int32, device=device)
             for _ in range(2)]
    return full + zeros


def advance(state, M, I, D, H, s1d):
    """Shift a step's results into the rolling state, in place."""
    H2, H1, M1, I1, D1, s1d_old, _s2v = state
    H2.copy_(H1)
    for dst, src in ((H1, H), (M1, M), (I1, I), (D1, D), (s1d_old, s1d)):
        dst.copy_(src)


def gotoh_fill_stream_torch(
    qstream, dstream, dsums, n2s,
    plan: StreamPlan, scheme: ScoringScheme,
    compat: bool, wildcard: bool, dirs_mode, state_dtype=torch.int32,
):
    """Plain PyTorch twin of gotoh_fill_stream_lax: a loop over the t_total
    steps, each a handful of (R, P) tensor ops, with the same torus rolls.
    qstream/dstream: (R, t_total) int32; dsums/n2s: (np_slots, R) int32;
    state_dtype: torch.int32 or torch.int16 (resolve_stream_state; int16
    raises ValueError for an uncertified scheme x shape).  Returns (finals
    (R*np_slots, 3) int32, dirs uint32 or None).  The step is a device
    counter and the state updates in place, so on the card the loop
    replays as CUDA graphs (ops.step_graph)."""
    _check_fill_args(qstream, dstream, dsums, n2s, plan, dirs_mode)
    neg = state_sentinel(state_dtype, scheme, plan)
    R, P, S, NP = plan.n_rows, plan.p, plan.s, plan.np_slots
    dev = qstream.device

    # Pair r * NP + k (row r, slot k) is captured at lane n2 on step
    # k * S + dsum.
    slot = torch.arange(NP, device=dev)[:, None]
    cap_t = (slot * S + dsums.long()).T.reshape(-1)
    rows = torch.arange(R, device=dev).repeat_interleave(NP)
    lanes = n2s.long().T.reshape(-1)
    state = stream_state(R, P, NEG_INF if neg is None else neg, dev,
                         state_dtype)
    finals = torch.zeros((R * NP, 3), dtype=torch.int32, device=dev)
    pack = None
    if dirs_mode:
        per = 8 if dirs_mode == "fast4" else 4
        pack = CounterPacker(torch.empty((plan.t_total // per, R, P),
                                         dtype=torch.uint32, device=dev), per)
    t = torch.zeros((), dtype=torch.int64, device=dev)

    def step():
        at = t.view(1)
        M, I, D, H, s1d, b = stream_step_torch(
            *state[:6], state[6], qstream.index_select(1, at)[:, 0],
            dstream.index_select(1, at)[:, 0], t % S, scheme, compat,
            wildcard, dirs_mode, neg=neg,
        )
        if pack is not None:
            pack.add(t, b)
        got = torch.stack([M[rows, lanes], I[rows, lanes], D[rows, lanes]],
                          dim=1).to(torch.int32)
        finals.copy_(torch.where((cap_t == t)[:, None], got, finals))
        advance(state, M, I, D, H, s1d)

    run_steps(step, t, plan.t_total)
    return finals, pack.dirs if pack is not None else None


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


_RING = contextvars.ContextVar("stream_ring", default={})


@contextlib.contextmanager
def forced_ring(**knobs):
    """Force the warp rings' shape of kernels #1, #2, #6 and #7 and the
    linear fill launched in this context (csrc/stream_sweep.py and
    chip_smoke.py's stall checks): lanes_per_thread (2, 4, 8, 16), chunk
    (steps, 1-32), ring_slots and wrap_words (stream_ring.cuh::ring_shape;
    the per-pair fills have no wrap ring); an absent knob or 0 takes the
    default."""
    token = _RING.set(knobs)
    try:
        yield
    finally:
        _RING.reset(token)


def forced_knobs() -> dict:
    """The knobs forced_ring has set in this context ({} for none)."""
    return dict(_RING.get())


def stream_launch_shape(lib, P: int, cta_lanes: int, modes: bool,
                        lanes_per_thread: int = 0, chunk: int = 0,
                        ring_slots: int = 0, wrap_words: int = 0) -> dict:
    """The streamed fills' launch shape for a row of P lanes, the defaults
    resolved (stream_ring.cuh::stream_launch_shape, through
    ``lib.sa_stream_plan`` or the host build's ``hc_stream_plan``).
    Raises ValueError when the shape is out of range."""
    shape = (ctypes.c_int * 6)()
    plan_fn = getattr(lib, "sa_stream_plan", None) or lib.hc_stream_plan
    if plan_fn(P, cta_lanes, int(modes), lanes_per_thread, chunk,
               ring_slots, wrap_words, shape) != 0:
        raise ValueError(
            f"lane width {P} (CTA width {cta_lanes}, {lanes_per_thread} "
            f"lanes a thread, ring {chunk}/{ring_slots}/{wrap_words}) is "
            "out of the CUDA fill kernel's range")
    return dict(zip(("lanes_per_thread", "threads", "ctas", "chunk",
                     "ring_slots", "wrap_words"), shape))


class _Watch(NamedTuple):
    entry: str
    host: torch.Tensor  # the status word, copied into pinned memory
    done: object        # a CUDA event recorded after the copy


_watches: list = []
_watches_lock = threading.Lock()


def check_stream_stalls(wait: bool = False) -> None:
    """Raise RuntimeError for a launch of kernel #1, #2, #6 or #7 or of the
    linear fill that has ended with a wait stalled past the spin limit (its
    results are incomplete).  A launch does not wait for its kernel: its
    status word is copied to the host behind the kernel and read here once
    the launch has ended, or with ``wait`` after waiting for it.  Reading a
    fill's results on the host waits for the fill, so the places that read
    them call this after: the runner's ``to_host``,
    ``nw_affine_stream_batch``, ``nw_affine_stream_modes_batch``,
    ``nw_affine_modes_batch``, ``nw_affine_batch``, ``nw_linear_batch`` and
    each launch (for the launches before it)."""
    with _watches_lock:
        keep, ready = [], []
        for w in _watches:
            (ready if wait or w.done.query() else keep).append(w)
        _watches[:] = keep
    for w in ready:
        w.done.synchronize()
        got = int(w.host[0])
        if got != 0:
            raise RuntimeError(
                f"{w.entry}: a warp waited on its neighbour past the spin "
                f"limit (status {got}); its results are incomplete")


def stream_fill_launch(entry: str, mode_arg: int, qstream, dstream, dsums,
                       n2s, out, dirs, plan: StreamPlan,
                       scheme: ScoringScheme, dirs_code: int, wildcard: bool,
                       modes: bool, cta_lanes: int,
                       neg: Optional[int] = None) -> dict:
    """Launch sa_stream_fill (mode_arg: compat) or sa_stream_modes_fill
    (mode_arg: local) into out/dirs on the current stream, the rings as
    forced_ring leaves them, and return the launch's shape without waiting
    for the kernel; with neg (int16 state's sentinel) the int16 instance
    (entry + "_i16").  Raises for a failed launch, and for an earlier
    launch that has ended stalled (check_stream_stalls); this launch's
    status is read by a later check."""
    check_stream_stalls()
    extra = ()
    if neg is not None:
        entry += "_i16"
        extra = (neg,)
    lib = csrc.kernels()
    shape = stream_launch_shape(lib, plan.p, cta_lanes, modes,
                                **forced_knobs())
    dev = qstream.device
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = getattr(lib, entry)(
            qstream.data_ptr(), dstream.data_ptr(), dsums.data_ptr(),
            n2s.data_ptr(), out.data_ptr(),
            dirs.data_ptr() if dirs is not None else None, status.data_ptr(),
            plan.n_rows, plan.t_total, plan.p, plan.s, plan.np_slots,
            scheme.match_, scheme.mismatch, scheme.gap_open,
            scheme.gap_extend, dirs_code, mode_arg, int(wildcard), cta_lanes,
            shape["lanes_per_thread"], shape["chunk"], shape["ring_slots"],
            shape["wrap_words"], *extra, stream.cuda_stream,
        )
        if rc != 0:
            raise csrc.launch_error(entry, rc, shape["ctas"])
        watch_status(entry, status, stream)
    return shape


def watch_status(entry: str, status, stream) -> None:
    """Copy a launch's status word into pinned memory behind its kernel on
    ``stream`` and record an event, for check_stream_stalls."""
    host = torch.empty(1, dtype=torch.int32, pin_memory=True)
    host.copy_(status, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    with _watches_lock:
        _watches.append(_Watch(entry, host, done))


def gotoh_fill_stream_cuda(
    qstream, dstream, dsums, n2s,
    plan: StreamPlan, scheme: ScoringScheme,
    compat: bool, wildcard: bool, dirs_mode, cta_lanes: int = 0,
    state_dtype=torch.int32,
):
    """The fill kernel on CUDA tensors: same arguments and results as
    gotoh_fill_stream_torch; int32 state launches the instances of
    csrc/nw_affine_stream.cu (counted in ``launches``), int16 those of
    csrc/nw_affine_stream_i16.cu (``launches_i16``).  A row of more than
    8192 lanes is split over a thread-block cluster; cta_lanes > 0 forces
    CTAs of that many lanes (a multiple of 128, for testing the split).
    The launch's shape is left in ``gotoh_fill_stream_cuda.last_launch``.
    Builds the kernels on first use; returns without waiting for the
    kernel; raises on a CPU tensor, an unsupported shape or state (an
    uncertified int16 one: ValueError) or a failed launch, and
    check_stream_stalls raises for a stalled wait."""
    _check_fill_args(qstream, dstream, dsums, n2s, plan, dirs_mode)
    neg = state_sentinel(state_dtype, scheme, plan)
    if not qstream.is_cuda:
        raise ValueError("gotoh_fill_stream_cuda needs CUDA tensors")
    for name, t in (("qstream", qstream), ("dstream", dstream),
                    ("dsums", dsums), ("n2s", n2s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    R, P, NP = plan.n_rows, plan.p, plan.np_slots
    dev = qstream.device
    finals = torch.zeros((R * NP, 3), dtype=torch.int32, device=dev)
    dirs = None
    if dirs_mode:
        upack = 8 if dirs_mode == "fast4" else 4
        dirs = torch.empty(
            (plan.t_total // upack, R, P), dtype=torch.uint32, device=dev
        )
    gotoh_fill_stream_cuda.last_launch = stream_fill_launch(
        "sa_stream_fill", int(compat), qstream, dstream, dsums, n2s, finals,
        dirs, plan, scheme, _DIRS_CODES[dirs_mode], wildcard, False,
        cta_lanes, neg)
    if neg is None:
        gotoh_fill_stream_cuda.launches += 1
    else:
        gotoh_fill_stream_cuda.launches_i16 += 1
    return finals, dirs


gotoh_fill_stream_cuda.launches = 0
gotoh_fill_stream_cuda.launches_i16 = 0
gotoh_fill_stream_cuda.last_launch = None


def gotoh_fill_stream(qstream, dstream, dsums, n2s, plan, scheme, compat,
                      wildcard, dirs_mode, state_dtype=torch.int32):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (qstream, dstream, dsums, n2s, plan, scheme, compat, wildcard,
            dirs_mode)
    if qstream.is_cuda:
        return gotoh_fill_stream_cuda(*args, state_dtype=state_dtype)
    if qstream.device.type != "cpu":
        raise ValueError(f"unsupported device {qstream.device}")
    return gotoh_fill_stream_torch(*args, state_dtype=state_dtype)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def stream_inputs(query, db, query_len, db_len,
                  np_slots: Optional[int] = None, chunk: int = 128):
    """Plan a fill of a batch held as tensors (device.to_device) and lay it
    out for gotoh_fill_stream: pads the batch to np_slots * n_rows pairs
    (pairs of length 1).  Returns (plan, (qstream, dstream, dsums, n2s))
    on the batch's device."""
    B, L1 = query.shape
    plan = plan_stream(B, L1, db.shape[1], chunk=chunk, np_slots=np_slots)
    n_padded = plan.np_slots * plan.n_rows

    def pad(a, value):
        out = torch.full(
            (n_padded,) + tuple(a.shape[1:]), value, dtype=torch.int32,
            device=query.device,
        )
        out[:B] = a
        return out

    qstream, dstream, dsy, n2y, _dso, _n2o = build_stream_inputs(
        pad(query, 0), pad(db, 0), pad(query_len, 1), pad(db_len, 1), plan,
    )
    NP = plan.np_slots
    return plan, (qstream, dstream, dsy[:NP, :, 0].contiguous(),
                  n2y[:NP, :, 0].contiguous())


def nw_affine_stream_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    with_dirs=True,
    np_slots: Optional[int] = None,
    chunk: int = 128,
    state_dtype="i32",
) -> StreamResult:
    """Streamed batched Gotoh fill of a padded batch held as tensors
    (device.to_device); the padding pairs are stripped from the finals.
    with_dirs: True/"full", "fast4" or False; state_dtype: "i32", "i16",
    "auto" or a dtype (resolve_stream_state, on the batch's plan)."""
    plan, ins = stream_inputs(query, db, query_len, db_len, np_slots, chunk)
    finals, dirs = gotoh_fill_stream(
        *ins, plan, scheme, compat, wildcard, _dirs_mode(with_dirs),
        resolve_stream_state(state_dtype, scheme, plan),
    )
    finals = finals[: query.shape[0]].cpu().numpy()
    check_stream_stalls()
    return StreamResult(finals=finals, dirs=dirs, plan=plan)

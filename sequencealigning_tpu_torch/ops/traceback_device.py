"""On-device tracebacks: the port of ops/traceback_device.py, fast4 and
textbook modes.

The streamed fill's fast4 direction tensor (0.5 byte a cell) stays on the
device; each pair walks from its corner to the origin reading one nibble a
step, and only the 2-bit op codes (16 to a u32, walk order = end to start)
come back to the host, where they become op strings
(fast4_stream_walk_device) or, through the native decoder, aligned strings
(fast4_stream_align_device).  Walk semantics are those of
ops/traceback.fast4_traceback_pair: seed plane M > I > D from the corner
finals, x == 0 forces I, y == 0 forces D, and after an M move the plane is
read from the next cell's code.

Two implementations of the walk, chosen by the direction tensor's device:

* ``walk_fast4_torch`` -- plain PyTorch, vectorised over pairs with a
  Python loop over steps (CPU tensors, and the reference for the kernel);
* ``walk_fast4_cuda`` -- the hand-written kernel
  (``csrc/traceback_device.cu``; CUDA tensors only): a warp a pair over
  rows staged in shared memory ahead of the walk, a whole run of M moves an
  iteration (``slow=`` counts the reads outside the stage and the ring's
  restagings).

The textbook semi-global / local fills (ops.nw_affine_modes,
ops.nw_affine_stream_modes) are walked the same way over their full
direction bytes (``walk_modes_torch`` / ``walk_modes_cuda``, the twins of
_walk_modes_impl): from each pair's end cell to its stop cell, emitting the
same packed 2-bit op codes.

The banded fill's wavefront-packed fast4 codes (ops.nw_banded_diag) are
walked by ``walk_banded_torch`` / ``walk_banded_cuda`` with the host
walker's semantics (ops.traceback.banded_diag_fast4_traceback_pair): a read
outside the band gives code 0 and the walk advances.  The kernel walks a
pair a warp, reading the words from rows it staged in shared memory ahead
of the walk (``forced_walk`` narrows their window, ``slow=`` counts the
reads outside it).  The JAX device walk
(_walk_banded_diag_msub) freezes on such a read instead and burns its step
budget (ops/traceback_device.py:234, a known fault of the reference); the
port does not copy that.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import numpy as np
import torch

from sequencealigning_tpu_torch import csrc, native
from sequencealigning_tpu_torch.errors import AlignerError, AlignmentError
from sequencealigning_tpu_torch.ops.step_graph import run_steps
from sequencealigning_tpu_torch.ops.traceback import (
    banded_diag_fast4_traceback_pair,
    local_affine_traceback_pair,
    semi_global_traceback_pair,
)

# Walk planes: 0 = M, 1 = I, 2 = D, 3 = pending (resolved from the next
# step's own nibble; set only after a diagonal move); the modes walk's
# plane when a byte has no H-plane bit (a corrupt fill).
_PEND = 3
_BROKEN = 4
_OP_LUT = np.frombuffer(b"\x00MID", dtype=np.uint8)
# Steps between all-pairs-done checks of the plain walk, and the unit of
# the packed output width (ceil(t_steps / 512) * 32 words, as the JAX walk).
_CHUNK = 512


WALK_ROUTES = ("auto", "device", "host")


def use_device_walk(config, device, dirs=None) -> bool:
    """The walk route of config.traceback, as the JAX package's
    use_device_walk: "device" walks on the fill's device (the kernels on
    the card, their plain versions on the CPU), "host" fetches the
    direction words and walks them with the host walkers (ops.traceback,
    the native decoder), "auto" walks on the device when the fill's device
    is the card -- the aligner's device, or the dirs tensor's."""
    choice = getattr(config, "traceback", "auto")
    if choice not in WALK_ROUTES:
        raise ValueError(f"unknown traceback route {choice!r}")
    if choice != "auto":
        return choice == "device"
    return torch.device(device).type == "cuda" or bool(
        dirs is not None and dirs.is_cuda)


def packed_width(t_steps: int) -> int:
    """u32 words per pair of a walk's packed op codes."""
    return -(-t_steps // _CHUNK) * (_CHUNK // 16)


def _plane_step(nib, x, y, plane, std: bool = False):
    """One walk step for every pair given its current cell's fast4 nibble:
    (op code, x', y', plane').  As ops/traceback_device._plane_step: with
    std (the any-state-open model of the banded fill's model="std") a gap
    open goes to the pending plane, resolved from the next cell's code,
    instead of M."""
    plane = torch.where(plane == _PEND, torch.clamp(nib & 3, max=2), plane)
    at_x0 = x == 0
    at_y0 = y == 0
    done = at_x0 & at_y0
    eff = torch.where(at_x0, 1, torch.where(at_y0, 2, plane))
    op = torch.where(done, 0, eff + 1)
    step_x = ~done & ((eff == 0) | (eff == 2))
    step_y = ~done & ((eff == 0) | (eff == 1))
    open_to = _PEND if std else 0
    nxt = torch.where(
        eff == 0,
        _PEND,
        torch.where(
            eff == 1,
            torch.where((nib & 4) != 0, 1, open_to),
            torch.where((nib & 8) != 0, 2, open_to),
        ),
    )
    plane = torch.where(done, plane, nxt).to(torch.int32)
    x = x - step_x.to(torch.int32)
    y = y - step_y.to(torch.int32)
    return op, x, y, plane


def _pack_ops(ops: torch.Tensor) -> torch.Tensor:
    """(T, B) op codes, T a multiple of 16 -> (B, T/16) uint32, 2 bits a
    step, little-endian in step."""
    t, b = ops.shape
    shift = torch.arange(16, device=ops.device, dtype=torch.int64) * 2
    words = ops.to(torch.int64).reshape(t // 16, 16, b) << shift[:, None]
    words = words.sum(1)
    words = words - ((words >> 31) & 1) * (1 << 32)
    return words.to(torch.int32).view(torch.uint32).T.contiguous()


def _check_walk_args(dirs, seeds, t_steps: int, check_bounds: bool = True):
    if dirs.dtype != torch.uint32 or dirs.dim() != 3:
        raise ValueError(f"dirs: expected (W, R, P) uint32, got {dirs.dtype} "
                         f"{tuple(dirs.shape)}")
    b = seeds[0].shape[0]
    for t in seeds:
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"walk seeds must be ({b},) int32")
        if t.device != dirs.device:
            raise ValueError(f"walk seed on {t.device}, dirs on {dirs.device}")
    if t_steps < 1:
        raise ValueError("t_steps must be positive")
    if check_bounds:
        _check_seed_bounds(dirs, seeds)


def _check_seed_bounds(dirs, seeds):
    """The fast4 walk's seeds inside the dirs tensor.  Their values on a
    card wait for the work queued before the walk (one transfer for all):
    the kernel's wrapper checks them last, just before its launch, so that
    the card idles only for the launch.  Seeds the caller built from the
    fill's own plan skip this (check_bounds=False)."""
    x0, y0, _plane0, rowp, off = seeds
    if not x0.shape[0]:
        return
    lo, hi = torch.stack((rowp, x0, y0, off, x0 + y0 + off)).aminmax(dim=1)
    (lo_r, lo_x, lo_y, lo_o, _), (hi_r, hi_x, _, _, hi_d) = torch.stack(
        (lo, hi)).tolist()
    if (lo_r < 0 or hi_r >= dirs.shape[1] or lo_x < 0
            or hi_x >= dirs.shape[2] or lo_y < 0 or lo_o < 0
            or hi_d >= 8 * dirs.shape[0]):
        raise ValueError("walk seeds reach outside the dirs tensor")


def walk_fast4_torch(dirs, x0, y0, plane0, rowp, off, t_steps: int):
    """Plain PyTorch twin of the JAX _walk_fast4: every pair takes up to
    t_steps steps (checking every 512 steps whether all have reached the
    origin).  dirs: (T/8, R, P) uint32 fast4 words; x0/y0/plane0/rowp/off:
    (B,) int32.  Returns (xf, yf, packed (B, packed_width(t_steps))
    uint32, n_ops (B,) int32)."""
    _check_walk_args(dirs, (x0, y0, plane0, rowp, off), t_steps)
    d32 = dirs.view(torch.int32)
    x, y, plane = x0.clone(), y0.clone(), plane0.clone()
    row = rowp.long()
    n_chunks = -(-t_steps // _CHUNK)
    ops = torch.zeros((n_chunks * _CHUNK, x0.shape[0]), dtype=torch.int32,
                      device=dirs.device)
    for c in range(n_chunks):
        if bool(((x == 0) & (y == 0)).all()):
            break
        for i in range(c * _CHUNK, (c + 1) * _CHUNK):
            d = x + y + off
            w = d32[(d >> 3).long(), row, x.long()]
            nib = (w >> ((d & 7) * 4)) & 0xF
            op, x, y, plane = _plane_step(nib, x, y, plane)
            ops[i] = op
    n_ops = (ops != 0).sum(0, dtype=torch.int32)
    return x, y, _pack_ops(ops), n_ops


def _check_staged_lanes(dirs, name: str):
    """The staged walk kernels take rows of P >= 32 lanes, a multiple of 4
    (16-byte copies of 32 lanes; every fill gives a multiple of 128)."""
    P = dirs.shape[2]
    if P < 32 or P % 4:
        raise ValueError(f"{name} takes rows of 32 lanes or more, a multiple "
                         f"of 4, not {P}")


def _check_slow(slow, dirs, n: int = 1):
    if slow is not None and (slow.dtype != torch.int64 or slow.numel() < n
                             or slow.device != dirs.device):
        raise ValueError(f"slow must be an int64 tensor of {n} or more "
                         "elements on the walk's device")


def walk_fast4_cuda(dirs, x0, y0, plane0, rowp, off, t_steps: int,
                    check_bounds: bool = True, slow=None):
    """The walk kernel (csrc/traceback_device.cu) on CUDA tensors: same
    arguments and results as walk_fast4_torch, for rows of P >= 32 lanes, a
    multiple of 4.  check_bounds=False skips the seeds' range check (which
    waits for the card), for seeds built from the fill's plan.  slow: None,
    or a (2,) int64 CUDA tensor: the words read outside the staged rows
    (the slow path) are added to slow[0], the ring's restagings after the
    walk left its windows' diagonal (a gap) to slow[1].  Raises on a CPU
    tensor, a non-contiguous input, another P or a failed launch."""
    seeds = (x0, y0, plane0, rowp, off)
    _check_walk_args(dirs, seeds, t_steps, check_bounds=False)
    if not dirs.is_cuda:
        raise ValueError("walk_fast4_cuda needs CUDA tensors")
    if not all(t.is_contiguous() for t in (dirs,) + seeds):
        raise ValueError("walk inputs must be contiguous")
    _check_staged_lanes(dirs, "walk_fast4_cuda")
    _check_slow(slow, dirs, 2)
    lib = csrc.kernels()
    NW, R, P = dirs.shape
    B = x0.shape[0]
    W = packed_width(t_steps)
    dev = dirs.device
    packed = torch.empty((B, W), dtype=torch.uint32, device=dev)
    xf = torch.empty(B, dtype=torch.int32, device=dev)
    yf = torch.empty(B, dtype=torch.int32, device=dev)
    n_ops = torch.empty(B, dtype=torch.int32, device=dev)
    args = (dirs.data_ptr(), NW, R, P, *(t.data_ptr() for t in seeds), B, W,
            packed.data_ptr(), xf.data_ptr(), yf.data_ptr(),
            n_ops.data_ptr(), slow.data_ptr() if slow is not None else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if check_bounds:
            _check_seed_bounds(dirs, seeds)
        rc = lib.sa_walk_fast4(*args, stream)
    if rc != 0:
        raise csrc.launch_error("sa_walk_fast4", rc)
    walk_fast4_cuda.launches += 1
    return xf, yf, packed, n_ops


walk_fast4_cuda.launches = 0


def walk_fast4(dirs, x0, y0, plane0, rowp, off, t_steps: int,
               check_bounds: bool = True):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if dirs.is_cuda:
        return walk_fast4_cuda(dirs, x0, y0, plane0, rowp, off, t_steps,
                               check_bounds)
    if dirs.device.type != "cpu":
        raise ValueError(f"unsupported device {dirs.device}")
    return walk_fast4_torch(dirs, x0, y0, plane0, rowp, off, t_steps)


def seed_planes(finals: np.ndarray) -> np.ndarray:
    """(B,) plane seeds from (B, 3) M/I/D corner finals, priority
    M > I > D (ops.traceback.fast4_traceback_pair's seed rule)."""
    finals = np.asarray(finals)
    score = finals.max(axis=1, keepdims=True)
    is_m = finals[:, 0:1] == score
    is_i = finals[:, 1:2] == score
    return np.where(is_m[:, 0], 0, np.where(is_i[:, 0], 1, 2)).astype(
        np.int32
    )


def decode_packed_ops(
    packed: np.ndarray, n1s: np.ndarray, n2s: np.ndarray
) -> List[Optional[str]]:
    """Packed (B, T16) uint32 walk codes -> forward op strings ('M'/'I'/
    'D', start->end).  A pair whose ops do not consume exactly n1 query and
    n2 db characters decodes to None."""
    packed = np.asarray(packed)
    B, t16 = packed.shape
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(B, t16 * 16)
    chars = _OP_LUT[codes]
    n_ops = (codes != 0).sum(axis=1)
    out: List[Optional[str]] = []
    for b in range(B):
        ops_rev = chars[b, : int(n_ops[b])].tobytes()
        n_m = ops_rev.count(b"M")
        if (n_m + ops_rev.count(b"I") != int(n1s[b])
                or n_m + ops_rev.count(b"D") != int(n2s[b])):
            out.append(None)
            continue
        out.append(ops_rev[::-1].decode("ascii"))
    return out


def decode_packed_alignments(
    packed: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
) -> List[Optional[Tuple[str, str]]]:
    """Packed walk codes -> aligned (seq1, seq2) string pairs through the
    threaded native decoder (native.walk_decode_batch_native).  A pair
    whose walk did not consume exactly its sequences decodes to None.
    Raises if the native runtime is unavailable."""
    packed = np.asarray(packed)
    B = packed.shape[0]
    n1s = np.asarray([len(s) for s in seqs1], np.int32)
    n2s = np.asarray([len(s) for s in seqs2], np.int32)
    l1 = max(1, int(n1s.max()) if B else 1)
    l2 = max(1, int(n2s.max()) if B else 1)
    s1p = np.zeros((B, l1), np.uint8)
    s2p = np.zeros((B, l2), np.uint8)
    for b in range(B):
        s1p[b, : n1s[b]] = np.frombuffer(seqs1[b], np.uint8)
        s2p[b, : n2s[b]] = np.frombuffer(seqs2[b], np.uint8)
    return native.walk_decode_batch_native(packed, s1p, s2p, n1s, n2s)


def _stream_walk_fetch(dirs, finals, n1s, n2s, plan):
    """Walk a streamed fill's fast4 dirs on their device (walk_fast4: the
    kernel on CUDA tensors, its plain version on CPU tensors) and fetch the
    used prefix of the packed op codes.  Returns (packed (B, words) uint32,
    (B,) ended-at-origin mask), both on the host."""
    B = len(n1s)
    bs = np.arange(B)
    dev = dirs.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    xf, yf, packed, n_ops = walk_fast4(
        dirs, put(n2s), put(n1s), put(seed_planes(finals)),
        put(bs // plan.np_slots), put((bs % plan.np_slots) * plan.s),
        t_steps=int(plan.l1 + plan.l2),
    )
    n_words = max(1, -(-int(n_ops.max()) // 16)) if B else 1
    packed = packed[:, :n_words].cpu().numpy()
    return packed, (xf.cpu().numpy() == 0) & (yf.cpu().numpy() == 0)


def fast4_stream_walk_device(
    dirs: torch.Tensor,
    finals: np.ndarray,
    n1s: np.ndarray,
    n2s: np.ndarray,
    plan,
) -> Tuple[List[Optional[str]], np.ndarray]:
    """Walk a streamed fill's fast4 dirs ((t_total/8, n_rows, P) uint32,
    pair b = slot b % np_slots of row b // np_slots, diagonal offset
    slot*s) on their device.  Returns (op strings start to end, one a pair
    -- None where the walk failed validation -- and the (B,) scores).  Only
    the used prefix of the packed 2-bit op codes leaves the device."""
    B = len(n1s)
    n1s = np.asarray(n1s, np.int32)
    n2s = np.asarray(n2s, np.int32)
    finals = np.asarray(finals)[:B]
    packed, ended = _stream_walk_fetch(dirs, finals, n1s, n2s, plan)
    ops = decode_packed_ops(packed, n1s, n2s)
    return ([o if ended[b] else None for b, o in enumerate(ops)],
            finals.max(axis=1))


def fast4_stream_align_device(
    dirs: torch.Tensor,
    finals: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    plan,
) -> Tuple[List[Optional[Tuple[str, str]]], np.ndarray]:
    """fast4_stream_walk_device, decoded straight to aligned string pairs
    by the native decoder.  Returns (alignments, (B,) scores); an alignment
    is None where the walk failed validation (the caller re-walks that
    pair on the host)."""
    B = len(seqs1)
    n1s = np.asarray([len(s) for s in seqs1], np.int32)
    n2s = np.asarray([len(s) for s in seqs2], np.int32)
    finals = np.asarray(finals)[:B]
    packed, ended = _stream_walk_fetch(dirs, finals, n1s, n2s, plan)
    alns = decode_packed_alignments(packed, seqs1, seqs2)
    return ([a if ended[b] else None for b, a in enumerate(alns)],
            finals.max(axis=1))


# ---------------------------------------------------------------------------
# Banded (wavefront-packed) fast4 walk
# ---------------------------------------------------------------------------


def banded_packed_width(t_steps: int) -> int:
    """u32 words per pair of the banded walk's packed op codes (the JAX
    msub walk's compacted width, max(ceil(t_steps / 16), 1))."""
    return max(-(-t_steps // 16), 1)


def _check_banded_walk_args(dirs, seeds, t_steps: int):
    if dirs.dtype != torch.uint32 or dirs.dim() != 3:
        raise ValueError(f"dirs: expected (Aw, B, L) uint32, got "
                         f"{dirs.dtype} {tuple(dirs.shape)}")
    b = seeds[0].shape[0]
    for t in seeds:
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"walk seeds must be ({b},) int32")
        if t.device != dirs.device:
            raise ValueError(f"walk seed on {t.device}, dirs on {dirs.device}")
    if t_steps < 1:
        raise ValueError("t_steps must be positive")
    x0, y0, _plane0, bidx = seeds
    if b:
        # One transfer to the host for the four bounds.
        lo_b, hi_b, lo_x, lo_y = torch.stack(
            (bidx.min(), bidx.max(), x0.min(), y0.min())).tolist()
        if lo_b < 0 or hi_b >= dirs.shape[1] or lo_x < 0 or lo_y < 0:
            raise ValueError("walk seeds reach outside the dirs tensor")


def walk_banded_torch(dirs, x0, y0, plane0, bidx, k_lo_even: int,
                      t_steps: int, std: bool = False):
    """Plain PyTorch banded-diag fast4 walk: every pair walks from (x0, y0)
    on plane0 for up to t_steps steps (checking every 512 steps whether all
    have reached the origin), reading nibble (x+y-1) & 7 of
    dirs[(x+y-1) >> 3, bidx, (y-x-k_lo_even) >> 1]; a read outside the
    band or the tensor gives code 0 and the walk advances (the host
    walker's rule).  dirs: (Aw, B, L) uint32; seeds (B,) int32.  Returns
    (xf, yf, packed (B, banded_packed_width(t_steps)) uint32 op codes in
    walk order, n_ops (B,) int32)."""
    _check_banded_walk_args(dirs, (x0, y0, plane0, bidx), t_steps)
    W, _, L = dirs.shape
    d32 = dirs.view(torch.int32)
    x, y, plane = x0.clone(), y0.clone(), plane0.clone()
    b = bidx.long()
    n_chunks = -(-t_steps // _CHUNK)
    ops = torch.zeros((n_chunks * _CHUNK, x0.shape[0]), dtype=torch.int32,
                      device=dirs.device)
    counter = torch.zeros((), dtype=torch.int64, device=dirs.device)

    def step():
        a = x + y - 1
        lane = (y - x - k_lo_even) >> 1
        ok = (lane >= 0) & (lane < L) & (a >= 0) & ((a >> 3) < W)
        w = d32[torch.clamp(a >> 3, 0, W - 1).long(), b,
                torch.clamp(lane, 0, L - 1).long()]
        nib = torch.where(ok, (w >> ((a & 7) * 4)) & 0xF, 0)
        op, nx, ny, npl = _plane_step(nib, x, y, plane, std)
        x.copy_(nx)
        y.copy_(ny)
        plane.copy_(npl)
        ops.index_copy_(0, counter.view(1), op.to(torch.int32)[None])

    # On the card the steps replay as CUDA graphs (ops.step_graph), the
    # all-at-the-origin check read every _CHUNK steps.
    run_steps(step, counter, n_chunks * _CHUNK,
              done=lambda: ((x == 0) & (y == 0)).all(), every=_CHUNK)
    n_ops = (ops != 0).sum(0, dtype=torch.int32)
    return x, y, _pack_ops(ops[: banded_packed_width(t_steps) * 16]), n_ops


_WALK = contextvars.ContextVar("banded_walk", default={})


@contextlib.contextmanager
def forced_walk(window: int = 0):
    """Force the banded walk kernel's staged window in this context
    (chip_smoke.py's slow-path check): the lanes of a staged row it reads
    (1-32; 0 takes the default, 32)."""
    token = _WALK.set(dict(window=window))
    try:
        yield
    finally:
        _WALK.reset(token)


def walk_banded_cuda(dirs, x0, y0, plane0, bidx, k_lo_even: int,
                     t_steps: int, std: bool = False, slow=None):
    """The banded walk kernel (csrc/traceback_device.cu) on CUDA tensors:
    same arguments and results as walk_banded_torch, for a band of L >= 32
    lanes, a multiple of 4 (the banded fill's are multiples of 128).
    slow: None, or a (1,) int64 CUDA tensor the words read outside the
    staged window are added to.  The window is as forced_walk leaves it.
    Raises on a CPU tensor, a non-contiguous input, another L or a failed
    launch."""
    seeds = (x0, y0, plane0, bidx)
    _check_banded_walk_args(dirs, seeds, t_steps)
    if not dirs.is_cuda:
        raise ValueError("walk_banded_cuda needs CUDA tensors")
    if not all(t.is_contiguous() for t in (dirs,) + seeds):
        raise ValueError("walk inputs must be contiguous")
    if dirs.shape[2] < 32 or dirs.shape[2] % 4:
        raise ValueError(f"the banded walk kernel takes a band of 32 lanes "
                         f"or more, a multiple of 4, not {dirs.shape[2]}")
    _check_slow(slow, dirs)
    lib = csrc.kernels()
    W, Bd, L = dirs.shape
    B = x0.shape[0]
    WP = banded_packed_width(t_steps)
    dev = dirs.device
    packed = torch.empty((B, WP), dtype=torch.uint32, device=dev)
    xf, yf, n_ops = (torch.empty(B, dtype=torch.int32, device=dev)
                     for _ in range(3))
    knobs = _WALK.get()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sa_walk_banded(
            dirs.data_ptr(), W, Bd, L, *(t.data_ptr() for t in seeds),
            k_lo_even, B, WP, int(std), packed.data_ptr(), xf.data_ptr(),
            yf.data_ptr(), n_ops.data_ptr(), knobs.get("window", 0),
            slow.data_ptr() if slow is not None else None, stream,
        )
    if rc != 0:
        raise csrc.launch_error("sa_walk_banded", rc)
    walk_banded_cuda.launches += 1
    return xf, yf, packed, n_ops


walk_banded_cuda.launches = 0


def walk_banded(dirs, x0, y0, plane0, bidx, k_lo_even: int, t_steps: int,
                std: bool = False):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (dirs, x0, y0, plane0, bidx, k_lo_even, t_steps, std)
    if dirs.is_cuda:
        return walk_banded_cuda(*args)
    if dirs.device.type != "cpu":
        raise ValueError(f"unsupported device {dirs.device}")
    return walk_banded_torch(*args)


def banded_diag_align_device(
    dirs: torch.Tensor,
    finals: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    k_lo_even: int,
    *,
    pair_idx: Optional[np.ndarray] = None,
    std: bool = False,
) -> Tuple[List[Optional[Tuple[str, str]]], np.ndarray]:
    """Walk an ops.nw_banded_diag fast4 dirs tensor ((Aw, B, L) uint32) on
    its device and decode to aligned string pairs.  Returns (alignments,
    scores); an alignment is None where the walk failed validation.
    pair_idx: the dirs batch slot of each sequence pair (default 0..B-1).
    Only the used prefix of the packed op codes is fetched."""
    B = len(seqs1)
    n1s = np.asarray([len(s) for s in seqs1], np.int32)
    n2s = np.asarray([len(s) for s in seqs2], np.int32)
    if pair_idx is None:
        pair_idx = np.arange(B, dtype=np.int32)
    finals = np.asarray(finals)[np.asarray(pair_idx)]
    t_steps = int((n1s + n2s).max()) if B else 1
    dev = dirs.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    xf, yf, packed, n_ops = walk_banded(
        dirs, put(n2s), put(n1s), put(seed_planes(finals)), put(pair_idx),
        k_lo_even, max(t_steps, 1), std,
    )
    n_words = max(1, -(-int(n_ops.max()) // 16)) if B else 1
    packed = packed[:, :n_words].cpu().numpy()
    xf, yf = xf.cpu().numpy(), yf.cpu().numpy()
    alns = decode_packed_alignments(packed, seqs1, seqs2)
    ended = (xf == 0) & (yf == 0)
    alns = [a if ended[b] else None for b, a in enumerate(alns)]
    return alns, finals.max(axis=1)


def banded_diag_device_tbs(
    dirs: torch.Tensor,
    finals: np.ndarray,
    seqs1: List[bytes],
    seqs2: List[bytes],
    k_lo_even: int,
    compat: bool = True,
    pair_idx: Optional[np.ndarray] = None,
    std: bool = False,
):
    """Device walk over a banded-diag fast4 fill in the host walkers'
    result format: (score, [(a1, a2)]) or an AlignmentError per pair.  A
    pair whose walk fails validation is re-walked on the host
    (ops.traceback.banded_diag_fast4_traceback_pair) when the dirs lie on
    the CPU, and is an AlignmentError naming walk_banded_cuda when they lie
    on the card (the kernel is at fault; the host does not take over)."""
    if pair_idx is None:
        pair_idx = np.arange(len(seqs1), dtype=np.int32)
    alns, scores = banded_diag_align_device(
        dirs, finals, seqs1, seqs2, k_lo_even, pair_idx=pair_idx, std=std
    )
    finals = np.asarray(finals)
    out = []
    for b in range(len(seqs1)):
        if alns[b] is not None:
            out.append((int(scores[b]), [alns[b]]))
            continue
        if dirs.is_cuda:
            out.append(AlignmentError(
                "device banded walk (walk_banded_cuda) failed validation"))
            continue
        slot = int(pair_idx[b])
        try:
            out.append(banded_diag_fast4_traceback_pair(
                dirs[:, slot, :].numpy(), finals[slot], seqs1[b], seqs2[b],
                k_lo_even, compat=compat, std=std,
            ))
        except AlignmentError as e:
            out.append(e)
    return out


# ---------------------------------------------------------------------------
# Textbook modes walk
# ---------------------------------------------------------------------------


def _modes_step(byte, x, y, plane, st, local: bool):
    """One modes-walk step for every pair given its current cell's full
    direction byte: (op, x', y', plane', st').  As the step of
    ops/traceback_device._walk_modes_impl: a pending plane resolves from
    the H bits (M > I > D, _BROKEN when none), broken (that, or x/y below
    0) beats the stop rule (semi: x == 0 or y == 0; local: an M-plane
    LSTART), and a stopped walk emits 0 and moves no more."""
    resolved = torch.where(
        (byte & 1) != 0, 0,
        torch.where((byte & 2) != 0, 1,
                    torch.where((byte & 4) != 0, 2, _BROKEN)),
    )
    plane = torch.where(plane == _PEND, resolved, plane)
    if local:
        stop_now = (plane == 0) & ((byte & 128) != 0)
    else:
        stop_now = (x == 0) | (y == 0)
    broken = (plane == _BROKEN) | (x < 0) | (y < 0)
    st = torch.where(st != 0, st,
                     torch.where(broken, 2, torch.where(stop_now, 1, 0)))
    active = st == 0
    op = torch.where(active, plane + 1, 0)
    step_x = active & ((plane == 0) | (plane == 2))
    step_y = active & ((plane == 0) | (plane == 1))
    nxt = torch.where(
        plane == 0, _PEND,
        torch.where(plane == 1, torch.where((byte & 8) != 0, 1, 0),
                    torch.where((byte & 32) != 0, 2, 0)),
    )
    plane = torch.where(active, nxt, plane).to(torch.int32)
    x = x - step_x.to(torch.int32)
    y = y - step_y.to(torch.int32)
    return op, x, y, plane, st.to(torch.int32)


def _check_modes_walk_args(dirs, seeds, t_steps: int,
                           check_bounds: bool = True):
    if dirs.dtype != torch.uint32 or dirs.dim() != 3:
        raise ValueError(f"dirs: expected (W, R, P) uint32, got {dirs.dtype} "
                         f"{tuple(dirs.shape)}")
    b = seeds[0].shape[0]
    for t in seeds:
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"walk seeds must be ({b},) int32")
        if t.device != dirs.device:
            raise ValueError(f"walk seed on {t.device}, dirs on {dirs.device}")
    if t_steps < 1:
        raise ValueError("t_steps must be positive")
    if check_bounds:
        _check_rows(dirs, seeds[2])


def _check_rows(dirs, rowp):
    """The modes walk's rows inside the dirs tensor (checked last by the
    kernel's wrapper, as _check_seed_bounds)."""
    if rowp.shape[0]:
        lo_r, hi_r = torch.stack(rowp.aminmax()).tolist()
        if lo_r < 0 or hi_r >= dirs.shape[1]:
            raise ValueError("walk rows reach outside the dirs tensor")


def walk_modes_torch(dirs, x0, y0, rowp, off, local: bool, t_steps: int):
    """Plain PyTorch twin of the JAX _walk_modes: every pair walks from its
    end cell (x0, y0) for up to ceil(t_steps/512)*512 steps (checking every
    512 steps whether all have stopped).  dirs: (W, R, P) uint32 full
    bytes, the cell's byte d & 3 of word dirs[d >> 2, row, x] with
    d = x + y + off, indices clipped into the tensor.  Returns (xf, yf, st
    (1 stopped cleanly, 2 broken or still running), packed (B,
    packed_width(t_steps)) uint32 op codes, n_ops)."""
    seeds = (x0, y0, rowp, off)
    _check_modes_walk_args(dirs, seeds, t_steps)
    W, _, P = dirs.shape
    d32 = dirs.view(torch.int32)
    x, y = x0.clone(), y0.clone()
    plane = torch.full_like(x0, _PEND)
    st = torch.zeros_like(x0)
    row = rowp.long()
    n_chunks = -(-t_steps // _CHUNK)
    ops = torch.zeros((n_chunks * _CHUNK, x0.shape[0]), dtype=torch.int32,
                      device=dirs.device)
    for c in range(n_chunks):
        if bool((st != 0).all()):
            break
        for i in range(c * _CHUNK, (c + 1) * _CHUNK):
            d = x + y + off
            w = d32[torch.clamp(d >> 2, 0, W - 1).long(), row,
                    torch.clamp(x, 0, P - 1).long()]
            byte = (w >> ((d & 3) * 8)) & 0xFF
            op, x, y, plane, st = _modes_step(byte, x, y, plane, st, local)
            ops[i] = op
    st = torch.where(st == 0, 2, st).to(torch.int32)
    n_ops = (ops != 0).sum(0, dtype=torch.int32)
    return x, y, st, _pack_ops(ops), n_ops


def walk_modes_cuda(dirs, x0, y0, rowp, off, local: bool, t_steps: int,
                    check_bounds: bool = True, slow=None):
    """The modes walk kernel (csrc/traceback_device.cu) on CUDA tensors:
    same arguments and results as walk_modes_torch; check_bounds and slow
    as walk_fast4_cuda's.  Raises on a CPU tensor, a non-contiguous input,
    rows of another P or a failed launch."""
    seeds = (x0, y0, rowp, off)
    _check_modes_walk_args(dirs, seeds, t_steps, check_bounds=False)
    if not dirs.is_cuda:
        raise ValueError("walk_modes_cuda needs CUDA tensors")
    if not all(t.is_contiguous() for t in (dirs,) + seeds):
        raise ValueError("walk inputs must be contiguous")
    _check_staged_lanes(dirs, "walk_modes_cuda")
    _check_slow(slow, dirs, 2)
    lib = csrc.kernels()
    W, R, P = dirs.shape
    B = x0.shape[0]
    WP = packed_width(t_steps)
    dev = dirs.device
    packed = torch.empty((B, WP), dtype=torch.uint32, device=dev)
    xf, yf, st, n_ops = (torch.empty(B, dtype=torch.int32, device=dev)
                         for _ in range(4))
    args = (dirs.data_ptr(), W, R, P, *(t.data_ptr() for t in seeds), B, WP,
            int(local), packed.data_ptr(), xf.data_ptr(), yf.data_ptr(),
            st.data_ptr(), n_ops.data_ptr(),
            slow.data_ptr() if slow is not None else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if check_bounds:
            _check_rows(dirs, rowp)
        rc = lib.sa_walk_modes(*args, stream)
    if rc != 0:
        raise csrc.launch_error("sa_walk_modes", rc)
    walk_modes_cuda.launches += 1
    return xf, yf, st, packed, n_ops


walk_modes_cuda.launches = 0


def walk_modes(dirs, x0, y0, rowp, off, local: bool, t_steps: int,
               check_bounds: bool = True):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if dirs.is_cuda:
        return walk_modes_cuda(dirs, x0, y0, rowp, off, local, t_steps,
                               check_bounds)
    if dirs.device.type != "cpu":
        raise ValueError(f"unsupported device {dirs.device}")
    return walk_modes_torch(dirs, x0, y0, rowp, off, local, t_steps)


def modes_walk_device(dirs, end_x, end_y, rowp, off, seqs1, seqs2,
                      local: bool, t_steps: int):
    """Device walk of a textbook-modes fill (per-pair (D4, B, P) dirs with
    rowp = b, off = 0, or streamed (T4, R, P) with the plan's row and
    slot * S).  Only the used prefix of the op codes leaves the device.
    Returns per pair (mid_aligned1, mid_aligned2, stop_x, stop_y) -- the
    walked segment, exactly ops.traceback._walk_from's -- or None where the
    walk failed validation."""
    dev = dirs.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    end_x = np.asarray(end_x, np.int32)
    end_y = np.asarray(end_y, np.int32)
    xf, yf, st, packed, n_ops = walk_modes(
        dirs, put(end_x), put(end_y), put(rowp), put(off), local, t_steps
    )
    n_words = max(1, -(-int(n_ops.max()) // 16)) if len(seqs1) else 1
    packed = packed[:, :n_words].cpu().numpy()
    return decode_modes_walk(packed, xf.cpu().numpy(), yf.cpu().numpy(),
                             st.cpu().numpy(), end_x, end_y, seqs1, seqs2)


def decode_modes_walk(packed, xf, yf, st, end_x, end_y, seqs1, seqs2):
    """Decode each walk against the substrings it must consume
    (seq1[stop_y:end_y], seq2[stop_x:end_x]): per pair (mid1, mid2,
    stop_x, stop_y), or None where the walk did not stop cleanly or did not
    consume exactly them.  As ops/traceback_device.decode_modes_walk."""
    B = len(seqs1)
    subs1 = [seqs1[b][int(yf[b]): int(end_y[b])] for b in range(B)]
    subs2 = [seqs2[b][int(xf[b]): int(end_x[b])] for b in range(B)]
    alns = decode_packed_alignments(packed, subs1, subs2)
    out = []
    for b in range(B):
        if st[b] != 1 or alns[b] is None:
            out.append(None)
            continue
        out.append((alns[b][0], alns[b][1], int(xf[b]), int(yf[b])))
    return out


def assemble_modes_alignments(pairs, walked, scores, end_x, end_y,
                              local: bool, dirs_fetch=None):
    """Full alignments from the modes walk's segments: local's segment is
    the alignment; semi gets its free leading and trailing gap columns laid
    out as ops.traceback.semi_global_traceback_pair lays them.  Empty pairs
    are answered directly (score 0).  Where a walk returned None,
    ``dirs_fetch(b) -> (dirs_b, d_off)`` supplies the pair's dirs row for
    the host walker; without dirs_fetch (a kernel's walk, which the host
    does not redo) the pair is an AlignmentError naming walk_modes_cuda.
    Returns per pair (score, [(aligned1, aligned2)]) or an AlignerError.
    As ops/traceback_device.assemble_modes_alignments."""
    out = []
    for b, (s1, s2) in enumerate(pairs):
        if not s1 or not s2:
            if local:
                out.append((0, [("", "")]))
            else:
                out.append((0, [(
                    s1.decode("latin-1") + "-" * len(s2),
                    "-" * len(s1) + s2.decode("latin-1"),
                )]))
            continue
        try:
            score = int(scores[b])
            x, y = int(end_x[b]), int(end_y[b])
            w = walked[b] if walked is not None else None
            if w is not None:
                mid1, mid2, sx, sy = w
                if local:
                    a1, a2 = mid1, mid2
                else:
                    n1, n2 = len(s1), len(s2)
                    a1 = (s1[:sy].decode("latin-1") + "-" * sx + mid1
                          + s1[y:].decode("latin-1") + "-" * (n2 - x))
                    a2 = ("-" * sy + s2[:sx].decode("latin-1") + mid2
                          + "-" * (n1 - y) + s2[x:].decode("latin-1"))
            elif dirs_fetch is None:
                raise AlignmentError(
                    "device modes walk (walk_modes_cuda) failed validation"
                )
            elif local:
                dirs_b, d_off = dirs_fetch(b)
                a1, a2, _sy, _sx = local_affine_traceback_pair(
                    dirs_b, x, y, s1, s2, d_offset=d_off
                )
            else:
                dirs_b, d_off = dirs_fetch(b)
                a1, a2 = semi_global_traceback_pair(
                    dirs_b, x, y, s1, s2, d_offset=d_off
                )
            out.append((score, [(a1, a2)]))
        except AlignerError as e:
            out.append(e)
    return out

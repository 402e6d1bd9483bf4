"""Batched textbook wavefront alignment (WFA, gap-affine): the port of
ops/wfa.py.

Wavefronts are fixed-shape (B, K) offset vectors over a static diagonal
band k in [k_lo, k_lo + K) (NEG = absent), stepped over the score lattice
s = u * g (g = gcd(x, e, o + e): every reachable penalty is a multiple of
it).  Coordinates: diagonal k = y - x, offset t = x (db chars consumed),
y = t + k.  Recurrence (Marco-Sola et al. 2021):

    I[s][k] = max(M[s-o-e][k-1], I[s-e][k-1])        (consume seq1)
    D[s][k] = max(M[s-o-e][k+1], D[s-e][k+1]) + 1    (consume seq2)
    M[s][k] = extend(max(M[s-x][k] + 1, I[s][k], D[s][k]))

The fill state is a ring of the last few wavefronts a plane; each chunk of
S_CHUNK lattice steps emits its (S_CHUNK, 3, B, K) int16 offset log, the
contract the walkers read: row j of the log holds score j * g, rows at or
below each pair's score/stride are its wavefronts, every other row is NEG.

Two implementations of a chunk, chosen by the tensors' device:

* ``wfa_chunk_torch`` -- plain PyTorch, the JAX step as tensor ops over
  (B, K), its extension read from a run-length table (CPU tensors, and the
  yardstick of the kernel);
* ``wfa_chunk_cuda`` -- the hand-written kernel (``csrc/wfa.cu``; CUDA
  tensors only): a CTA a pair, a thread a diagonal, the rings in shared
  memory for the launch (in device memory past the budget, the kernel's
  choice by shape), the extension comparing the pair's codes packed as
  bytes a word at a time, a run past its first word taken by the warp.

The walk back from each pair's end over the log has two implementations
too, ``wfa_walk_torch`` and ``wfa_walk_cuda`` (a warp a pair over log rows
staged in shared memory), emitting
the port's packed 2-bit op codes (ops.traceback_device) for the native
decoder.  The JAX device walk emits run-length pairs whose uint16 cast
wraps runs past 65535 (ops/wfa.py:855-857 there); the port does not copy
that.

The host walkers ``wfa_traceback_host`` (global, the native walker first)
and ``wfa_ends_free_traceback_host`` (spans) read the log fetched to the
host, as in the JAX package.
"""

from __future__ import annotations

import math
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import WfaPenalties
from sequencealigning_tpu_torch.errors import AlignmentError

NEG = -(2 ** 14)  # fits int16; parked far below any offset
S_CHUNK = 256
# End target of a diagonal outside the free-end window; parks absent
# lanes out of bounds.
BIG = 2 ** 14
_M, _I, _D = 1, 2, 3  # the port's walk op codes (ops.traceback_device)


def _score_stride(penalties: WfaPenalties) -> int:
    """gcd(x, e, o + e): every reachable penalty is a non-negative integer
    combination of x, o+e and e, so the fill steps only that lattice (with
    the reference's 4/2/6, every even score)."""
    g = math.gcd(
        penalties.mismatch,
        math.gcd(penalties.gap_extend,
                 penalties.gap_open + penalties.gap_extend),
    )
    return max(1, g)


class WfaBatchResult:
    """score: (B,) int32 penalty (valid where converged); converged: (B,)
    bool; end_k: (B,) int32 hit diagonal; hist: (S_total, 3, B, K) int16
    offsets (M, I, D), row j holding score j * stride -- fetched from the
    device on first access, so score-only consumers never pay for it."""

    def __init__(self, score, converged, hist_chunks, k_lo: int,
                 stride: int = 1, end_k=None,
                 spans: Tuple[int, int, int, int] = (0, 0, 0, 0)):
        self.score = score
        self.converged = converged
        self._chunks = hist_chunks
        self.k_lo = k_lo
        self.stride = stride
        self.end_k = end_k
        self.spans = spans
        self._device = hist_chunks[0].device if hist_chunks else None

    def _needed_chunks(self) -> List[torch.Tensor]:
        """The chunks up to the batch's deepest score's row (the fill loop
        may have queued chunks past every pair's convergence: all NEG)."""
        smax = int(np.max(self.score, initial=-1))
        rows_needed = smax // self.stride + 1 if smax >= 0 else None
        out, rows = [], 0
        for c in self._chunks:
            if rows_needed is not None and rows >= rows_needed:
                break
            out.append(c)
            rows += c.shape[0]
        return out

    def device_hist(self) -> torch.Tensor:
        """The log on the fill's device, as far as the walks read it."""
        if self._chunks is None:
            return torch.from_numpy(self._hist).to(self._device)
        keep = self._needed_chunks()
        return torch.cat(keep, 0) if len(keep) > 1 else keep[0]

    @property
    def hist(self) -> np.ndarray:
        if self._chunks is not None:
            self._hist = torch.cat(
                [c.cpu() for c in self._needed_chunks()], 0).numpy()
            self._chunks = None
        return self._hist


def band_plan(qlen: np.ndarray, dlen: np.ndarray, band: int,
              spans: Tuple[int, int, int, int]) -> Tuple[int, int]:
    """(k_lo, K): the static band of wfa_textbook_batch -- the batch's
    length-difference range, the free-start and free-end windows and
    `band` diagonals each side, K rounded up to a multiple of 128 (never
    below the requested band: the rounding only widens the search)."""
    lead1, lead2, trail1, trail2 = spans
    diff = qlen.astype(np.int64) - dlen.astype(np.int64)
    dmin = int(diff.min()) if diff.size else 0
    dmax = int(diff.max()) if diff.size else 0
    need_lo = min(0, dmin, -lead2, dmin - trail1)
    need_hi = max(0, dmax, lead1, dmax + trail2)
    k_lo = need_lo - band
    k_hi = need_hi + band
    K_need = need_hi - need_lo + 1
    K_cur = k_hi - k_lo + 1
    K_tgt = max(128, 128 * ((K_cur + 127) // 128),
                128 * ((K_need + 127) // 128))
    if K_tgt > K_cur:
        add = K_tgt - K_cur
        k_lo -= add // 2
        k_hi += add - add // 2
    return k_lo, k_hi - k_lo + 1


def ring_rows(penalties: WfaPenalties) -> int:
    """Rows of each plane's ring: one more than the JAX package's
    max(o+e, e, x)/g + 1, so that no step reads the slot it writes (a
    zero x or e reads the row rl steps back, as the JAX ring does)."""
    g = _score_stride(penalties)
    return max(penalties.gap_open + penalties.gap_extend,
               penalties.gap_extend, penalties.mismatch) // g + 2


def lattice_offsets(penalties: WfaPenalties) -> Tuple[int, int, int]:
    """(x, o + e, e) in lattice steps; a zero offset reads the JAX ring's
    own slot before this step's write, the row rl steps back."""
    g = _score_stride(penalties)
    rl = ring_rows(penalties) - 1
    return tuple(v // g if v // g else rl for v in (
        penalties.mismatch, penalties.gap_open + penalties.gap_extend,
        penalties.gap_extend))


class WfaFill(NamedTuple):
    """One batch's wavefront fill on a device.  seq1/seq2: (B, L1) / (B,
    L2) int32 codes; n1v/n2v: (B,) int32 lengths; ring_m/i/d: (R, B, K)
    int32 offsets of the last R lattice steps; done, score, end_k: (B,)
    int32 (updated in place by every chunk); codes: (B, code_pitch(L1) +
    code_pitch(L2)) uint8, the codes packed by the kernel's seed launch
    for the launches after it (the plain fill reads none)."""

    seq1: torch.Tensor
    seq2: torch.Tensor
    n1v: torch.Tensor
    n2v: torch.Tensor
    ring_m: torch.Tensor
    ring_i: torch.Tensor
    ring_d: torch.Tensor
    done: torch.Tensor
    score: torch.Tensor
    end_k: torch.Tensor
    k_lo: int
    penalties: WfaPenalties
    spans: Tuple[int, int, int, int]
    codes: torch.Tensor


def code_pitch(L: int) -> int:
    """Bytes of one sequence in a pair's packed codes (csrc/wfa.cuh
    wfa_code_pitch): L padded by 8 and rounded up to 16."""
    return (L + 8 + 15) // 16 * 16


def wfa_fill_state(seq1, seq2, n1v, n2v, k_lo: int, K: int,
                   penalties: WfaPenalties,
                   spans: Tuple[int, int, int, int] = (0, 0, 0, 0)):
    """A fresh fill: rings all NEG, nothing converged, score -1, end_k the
    global target n1 - n2.  The seed is step u = 0 of the first chunk."""
    B = seq1.shape[0]
    dev = seq1.device
    R = ring_rows(penalties)

    def ring():
        return torch.full((R, B, K), NEG, dtype=torch.int32, device=dev)

    return WfaFill(
        seq1.contiguous(), seq2.contiguous(), n1v.contiguous(),
        n2v.contiguous(), ring(), ring(), ring(),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.full((B,), -1, dtype=torch.int32, device=dev),
        (n1v - n2v).to(torch.int32), int(k_lo), penalties,
        tuple(int(v) for v in spans),
        torch.empty((B, code_pitch(seq1.shape[1]) + code_pitch(
            seq2.shape[1])), dtype=torch.uint8, device=dev))


def _end_targets(n1v, n2v, kv, spans):
    """Per-diagonal end offsets for (bounded) ends-free alignment, spans =
    (lead1, lead2, trail1, trail2): an alignment may end at x = n2 with up
    to trail1 unconsumed seq1 chars (diagonals dtar-trail1 .. dtar, end
    offset n2), or at y = n1 with up to trail2 unconsumed seq2 chars
    (diagonals dtar .. dtar+trail2, end offset n1 - k).  Returns (end_t
    (B, K) int32, end_mask (B, K) bool)."""
    _l1, _l2, trail1, trail2 = spans
    dtar = n1v - n2v
    in_a = (kv >= dtar - trail1) & (kv <= dtar)
    in_b = (kv > dtar) & (kv <= dtar + trail2)
    end_t = torch.where(in_a, n2v, torch.where(in_b, n1v - kv, BIG))
    return end_t, in_a | in_b


def build_runlen(f: WfaFill) -> torch.Tensor:
    """runlen[b, j, t]: the exact-match run from offset t on diagonal
    k_lo + j (the JAX _build_runlen), a (B, K, T) int16 table for the plain
    fill's extension.  A suffix minimum by doubling over t."""
    seq1, seq2 = f.seq1, f.seq2
    B, T = seq2.shape
    K = f.ring_m.shape[2]
    k_lo = f.k_lo
    dev = seq1.device
    pad_l = max(0, -k_lo)
    pad_r = max(0, K + T + k_lo - seq1.shape[1])
    s1 = F.pad(seq1.to(torch.int16), (pad_l, pad_r), value=-1)
    s1win = s1.unfold(1, T, 1)[:, pad_l + k_lo: pad_l + k_lo + K]
    tv = torch.arange(T, device=dev, dtype=torch.int16)
    kv = k_lo + torch.arange(K, device=dev, dtype=torch.int32)
    eq = s1win == seq2.to(torch.int16)[:, None, :]
    eq &= tv < f.n2v[:, None, None]
    eq &= (tv.to(torch.int32) + kv[:, None]) < f.n1v[:, None, None]
    run = torch.where(eq, torch.tensor(T, dtype=torch.int16, device=dev), tv)
    del eq
    sh = 1
    while sh < T:
        run = torch.minimum(run, F.pad(run[..., sh:], (0, sh), value=T))
        sh *= 2
    return run - tv


def _check_chunk_args(f: WfaFill, u0: int, n_steps: int):
    if u0 < 0 or n_steps < 1:
        raise ValueError("a chunk starts at a lattice step u0 >= 0 and takes "
                         "one step or more")
    ins = (f.seq1, f.seq2, f.n1v, f.n2v, f.ring_m, f.ring_i, f.ring_d,
           f.done, f.score, f.end_k)
    for t in ins:
        if t.dtype != torch.int32:
            raise ValueError("WFA fill tensors must be int32")
        if t.device != f.seq1.device:
            raise ValueError("WFA fill tensors on more than one device")
    R, B, K = f.ring_m.shape
    if R != ring_rows(f.penalties) or f.seq2.shape[0] != B \
            or f.seq1.shape[0] != B or K % 32:
        raise ValueError("WFA fill state does not match its penalties or "
                         "batch (K a multiple of 32)")
    if f.codes.dtype != torch.uint8 or f.codes.device != f.seq1.device \
            or tuple(f.codes.shape) != (B, code_pitch(f.seq1.shape[1])
                                        + code_pitch(f.seq2.shape[1])):
        raise ValueError("WFA fill codes must be (B, code_pitch(L1) + "
                         "code_pitch(L2)) uint8 on the fill's device")


def wfa_chunk_torch(f: WfaFill, u0: int, n_steps: int,
                    runlen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch twin of the JAX _wfa_chunk_jax (and, at u = 0, of the
    seed _wfa_seed2_jax): n_steps lattice steps from u0, updating f's rings
    and per-pair results in place.  Returns the (n_steps, 3, B, K) int16
    log (NEG where a pair had converged).  runlen: build_runlen(f), built
    here if None."""
    _check_chunk_args(f, u0, n_steps)
    R, B, K = f.ring_m.shape
    dev = f.seq1.device
    if runlen is None:
        runlen = build_runlen(f)
    T = runlen.shape[2]
    g = _score_stride(f.penalties)
    x_off, oe_off, e_off = lattice_offsets(f.penalties)
    lead1, lead2 = f.spans[:2]
    kv = f.k_lo + torch.arange(K, device=dev, dtype=torch.int32)[None, :]
    n1v, n2v = f.n1v[:, None], f.n2v[:, None]
    end_t, end_mask = _end_targets(n1v, n2v, kv, f.spans)
    negs = torch.full((B, K), NEG, dtype=torch.int32, device=dev)
    hist = torch.full((n_steps, 3, B, K), NEG, dtype=torch.int16, device=dev)

    def ok(t):
        y = t + kv
        return (t >= 0) & (t <= n2v) & (y >= 0) & (y <= n1v)

    def extend(t):
        idx = torch.clamp(t, 0, T - 1).long()[:, :, None]
        run = torch.gather(runlen, 2, idx)[:, :, 0].to(torch.int32)
        return t + torch.where((t >= 0) & (t < T), run, 0)

    def ring_at(ring, u_):
        return ring[u_ % R] if u_ >= 0 else negs

    def shift_left(a):  # lane k reads k+1
        return torch.cat([a[:, 1:], negs[:, :1]], 1)

    def shift_right(a):  # lane k reads k-1
        return torch.cat([negs[:, :1], a[:, :-1]], 1)

    for i in range(n_steps):
        if i % 32 == 0 and i and bool(f.done.all()):
            break
        u = u0 + i
        if u == 0:
            # The seed: leading match runs from the free-start window
            # (global: diagonal 0 at t = 0), t0 = max(0, -k).
            t0 = torch.clamp(-kv, min=0).expand(B, K)
            seeded = (kv >= -lead2) & (kv <= lead1) & (t0 <= n2v) \
                & (kv <= n1v)
            m_new = extend(t0)
            m_new = torch.where(seeded & ok(m_new), m_new, NEG)
            i_new = d_new = negs
        else:
            m_oe = ring_at(f.ring_m, u - oe_off)
            m_x = ring_at(f.ring_m, u - x_off)
            i_e = ring_at(f.ring_i, u - e_off)
            d_e = ring_at(f.ring_d, u - e_off)
            i_new = torch.maximum(shift_right(m_oe), shift_right(i_e))
            i_new = torch.where((i_new > NEG) & ok(i_new), i_new, NEG)
            d_src = torch.maximum(shift_left(m_oe), shift_left(d_e))
            d_new = torch.where(d_src > NEG, d_src + 1, NEG)
            d_new = torch.where(ok(d_new), d_new, NEG)
            m_cand = torch.maximum(torch.where(m_x > NEG, m_x + 1, NEG),
                                   torch.maximum(i_new, d_new))
            m_cand = torch.where(ok(m_cand), m_cand, NEG)
            m_new = extend(torch.where(m_cand > NEG, m_cand, BIG))
            m_new = torch.where(m_cand > NEG, m_new, NEG)
        live = (f.done == 0)[:, None]
        m_new = torch.where(live, m_new, NEG)
        i_new = torch.where(live, i_new, NEG)
        d_new = torch.where(live, d_new, NEG)
        slot = u % R
        f.ring_m[slot] = m_new
        f.ring_i[slot] = i_new
        f.ring_d[slot] = d_new
        hitk = (m_new >= end_t) & end_mask
        newly = hitk.any(1) & (f.done == 0)
        f.score.copy_(torch.where(newly, u * g, f.score))
        first = torch.argmax(hitk.to(torch.int32), 1).to(torch.int32)
        f.end_k.copy_(torch.where(newly, f.k_lo + first, f.end_k))
        f.done.copy_(torch.where(newly, 1, f.done))
        hist[i, 0] = m_new.to(torch.int16)
        hist[i, 1] = i_new.to(torch.int16)
        hist[i, 2] = d_new.to(torch.int16)
    return hist


def fill_lanes_per_thread(K: int, lanes_per_thread: int = 0) -> int:
    """The fill kernel's lanes a thread: forced (> 0; the kernel refuses
    fewer than ceil(K / 1024)), else ceil(K / 1024)."""
    return lanes_per_thread or -(-K // 1024)


def sm_count(dev) -> int:
    """The SMs of a CUDA device (the walk sizes its blocks by it, the fill
    its spare CTAs)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def wfa_chunk_cuda(f: WfaFill, u0: int, n_steps: int,
                   lanes_per_thread: int = 0) -> torch.Tensor:
    """The fill kernel (csrc/wfa.cu) on CUDA tensors: the same steps, state
    updates and log as wfa_chunk_torch, a CTA a pair, every log row written
    by the kernel (a converged pair's NEG).  The launch at u0 == 0 packs
    the codes into f.codes; the fill's later launches read them there, so
    a fill's chunks follow its seed (fill_chunks).  The kernel keeps the
    rings in shared memory where they fit, else in device memory (by
    shape).  lanes_per_thread > 0 forces the lanes a thread (tests and
    tools).  Returns without waiting for the kernel; raises on a CPU
    tensor or a failed launch."""
    _check_chunk_args(f, u0, n_steps)
    if not f.seq1.is_cuda:
        raise ValueError("wfa_chunk_cuda needs CUDA tensors")
    R, B, K = f.ring_m.shape
    L1, L2 = f.seq1.shape[1], f.seq2.shape[1]
    lpt = fill_lanes_per_thread(K, lanes_per_thread)
    g = _score_stride(f.penalties)
    x_off, oe_off, e_off = lattice_offsets(f.penalties)
    dev = f.seq1.device
    hist = torch.empty((n_steps, 3, B, K), dtype=torch.int16, device=dev)
    lib = csrc.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sa_wfa_chunk(
            f.seq1.data_ptr(), f.seq2.data_ptr(), f.n1v.data_ptr(),
            f.n2v.data_ptr(), f.codes.data_ptr(), f.ring_m.data_ptr(),
            f.ring_i.data_ptr(), f.ring_d.data_ptr(), f.done.data_ptr(),
            f.score.data_ptr(), f.end_k.data_ptr(), hist.data_ptr(), B, L1,
            L2, K, R, f.k_lo, u0, n_steps, g, x_off, oe_off, e_off,
            *f.spans, lpt, sm_count(dev), stream)
    if rc != 0:
        raise csrc.launch_error("sa_wfa_chunk", rc)
    wfa_chunk_cuda.launches += 1
    return hist


wfa_chunk_cuda.launches = 0


def wfa_chunk(f: WfaFill, u0: int, n_steps: int,
              runlen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if f.seq1.is_cuda:
        return wfa_chunk_cuda(f, u0, n_steps)
    if f.seq1.device.type != "cpu":
        raise ValueError(f"unsupported device {f.seq1.device}")
    return wfa_chunk_torch(f, u0, n_steps, runlen)


def wfa_textbook_batch(
    query: torch.Tensor,
    db: torch.Tensor,
    query_len: torch.Tensor,
    db_len: torch.Tensor,
    penalties: WfaPenalties = WfaPenalties(),
    band: int = 64,
    s_max: int = 16_384,
    spans: Tuple[int, int, int, int] = (0, 0, 0, 0),
) -> WfaBatchResult:
    """Batched exact gap-affine WFA of a padded batch held as tensors
    (device.to_device), on the batch's device.  band = half-width of the
    static diagonal window beyond the batch's length-difference range;
    s_max a safety cap on the penalty (the fill's memory does not grow with
    the score).  spans = (lead1, lead2, trail1, trail2): bounded ends-free
    alignment, up to lead1/trail1 seq1 chars and lead2/trail2 seq2 chars
    skipped free at the start/end (all 0 = global)."""
    qlen = query_len.cpu().numpy()
    dlen = db_len.cpu().numpy()
    spans = tuple(int(v) for v in spans)
    if int(dlen.max(initial=0)) >= 2 ** 14 or \
            int(qlen.max(initial=0)) >= 2 ** 14:
        raise AlignmentError(
            "textbook WFA int16 offset log caps pairs at 16 kb; use the "
            "Gotoh engines for longer pairs"
        )
    k_lo, K = band_plan(qlen, dlen, band, spans)
    f = wfa_fill_state(query, db, query_len, db_len, k_lo, K, penalties,
                       spans)
    runlen = None if query.is_cuda else build_runlen(f)
    chunks = fill_chunks(
        f, s_max, lambda f_, u0, n: wfa_chunk(f_, u0, n, runlen))
    return WfaBatchResult(
        score=f.score.cpu().numpy(), converged=f.done.cpu().numpy() != 0,
        hist_chunks=chunks, k_lo=k_lo, stride=_score_stride(penalties),
        end_k=f.end_k.cpu().numpy(), spans=spans,
    )


def fill_chunks(f: WfaFill, s_max: int, chunk) -> List[torch.Tensor]:
    """The fill's chunk loop: the seed (u = 0), then chunks of S_CHUNK
    lattice steps from u = 1 while u stays below s_max / g, one queued
    ahead: after queuing a chunk the done flags left by the one before it
    are read (one host sync a chunk, the new chunk running meanwhile), and
    the loop stops once they all hold, so at most one chunk runs after
    convergence (it only writes NEG rows).  chunk(f, u0, n_steps) runs one
    chunk and returns its log.  Returns the logs in order."""
    g = _score_stride(f.penalties)
    chunks = [chunk(f, 0, 1)]
    u = 1
    u_max = (s_max + g - 1) // g
    prev_done = None
    while u < u_max:
        chunks.append(chunk(f, u, S_CHUNK))
        u += S_CHUNK
        if prev_done is not None and bool(prev_done.all()):
            break
        prev_done = f.done.clone()
    return chunks


def wfa_traceback_host(
    result: WfaBatchResult,
    b: int,
    seq1: bytes,
    seq2: bytes,
    penalties: WfaPenalties = WfaPenalties(),
) -> Tuple[int, str, str]:
    """Reconstruct one pair's alignment from the offset log on the host
    (the native walker for global results, the Python one for spans or
    with SEQALIGN_NO_NATIVE).  Returns (penalty, aligned_seq1,
    aligned_seq2).  Tie priority: mismatch > I > D."""
    if not bool(np.asarray(result.converged)[b]):
        raise AlignmentError("WFA did not converge within band/s_max")
    s = int(np.asarray(result.score)[b])
    if result.spans == (0, 0, 0, 0) and not os.environ.get(
            "SEQALIGN_NO_NATIVE"):
        from sequencealigning_tpu_torch import native

        r = native.wfa_textbook_traceback_native(
            result.hist, b, result.k_lo, s, seq1, seq2, penalties,
            stride=result.stride,
        )
        if r is not None:
            return s, r[0], r[1]
    mid1, mid2, _k0, _t0 = _walk_hist(
        result, b, seq1, seq2, penalties, len(seq1) - len(seq2), len(seq2)
    )
    return s, mid1, mid2


def _walk_hist(
    result: WfaBatchResult,
    b: int,
    seq1: bytes,
    seq2: bytes,
    penalties: WfaPenalties,
    k_start: int,
    t_start: int,
) -> Tuple[str, str, int, int]:
    """The offset-log walker: the aligned segment from (k_start, t_start)
    back to an s = 0 seed.  Global walks start at (n1-n2, n2) and stop on
    diagonal 0 at t = 0; ends-free walks start at the hit diagonal and stop
    on any seed diagonal k0 of the free-start window at t0 = max(0, -k0).
    Returns (aligned_seq1_segment, aligned_seq2_segment, k0, t0)."""
    s = int(np.asarray(result.score)[b])
    hist_b = np.asarray(result.hist[:, :, b, :], np.int32)  # (S, 3, K)
    m_hist, i_hist, d_hist = hist_b[:, 0], hist_b[:, 1], hist_b[:, 2]
    k_lo = result.k_lo
    g = result.stride  # hist row j holds score j * g
    n1, n2 = len(seq1), len(seq2)
    x_pen, o_pen, e_pen = (penalties.mismatch, penalties.gap_open,
                           penalties.gap_extend)
    oe = o_pen + e_pen
    lead1, lead2 = result.spans[0], result.spans[1]

    def hist(h, s_, k_):
        lane = k_ - k_lo
        if s_ < 0 or s_ % g or lane < 0 or lane >= h.shape[1]:
            return NEG
        row = s_ // g
        if row >= h.shape[0]:
            return NEG
        return int(h[row, lane])

    a1: List[str] = []
    a2: List[str] = []
    state = "M"
    k = k_start
    t = t_start

    def emit_matches(n: int, t_end: int) -> None:
        # Matches ending at offset t_end (exclusive) on diagonal k, emitted
        # last column first (the walk is reversed at the end).
        for tt in range(t_end - 1, t_end - n - 1, -1):
            a1.append(chr(seq1[tt + k]))
            a2.append(chr(seq2[tt]))

    guard = 0
    while True:
        guard += 1
        if guard > 4 * (n1 + n2) + s + 16:
            raise AlignmentError("WFA traceback did not terminate")
        if state == "M":
            if s == 0:
                # The seed: leading matches down to t0 = max(0, -k) on a
                # free-start diagonal.
                if not (-lead2 <= k <= lead1):
                    raise AlignmentError(
                        "WFA traceback landed outside the seed window"
                    )
                t0 = max(0, -k)
                emit_matches(t - t0, t)
                break
            mx = hist(m_hist, s - x_pen, k)
            iv = hist(i_hist, s, k)
            dv = hist(d_hist, s, k)
            t_pre = max(mx + 1 if mx > NEG else NEG, iv, dv)
            emit_matches(t - t_pre, t)
            t = t_pre
            if mx > NEG and t_pre == mx + 1:
                # mismatch column
                a1.append(chr(seq1[t - 1 + k]))
                a2.append(chr(seq2[t - 1]))
                s, t = s - x_pen, t - 1
            elif t_pre == iv:
                state = "I"
            else:
                state = "D"
        elif state == "I":
            # consume seq1[t + k - 1]; came from k-1 with the same t
            a1.append(chr(seq1[t + k - 1]))
            a2.append("-")
            m_src = hist(m_hist, s - oe, k - 1)
            if m_src == t:
                s, k, state = s - oe, k - 1, "M"
            else:
                s, k = s - e_pen, k - 1
        else:  # D: consume seq2[t-1]; came from k+1 with t-1
            a1.append("-")
            a2.append(chr(seq2[t - 1]))
            m_src = hist(m_hist, s - oe, k + 1)
            if m_src == t - 1:
                s, k, t, state = s - oe, k + 1, t - 1, "M"
            else:
                s, k, t = s - e_pen, k + 1, t - 1

    return "".join(reversed(a1)), "".join(reversed(a2)), k, t0


class WfaWalkSeeds(NamedTuple):
    """A walk's start per pair, (B,) int32: score, diagonal, offset, live
    (converged) flag and op budget (n1 + n2 + 1)."""

    s0: torch.Tensor
    k0: torch.Tensor
    t0: torch.Tensor
    live: torch.Tensor
    budget: torch.Tensor


def walk_width(budget_max: int) -> int:
    """u32 words a pair of the walk's packed op codes (16 ops a word)."""
    return max(1, -(-budget_max // 16))


def _check_walk_args(hist, seeds: WfaWalkSeeds, W: int):
    if hist.dtype != torch.int16 or hist.dim() != 4 or hist.shape[1] != 3:
        raise ValueError(f"hist: expected (S, 3, B, K) int16, got "
                         f"{hist.dtype} {tuple(hist.shape)}")
    B = seeds.s0.shape[0]
    for t in seeds:
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"walk seeds must be ({B},) int32")
        if t.device != hist.device:
            raise ValueError(f"walk seed on {t.device}, hist on "
                             f"{hist.device}")
    if B > hist.shape[2] or W < 1:
        raise ValueError("more walks than the log's pairs, or no output")


def wfa_walk_torch(hist, seeds: WfaWalkSeeds, k_lo: int, g: int,
                   penalties: WfaPenalties, W: int):
    """Plain PyTorch twin of the JAX _wfa_walk_device_jit, vectorised over
    pairs: each pair walks from (s0, k0, t0) back to the s = 0 seed, three
    log reads a step (ties mismatch > I > D, the open-vs-extend probe on
    the M plane at (s - o - e, k -+ 1)), emitting a run of ops a step.
    hist: (S, 3, B', K) int16 (pair b at column b).  Returns (packed (B, W)
    uint32 op codes in walk order, 2 bits an op (1 M, 2 I, 3 D), n_ops
    (B,) int32, ok (B,) bool: the walk reached the s = 0 seed on diagonal
    0 with no negative run and no more ops than its budget)."""
    _check_walk_args(hist, seeds, W)
    S, _, _, K = hist.shape
    B = seeds.s0.shape[0]
    dev = hist.device
    x_pen, e_pen = penalties.mismatch, penalties.gap_extend
    oe = penalties.gap_open + e_pen
    h32 = hist[:, :, :B].to(torch.int32)
    bidx = torch.arange(B, device=dev)
    s, k, t = seeds.s0.clone(), seeds.k0.clone(), seeds.t0.clone()
    st = torch.where(seeds.live != 0, 0, 3).to(torch.int32)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    total = torch.zeros(B, dtype=torch.int32, device=dev)
    vals, lens = [], []

    def gat(plane, r, ln):
        okr = (r >= 0) & (r % g == 0) & (r // g < S) & (ln >= 0) & (ln < K)
        v = h32[torch.clamp(r // g, 0, S - 1).long(), plane, bidx,
                torch.clamp(ln, 0, K - 1).long()]
        return torch.where(okr, v, NEG)

    max_steps = 2 * int(seeds.budget.max()) + 4 if B else 0
    for i in range(max_steps):
        if i % 64 == 0 and bool(((st == 3) | bad).all()):
            break
        live = (st < 3) & ~bad
        lane = k - k_lo
        is_m, is_i, is_d = st == 0, st == 1, st == 2
        r1 = torch.where(is_m, s - x_pen, s - oe)
        l1 = lane + torch.where(is_m, 0, torch.where(is_i, -1, 1))
        mx = gat(0, r1, l1)
        iv = gat(1, s, lane)
        dv = gat(2, s, lane)
        mx1 = torch.where(mx > NEG, mx + 1, NEG)
        t_pre = torch.maximum(torch.maximum(mx1, iv), dv)
        seed = is_m & (s == 0)
        mis = is_m & ~seed & (mx > NEG) & (t_pre == mx1)
        to_i = is_m & ~seed & ~mis & (t_pre == iv)
        run = t - t_pre
        opn = torch.where(is_i, mx == t, mx == t - 1)
        val = torch.where(is_m, _M, torch.where(is_i, _I, _D))
        ln = torch.where(is_m, torch.where(seed, t, torch.where(
            mis, run + 1, run)), 1)
        ln = torch.where(live, ln, 0).to(torch.int32)
        bad_now = live & ((ln < 0) | (seed & (k != 0))
                          | (total + ln > seeds.budget))
        ln = torch.where(bad_now, 0, ln)
        vals.append(torch.where(live, val, 0).to(torch.int32))
        lens.append(ln)
        total = total + ln
        s_n = torch.where(is_m, torch.where(mis, s - x_pen, s),
                          torch.where(opn, s - oe, s - e_pen))
        k_n = k + torch.where(is_i, -1, torch.where(is_d, 1, 0))
        t_n = torch.where(is_m, torch.where(seed, 0, torch.where(
            mis, t_pre - 1, t_pre)), torch.where(is_d, t - 1, t))
        st_n = torch.where(is_m, torch.where(seed, 3, torch.where(
            mis, 0, torch.where(to_i, 1, 2))), torch.where(opn, 0, st))
        adv = live & ~bad_now
        s = torch.where(adv, s_n, s)
        k = torch.where(adv, k_n, k)
        t = torch.where(adv, t_n, t)
        st = torch.where(adv, st_n, st).to(torch.int32)
        bad |= bad_now
    ok = (seeds.live != 0) & (st == 3) & ~bad
    # Expand the runs to one op a column: position p of pair b falls in the
    # first run whose running end exceeds p.
    P = 16 * W
    if vals:
        v = torch.stack(vals, 1)
        ends = torch.cumsum(torch.stack(lens, 1), 1)
        pos = torch.arange(P, device=dev, dtype=ends.dtype).expand(B, P)
        r = torch.searchsorted(ends.contiguous(), pos.contiguous(),
                               right=True)
        ops = torch.gather(v, 1, torch.clamp(r, max=v.shape[1] - 1))
        ops = torch.where(r < v.shape[1], ops, 0)
    else:
        ops = torch.zeros((B, P), dtype=torch.int32, device=dev)
    ops = torch.where(ok[:, None], ops, 0)
    from sequencealigning_tpu_torch.ops.traceback_device import _pack_ops

    packed = _pack_ops(ops.T.contiguous())
    n_ops = torch.where(ok, total, 0).to(torch.int32)
    return packed, n_ops, ok


def wfa_walk_cuda(hist, seeds: WfaWalkSeeds, k_lo: int, g: int,
                  penalties: WfaPenalties, W: int):
    """The walk kernel (csrc/wfa.cu) on CUDA tensors: the results of
    wfa_walk_torch, a warp a pair over log rows staged in shared memory
    (the codes of a pair whose walk is not ok are 0).  Returns without
    waiting; raises on a CPU tensor, a non-contiguous log, a band of fewer
    than 32 lanes or not a multiple of 8 (the fill's are multiples of 32),
    or a failed launch."""
    _check_walk_args(hist, seeds, W)
    if not hist.is_cuda:
        raise ValueError("wfa_walk_cuda needs CUDA tensors")
    if not hist.is_contiguous() or not all(
            t.is_contiguous() for t in seeds):
        raise ValueError("walk inputs must be contiguous")
    S, _, Bh, K = hist.shape
    if K < 32 or K % 8 or hist.data_ptr() % 16:
        raise ValueError(f"wfa_walk_cuda needs a 16-byte aligned log of K "
                         f">= 32 lanes, a multiple of 8, got K {K}")
    B = seeds.s0.shape[0]
    dev = hist.device
    packed = torch.zeros((B, W), dtype=torch.uint32, device=dev)
    n_ops = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.int32, device=dev)
    lib = csrc.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sa_wfa_walk(
            hist.data_ptr(), S, Bh, K, k_lo, g,
            *(t.data_ptr() for t in seeds), B, penalties.mismatch,
            penalties.gap_open, penalties.gap_extend, W, packed.data_ptr(),
            n_ops.data_ptr(), ok.data_ptr(), sm_count(dev), stream)
    if rc == -4:
        raise RuntimeError("sa_wfa_walk: the driver could not make the log's "
                           "tensor map")
    if rc != 0:
        raise csrc.launch_error("sa_wfa_walk", rc)
    wfa_walk_cuda.launches += 1
    return packed, n_ops, ok != 0


wfa_walk_cuda.launches = 0


def wfa_walk(hist, seeds: WfaWalkSeeds, k_lo: int, g: int,
             penalties: WfaPenalties, W: int):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if hist.is_cuda:
        return wfa_walk_cuda(hist, seeds, k_lo, g, penalties, W)
    if hist.device.type != "cpu":
        raise ValueError(f"unsupported device {hist.device}")
    return wfa_walk_torch(hist, seeds, k_lo, g, penalties, W)


def walk_seeds(result: WfaBatchResult, seqs1: List[bytes],
               seqs2: List[bytes], device) -> WfaWalkSeeds:
    """Global walks' seeds: each pair's score at (n1 - n2, n2), live where
    it converged, a budget of n1 + n2 + 1 ops."""
    B = len(seqs1)
    n1s = np.array([len(x) for x in seqs1], np.int64)
    n2s = np.array([len(x) for x in seqs2], np.int64)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return WfaWalkSeeds(
        put(np.asarray(result.score)[:B]), put(n1s - n2s), put(n2s),
        put(np.asarray(result.converged)[:B]), put(n1s + n2s + 1))


def wfa_traceback_device(
    result: WfaBatchResult,
    seqs1: List[bytes],
    seqs2: List[bytes],
    penalties: WfaPenalties = WfaPenalties(),
) -> List[Optional[Tuple[str, str]]]:
    """The walk of every converged pair on the log's device (global mode),
    decoded by the native decoder.  Returns one (aligned_seq1,
    aligned_seq2) a pair, or None where the pair did not converge, its
    walk failed validation, or the result is ends-free (the spans walk
    stays on the host)."""
    from sequencealigning_tpu_torch.ops.traceback_device import (
        decode_packed_alignments,
    )

    B = len(seqs1)
    if result.spans != (0, 0, 0, 0):
        return [None] * B
    conv = np.asarray(result.converged)[:B]
    if not conv.any():
        return [None] * B
    hist = result.device_hist()
    seeds = walk_seeds(result, seqs1, seqs2, hist.device)
    W = walk_width(int(seeds.budget.max()))
    packed, n_ops, ok = wfa_walk(hist, seeds, result.k_lo, result.stride,
                                 penalties, W)
    n_words = max(1, -(-int(n_ops.max()) // 16))
    packed = packed[:, :n_words].cpu().numpy()
    ok = ok.cpu().numpy()
    alns = decode_packed_alignments(packed, seqs1, seqs2)
    return [a if ok[b] else None for b, a in enumerate(alns)]


def wfa_ends_free_traceback_host(
    result: WfaBatchResult,
    b: int,
    seq1: bytes,
    seq2: bytes,
    penalties: WfaPenalties = WfaPenalties(),
) -> Tuple[int, str, str]:
    """One pair's bounded-ends-free alignment, the free end skips
    assembled as end gaps (the textbook semi-global layout: skipped chars
    against '-' runs).  Returns (penalty, aligned_seq1, aligned_seq2)."""
    if not bool(np.asarray(result.converged)[b]):
        raise AlignmentError("WFA did not converge within band/s_max")
    s = int(np.asarray(result.score)[b])
    n1, n2 = len(seq1), len(seq2)
    dtar = n1 - n2
    k_end = int(np.asarray(result.end_k)[b])
    t_end = n2 if k_end <= dtar else n1 - k_end
    mid1, mid2, k0, t0 = _walk_hist(
        result, b, seq1, seq2, penalties, k_end, t_end
    )
    # Start skips: y0 = t0 + k0 free seq1 chars, x0 = t0 free seq2 chars
    # (one of them is 0).  End skips: n1 - y_end seq1 / n2 - x_end seq2.
    x0, y0 = t0, t0 + k0
    x1, y1 = t_end, t_end + k_end
    a1 = (
        seq1[:y0].decode("latin-1") + "-" * x0 + mid1
        + seq1[y1:].decode("latin-1") + "-" * (n2 - x1)
    )
    a2 = (
        "-" * y0 + seq2[:x0].decode("latin-1") + mid2
        + "-" * (n1 - y1) + seq2[x1:].decode("latin-1")
    )
    return s, a1, a2

"""Data-parallel batch runner: the port of parallel/runner.py.

Pairs are laid out in rows (the streamed fill's layout, or one pair a row
for the per-pair kernel) and the rows are split into contiguous blocks, one
a device of the runner's list (parallel.mesh.make_mesh), in row order.
Each device fills its own block; the finals come back either gathered (each
device's rows concatenated onto the first device, and with several
processes all-gathered across them) or as the per-device blocks.

On the card the fill and the walk of a batch are queued on each device's
stream one after the other, with no host synchronisation between them: the
walk's seeds are computed on the device from the fill's finals and the
batch's lengths, and only the walks' 2-bit op codes come back to the host
(``fill_walk_from_stream_args``, ``fill_walk_modes_from_stream_args``).

Per-pair failure isolation is structural: padding rows align to throwaway
scores and are dropped on the host.  A pair whose walk fails validation is
re-walked on the host from its dirs row on the CPU; on a card it is that
pair's AlignmentError naming the walk kernel (the named divergence of
ROADMAP.md §3), as in the aligners.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.errors import AlignmentError
from sequencealigning_tpu_torch.io.encode import (
    PairBatch,
    WireBatch,
    round_up,
    trim_for_stream,
    wire_pack_codes,
)
from sequencealigning_tpu_torch.ops.nw_affine import gotoh_fill
from sequencealigning_tpu_torch.ops.nw_affine_modes import modes_reduce
from sequencealigning_tpu_torch.ops.nw_affine_stream import (
    check_stream_stalls,
    gotoh_fill_stream,
    plan_stream,
    check_stream_state,
    resolve_stream_state,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream_modes import (
    gotoh_fill_stream_modes,
)
from sequencealigning_tpu_torch.ops.traceback import fast4_traceback_pair
from sequencealigning_tpu_torch.ops.traceback_device import (
    WALK_ROUTES,
    decode_modes_walk,
    decode_packed_alignments,
    use_device_walk,
    walk_fast4,
    walk_modes,
)
from sequencealigning_tpu_torch.parallel.mesh import (
    make_mesh,
    process_count,
    process_index,
)


def _unpack_wire(p2, nm, lens, L: int, has_n: bool):
    """Device-side unpack of the 2-bit wire format (io.encode.
    wire_pack_codes): (R, NP, ceil(L/4)) uint8 packed bases [+ (R, NP,
    ceil(L/8)) uint8 N bitmask] + (R, NP) int32 true lengths -> (R, NP, L)
    int32 one-hot nibble codes, bit-identical to the unpacked host layout
    (PAD = 0 beyond each slot's true length, N = 15 where the mask is
    set).  Elementwise torch bit operations on the shard's device."""
    p = p2.to(torch.int32)
    k = torch.stack([(p >> (2 * i)) & 3 for i in range(4)], dim=-1)
    codes = torch.bitwise_left_shift(torch.ones_like(k), k)
    codes = codes.reshape(tuple(p2.shape[:-1]) + (p2.shape[-1] * 4,))
    codes = codes[..., :L]
    if has_n:
        nb = nm.to(torch.int32)
        bits = torch.stack([(nb >> i) & 1 for i in range(8)], dim=-1)
        nbit = bits.reshape(tuple(nm.shape[:-1]) + (nm.shape[-1] * 8,))
        codes = torch.where(nbit[..., :L] != 0, 15, codes)
    pos = torch.arange(L, dtype=torch.int32, device=p2.device)
    return torch.where(pos < lens[..., None], codes, 0).to(torch.int32)


def _mk_streams(q_r, d_r, plan):
    """Per-row code streams (R, T) int32 from the (R, NP, L) codes: slot k's
    codes start at step k*S + 1, zeros elsewhere (as
    ops.nw_affine_stream.build_stream_inputs lays them out)."""
    S, T = plan.s, plan.t_total

    def one(a):
        r, np_, l = a.shape
        s_ = F.pad(a, (1, S - l - 1)).reshape(r, np_ * S)
        return F.pad(s_, (0, T - np_ * S)).contiguous()

    return one(q_r), one(d_r)


def _seed_plane(finals: torch.Tensor) -> torch.Tensor:
    """(n,) int32 start planes from (n, 3) corner finals on their device,
    priority M > I > D (ops.traceback_device.seed_planes' rule)."""
    score = finals.max(dim=1).values
    return torch.where(
        finals[:, 0] == score, 0, torch.where(finals[:, 1] == score, 1, 2)
    ).to(torch.int32)


def _all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Concatenate every process's t along dim 0, in rank order."""
    n = process_count()
    t = t.contiguous()
    full = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                       device=t.device)
    dist.all_gather_into_tensor(full, t)
    return full


def _head(x, n: int):
    """The first n rows of a gathered tensor, or of a list of per-device
    row blocks (the blocks trimmed to them)."""
    if isinstance(x, torch.Tensor):
        return x[:n]
    out, left = [], n
    for t in x:
        out.append(t[:max(left, 0)])
        left -= t.shape[0]
    return out


def to_host(x) -> np.ndarray:
    """A runner result (a tensor, or per-device row blocks) as one numpy
    array.  Reading it waits for the fills behind it, whose stalled waits
    then raise here (ops.nw_affine_stream.check_stream_stalls)."""
    if isinstance(x, torch.Tensor):
        out = x.cpu().numpy()
    elif isinstance(x, np.ndarray):
        out = x
    else:
        out = np.concatenate([t.cpu().numpy() for t in x])
    check_stream_stalls()
    return out


class DataParallelRunner:
    """Splits batches of pairs over the runner's devices by rows and runs
    the fill: ``kernel="stream"`` the streamed fill (kernel #1, and #2 for
    the textbook modes), ``kernel="plain"`` the per-pair global fill
    (kernel #7, score-only).  ``traceback``: "auto" walks on the device
    when the devices are CUDA and on the host on the CPU; "device" and
    "host" force.  ``state_dtype``: the streamed fills' score state, "i32",
    "i16" or "auto", resolved on each batch's plan
    (ops.nw_affine_stream.resolve_stream_state, as the JAX package's
    runner); an uncertified "i16" raises ValueError at the fill."""

    def __init__(
        self,
        devices=None,
        scheme: ScoringScheme = ScoringScheme(),
        compat: bool = True,
        wildcard: bool = False,
        gather: bool = True,
        kernel: str = "stream",
        np_slots: int = 32,
        state_dtype="i32",
        traceback: str = "auto",
    ):
        if kernel not in ("stream", "plain"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if traceback not in WALK_ROUTES:
            raise ValueError(f"unknown traceback route {traceback!r}")
        check_stream_state(state_dtype)
        self.devices = make_mesh(devices)
        self.scheme = scheme
        self.compat = compat
        self.wildcard = wildcard
        self.gather = gather
        self.kernel = kernel
        self.np_slots = np_slots
        self.state_dtype = state_dtype
        self.traceback = traceback

    @property
    def n_devices(self) -> int:
        """Devices of the run: this process's times the process count."""
        return len(self.devices) * process_count()

    def walk_on_device(self) -> bool:
        """The fast4 / modes walk route for the streaming cigars path
        (ops.traceback_device.use_device_walk on the runner's devices)."""
        return use_device_walk(self, self.devices[0])

    def _gather(self, parts: Sequence[torch.Tensor]):
        """The result merge of per-device row blocks (see the module
        docstring)."""
        if not self.gather:
            return list(parts)
        out = torch.cat([p.to(self.devices[0]) for p in parts])
        if process_count() > 1:
            out = _all_gather_rows(out)
        return out

    # -- stream arguments --------------------------------------------------

    def _stream_args_host(self, batch):
        """Host half of _stream_args: trim, pad, wire-pack and the capture
        parameters, no device traffic.  Returns (host arrays, plan, B,
        has_n); the arrays are (q2, d2, qn, dn, qll, dll, dsum, n2), the
        sequences (R, NP, W) uint8 (qn/dn None without N), the lengths
        (R, NP) int32 (padding pairs have length 1) and dsum/n2 (NP, R)
        int32.  With several processes ``batch`` is this process's input
        shard, the arrays hold its rows only and the plan is global: pair j
        of process p is global pair p * Bp / nproc + j (mp_local_slice)."""
        nd = self.n_devices
        nproc = process_count()
        if isinstance(batch, WireBatch):
            B = batch.size
            L1, L2 = batch.l1, batch.l2
            q2, qn, d2, dn = batch.q2, batch.qn, batch.d2, batch.dn
            qlen_in, dlen_in = batch.query_len, batch.db_len
        else:
            batch = trim_for_stream(batch)
            B = batch.query.shape[0]
            L1 = batch.query.shape[1]
            L2 = batch.db.shape[1]
            q2, qn = wire_pack_codes(np.asarray(batch.query))
            d2, dn = wire_pack_codes(np.asarray(batch.db))
            qlen_in = np.asarray(batch.query_len, np.int32)
            dlen_in = np.asarray(batch.db_len, np.int32)
        NP = max(1, min(self.np_slots, B * nproc // (8 * nd)))
        Bp_total = round_up(max(B * nproc, NP * 8 * nd), NP * 8 * nd)
        plan = plan_stream(Bp_total, L1, L2, np_slots=NP)
        Bp = Bp_total // nproc

        def padb(a, w):
            out = np.zeros((Bp, w), dtype=np.uint8)
            out[:B] = a
            return out

        def pad32(a, fill):
            out = np.full((Bp,), fill, dtype=np.int32)
            out[:B] = a
            return out

        R = Bp // NP
        has_n = qn is not None or dn is not None
        q2 = padb(q2, q2.shape[1]).reshape(R, NP, -1)
        d2 = padb(d2, d2.shape[1]).reshape(R, NP, -1)
        if has_n:
            w_q, w_d = -(-L1 // 8), -(-L2 // 8)
            qn = (padb(qn, w_q) if qn is not None
                  else np.zeros((Bp, w_q), np.uint8)).reshape(R, NP, -1)
            dn = (padb(dn, w_d) if dn is not None
                  else np.zeros((Bp, w_d), np.uint8)).reshape(R, NP, -1)
        else:
            qn = dn = None
        qlen = pad32(qlen_in, 1)
        dlen = pad32(dlen_in, 1)
        dsum = np.ascontiguousarray((qlen + dlen).reshape(R, NP).T)
        n2 = np.ascontiguousarray(dlen.reshape(R, NP).T)
        if nproc > 1:
            B = plan.n_rows * NP  # finals come back global; no local slice
        host = (q2, d2, qn, dn, qlen.reshape(R, NP), dlen.reshape(R, NP),
                dsum, n2)
        return host, plan, B, has_n

    def _put_stream_args(self, host_args, has_n: bool):
        """Move the _stream_args_host arrays onto the devices: one tuple a
        device, holding its contiguous block of this process's rows."""
        q2, d2, qn, dn, qll, dll, dsum, n2 = host_args
        R = q2.shape[0]
        nloc = len(self.devices)
        if R % nloc:
            raise ValueError(f"{R} rows do not split over {nloc} devices")
        rd = R // nloc
        shards = []
        for i, dev in enumerate(self.devices):
            rows = slice(i * rd, (i + 1) * rd)

            def put(a, rows=rows, dev=dev, slot_axis=False):
                if a is None:
                    return None
                a = a[:, rows] if slot_axis else a[rows]
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            shards.append((
                put(q2), put(d2), put(qn), put(dn), put(qll), put(dll),
                put(dsum, slot_axis=True), put(n2, slot_axis=True),
            ))
        return shards

    def _stream_args(self, batch):
        """(per-device args, plan, B, has_n) for the streamed fill."""
        host_args, plan, B, has_n = self._stream_args_host(batch)
        return self._put_stream_args(host_args, has_n), plan, B, has_n

    def mp_local_slice(self, plan) -> slice:
        """The slice of the gathered global finals holding THIS process's
        pairs, in its local row-major order (pair j of process p = global
        index p * Bp/nproc + j)."""
        nproc = process_count()
        bp = plan.n_rows * plan.np_slots
        lo = process_index() * (bp // nproc)
        return slice(lo, lo + bp // nproc)

    def _streams(self, shard, plan):
        q2, d2, qn, dn, qll, dll, dsum, n2 = shard
        has_n = qn is not None
        qs, ds = _mk_streams(_unpack_wire(q2, qn, qll, plan.l1, has_n),
                             _unpack_wire(d2, dn, dll, plan.l2, has_n), plan)
        return qs, ds, dsum, n2, plan._replace(n_rows=q2.shape[0])

    # -- global fill and walk ----------------------------------------------

    def _stream_fill_body(self, shard, plan, dirs_mode):
        """One device's streamed GLOBAL fill: wire unpack -> stream build ->
        kernel.  Returns (local finals (R_dev * NP, 3), dirs or None)."""
        qs, ds, dsum, n2, lplan = self._streams(shard, plan)
        return gotoh_fill_stream(qs, ds, dsum, n2, lplan, self.scheme,
                                 self.compat, self.wildcard, dirs_mode,
                                 self.stream_state(plan))

    def stream_state(self, plan):
        """The score state of the streamed fills on a batch's plan."""
        return resolve_stream_state(self.state_dtype, self.scheme, plan)

    def _scores_stream(self, batch):
        args, plan, B, has_n = self._stream_args(batch)
        return self.scores_from_stream_args(args, plan, B, has_n)

    def scores_from_stream_args(self, args, plan, B: int, has_n: bool):
        """The streamed score fill on args already on the devices (the
        streaming pipeline prepares batch k+1 while batch k runs)."""
        parts = [self._stream_fill_body(a, plan, None)[0] for a in args]
        return _head(self._gather(parts), B)

    def fill_with_dirs(self, batch, dirs_mode: str = "fast4"):
        """Streamed fill WITH direction words: (finals[:B] gathered per
        self.gather, dirs -- one (W, R_dev, P) tensor a device, plan)."""
        if self.kernel != "stream":
            raise ValueError("fill_with_dirs requires kernel='stream'")
        args, plan, B, has_n = self._stream_args(batch)
        return self.fill_with_dirs_from_stream_args(args, plan, B, has_n,
                                                    dirs_mode)

    def fill_with_dirs_from_stream_args(self, args, plan, B: int,
                                        has_n: bool, dirs_mode="fast4"):
        """fill_with_dirs on args already on the devices."""
        outs = [self._stream_fill_body(a, plan, dirs_mode) for a in args]
        finals = _head(self._gather([o[0] for o in outs]), B)
        return finals, [o[1] for o in outs], plan

    def _walk_coords(self, n: int, plan, dev):
        """Device-local (row, lane offset) of a device's n pairs."""
        bs = torch.arange(n, dtype=torch.int32, device=dev)
        return bs // plan.np_slots, (bs % plan.np_slots) * plan.s

    def device_walk_fast4_dispatch(self, dirs, plan, finals_dev, n1s, n2s):
        """Queue the fast4 walk of every device's pairs behind its fill,
        with no host synchronisation: each device's seed planes come from
        its rows of finals_dev (the UNsliced (Bp, 3) finals, global with
        several processes) on the device.  n1s/n2s: true lengths of this
        process's B real pairs (padding walks from (1, 1)).  Returns
        handles for device_walk_fast4_finish."""
        NP, R = plan.np_slots, plan.n_rows
        n_loc = NP * R // process_count()
        n1 = np.ones(n_loc, np.int32)
        n2 = np.ones(n_loc, np.int32)
        n1[:len(n1s)] = n1s
        n2[:len(n2s)] = n2s
        g0 = self.mp_local_slice(plan).start
        per = n_loc // len(self.devices)
        walks = []
        for i, (d, dev) in enumerate(zip(dirs, self.devices)):
            lo = i * per
            fin = torch.as_tensor(finals_dev[g0 + lo: g0 + lo + per]).to(dev)
            walks.append(self._walk_fast4(
                d, torch.from_numpy(n2[lo: lo + per]).to(dev),
                torch.from_numpy(n1[lo: lo + per]).to(dev), fin, plan))
        return walks, dirs, plan

    def _walk_fast4(self, dirs, x0, y0, finals, plan):
        rowp, off = self._walk_coords(x0.shape[0], plan, dirs.device)
        return walk_fast4(dirs, x0, y0, _seed_plane(finals), rowp, off,
                          t_steps=int(plan.l1 + plan.l2), check_bounds=False)

    def _dirs_row(self, dirs, row: int) -> np.ndarray:
        """This process's local row ``row`` of the per-device dirs."""
        rd = dirs[0].shape[1]
        return dirs[row // rd][:, row % rd, :].cpu().numpy()

    def device_walk_fast4_finish(self, handles, finals, seqs1, seqs2):
        """Fetch and decode a dispatched fast4 walk: only the used prefix of
        the packed op codes and the end cells leave the devices.  finals:
        (>= B, 3) finals, global with several processes.  Returns per pair
        (score, [(a1, a2)]) or an AlignmentError; a pair whose walk failed
        validation is re-walked on the host from its dirs row on the CPU
        and is an AlignmentError naming the walk kernel on a card."""
        finals = to_host(finals)
        if process_count() > 1:
            return self._device_walk_finish_mp(handles, finals, seqs1, seqs2)
        return self._finish_fast4(handles, finals, seqs1, seqs2, 0)

    def _device_walk_finish_mp(self, handles, finals, seqs1, seqs2):
        """device_walk_fast4_finish with several processes: each process
        fetches its own devices' walk outputs and decodes its OWN pairs,
        in local order; no op code crosses a process boundary.  finals:
        the GLOBAL gathered (Bp, 3) finals."""
        plan = handles[2]
        loc = self.mp_local_slice(plan)
        return self._finish_fast4(handles, finals[loc], seqs1, seqs2,
                                  loc.start // plan.np_slots)

    def _finish_fast4(self, handles, finals_l, seqs1, seqs2, row0: int):
        walks, dirs, plan = handles
        B = len(seqs1)
        n_words = max(max(1, -(-int(w[3].max()) // 16)) for w in walks)
        packed = np.concatenate(
            [w[2][:, :n_words].cpu().numpy() for w in walks])[:B]
        xf = np.concatenate([w[0].cpu().numpy() for w in walks])[:B]
        yf = np.concatenate([w[1].cpu().numpy() for w in walks])[:B]
        alns = decode_packed_alignments(packed, seqs1, seqs2)
        ended = (xf == 0) & (yf == 0)
        out = []
        for b in range(B):
            if alns[b] is not None and ended[b]:
                out.append((int(finals_l[b].max()), [alns[b]]))
                continue
            if dirs[0].is_cuda:
                out.append(AlignmentError(
                    "device fast4 walk (walk_fast4_cuda) failed validation"))
                continue
            row, _slot, doff = plan.pair_coords(row0 * plan.np_slots + b)
            try:
                out.append(fast4_traceback_pair(
                    self._dirs_row(dirs, row - row0), finals_l[b], seqs1[b],
                    seqs2[b], compat=self.compat, d_offset=doff))
            except AlignmentError as e:
                out.append(e)
        return out

    def device_walk_fast4(self, dirs, plan, finals, seqs1, seqs2):
        """Synchronous on-device fast4 walk over fill_with_dirs' per-device
        dirs: dispatch + finish.  finals: host (>= B, 3) finals."""
        finals = to_host(finals)
        B = len(seqs1)
        fin_full = np.zeros((plan.np_slots * plan.n_rows, 3), np.int32)
        fin_full[:B] = finals[:B]
        handles = self.device_walk_fast4_dispatch(
            dirs, plan, fin_full,
            [len(s) for s in seqs1], [len(s) for s in seqs2],
        )
        return self.device_walk_fast4_finish(handles, finals, seqs1, seqs2)

    def host_walk_fast4(self, dirs, plan, finals, seqs1, seqs2):
        """The host route of the fast4 walk: every pair walked on the host
        from its dirs row (fetched once, whole)."""
        finals = to_host(finals)
        host = np.concatenate([d.cpu().numpy() for d in dirs], axis=1)
        out = []
        for b, (s1, s2) in enumerate(zip(seqs1, seqs2)):
            row, _slot, doff = plan.pair_coords(b)
            try:
                out.append(fast4_traceback_pair(
                    host[:, row, :], finals[b], s1, s2, compat=self.compat,
                    d_offset=doff))
            except AlignmentError as e:
                out.append(e)
        return out

    def fill_walk_from_stream_args(self, args, plan, B: int, has_n: bool,
                                   seqs1, seqs2):
        """The streamed fast4 fill AND its walk on args already on the
        devices, queued back to back on each device with no host
        synchronisation: the walk's seeds are the args' true lengths
        (padding slots carry length 1) and the start planes computed on
        the device from the fill's local finals.  Returns (finals[:B],
        walk handles for device_walk_fast4_finish)."""
        parts, walks, dirs = [], [], []
        for a in args:
            fin, d = self._stream_fill_body(a, plan, "fast4")
            qll, dll = a[4], a[5]
            walks.append(self._walk_fast4(d, dll.reshape(-1),
                                          qll.reshape(-1), fin, plan))
            parts.append(fin)
            dirs.append(d)
        return _head(self._gather(parts), B), (walks, dirs, plan)

    # -- modes -------------------------------------------------------------

    def _stream_modes_fill_body(self, shard, plan, mode: str,
                                with_dirs: bool = True):
        """One device's streamed MODES fill and its end-cell reduction on
        the device: (best, x, y) (R_dev * NP,) int32 and the dirs."""
        qs, ds, dsum, n2, lplan = self._streams(shard, plan)
        (bv, bd), dirs = gotoh_fill_stream_modes(
            qs, ds, dsum, n2, lplan, self.scheme, self.wildcard, mode,
            with_dirs, self.stream_state(plan),
        )
        P = plan.p
        best, x, y = modes_reduce(bv.transpose(0, 1).reshape(-1, P),
                                  bd.transpose(0, 1).reshape(-1, P))
        return best, x, y, dirs

    @staticmethod
    def _check_mode(mode: str) -> None:
        if mode not in ("semi", "local"):
            raise ValueError(f"unknown mode {mode!r}")

    def fill_modes(self, batch, mode: str, with_dirs: bool = True):
        """Semi-global/local streamed fill (textbook semantics).  Returns
        (best[:B], best_x[:B], best_y[:B], dirs, plan) -- each pair's end
        cell, reduced on the devices; walk the dirs from (x, y) with
        d_offset = slot * plan.s."""
        if self.kernel != "stream":
            raise ValueError("fill_modes requires kernel='stream'")
        self._check_mode(mode)
        args, plan, B, has_n = self._stream_args(batch)
        return self.fill_modes_from_stream_args(args, plan, B, has_n, mode,
                                                with_dirs)

    def fill_modes_from_stream_args(self, args, plan, B: int, has_n: bool,
                                    mode: str, with_dirs: bool = True):
        """fill_modes on args already on the devices."""
        self._check_mode(mode)
        outs = [self._stream_modes_fill_body(a, plan, mode, with_dirs)
                for a in args]
        best, x, y = (_head(self._gather([o[k] for o in outs]), B)
                      for k in range(3))
        dirs = [o[3] for o in outs] if with_dirs else None
        return best, x, y, dirs, plan

    def _walk_modes(self, dirs, x, y, plan, local: bool):
        rowp, off = self._walk_coords(x.shape[0], plan, dirs.device)
        return walk_modes(dirs, x, y, rowp, off, local,
                          int(plan.l1 + plan.l2), check_bounds=False)

    def device_walk_modes_dispatch(self, dirs, plan, x_dev, y_dev,
                                   mode: str):
        """Queue the modes walk of every device's pairs behind its fill
        with no host synchronisation, from the full (Bp,) end cells (global
        with several processes; host arrays or tensors).  Returns handles
        for device_walk_modes_finish."""
        local = mode == "local"
        g0 = self.mp_local_slice(plan).start
        per = plan.n_rows * plan.np_slots // process_count()
        per //= len(self.devices)
        walks, xs, ys = [], [], []
        for i, (d, dev) in enumerate(zip(dirs, self.devices)):
            lo = g0 + i * per
            x = torch.as_tensor(x_dev[lo: lo + per]).to(dev, torch.int32)
            y = torch.as_tensor(y_dev[lo: lo + per]).to(dev, torch.int32)
            walks.append(self._walk_modes(d, x, y, plan, local))
            xs.append(x)
            ys.append(y)
        return walks, xs, ys, dirs, plan, local

    def device_walk_modes_finish(self, handles, seqs1, seqs2):
        """Fetch and decode a dispatched modes walk: per pair the walked
        segment (mid1, mid2, stop_x, stop_y), or None where the walk failed
        validation.  Each process decodes its own pairs."""
        walks, xs, ys, _dirs, _plan, _local = handles
        B = len(seqs1)
        n_words = max(max(1, -(-int(w[4].max()) // 16)) for w in walks)

        def cat(parts):
            return np.concatenate([t.cpu().numpy() for t in parts])[:B]

        packed = cat([w[3][:, :n_words] for w in walks])
        return decode_modes_walk(
            packed, cat([w[0] for w in walks]), cat([w[1] for w in walks]),
            cat([w[2] for w in walks]), cat(xs), cat(ys), seqs1, seqs2,
        )

    def device_walk_modes(self, dirs, plan, best_x, best_y, seqs1, seqs2,
                          mode: str):
        """Synchronous modes walk over fill_modes' per-device dirs;
        best_x/best_y: host arrays or tensors sized >= B."""
        Bp = plan.np_slots * plan.n_rows
        B = len(seqs1)
        x0 = np.zeros(Bp, np.int32)
        y0 = np.zeros(Bp, np.int32)
        x0[:B] = to_host(best_x)[:B]
        y0[:B] = to_host(best_y)[:B]
        handles = self.device_walk_modes_dispatch(dirs, plan, x0, y0, mode)
        return self.device_walk_modes_finish(handles, seqs1, seqs2)

    def fill_walk_modes_from_stream_args(self, args, plan, B: int,
                                         has_n: bool, mode: str):
        """The streamed textbook fill (semi/local), its end-cell reduction
        AND its modes walk on args already on the devices, queued back to
        back on each device: the walk seeds straight from each device's
        reduced end cells, and the dirs never leave the devices on the
        happy path.  Returns (best[:B], x[:B], y[:B], walk handles for
        device_walk_modes_finish, dirs, plan)."""
        self._check_mode(mode)
        local = mode == "local"
        outs, walks = [], []
        for a in args:
            best, x, y, d = self._stream_modes_fill_body(a, plan, mode)
            walks.append(self._walk_modes(d, x, y, plan, local))
            outs.append((best, x, y, d))
        dirs = [o[3] for o in outs]
        handles = (walks, [o[1] for o in outs], [o[2] for o in outs], dirs,
                   plan, local)
        best, x, y = (_head(self._gather([o[k] for o in outs]), B)
                      for k in range(3))
        return best, x, y, handles, dirs, plan

    def dirs_fetch(self, dirs, plan, b: int):
        """(dirs row, d_offset) of this process's pair b, for the host
        walkers (ops.traceback_device.assemble_modes_alignments)."""
        row0 = self.mp_local_slice(plan).start // plan.np_slots
        row, _slot, d_off = plan.pair_coords(row0 * plan.np_slots + b)
        return self._dirs_row(dirs, row - row0), d_off

    # -- scores --------------------------------------------------------------

    def scores(self, batch: PairBatch):
        """(B, 3) int32 finals (M/I/D at each pair's corner), gathered per
        self.gather.  kernel='stream' pads the batch to np_slots * 8 *
        n_devices pairs; kernel='plain' (kernel #7, one pair a row) to a
        multiple of 8 * the devices.  With several processes the finals are
        the global rows (pair j of process p at p * Bp_local + j)."""
        if self.kernel == "stream":
            return self._scores_stream(batch)
        nloc = len(self.devices)
        B = batch.query.shape[0]
        Bp = round_up(max(B, 8 * nloc), 8 * nloc)
        L1 = batch.query.shape[1]
        L2 = batch.db.shape[1]
        P = round_up(L2 + 1, 128)

        def pad(a):
            out = np.zeros((Bp,) + a.shape[1:], dtype=np.int32)
            out[:B] = a
            return out

        query = pad(np.asarray(batch.query, np.int32))
        s2v = np.zeros((Bp, P), np.int32)
        s2v[:B, 1: L2 + 1] = batch.db
        dlen = pad(np.asarray(batch.db_len, np.int32))
        qlen = pad(np.asarray(batch.query_len, np.int32))
        dsum = (qlen + dlen)[:, None].astype(np.int32)
        n2mask = (np.arange(P, dtype=np.int32)[None, :]
                  == dlen[:, None]).astype(np.int32)
        rd = Bp // nloc
        parts = []
        for i, dev in enumerate(self.devices):
            rows = slice(i * rd, (i + 1) * rd)
            put = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a[rows])).to(dev)
            fin, _ = gotoh_fill(put(query), put(s2v), put(dsum), put(n2mask),
                                L1, L2, self.scheme, self.compat,
                                self.wildcard, with_dirs=False)
            parts.append(fin)
        finals = self._gather(parts)
        return finals if process_count() > 1 else _head(finals, B)


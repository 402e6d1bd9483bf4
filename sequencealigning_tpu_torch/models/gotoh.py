"""Affine-gap NW (Gotoh) aligner: the port of models/gotoh.py.

Global mode: a batch is packed and trimmed exactly as in the JAX package,
filled by the streamed fill (ops.nw_affine_stream) on the aligner's device
with config.stream_state's score state, and traced back from the fast4
codes (first_only) or on the host from the full 7-bit codes (the
reference's co-optimal enumeration, ops.traceback.traceback_stream_batch).
config.traceback routes the first-path, modes and long-pair walks as the
JAX package does (ops.traceback_device.use_device_walk): on the device
(the walk kernels on the card, their plain versions on the CPU) or on the
host (the host walkers and the native decoder, the dirs fetched once).
On the card a device-walked first-only batch goes through the
data-parallel runner's fill+walk (parallel.runner, as the JAX package's
production route); the other routes fill directly.

Semi-global and local: compat mode answers with the reference's per-pair
"not implemented"; textbook mode fills with the streamed modes engine
(ops.nw_affine_stream_modes, 32 pairs or more) or the per-pair one
(ops.nw_affine_modes), walks the full direction bytes on the device
(ops.traceback_device.walk_modes) and assembles the alignments.

Long pairs (db beyond long_pair_lanes, ~49 kb; the CUDA fills take every
lane width up to it, splitting a row over a thread-block cluster past 8192
lanes) take the JAX package's long-pair path: exact scores from the tiled
fill (ops.nw_affine_tiled: kernel #4 for 6 pairs or more, kernel #5 for 1-4
similar pairs and for serial singles), then a fast4 banded fill
(ops.nw_banded_diag) with band doubling until each pair's banded score
equals its exact score, walked on the card (CUDA) or on the host (CPU), and
Myers-Miller (ops.mm_align) for the pairs that escape the largest band."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from sequencealigning_tpu_torch.config import Mode
from sequencealigning_tpu_torch.errors import AlignerError, AlignmentError
from sequencealigning_tpu_torch.io.encode import (
    pack_batch,
    round_up,
    trim_for_stream,
)
from sequencealigning_tpu_torch.ops.traceback import (
    _apply_ops,
    banded_diag_fast4_traceback_pair,
    fast4_traceback_pair,
    traceback_stream_batch,
)
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.models.base import Aligner
from sequencealigning_tpu_torch.ops.mm_align import mm_align, mm_score_ops
from sequencealigning_tpu_torch.ops.nw_affine_modes import (
    nw_affine_modes_batch,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream import (
    nw_affine_stream_batch,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream_modes import (
    nw_affine_stream_modes_batch,
)
from sequencealigning_tpu_torch.ops.nw_affine_tiled import (
    nw_affine_tiled_batch,
    nw_affine_tiled_fold_batch,
    nw_affine_tiled_single,
)
from sequencealigning_tpu_torch.ops.nw_banded_diag import nw_banded_diag_batch
from sequencealigning_tpu_torch.ops.traceback_device import (
    assemble_modes_alignments,
    banded_diag_device_tbs,
    fast4_stream_align_device,
    modes_walk_device,
    use_device_walk,
)


class GotohAligner(Aligner):
    # Lane width beyond which a batch leaves the streamed fill for the
    # long-pair path (_long_batch); the JAX package's value.
    long_pair_lanes = 49_152
    # Band-doubling cap of the long-pair alignment search.
    long_pair_max_band = 4096
    # Pairs from which textbook modes take the streamed engine (the JAX
    # package's threshold); smaller batches take the per-pair one.
    modes_stream_min_pairs = 32
    # Budget of a direction tensor that lands in host memory (every fill on
    # the CPU, and the co-optimal walk's full codes fetched from the card):
    # the JAX package's 9 GiB.  A first-only fill on a GPU may take half the
    # device memory free when the batch starts.
    dirs_host_budget = 9 * 2 ** 30

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device)
        # Pairs whose plain (CPU) walk failed validation and were re-walked
        # on the host (never expected with a healthy fill).
        self.host_fallbacks = 0

    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.mode is not Mode.GLOBAL:
            if self.config.compat:
                # Reference parity (needleman_wunsch_affine.rs:433-434).
                return [AlignmentError("not implemented") for _ in pairs]
            return self._modes_batch(pairs)
        batch = trim_for_stream(
            pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))
        )
        if batch.db.shape[1] + 2 > self.long_pair_lanes:
            return self._long_batch(pairs, batch)
        n_sub = self._dirs_chunks(batch, len(pairs))
        if n_sub > 1:
            # Fill and drain per sub-batch so one direction tensor at a time
            # is alive.
            out: List = []
            per = -(-len(pairs) // n_sub)
            for lo in range(0, len(pairs), per):
                out.extend(self._align_batch_impl(pairs[lo : lo + per]))
            return out
        np_slots = max(1, min(8, len(batch.query) // 8))
        first_only = getattr(self.config, "first_only", False)
        if first_only and use_device_walk(self.config, self.device) and (
                self.device.type == "cuda"):
            # On the card a first-only batch takes the data-parallel
            # runner's fill+walk: the fill and the walk queued back to back
            # with no host synchronisation, the sequences shipped 2-bit
            # packed.  Same kernels and walker as the direct route below,
            # so the same results.
            return self._runner_first_only_batch(pairs, batch)
        tb = to_device(batch, self.device)
        res = nw_affine_stream_batch(
            tb.query, tb.db, tb.query_len, tb.db_len,
            scheme=self.config.scoring,
            compat=self.config.compat,
            with_dirs="fast4" if first_only else True,
            np_slots=np_slots,
            state_dtype=getattr(self.config, "stream_state", "i32"),
        )
        if self.config.debug:
            from sequencealigning_tpu_torch.utils.guards import check_finals

            check_finals(
                res.finals[: len(pairs)],
                batch.query_len[: len(pairs)], batch.db_len[: len(pairs)],
                scheme=self.config.scoring, compat=self.config.compat,
                label="gotoh finals",
            )
        if first_only and use_device_walk(self.config, self.device,
                                          res.dirs):
            tb = self._traceback_device(res, pairs)
        else:
            tb = traceback_stream_batch(
                res.dirs.cpu().numpy(), res.finals,
                [p[0] for p in pairs], [p[1] for p in pairs], res.plan,
                compat=self.config.compat,
                dirs_mode="fast4" if first_only else "full",
            )
        out = []
        for r in tb:
            if isinstance(r, AlignerError):
                out.append(r)
                continue
            score, alns = r
            if not alns:
                out.append(AlignmentError("traceback produced no alignment"))
                continue
            out.append(
                dict(
                    score=score,
                    aligned_query=alns[0][0],
                    aligned_db=alns[0][1],
                    alignments=alns,
                )
            )
        return out

    def _dp_runner(self):
        """The aligner's DataParallelRunner for the first-only batch path,
        made on first use: the aligner's device, the direct route's
        pipeline depth (8 slots)."""
        r = getattr(self, "_dp_runner_cache", None)
        if r is None:
            from sequencealigning_tpu_torch.parallel.runner import (
                DataParallelRunner,
            )

            r = DataParallelRunner(
                [self.device], scheme=self.config.scoring,
                compat=self.config.compat, np_slots=8, traceback="device",
                state_dtype=getattr(self.config, "stream_state", "i32"),
            )
            self._dp_runner_cache = r
        return r

    def _runner_first_only_batch(self, pairs, batch):
        """First-path alignments through the runner's fill+walk and its
        finish (a pair whose walk fails validation is its AlignmentError
        naming the walk kernel, as on the direct route)."""
        from sequencealigning_tpu_torch.parallel.runner import to_host

        runner = self._dp_runner()
        args, plan, bp, has_n = runner._stream_args(batch)
        seqs1 = [p[0] for p in pairs]
        seqs2 = [p[1] for p in pairs]
        finals, handles = runner.fill_walk_from_stream_args(
            args, plan, bp, has_n, seqs1, seqs2)
        finals = to_host(finals)
        if self.config.debug:
            from sequencealigning_tpu_torch.utils.guards import check_finals

            check_finals(
                finals[: len(pairs)],
                batch.query_len[: len(pairs)], batch.db_len[: len(pairs)],
                scheme=self.config.scoring, compat=self.config.compat,
                label="gotoh finals",
            )
        out = []
        for r in runner.device_walk_fast4_finish(handles, finals, seqs1,
                                                 seqs2):
            if isinstance(r, AlignerError):
                out.append(r)
                continue
            score, alns = r
            out.append(dict(score=score, aligned_query=alns[0][0],
                            aligned_db=alns[0][1], alignments=alns))
        return out

    def _traceback_device(self, res, pairs):
        """The fast4 walk's plain version on the CPU (device-walked CUDA
        batches take _runner_first_only_batch).  A pair whose walk fails validation is
        re-walked on the host from its dirs row, as in the reference, and
        counted in host_fallbacks."""
        alns, scores = fast4_stream_align_device(
            res.dirs, res.finals,
            [p[0] for p in pairs], [p[1] for p in pairs], res.plan,
        )
        out = []
        for b, (s1, s2) in enumerate(pairs):
            if alns[b] is not None:
                out.append((int(scores[b]), [alns[b]]))
                continue
            self.host_fallbacks += 1
            row, _slot, off = res.plan.pair_coords(b)
            try:
                out.append(
                    fast4_traceback_pair(
                        res.dirs[:, row, :].numpy(), res.finals[b],
                        s1, s2, compat=self.config.compat, d_offset=off,
                    )
                )
            except AlignmentError as e:
                out.append(e)
        return out

    def _dirs_budget(self, host_fetch=None) -> int:
        """Bytes a direction tensor may take.  On the CPU it lands in host
        memory: dirs_host_budget.  On CUDA, half the free device memory,
        capped at dirs_host_budget when the walk fetches the codes to the
        host (host_fetch; by default the co-optimal walk does, the
        first-only walk does on the host route only)."""
        if self.device.type != "cuda":
            return self.dirs_host_budget
        free, _total = torch.cuda.mem_get_info(self.device)
        if host_fetch is None:
            host_fetch = not (getattr(self.config, "first_only", False)
                              and use_device_walk(self.config, self.device))
        if not host_fetch:
            return free // 2
        return min(free // 2, self.dirs_host_budget)

    def _dirs_chunks(self, batch, n_pairs: int, per_byte=None,
                     budget=None) -> int:
        """Number of fill-and-drain sub-batches that keep the direction
        tensor under budget.  Per pair the streamed layout stores ~s * P
        cells: 1 byte a cell in full mode, 1/2 byte in fast4 (per_byte;
        by default from config.first_only)."""
        l1 = batch.query.shape[1]
        l2 = batch.db.shape[1]
        s = round_up(max(l1, l2) + 1, 128)
        p = round_up(l2 + 2, 128)
        if per_byte is None:
            per_byte = 0.5 if getattr(self.config, "first_only", False) else 1.0
        if budget is None:
            budget = self._dirs_budget()
        total = n_pairs * s * p * per_byte
        return max(1, int(-(-total // budget)))

    def _long_batch(self, pairs: List[Tuple[bytes, bytes]], batch):
        """Long-pair path (db beyond long_pair_lanes), as the JAX package's
        GotohAligner._long_batch:

        1. exact corner finals from the tiled fill (score-only, any length):
           one folded launch for 1-4 similar-sized pairs, serial folded
           singles for fewer than 6 others, the batched fill otherwise;
        2. alignments from a fast4 banded fill of the whole batch with band
           doubling until a pair's banded score equals its exact score (the
           banded path is then provably optimal), walked on the card on CUDA
           (a failed walk is that pair's AlignmentError) and on the host on
           the CPU;
        3. Myers-Miller (ops.mm_align) for the pairs that escape the
           largest band (_mm_fallback)."""
        scheme, compat = self.config.scoring, self.config.compat
        nb = len(pairs)
        # The batch's padding rows are no pairs: the fills take the real
        # rows only (the band plan is the same with or without them).
        tb = [t[:nb] for t in to_device(batch, self.device)]
        cells = [max(1, len(a) * len(b)) for a, b in pairs]
        groups = {1: 1, 2: 2, 3: 4, 4: 4}.get(nb, 8)
        if nb <= 4 and sum(cells) >= 0.7 * groups * max(cells):
            # Few similar-sized long pairs: one folded launch; mixed sizes
            # (sum(cells) << groups * max) take serial folded singles.
            exact = nw_affine_tiled_fold_batch(*tb, scheme=scheme,
                                               compat=compat)
        elif nb < 6:
            exact = np.stack([
                nw_affine_tiled_single(s1, s2, scheme=scheme, compat=compat,
                                       device=self.device)
                for s1, s2 in pairs
            ])
        else:
            exact = nw_affine_tiled_batch(*tb, scheme=scheme, compat=compat)
        scores = exact[:nb].max(axis=1)
        out: List = [None] * nb
        pending = list(range(nb))
        band = max(self.config.band, 128)
        while pending and band <= self.long_pair_max_band:
            # Every round refills the whole batch: the band plan is the
            # batch's, and a narrower plan could pick another co-optimal
            # path.
            res = nw_banded_diag_batch(*tb, band=band, scheme=scheme,
                                       compat=compat, with_dirs="fast4")
            bf = res.finals[:nb]
            resolved = [b for b in pending
                        if int(bf[b].max()) == int(scores[b])]
            pending = [b for b in pending
                       if int(bf[b].max()) != int(scores[b])]
            tbs: List = []
            if resolved and use_device_walk(self.config, self.device,
                                            res.dirs):
                tbs = banded_diag_device_tbs(
                    res.dirs, bf, [pairs[b][0] for b in resolved],
                    [pairs[b][1] for b in resolved], res.k_lo_even,
                    compat=compat, pair_idx=np.asarray(resolved, np.int32),
                )
            elif resolved:
                dirs = res.dirs.cpu().numpy()
                for b in resolved:
                    try:
                        tbs.append(banded_diag_fast4_traceback_pair(
                            dirs[:, b, :], bf[b], pairs[b][0], pairs[b][1],
                            res.k_lo_even, compat=compat,
                        ))
                    except AlignerError as e:
                        tbs.append(e)
            for b, r in zip(resolved, tbs):
                if isinstance(r, AlignerError):
                    out[b] = r
                    continue
                score, alns = r
                out[b] = dict(score=score, aligned_query=alns[0][0],
                              aligned_db=alns[0][1], alignments=alns)
            del res
            band *= 2
        for b in pending:
            out[b] = self._mm_fallback(pairs[b], int(scores[b]))
        return out

    def _mm_fallback(self, pair, exact_score: int):
        """Myers-Miller on the aligner's device.  Its standard-model
        alignment is rescored (compat: plus the leading gap chain's extra
        extension) and kept only if it reaches the exact score; otherwise
        the exact score with the alignment explicitly absent."""
        s1, s2 = pair
        scheme = self.config.scoring
        try:
            ops = mm_align(s1, s2, scheme, device=self.device)
            got = mm_score_ops(ops, s1, s2, scheme)
            if self.config.compat and ops and ops[0] in "ID":
                # compat scores the leading gap chain o+(L+1)e: one extra
                # extension (needleman_wunsch_affine.rs:195,207).
                got += scheme.gap_extend
            if got == exact_score:
                a1, a2 = _apply_ops(ops, s1, s2)
                return dict(score=exact_score, aligned_query=a1,
                            aligned_db=a2)
        except AlignerError:
            pass
        return dict(score=exact_score, aligned_query=None, aligned_db=None)

    def _modes_batch(self, pairs: List[Tuple[bytes, bytes]]):
        """Textbook semi-global / local: fill, walk, assembly (as the JAX
        package's GotohAligner._modes_batch).  The dirs are full bytes; on
        the device route only op codes leave the device, so on CUDA a fill
        may take half the free device memory.  A failed device walk is
        re-walked on the host on the CPU, and is the pair's AlignmentError
        on CUDA; the host route walks every pair on the host."""
        local = self.config.mode is Mode.LOCAL
        batch = pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))
        n_sub = self._dirs_chunks(
            batch, len(pairs), per_byte=1.0, budget=self._dirs_budget(
                host_fetch=not use_device_walk(self.config, self.device)))
        if n_sub > 1:
            out: List = []
            per = -(-len(pairs) // n_sub)
            for lo in range(0, len(pairs), per):
                out.extend(self._modes_batch(pairs[lo : lo + per]))
            return out
        streamed = len(pairs) >= self.modes_stream_min_pairs
        l2 = batch.db.shape[1]
        tb = to_device(batch, self.device)
        if streamed:
            res = nw_affine_stream_modes_batch(
                tb.query, tb.db, tb.query_len, tb.db_len,
                "local" if local else "semi", scheme=self.config.scoring,
                state_dtype=getattr(self.config, "stream_state", "i32"),
            )
            bs = np.arange(len(pairs))
            rowp = bs // res.plan.np_slots
            offs = (bs % res.plan.np_slots) * res.plan.s
            t_steps = int(res.plan.l1 + res.plan.l2)
        else:
            res = nw_affine_modes_batch(
                tb.query, tb.db, tb.query_len, tb.db_len, local=local,
                scheme=self.config.scoring,
            )
            rowp = np.arange(len(pairs))
            offs = np.zeros(len(pairs), np.int64)
            t_steps = int(batch.query.shape[1] + l2)
        n = len(pairs)
        seqs1 = [p[0] for p in pairs]
        seqs2 = [p[1] for p in pairs]
        end_x, end_y = res.best_x[:n], res.best_y[:n]
        if use_device_walk(self.config, self.device, res.dirs):
            walked = modes_walk_device(res.dirs, end_x, end_y, rowp, offs,
                                       seqs1, seqs2, local, t_steps)

            def dirs_fetch(b):
                self.host_fallbacks += 1
                return res.dirs[:, int(rowp[b]), :].numpy(), int(offs[b])

            if self.device.type == "cuda":
                dirs_fetch = None
        else:
            # The host route: one fetch of the whole dirs tensor.
            walked, host_dirs = None, res.dirs.cpu().numpy()

            def dirs_fetch(b):
                return host_dirs[:, int(rowp[b]), :], int(offs[b])

        tbs = assemble_modes_alignments(
            pairs, walked, res.best[:n], end_x, end_y, local,
            dirs_fetch=dirs_fetch,
        )
        return [
            r if isinstance(r, AlignerError) else dict(
                score=r[0], aligned_query=r[1][0][0], aligned_db=r[1][0][1])
            for r in tbs
        ]

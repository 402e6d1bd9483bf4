"""WFA aligner: the port of models/wfa.py.

Reference: wfa_align (src/wfa.rs:23-42), global mode only (:24-27).

* compat: the reference's WFA with its quirks (the native engine, then the
  scalar oracle ops.oracle_wfa where the native engine declines a pair),
  the score reported as the reference reports it.
* textbook: exact gap-affine penalties, by one of four engines
  (config.wfa_engine): the banded Gotoh fill under the penalty-converted
  scheme with a band certificate ("banded"), the exact threaded native
  host engine ("native"), the wavefront engine ops.wfa ("wavefront": the
  fill kernel and the walk kernel on CUDA), or "auto" (native capped at
  wfa_native_s_cap, then banded).  Pairs that escape every band go to the
  exact Gotoh engine under the penalty-converted scheme, so every pair gets
  an exact penalty and an alignment.
* textbook semi-global and local with config.wfa_spans: the wavefront
  engine's bounded ends-free mode.

Unlike the JAX aligner, a native engine error raises (only
SEQALIGN_NO_NATIVE routes past the native engine), and on CUDA a pair whose
device walk fails validation is that pair's AlignmentError naming the walk
kernel, not a host re-walk."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np

from sequencealigning_tpu_torch.config import Mode, ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.errors import AlignerError, AlignmentError
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.models.base import Aligner
from sequencealigning_tpu_torch.ops import oracle_wfa
from sequencealigning_tpu_torch.ops.nw_banded_diag import nw_banded_diag_batch
from sequencealigning_tpu_torch.ops.traceback import (
    banded_diag_fast4_traceback_pair,
)
from sequencealigning_tpu_torch.ops.traceback_device import (
    banded_diag_device_tbs,
    use_device_walk,
)
from sequencealigning_tpu_torch.ops.wfa import (
    wfa_ends_free_traceback_host,
    wfa_textbook_batch,
    wfa_traceback_device,
    wfa_traceback_host,
)


def _padded(pairs):
    return pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))


class WfaAligner(Aligner):
    # Band-doubling cap of the wavefront engine's escape retries; past it
    # the Gotoh fallback is exact and cheaper.
    wfa_max_band = 256
    # Band cap and per-round fast4 dirs budget of the banded route.
    wfa_banded_max_band = 1024
    wfa_dirs_budget = 1 << 30
    # Penalty cap of the native leg of the auto route: pairs needing more
    # go to the banded route, whose cost does not grow with divergence.
    wfa_native_s_cap = 1024

    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.mode in (Mode.SEMI_GLOBAL, Mode.LOCAL) \
                and not self.config.compat:
            # Bounded ends-free WFA: unbounded ends-free is degenerate
            # under min-penalty scoring (the empty alignment costs 0), so
            # the span bounds make these modes well-posed; without them
            # both stay unimplemented, as in the reference.
            spans = getattr(self.config, "wfa_spans", None)
            if spans is not None:
                return self._ends_free_batch(pairs, tuple(spans))
        if self.config.mode is not Mode.GLOBAL:
            return [AlignmentError("not implemented") for _ in pairs]
        if self.config.compat:
            return self._compat_batch(pairs)
        return self._textbook_batch(pairs)

    def _ends_free_batch(self, pairs, spans):
        """Textbook semi-global / local by the wavefront engine's bounded
        ends-free mode, the free end skips assembled as end gaps; band
        doubling as the global wavefront route.  An engine-level failure
        (the offset log's length cap) is every pending pair's error."""
        out = [None] * len(pairs)
        pending = list(range(len(pairs)))
        band = self.config.band
        abort_cause = None
        while pending and band <= self.wfa_max_band:
            sub = [pairs[i] for i in pending]
            tb = to_device(_padded(sub), self.device)
            try:
                res = wfa_textbook_batch(
                    *tb, penalties=self.config.wfa_penalties, band=band,
                    spans=spans,
                )
            except AlignmentError as e:
                abort_cause = e
                break
            still = []
            for j, i in enumerate(pending):
                if not res.converged[j]:
                    still.append(i)
                    continue
                try:
                    score, a1, a2 = wfa_ends_free_traceback_host(
                        res, j, pairs[i][0], pairs[i][1],
                        self.config.wfa_penalties,
                    )
                    out[i] = dict(score=score, aligned_query=a1,
                                  aligned_db=a2)
                except AlignerError as e:
                    out[i] = e
            pending = still
            band *= 2
        for i in pending:
            out[i] = (
                AlignmentError(f"ends-free WFA failed: {abort_cause}")
                if abort_cause is not None
                else AlignmentError(
                    "ends-free WFA did not converge within band/s_max")
            )
        return out

    def _compat_batch(self, pairs):
        """The reference's WFA: the native engine, the oracle where it
        declines a pair (or with SEQALIGN_NO_NATIVE)."""
        use_native = not os.environ.get("SEQALIGN_NO_NATIVE")
        cfg = self.config
        out = []
        for s1, s2 in pairs:
            try:
                if use_native:
                    from sequencealigning_tpu_torch import native

                    r = native.wfa_compat_align_native(
                        s1, s2, cfg.wfa_penalties, cfg.wfa_pruning,
                        cfg.wfa_max_steps,
                    )
                    if r is not None:
                        score, a1, a2 = r
                        out.append(dict(score=score, aligned_query=a1,
                                        aligned_db=a2))
                        continue
                score, ocean = oracle_wfa.wfa_align(
                    s1, s2, penalties=cfg.wfa_penalties,
                    pruning=cfg.wfa_pruning, max_steps=cfg.wfa_max_steps,
                )
                a1, a2 = oracle_wfa.wfa_traceback(ocean, s1, s2)
                out.append(dict(score=score, aligned_query=a1, aligned_db=a2))
            except AlignerError as e:
                out.append(e)
        return out

    def _textbook_batch(self, pairs):
        """Engine dispatch (config.wfa_engine).  Min-penalty gap-affine WFA
        equals the negated banded Gotoh fill under (match=0, -x, -o, -e):
        in the reference model where mismatch <= 2*gap_extend (adjacent
        gap runs of the two directions are never optimal there), in the
        fill's any-state-open "std" model outside it."""
        engine = getattr(self.config, "wfa_engine", "auto")
        pen = self.config.wfa_penalties
        model = "ref" if pen.mismatch <= 2 * pen.gap_extend else "std"
        if engine == "banded":
            return self._banded_route(pairs, model=model)
        if engine == "wavefront":
            return self._wavefront_batch(pairs)
        if engine == "native":
            out = self._native_raw(pairs)
            if out is None:
                return self._wavefront_batch(pairs)
            return self._fill_rest(pairs, out, self._wavefront_batch)
        # auto: low-divergence pairs on the native host engine (WFA's work
        # grows with the penalty), capped at wfa_native_s_cap; the rest on
        # the banded route, whose cost does not.
        out = self._native_raw(pairs, s_max=self.wfa_native_s_cap)
        if out is None:
            return self._banded_route(pairs, model=model)
        return self._fill_rest(
            pairs, out, lambda rest: self._banded_route(rest, model=model))

    @staticmethod
    def _fill_rest(pairs, out, engine_fn):
        rest = [i for i, r in enumerate(out) if r is None]
        if rest:
            for i, r in zip(rest, engine_fn([pairs[i] for i in rest])):
                out[i] = r
        return out

    def _native_raw(self, pairs, s_max=None):
        """The exact threaded native host engine (no band).  None with
        SEQALIGN_NO_NATIVE; else per pair a result, or None where the
        engine declined it (penalty cap, memory budget).  A native error
        raises."""
        if os.environ.get("SEQALIGN_NO_NATIVE"):
            return None
        from sequencealigning_tpu_torch import native

        kw = {} if s_max is None else dict(s_max=s_max)
        res = native.wfa_textbook_align_batch_native(
            pairs, self.config.wfa_penalties, **kw)
        return [
            None if r is None
            else dict(score=r[0], aligned_query=r[1], aligned_db=r[2])
            for r in res
        ]

    def _banded_route(self, pairs, model: str = "ref"):
        """The banded Gotoh fill (kernel #3 on CUDA) under the
        penalty-converted scheme, a pair accepted only where a fill at
        band + 128 (one more 128-lane block) gives the same score; the rest
        escalate to 2 * band + 128.  Past wfa_banded_max_band: the Gotoh
        fallback (ref), or one full-width round (std, which cannot
        escape).  Walked on the card (CUDA; a failed walk is the pair's
        error) or on the host (CPU)."""
        pen = self.config.wfa_penalties
        eq = ScoringScheme(match_=0, mismatch=-pen.mismatch,
                           gap_open=-pen.gap_open,
                           gap_extend=-pen.gap_extend)
        n = len(pairs)
        out = [None] * n
        pending = []
        for i, (s1, s2) in enumerate(pairs):
            if len(s1) == 0 and len(s2) == 0:
                out[i] = dict(score=0, aligned_query="", aligned_db="")
            elif len(s2) == 0:
                out[i] = dict(score=pen.gap_open + len(s1) * pen.gap_extend,
                              aligned_query=s1.decode("latin-1"),
                              aligned_db="-" * len(s1))
            elif len(s1) == 0:
                out[i] = dict(score=pen.gap_open + len(s2) * pen.gap_extend,
                              aligned_query="-" * len(s2),
                              aligned_db=s2.decode("latin-1"))
            else:
                pending.append(i)
        band = max(8, self.config.band)
        full_round = False
        std = model == "std"
        while pending:
            if band > self.wfa_banded_max_band and not full_round:
                if not std:
                    break  # the Gotoh fallback below
                # std: one full-width round (the band covers every
                # diagonal of every pending pair: no escape).
                full_round = True
                band = max(max(len(pairs[i][0]), len(pairs[i][1]))
                           for i in pending)
            still = []
            for chunk in self._dirs_chunked(pairs, pending, band):
                tb = to_device(_padded([pairs[i] for i in chunk]),
                               self.device)
                res = nw_banded_diag_batch(
                    *tb, band=band, scheme=eq, compat=False,
                    with_dirs="fast4", model=model,
                )
                f1 = res.finals
                if full_round:
                    certified = list(enumerate(chunk))
                else:
                    f2 = nw_banded_diag_batch(
                        *tb, band=band + 128, scheme=eq, compat=False,
                        with_dirs=False, model=model,
                    ).finals
                    same = [int(f1[j].max()) == int(f2[j].max())
                            for j in range(len(chunk))]
                    certified = [(j, i) for j, i in enumerate(chunk)
                                 if same[j]]
                    still.extend(i for j, i in enumerate(chunk)
                                 if not same[j])
                if not certified:
                    continue
                tbs = self._banded_walks(res, f1, pairs, certified, std)
                for (_j, i), r in zip(certified, tbs):
                    if isinstance(r, AlignerError):
                        out[i] = r
                        continue
                    score, alns = r
                    out[i] = dict(score=-score, aligned_query=alns[0][0],
                                  aligned_db=alns[0][1])
            pending = still
            # Past both this round's fill and its certificate's width.
            band = 2 * band + 128
        if pending:
            self._gotoh_fallback(pairs, pending, out)
        return out

    def _banded_walks(self, res, f1, pairs, certified, std):
        """The certified slots' walks, routed by config.traceback
        (ops.traceback_device.use_device_walk): on the device by the banded
        walk (the kernel on the card), on the host by the fast4 walker."""
        if use_device_walk(self.config, self.device, res.dirs):
            return banded_diag_device_tbs(
                res.dirs, f1, [pairs[i][0] for _j, i in certified],
                [pairs[i][1] for _j, i in certified], res.k_lo_even,
                compat=False,
                pair_idx=np.asarray([j for j, _i in certified], np.int32),
                std=std,
            )
        dirs = res.dirs.cpu().numpy()
        tbs = []
        for j, i in certified:
            try:
                tbs.append(banded_diag_fast4_traceback_pair(
                    dirs[:, j, :], f1[j], pairs[i][0], pairs[i][1],
                    res.k_lo_even, compat=False, std=std,
                ))
            except AlignerError as e:
                tbs.append(e)
        return tbs

    def _dirs_chunked(self, pairs, pending, band):
        """Split `pending` so that each chunk's fast4 dirs tensor stays
        under wfa_dirs_budget: ~((l1+l2)/16) u32 words x L lanes a pair."""
        l1 = max(len(pairs[i][0]) for i in pending)
        l2 = max(len(pairs[i][1]) for i in pending)
        diffs = [len(pairs[i][0]) - len(pairs[i][1]) for i in pending]
        span = max(0, max(diffs)) - min(0, min(diffs)) + 2 * band + 2
        l_est = -(-(span // 2) // 128) * 128
        per_pair = max(1, ((l1 + l2) // 16 + 1) * 4 * l_est)
        max_pairs = max(8, int(self.wfa_dirs_budget // per_pair) // 8 * 8)
        return [pending[lo: lo + max_pairs]
                for lo in range(0, len(pending), max_pairs)]

    def _wavefront_batch(self, pairs):
        """The wavefront engine with band doubling to wfa_max_band, walked
        by the walk kernel (CUDA; a failed walk is the pair's error naming
        it) or its plain version (CPU; a failed walk is re-walked on the
        host, as in the JAX package); escapes and pairs past the offset
        log's length cap take the Gotoh fallback."""
        out = [None] * len(pairs)
        pending = list(range(len(pairs)))
        band = self.config.band
        pen = self.config.wfa_penalties
        on_card = self.device.type == "cuda"
        while pending and band <= self.wfa_max_band:
            sub = [pairs[i] for i in pending]
            try:
                res = wfa_textbook_batch(
                    *to_device(_padded(sub), self.device), penalties=pen,
                    band=band,
                )
            except AlignmentError:
                break  # past the int16 offset cap: the exact fallback
            dev_alns = wfa_traceback_device(
                res, [p[0] for p in sub], [p[1] for p in sub], pen)
            still = []
            for j, i in enumerate(pending):
                if not res.converged[j]:
                    still.append(i)
                    continue
                if dev_alns[j] is not None:
                    out[i] = dict(score=int(res.score[j]),
                                  aligned_query=dev_alns[j][0],
                                  aligned_db=dev_alns[j][1])
                    continue
                if on_card:
                    out[i] = AlignmentError(
                        "device WFA walk (wfa_walk_cuda) failed validation")
                    continue
                try:
                    score, a1, a2 = wfa_traceback_host(
                        res, j, pairs[i][0], pairs[i][1], pen)
                    out[i] = dict(score=score, aligned_query=a1,
                                  aligned_db=a2)
                except AlignerError as e:
                    out[i] = e
            pending = still
            band *= 2
        if pending:
            self._gotoh_fallback(pairs, pending, out)
        return out

    def _gotoh_fallback(self, pairs, pending, out):
        """Exact escape path: gap-affine min-penalty is the negated
        textbook Gotoh score under (match=0, -x, -o, -e), so the Gotoh
        aligner (first-only) gives the exact penalty and an alignment for
        any pair (the two models coincide where mismatch <=
        2*gap_extend)."""
        from sequencealigning_tpu_torch.models.gotoh import GotohAligner

        pen = self.config.wfa_penalties
        cfg = dataclasses.replace(
            self.config,
            scoring=ScoringScheme(match_=0, mismatch=-pen.mismatch,
                                  gap_open=-pen.gap_open,
                                  gap_extend=-pen.gap_extend),
            compat=False, first_only=True,
        )
        sub = [pairs[i] for i in pending]
        gotoh = GotohAligner(cfg, self.device)
        for i, r in zip(pending, gotoh._align_batch_impl(sub)):
            if isinstance(r, AlignerError):
                out[i] = r
            elif r.get("aligned_query") is None:
                out[i] = dict(score=-r["score"], aligned_query=None,
                              aligned_db=None)
            else:
                out[i] = dict(score=-r["score"],
                              aligned_query=r["aligned_query"],
                              aligned_db=r["aligned_db"])

"""Aligner base class, PairResult and the all-pairs loop (port of
models/base.py), with an explicit device."""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Tuple, Union

import torch

from sequencealigning_tpu_torch.config import AlignConfig, Algo
from sequencealigning_tpu_torch.errors import AlignerError
from sequencealigning_tpu_torch.io.fasta import Record, Records
from sequencealigning_tpu_torch.utils.cigar import Cigar, cigar_from_pair
from sequencealigning_tpu_torch.device import resolve_device


@dataclasses.dataclass
class PairResult:
    """Structured result for one (query, db) pair."""

    query_name: str
    db_name: str
    score: Optional[int] = None
    cigar: Optional[Cigar] = None
    aligned_query: Optional[str] = None
    aligned_db: Optional[str] = None
    # All co-optimal alignments, when the algorithm enumerates them.
    alignments: Optional[List[Tuple[str, str]]] = None
    error: Optional[str] = None
    elapsed_s: float = 0.0
    # Alignment mode ("global"/"local"/"semi-global"), set by align_batch;
    # scopes the Karlin-Altschul statistics below.
    mode: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("cigar") is not None:
            d["cigar"] = str(d["cigar"])
        if self.score is not None and self.aligned_query is not None:
            from sequencealigning_tpu_torch.utils.stats import (
                bit_score,
                e_value,
            )

            n1 = len(self.aligned_query.replace("-", ""))
            n2 = len(self.aligned_db.replace("-", ""))
            if n1 and n2:
                d["e_value"] = e_value(self.score, n1, n2)
                d["bit_score"] = bit_score(self.score)
                d["stats_domain"] = (
                    "local"
                    if self.mode in ("local", "semi-global")
                    else "approx_global"
                )
        return d

    def fill_derived(self) -> "PairResult":
        if self.aligned_query is not None and self.cigar is None:
            self.cigar = cigar_from_pair(self.aligned_query, self.aligned_db)
        return self


class Aligner:
    """Base aligner.  Subclasses implement _align_batch_impl (list of byte
    pairs -> list of PairResult payload dicts or AlignerError) and run it
    on ``self.device``."""

    def __init__(
        self,
        config: Optional[AlignConfig] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.config = config or AlignConfig()
        self.device = resolve_device(device)

    def align_pair(self, query: Record, db: Record) -> PairResult:
        return self.align_batch([(query, db)])[0]

    def align_batch(
        self, pairs: List[Tuple[Record, Record]]
    ) -> List[PairResult]:
        """Align (query, db) record pairs with per-pair failure isolation:
        an AlignerError on one pair becomes PairResult.error and the rest
        proceed."""
        t0 = time.perf_counter()
        results = self._align_batch_impl([(q.seq, d.seq) for q, d in pairs])
        elapsed = time.perf_counter() - t0
        out = []
        for (q, d), r in zip(pairs, results):
            pr = PairResult(
                query_name=q.name.decode("latin-1"),
                db_name=d.name.decode("latin-1"),
                elapsed_s=elapsed / max(len(pairs), 1),
                mode=self.config.mode.value,
            )
            if isinstance(r, AlignerError):
                pr.error = str(r)
            else:
                for k, v in r.items():
                    setattr(pr, k, v)
                pr.fill_derived()
            out.append(pr)
        return out

    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        raise NotImplementedError

    def align_all_pairs(
        self, query: Records, db: Records, batch_size: Optional[int] = None
    ) -> Iterator[PairResult]:
        """The reference's nested pair loop (for d in db { for q in
        query }), batched.  With config.bucket, pairs are length-bucketed
        within a window of 4 batches; results come back in the original
        db x query order."""
        bs = batch_size or self.config.batch_size
        window = bs * (4 if getattr(self.config, "bucket", False) else 1)
        pending: List[Tuple[Record, Record]] = []

        def flush(pend):
            if len(pend) <= bs or window == bs:
                yield from self.align_batch(pend)
                return
            order = sorted(
                range(len(pend)),
                key=lambda i: max(len(pend[i][0].seq), len(pend[i][1].seq)),
            )
            results: List[Optional[PairResult]] = [None] * len(pend)
            for lo in range(0, len(order), bs):
                idxs = order[lo : lo + bs]
                for i, r in zip(idxs, self.align_batch([pend[i] for i in idxs])):
                    results[i] = r
            yield from results

        for d in db:
            for q in query:
                pending.append((q, d))
                if len(pending) >= window:
                    yield from flush(pending)
                    pending = []
        if pending:
            yield from flush(pending)


def get_aligner(
    config: AlignConfig, device: Union[str, torch.device] = "cuda"
) -> Aligner:
    """The aligner for config.algo on ``device``: a-star (host search),
    needleman-wunsch (Gotoh: global with its long-pair path, textbook
    semi-global and local), nw-linear, banded and wfa."""
    from sequencealigning_tpu_torch.models.astar import AStarAligner
    from sequencealigning_tpu_torch.models.banded import BandedAligner
    from sequencealigning_tpu_torch.models.gotoh import GotohAligner
    from sequencealigning_tpu_torch.models.linear import LinearNWAligner
    from sequencealigning_tpu_torch.models.wfa import WfaAligner

    table = {Algo.A_STAR: AStarAligner, Algo.NEEDLEMAN_WUNSCH: GotohAligner,
             Algo.NW_LINEAR: LinearNWAligner, Algo.BANDED: BandedAligner,
             Algo.WFA: WfaAligner}
    return table[config.algo](config, device)

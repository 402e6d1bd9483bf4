"""Weighted-A* aligner: the port of models/astar.py.

Reference: align (src/align.rs:19-57).  The search is sequential,
heap-driven host work, kept bit-exact (including Rust BinaryHeap pop order)
in the native runtime's copy of the JAX package's C search, threaded over
the pairs of a batch; it runs on the host whatever the aligner's device.  A
pair the native search cannot allocate for is searched by the oracle
(ops.oracle_astar), as in the JAX package.

The reference's main always calls align() with local=false regardless of
--mode (src/main.rs:64); compat mode reproduces that.  With compat=False,
Mode.SEMI_GLOBAL selects the free-end-gaps expansion (align.rs:59-123) and
Mode.LOCAL, which the search has no form for, answers each pair with
AlignmentError("not implemented") -- where the JAX aligner silently aligns
globally (its models/astar.py:46-49).
"""

from __future__ import annotations

from typing import List, Tuple

from sequencealigning_tpu_torch import native
from sequencealigning_tpu_torch.config import Mode
from sequencealigning_tpu_torch.errors import AlignerError, AlignmentError
from sequencealigning_tpu_torch.models.base import Aligner
from sequencealigning_tpu_torch.ops.oracle_astar import astar_align


class AStarAligner(Aligner):
    def _astar_one(self, s1: bytes, s2: bytes, semi: bool):
        """The native search of one pair; the oracle where the native one
        cannot allocate (a search failure raises AlignmentError in both)."""
        sch = self.config.scoring
        r = native.astar_align_native(
            s1, s2, sch.match_, sch.mismatch, sch.gap_open, sch.gap_extend,
            sch.epsilon, semi_global=semi,
        )
        if r is not None:
            return r
        return astar_align(s1, s2, scheme=sch, semi_global=semi)

    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.compat:
            semi = False  # main.rs:64 hardcodes local=false
        elif self.config.mode is Mode.LOCAL:
            return [AlignmentError("not implemented") for _ in pairs]
        else:
            semi = self.config.mode is Mode.SEMI_GLOBAL
        results = None
        if len(pairs) >= 2:
            sch = self.config.scoring
            results = native.astar_align_batch_native(
                [p[0] for p in pairs], [p[1] for p in pairs],
                sch.match_, sch.mismatch, sch.gap_open, sch.gap_extend,
                sch.epsilon, semi_global=semi,
            )
        out = []
        for b, (s1, s2) in enumerate(pairs):
            r = results[b] if results is not None else None
            try:
                if isinstance(r, str):
                    raise AlignmentError(r)
                if r is None:
                    r = self._astar_one(s1, s2, semi)
                score, a1, a2 = r
                out.append(dict(score=score, aligned_query=a1, aligned_db=a2))
            except AlignerError as e:
                out.append(e)
        return out

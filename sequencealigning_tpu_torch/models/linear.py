"""Linear/gap-state NW aligner: the port of models/linear.py (the
reference's dead module src/needleman_wunsch.rs, revived).

Global and local (Smith-Waterman-style) modes; semi-global answers each
pair with the reference's "not implemented".  The fill (ops.nw_linear,
the linear kernel on CUDA) runs on the aligner's device; its path bits come
to the host for the reference's DFS walker
(ops.traceback.linear_traceback_pair), which enumerates up to 64 hits a
pair.  On CUDA a batch whose db row passes CUDA_LINEAR_LANES lanes answers
every pair with an AlignmentError naming the lane count; the CPU aligns it.
"""

from __future__ import annotations

from typing import List, Tuple

from sequencealigning_tpu_torch.config import Mode
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.errors import AlignmentError
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.models.base import Aligner
from sequencealigning_tpu_torch.ops.nw_linear import nw_linear_batch
from sequencealigning_tpu_torch.ops.traceback import linear_traceback_pair


class LinearNWAligner(Aligner):
    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.mode is Mode.SEMI_GLOBAL:
            return [AlignmentError("not implemented") for _ in pairs]
        local = self.config.mode is Mode.LOCAL
        batch = pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))
        try:
            res = nw_linear_batch(
                *to_device(batch, self.device),
                scheme=self.config.scoring,
                compat=self.config.compat,
                local=local,
            )
        except AlignmentError as e:  # a row too wide for the CUDA kernel
            return [AlignmentError(str(e)) for _ in pairs]
        dirs = res.dirs.cpu().numpy()
        out = []
        for b, (s1, s2) in enumerate(pairs):
            hits = linear_traceback_pair(dirs[:, b, :], s1, s2, local=local)
            if not hits:
                out.append(AlignmentError("no hits"))
                continue
            a1, a2, _siq, _sid = hits[0]
            out.append(
                dict(
                    score=int(res.score[b]),
                    aligned_query=a1,
                    aligned_db=a2,
                    alignments=[(h[0], h[1]) for h in hits],
                )
            )
        return out

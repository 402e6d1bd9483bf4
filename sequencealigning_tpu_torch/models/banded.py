"""Banded affine aligner: the port of models/banded.py (BASELINE config 4,
the fixed-shape masked band that stands in for the reference's A* pruning).

Global mode only; the other modes answer with the reference's per-pair
"not implemented".  Both routes fill with the anti-diagonal banded fill
(ops.nw_banded_diag, N matching anything) on the aligner's device:

* first_only: fast4 codes walked as config.traceback routes them
  (ops.traceback_device.use_device_walk, as the JAX package): the banded
  device walk (ops.traceback_device.banded_diag_device_tbs) and the native
  decode -- on CUDA a pair whose walk fails validation is that pair's
  AlignmentError, on the CPU it is re-walked on the host -- or the host
  fast4 walker over the fetched dirs;
* default: the full 7-bit codes, fetched to the host and walked by
  ops.traceback.banded_diag_traceback_pair (the first co-optimal
  alignment, in the reference's enumeration order).

On CUDA a band past 8192 lanes is split over a thread-block cluster; a
batch whose band needs more than the cluster's 131072 lanes (a --band past
~131000, or pairs whose lengths differ by ~250 kb) answers every pair with
an AlignmentError; the CPU aligns it.
"""

from __future__ import annotations

from typing import List, Tuple

from sequencealigning_tpu_torch.config import Mode
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.errors import AlignerError, AlignmentError
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.models.base import Aligner
from sequencealigning_tpu_torch.ops.nw_banded_diag import nw_banded_diag_batch
from sequencealigning_tpu_torch.ops.traceback import (
    banded_diag_fast4_traceback_pair,
    banded_diag_traceback_pair,
)
from sequencealigning_tpu_torch.ops.traceback_device import (
    banded_diag_device_tbs,
    use_device_walk,
)


class BandedAligner(Aligner):
    def _align_batch_impl(self, pairs: List[Tuple[bytes, bytes]]):
        if self.config.mode is not Mode.GLOBAL:
            return [AlignmentError("not implemented") for _ in pairs]
        first_only = getattr(self.config, "first_only", False)
        batch = pack_batch(pairs, batch_size=max(8, -(-len(pairs) // 8) * 8))
        try:
            res = nw_banded_diag_batch(
                *to_device(batch, self.device),
                band=self.config.band,
                scheme=self.config.scoring,
                compat=self.config.compat,
                wildcard=True,  # N matches anything (align.rs:298-304)
                with_dirs="fast4" if first_only else "full",
            )
        except AlignmentError as e:  # a band too wide for the CUDA kernel
            return [AlignmentError(str(e)) for _ in pairs]
        s1s = [p[0] for p in pairs]
        s2s = [p[1] for p in pairs]
        if first_only and use_device_walk(self.config, self.device,
                                          res.dirs):
            tbs = banded_diag_device_tbs(
                res.dirs, res.finals, s1s, s2s, res.k_lo_even,
                compat=self.config.compat,
            )
        else:
            dirs = res.dirs.cpu().numpy()
            tbs = []
            for b, (s1, s2) in enumerate(pairs):
                try:
                    if first_only:
                        tbs.append(banded_diag_fast4_traceback_pair(
                            dirs[:, b, :], res.finals[b], s1, s2,
                            res.k_lo_even, compat=self.config.compat))
                    else:
                        tbs.append(banded_diag_traceback_pair(
                            dirs[:, b, :], res.finals[b], s1, s2,
                            res.k_lo_even, compat=self.config.compat,
                            max_alignments=1,
                        ))
                except AlignerError as e:
                    tbs.append(e)
        out = []
        for r in tbs:
            if isinstance(r, AlignerError):
                out.append(r)
                continue
            score, alns = r
            if not alns:
                out.append(
                    AlignmentError("banded traceback found no alignment"))
                continue
            out.append(dict(score=score, aligned_query=alns[0][0],
                            aligned_db=alns[0][1]))
        return out

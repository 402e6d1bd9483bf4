"""Sequence parallelism: ONE pair's DP matrix spread over a mesh's devices
(the port of parallel/seqpar.py).

The db axis is cut into segments of W lanes (the JAX package's rule,
ops.nw_affine_tiled.seqpar_lanes), dealt round-robin to the mesh's devices:
segment k on device k % D, so a db longer than D * W lanes chains rounds,
device 0 taking segment D after device D - 1's segment D - 1.  Segments
couple only through the O(n1) boundary column at their edge.

* On a CUDA mesh (``make_mesh()``, ``["cuda:0"] * 4``, or distinct cards
  with peer access) one launch a device of the shard fill
  (ops.nw_affine_tiled.tiled_shard_fill_cuda, kernel #4's strips over the
  device's segments), all launches running at once; a segment's last strip
  writes its column straight into a boundary buffer on the next segment's
  device, published row by row, where the JAX package relays it every chunk
  with ppermute.  The devices' corner finals are added on the host (the
  JAX package's psum).
* On a CPU mesh (``["cpu"] * 8``) the plain twin
  (ops.nw_affine_tiled.shard_fill_torch): the rounds and devices in order,
  the column moved to the next device.

seqpar_align adds the pair's alignment: a banded fast4 fill on the mesh's
first device with band doubling until its score equals the mesh-exact
score (then the banded path is provably optimal), its walk, and past
max_band the Myers-Miller alignment, as the JAX package.  One difference
is deliberate: where the walk fails validation (an AlignmentError), the
JAX package raises; here the pair goes to the Myers-Miller fallback,
certified by the exact score, and without an alignment that reaches it
the score stands alone (aligned strings None).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sequencealigning_tpu_torch.config import AlignConfig, Algo, ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.errors import AlignerError, AlignmentError
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops.nw_affine_tiled import (
    CHUNK_ROWS,
    seqpar_lanes,
    shard_fill_torch,
    tiled_shard_fill_cuda,
)
from sequencealigning_tpu_torch.ops.nw_banded_diag import nw_banded_diag_batch
from sequencealigning_tpu_torch.ops.traceback import (
    banded_diag_fast4_traceback_pair,
)
from sequencealigning_tpu_torch.ops.traceback_device import (
    banded_diag_device_tbs,
    use_device_walk,
)
from sequencealigning_tpu_torch.parallel.mesh import Devices, make_mesh


def seqpar_fill(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    mesh: Optional[Devices] = None,
    tile_lanes: int = 4096,
    chunk: int = 128,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
) -> np.ndarray:
    """Exact Gotoh corner finals (B, 3) int32 of a packed batch
    (io.encode.pack_batch's arrays) with each pair's db axis spread over
    the mesh's devices (a device list, see parallel.mesh.make_mesh; by
    default every local CUDA device, raising without one).  Each device
    owns W = seqpar_lanes(L2, D, tile_lanes) lanes a round; longer dbs
    chain rounds.  chunk: the rows the plain twin rounds the query up to
    (the JAX package's scan chunk) and the kernel's rows handed over at a
    time (at most 128, a power of two).  Pairs with an empty db get their
    corner in closed form."""
    mesh = make_mesh(mesh)
    if len({d.type for d in mesh}) > 1:
        raise ValueError(f"seqpar: a mesh mixes CPU and CUDA devices: {mesh}")
    L2 = np.asarray(db).shape[1]
    W = seqpar_lanes(L2, len(mesh), tile_lanes)
    ins = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(mesh[0])
           for a in (query, db, query_len, db_len)]
    if mesh[0].type == "cuda":
        finals = tiled_shard_fill_cuda(*ins, mesh, W, scheme, compat,
                                       wildcard,
                                       chunk_rows=min(chunk, CHUNK_ROWS))
    else:
        finals = shard_fill_torch(*ins, mesh, W, chunk, scheme, compat,
                                  wildcard)
    return finals.cpu().numpy()


def _banded_walk(res, seq1: bytes, seq2: bytes, compat: bool,
                 config: AlignConfig, device):
    """The first banded path of the pair's fast4 fill: (score, [(a1,
    a2)]) or an AlignmentError.  On the card the banded walk kernel
    (use_device_walk), on the CPU the host walker."""
    if use_device_walk(config, device, res.dirs):
        return banded_diag_device_tbs(
            res.dirs, res.finals[:1], [seq1], [seq2], res.k_lo_even,
            compat=compat, pair_idx=np.zeros(1, np.int32))[0]
    try:
        return banded_diag_fast4_traceback_pair(
            res.dirs[:, 0, :].cpu().numpy(), res.finals[0], seq1, seq2,
            res.k_lo_even, compat=compat)
    except AlignmentError as e:
        return e


def seqpar_align(
    seq1: bytes,
    seq2: bytes,
    mesh: Optional[Devices] = None,
    tile_lanes: int = 4096,
    chunk: int = 128,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    band: int = 256,
    max_band: int = 4096,
):
    """ONE pair: the mesh-exact score (seqpar_fill) AND an alignment.

    The alignment comes from a fast4 banded fill on the mesh's first
    device (ops.nw_banded_diag), the band doubling from max(128, band)
    until the banded score equals the exact score, walked on the card on
    CUDA and on the host on the CPU.  Past max_band, or where the walk
    fails validation, the Myers-Miller alignment
    (models.gotoh.GotohAligner._mm_fallback), kept only if it rescores to
    the exact score; otherwise the aligned strings are None.

    Returns (score, aligned_seq1, aligned_seq2)."""
    from sequencealigning_tpu_torch.models.gotoh import GotohAligner

    mesh = make_mesh(mesh)
    batch = pack_batch([(seq1, seq2)], batch_size=8)
    finals = seqpar_fill(
        batch.query, batch.db, batch.query_len, batch.db_len, mesh=mesh,
        tile_lanes=tile_lanes, chunk=chunk, scheme=scheme, compat=compat,
    )
    exact = int(finals[0].max())
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, scoring=scheme,
                         compat=compat)
    tb = to_device(batch, mesh[0])
    b = max(128, band)
    while b <= max_band:
        res = nw_banded_diag_batch(*tb, band=b, scheme=scheme, compat=compat,
                                   with_dirs="fast4")
        if int(res.finals[0].max()) == exact:
            r = _banded_walk(res, seq1, seq2, compat, config, mesh[0])
            if not isinstance(r, AlignerError):
                _score, alns = r
                return exact, alns[0][0], alns[0][1]
            break
        b *= 2
    r = GotohAligner(config, mesh[0])._mm_fallback((seq1, seq2), exact)
    return exact, r["aligned_query"], r["aligned_db"]

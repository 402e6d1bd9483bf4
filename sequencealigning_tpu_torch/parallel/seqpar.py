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

Across processes (an initialised ``torch.distributed``, as the JAX mesh
from ``make_mesh()`` spans every process's devices after multihost_init)
the mesh is this rank's devices and the segments go over every rank's, in
rank order (parallel/mesh.rank_span: JAX's process-major device order):
each rank fills only its own devices' segments, a column between two ranks
is relayed through host buffers on a Gloo group (parallel/mesh.seqpar_group,
parallel/relay.py), and the finals are summed over the group, so every
rank returns the same finals, score and alignment as one process over all
the devices.  Every rank calls with the same batch.

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
import torch.distributed as dist

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
from sequencealigning_tpu_torch.parallel.mesh import (
    Devices,
    make_mesh,
    rank_span,
    seqpar_group,
)


def seqpar_fill(
    query: np.ndarray,
    db: np.ndarray,
    query_len: np.ndarray,
    db_len: np.ndarray,
    mesh: Optional[Devices] = None,
    *,
    tile_lanes: int = 4096,
    chunk: int = 128,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    wildcard: bool = False,
    group=None,
) -> np.ndarray:
    """Exact Gotoh corner finals (B, 3) int32 of a packed batch
    (io.encode.pack_batch's arrays) with each pair's db axis spread over
    the mesh's devices (a device list, see parallel.mesh.make_mesh; by
    default every local CUDA device, raising without one).  Each device
    owns W = seqpar_lanes(L2, D, tile_lanes) lanes a round; longer dbs
    chain rounds.  chunk: the rows the plain twin rounds the query up to
    (the JAX package's scan chunk) and the kernel's rows handed over at a
    time (at most 128, a power of two).  Pairs with an empty db get their
    corner in closed form.

    group: the processes the pair spans (parallel.mesh.seqpar_group's:
    by default every rank of an initialised ``torch.distributed``, else
    this process alone; a Gloo group when given).  Every rank calls with
    the same batch and its own mesh; D counts every rank's devices, and
    every rank returns the same finals."""
    mesh = make_mesh(mesh)
    group = seqpar_group(group)
    kinds = {d.type for d in mesh}
    if group is not None:
        every = [None] * dist.get_world_size(group)
        dist.all_gather_object(every, sorted(kinds), group=group)
        kinds = {k for ks in every for k in ks}
    if len(kinds) > 1:
        raise ValueError(f"seqpar: a mesh mixes CPU and CUDA devices: "
                         f"{mesh}" + (" (over the ranks)" if group is not None
                                      else ""))
    L2 = np.asarray(db).shape[1]
    starts, _rank = rank_span(len(mesh), group)
    W = seqpar_lanes(L2, starts[-1], tile_lanes)
    ins = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(mesh[0])
           for a in (query, db, query_len, db_len)]
    if mesh[0].type == "cuda":
        finals = tiled_shard_fill_cuda(*ins, mesh, W, scheme, compat,
                                       wildcard,
                                       chunk_rows=min(chunk, CHUNK_ROWS),
                                       group=group)
    else:
        finals = shard_fill_torch(*ins, mesh, W, chunk, scheme, compat,
                                  wildcard, group=group)
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
    *,
    tile_lanes: int = 4096,
    chunk: int = 128,
    scheme: ScoringScheme = ScoringScheme(),
    compat: bool = True,
    band: int = 256,
    max_band: int = 4096,
    group=None,
):
    """ONE pair: the mesh-exact score (seqpar_fill) AND an alignment.

    The alignment comes from a fast4 banded fill on the mesh's first
    device (ops.nw_banded_diag), the band doubling from max(128, band)
    until the banded score equals the exact score, walked on the card on
    CUDA and on the host on the CPU.  Past max_band, or where the walk
    fails validation, the Myers-Miller alignment
    (models.gotoh.GotohAligner._mm_fallback), kept only if it rescores to
    the exact score; otherwise the aligned strings are None.  Across
    processes (group, as seqpar_fill's) the score is the group's, and
    every rank then aligns on its own first device: the same answer on
    every rank.

    Returns (score, aligned_seq1, aligned_seq2)."""
    from sequencealigning_tpu_torch.models.gotoh import GotohAligner

    mesh = make_mesh(mesh)
    batch = pack_batch([(seq1, seq2)], batch_size=8)
    finals = seqpar_fill(
        batch.query, batch.db, batch.query_len, batch.db_len, mesh=mesh,
        tile_lanes=tile_lanes, chunk=chunk, scheme=scheme, compat=compat,
        group=group,
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

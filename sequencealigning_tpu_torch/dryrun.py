"""Multi-device dry run: one step of each of the port's multi-device paths
on tiny shapes (the port of __graft_entry__.py::dryrun_multichip).

    python -m sequencealigning_tpu_torch.dryrun --devices 1
    python -m sequencealigning_tpu_torch.dryrun --devices 4 --device cuda:0
    python -m sequencealigning_tpu_torch.dryrun --devices 4 --device cpu

With no --device the run takes the first N CUDA devices (make_mesh()) and
fails if there are fewer; --device D runs N shards on D (four shards of
one card with cuda:0, or of the CPU).  Prints one JSON line; exits 1 when
a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np

from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.errors import AlignerError
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops.nw_affine_modes import (
    modes_end_cell,
    nw_affine_modes_batch,
)
from sequencealigning_tpu_torch.ops.oracle_gotoh import gotoh_score
from sequencealigning_tpu_torch.parallel.mesh import make_mesh
from sequencealigning_tpu_torch.parallel.runner import (
    DataParallelRunner,
    to_host,
)
from sequencealigning_tpu_torch.parallel.seqpar import seqpar_fill


class DryRunFailure(RuntimeError):
    """A check of the dry run that did not hold."""


def _check(cond, msg) -> None:
    if not cond:
        raise DryRunFailure(msg)


def dryrun_pairs(n_devices: int):
    """The dry run's pairs, drawn as __graft_entry__.py draws them: 8 a
    device of 4-19 bp a side, then one pair of 90 x (128 n - 30) bp."""
    rng = np.random.default_rng(1)
    pairs = [
        (
            rng.choice(list(b"ACGT"), int(rng.integers(4, 20)))
            .astype(np.uint8).tobytes(),
            rng.choice(list(b"ACGT"), int(rng.integers(4, 20)))
            .astype(np.uint8).tobytes(),
        )
        for _ in range(8 * n_devices)
    ]
    long_pair = (
        rng.choice(list(b"ACGT"), 90).astype(np.uint8).tobytes(),
        rng.choice(list(b"ACGT"), 128 * n_devices - 30)
        .astype(np.uint8).tobytes(),
    )
    return pairs, long_pair


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """One step of the data-parallel runner and one of sequence
    parallelism over n_devices devices: the first n_devices of make_mesh()
    (raising if there are fewer), or ``devices`` (n_devices of them; a
    device may repeat, e.g. ["cuda:0"] * 4).  Checks what
    __graft_entry__.dryrun_multichip asserts, raising DryRunFailure:

    * DataParallelRunner.scores, 3 pairs against the oracle;
    * state "auto" gives the same finals;
    * fill_with_dirs + device_walk_fast4: valid alignments of the fill's
      scores;
    * the fused fill_walk_from_stream_args + device_walk_fast4_finish
      equal to that two-dispatch path;
    * fill_modes(batch, "semi") ends where nw_affine_modes_batch does;
    * seqpar_fill of one 90 x (128 n - 30) bp pair at 128-lane tiles
      against the oracle.

    Returns {"devices", "finals", "alignments", "seqpar"}: the runner's
    (8 n, 3) finals, the walked alignments and the seqpar pair's (1, 3)
    finals."""
    if devices is None:
        mesh = make_mesh()
        if len(mesh) < n_devices:
            raise RuntimeError(f"dryrun_multichip: {n_devices} devices "
                               f"asked, make_mesh() has {len(mesh)}")
        mesh = mesh[:n_devices]
    else:
        mesh = make_mesh(devices)
        if len(mesh) != n_devices:
            raise ValueError(f"dryrun_multichip: {n_devices} devices asked, "
                             f"{len(mesh)} named")
    pairs, long_pair = dryrun_pairs(n_devices)
    seqs1 = [p[0] for p in pairs]
    seqs2 = [p[1] for p in pairs]
    batch = pack_batch(pairs, batch_size=8 * n_devices)
    runner = DataParallelRunner(mesh)
    finals = to_host(runner.scores(batch))
    _check(finals.shape == (8 * n_devices, 3),
           f"scores: shape {finals.shape}")
    for b in (0, len(pairs) // 2, len(pairs) - 1):
        want = gotoh_score(*pairs[b])
        _check(int(finals[b].max()) == want,
               f"scores: pair {b} {finals[b].tolist()}, the oracle {want}")

    r16 = DataParallelRunner(mesh, state_dtype="auto")
    _check(np.array_equal(finals, to_host(r16.scores(batch))),
           "scores: state auto differs from int32")

    finals_w, dirs_w, plan_w = runner.fill_with_dirs(batch)
    tbs = runner.device_walk_fast4(dirs_w, plan_w, to_host(finals_w), seqs1,
                                   seqs2)
    for b in (0, len(pairs) - 1):
        _check(not isinstance(tbs[b], AlignerError),
               f"device_walk_fast4: pair {b}: {tbs[b]!r}")
        score, alns = tbs[b]
        _check(score == int(finals[b].max()),
               f"device_walk_fast4: pair {b} score {score}")
        _check(alns[0][0].replace("-", "").encode() == pairs[b][0],
               f"device_walk_fast4: pair {b} does not rebuild its query")

    args, plan, bp, has_n = runner._stream_args(batch)
    finals_f, handles = runner.fill_walk_from_stream_args(
        args, plan, len(pairs), has_n, seqs1, seqs2)
    tbs_f = runner.device_walk_fast4_finish(handles, to_host(finals_f),
                                            seqs1, seqs2)
    _check(tbs_f == tbs,
           "fused fill+walk disagrees with the two-dispatch path")

    best = to_host(runner.fill_modes(batch, "semi")[0])
    plain = nw_affine_modes_batch(*to_device(batch, mesh[0]), local=False)
    for b in (0, len(pairs) - 1):
        want = modes_end_cell(plain, b)[0]
        _check(int(best[b]) == want,
               f"fill_modes semi: pair {b} {int(best[b])}, plain {want}")

    sp_batch = pack_batch([long_pair], batch_size=8)
    sp = seqpar_fill(sp_batch.query, sp_batch.db, sp_batch.query_len,
                     sp_batch.db_len, mesh=mesh, tile_lanes=128)
    want = gotoh_score(*long_pair)
    _check(int(sp[0].max()) == want,
           f"seqpar_fill: {sp[0].tolist()}, the oracle {want}")
    return dict(devices=[str(d) for d in mesh], finals=finals,
                alignments=tbs, seqpar=sp[:1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="devices of the mesh (default 1)")
    ap.add_argument("--device", default=None,
                    help="run every shard on this device (e.g. cuda:0 or "
                    "cpu); default: the first N CUDA devices")
    args = ap.parse_args(argv)
    devices = None if args.device is None else [args.device] * args.devices
    t0 = time.perf_counter()
    try:
        out = dryrun_multichip(args.devices, devices)
    except DryRunFailure as e:
        print(f"[dryrun] FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(dict(ok=True, devices=out["devices"],
                          pairs=len(out["finals"]),
                          seqpar=out["seqpar"][0].tolist(),
                          seconds=round(time.perf_counter() - t0, 3))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

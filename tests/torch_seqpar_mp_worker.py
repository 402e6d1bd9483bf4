"""One rank of a two-process run of the port's sequence parallelism on the
CPU (driven by tests/test_torch_seqpar_mp.py): torch.distributed with the
Gloo backend (parallel.mesh.multihost_init), each rank a mesh of CPU
shards, one pair's segments spread over every rank's shards.

Usage: python tests/torch_seqpar_mp_worker.py <rank> <ranks> <port> <mode>

mode "fill": seqpar_fill on every case of FILL_CASES (the plain twin across
ranks, with the segments each rank filled), the shard fill's host build
(csrc/host_check.cpp::hc_tiled_shard_fill, one resumable call a launch)
with its columns between ranks through parallel.relay.ColumnRelay against
the plain twin on the same layout (HOST_CASES), and seqpar_align on
ALIGN_CASES.  Prints one "TAG <json>" line a result.

mode "withhold_plain" / "withhold_host": rank 0 sends no column (the plain
twin's send_column, resp. the relay's sender threads, do nothing), with
parallel.relay.RELAY_TIMEOUT_S at WITHHOLD_TIMEOUT_S; every rank prints
"RAISED <json>" (its message and the seconds it took) or "NO_RAISE".

Imports torch and the port only (never JAX): the test computes the JAX
results in its own process from the same cases.
"""

import json
import os
import random
import sys
import time

import numpy as np

WITHHOLD_TIMEOUT_S = 3.0


# ---------------------------------------------------------------------------
# Cases (the test builds the same pairs for the JAX side)
# ---------------------------------------------------------------------------


def chained_pairs():
    """tests/test_torch_seqpar.py's 3-round batch: dbs up to 2900 bp, so
    at 4 shards of 128 lanes the rounds wrap from rank 1 to rank 0."""
    rng = random.Random(71)
    pairs = []
    for n2 in (2900, 2500, 1500, 1024, 1025, 900, 40, 2048):
        n1 = rng.randint(1, 120)
        pairs.append((bytes(rng.choice(b"ACGT") for _ in range(n1)),
                      bytes(rng.choice(b"ACGT") for _ in range(n2))))
    return pairs


def random_pairs(seed, n=8, n1_hi=200, n2_lo=300, n2_hi=900):
    rng = random.Random(seed)
    return [(bytes(rng.choice(b"ACGT") for _ in range(rng.randint(1, n1_hi))),
             bytes(rng.choice(b"ACGT")
                   for _ in range(rng.randint(n2_lo, n2_hi))))
            for _ in range(n)]


def ragged_pairs(seed, db_hi=1100):
    """tests/test_torch_seqpar.py's _shard_batch: queries up to 90 bp, dbs
    up to db_hi (the first 400 bp longer), every other db a mutated copy
    of its query, N codes, an empty db and an empty query."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(6):
        s1 = rng.choice(alpha, int(rng.integers(1, 91)))
        s2 = rng.choice(alpha, int(rng.integers(1, db_hi + 1)))
        if i % 2:
            s2 = np.resize(s1, len(s2))
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        pairs.append((s1.tobytes(), s2.tobytes()))
    pairs[0] = (pairs[0][0], pairs[0][1] + b"ACGT" * 100)
    return pairs + [(b"ACGTA", b""), (b"", b"ACGTTGCA")]


def random_scheme(seed):
    """A scheme's four scores (match_, mismatch, gap_open, gap_extend)."""
    rng = np.random.default_rng(seed)
    return dict(match_=int(rng.integers(1, 8)),
                mismatch=-int(rng.integers(1, 9)),
                gap_open=-int(rng.integers(0, 12)),
                gap_extend=-int(rng.integers(1, 6)))


# name: (pairs, shards a rank, tile_lanes, compat, wildcard, scheme)
FILL_CASES = {
    "chained_compat": (chained_pairs, 2, 128, True, False, {}),
    "chained_textbook": (chained_pairs, 2, 128, False, False, {}),
    "chained_8_shards_w256": (chained_pairs, 4, 256, True, False, {}),
    "ragged_wildcard_scheme": (lambda: ragged_pairs(5), 2, 128, False, True,
                               random_scheme(5)),
    "pairs61_8_shards": (lambda: random_pairs(61), 4, 128, False, False, {}),
}

# name: (pairs, shards a rank, segment lanes, strip lanes, chunk rows,
# compat, wildcard, scheme, the relay's rows a message: a few, so a column
# takes many messages)
HOST_CASES = {
    "host_ragged_w128": (lambda: ragged_pairs(7), 2, 128, 128, 8, True, True,
                         random_scheme(7), 16),
    "host_chained_w256": (chained_pairs, 2, 256, 128, 8, False, False,
                          random_scheme(9), 32),
}


def edited_pair(n, edits, seed):
    """tests/test_seqpar.py's certified-alignment pair."""
    rng = np.random.default_rng(seed)
    A = np.frombuffer(b"ACGT", np.uint8)
    s2 = rng.choice(A, n).tobytes()
    s1 = bytearray(s2)
    for _ in range(edits):
        i = int(rng.integers(0, len(s1)))
        op = int(rng.integers(0, 3))
        if op == 0:
            s1[i] = int(rng.choice(A))
        elif op == 1 and len(s1) > 3:
            del s1[i]
        else:
            s1.insert(i, int(rng.choice(A)))
    return bytes(s1), s2


# name: (pair, shards a rank, seqpar_align keywords)
ALIGN_CASES = {
    "certified": (lambda: edited_pair(1500, 12, 29), 2,
                  dict(tile_lanes=128, compat=False, band=128)),
    "mm_fallback": (lambda: (b"ACGT" * 120, b"T" * 400 + b"ACGT" * 120), 2,
                    dict(tile_lanes=128, compat=False, band=128,
                         max_band=128)),
}


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def emit(tag, payload):
    print(tag, json.dumps(payload), flush=True)


def fill_cases(port):
    tiled = port.tiled
    for name, (make, n, tl, compat, wildcard, sk) in FILL_CASES.items():
        batch = port.pack_batch(make(), batch_size=8)
        segs = []
        real = tiled.tile_fill_torch

        def counted(db_tile, qs, *rest):
            segs.append((int(rest[-5]) - 1) // db_tile.shape[1])
            return real(db_tile, qs, *rest)

        tiled.tile_fill_torch = counted
        try:
            got = port.seqpar_fill(
                batch.query, batch.db, batch.query_len, batch.db_len,
                mesh=["cpu"] * n, tile_lanes=tl, compat=compat,
                wildcard=wildcard, scheme=port.ScoringScheme(**sk))
        finally:
            tiled.tile_fill_torch = real
        emit("FILL", dict(case=name, finals=got.tolist(), segments=segs))


def host_route(port, tb, n, seg_lanes, strip_lanes, chunk_rows, scheme,
               compat, wildcard, block_rows):
    """The shard fill's launches of this rank run through its host build,
    one resumable call a launch, in turn until all have run; the columns
    to and from the other rank through a ColumnRelay.  (finals, the
    segments of this rank's launches, the relay's messages)."""
    tiled, relay = port.tiled, port.relay
    host = port.csrc.host_check()
    group = port.seqpar_group()
    B, L1 = tb.query.shape
    nrow = L1 + 1
    S = seg_lanes // strip_lanes
    starts, me = port.rank_span(n, group)
    first, total = starts[me], starts[-1]
    sched, strips, nseg = tiled.shard_schedule(tb.db_len.numpy(), total,
                                               seg_lanes, strip_lanes)
    mine = sched[first:first + n]
    bufs, table, inbox, outbox = tiled.shard_buffers(
        strips, S, nseg, ["cpu"] * n, nrow, starts, me)
    relay.BLOCK_ROWS = block_rows
    rl = relay.ColumnRelay(group, inbox, outbox, tb.query_len.numpy() + 1,
                           relay.next_tag())
    torch = port.torch
    table_t = torch.from_numpy(table)
    runs = [dict(n=len(it), items=torch.from_numpy(np.ascontiguousarray(it)),
                 fin=torch.zeros((B, 3), dtype=torch.int32),
                 col=torch.full((max(len(it), 1) * 2 * nrow,), 12345,
                                dtype=torch.int32),
                 ctr=torch.zeros(2 + 8 * B + 2 * len(it), dtype=torch.int32))
            for it in mine]
    segments = sorted({int(s) // S for it in mine for s in it[:, 1]})
    rl.start()
    failure = None
    pending = [r for r in runs if r["n"]]
    while pending and failure is None:
        moved = False
        for r in list(pending):
            before = int(r["ctr"][0])
            rc = host.hc_tiled_shard_fill(
                *(t.data_ptr() for t in tb), r["fin"].data_ptr(),
                r["col"].data_ptr(), r["ctr"].data_ptr(),
                r["items"].data_ptr(), table_t.data_ptr(), B, L1,
                tb.db.shape[1], r["n"], r["n"], scheme.match_,
                scheme.mismatch, scheme.gap_open, scheme.gap_extend,
                int(compat), int(wildcard), strip_lanes, S, nseg, chunk_rows)
            if rc not in (0, 1):
                failure = f"hc_tiled_shard_fill: error {rc}"
                break
            if rc == 0:
                pending.remove(r)
            moved |= rc == 0 or int(r["ctr"][0]) > before
        if not moved and failure is None:
            if rl.errors:
                failure = f"rank {me} relay: " + "; ".join(rl.errors)
            time.sleep(1e-3)
    rl.finish(failure is None)
    if rl.errors and failure is None:
        failure = f"rank {me} relay: " + "; ".join(rl.errors)
    finals = sum(r["fin"] for r in runs).numpy()
    total_f, _ = relay.exchange_finals(finals, failure, group)
    del bufs
    got = tiled._empty_db_corners(
        torch.from_numpy(total_f.astype(np.int32)), tb.query_len, tb.db_len,
        scheme, compat)
    return got, segments, dict(sent=rl.sent, received=rl.received)


def host_cases(port):
    tiled = port.tiled
    for name, (make, n, seg, strip, rows, compat, wildcard, sk,
               block) in HOST_CASES.items():
        scheme = port.ScoringScheme(**sk)
        tb = port.to_device(port.pack_batch(make()), "cpu")
        got, segments, msgs = host_route(port, tb, n, seg, strip, rows,
                                         scheme, compat, wildcard, block)
        want = tiled.shard_fill_torch(*tb, ["cpu"] * n, seg, 128, scheme,
                                      compat, wildcard,
                                      group=port.seqpar_group())
        emit("HOST", dict(case=name, finals=got.tolist(),
                          plain=want.tolist(), segments=segments,
                          messages=msgs))


def align_cases(port):
    for name, (make, n, kw) in ALIGN_CASES.items():
        s1, s2 = make()
        got = port.seqpar_align(s1, s2, mesh=["cpu"] * n, **kw)
        emit("ALIGN", dict(case=name, result=list(got)))


def withhold(port, mode, rank):
    relay = port.relay
    relay.RELAY_TIMEOUT_S = WITHHOLD_TIMEOUT_S
    if rank == 0:
        if mode == "withhold_plain":
            relay.send_column = lambda *a, **k: None
        else:
            relay.ColumnRelay._send_loop = lambda self, peer, edges: None
    t0 = time.perf_counter()
    try:
        if mode == "withhold_plain":
            batch = port.pack_batch(chained_pairs(), batch_size=8)
            port.seqpar_fill(batch.query, batch.db, batch.query_len,
                             batch.db_len, mesh=["cpu"] * 2, tile_lanes=128)
        else:
            # Rank 1's shards wait on rank 0's columns from the start.
            tb = port.to_device(port.pack_batch(ragged_pairs(11, db_hi=400)),
                                "cpu")
            host_route(port, tb, 2, 128, 128, 8, port.ScoringScheme(), True,
                       False, 16)
    except RuntimeError as e:
        emit("RAISED", dict(rank=rank, message=str(e),
                            seconds=time.perf_counter() - t0))
        return
    emit("NO_RAISE", dict(rank=rank))


class _Port:
    """The port's names the cases use."""

    def __init__(self):
        import torch
        import torch.distributed as dist

        from sequencealigning_tpu_torch import csrc
        from sequencealigning_tpu_torch.config import ScoringScheme
        from sequencealigning_tpu_torch.device import to_device
        from sequencealigning_tpu_torch.io.encode import pack_batch
        from sequencealigning_tpu_torch.ops import nw_affine_tiled
        from sequencealigning_tpu_torch.parallel import relay, seqpar_align, \
            seqpar_fill
        from sequencealigning_tpu_torch.parallel.mesh import rank_span, \
            seqpar_group

        self.torch, self.dist, self.csrc = torch, dist, csrc
        self.ScoringScheme, self.to_device = ScoringScheme, to_device
        self.pack_batch, self.tiled, self.relay = pack_batch, \
            nw_affine_tiled, relay
        self.seqpar_fill, self.seqpar_align = seqpar_fill, seqpar_align
        self.rank_span, self.seqpar_group = rank_span, seqpar_group


def main() -> int:
    rank, ranks, port_no, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from sequencealigning_tpu_torch.parallel import multihost_init

    multihost_init(f"localhost:{port_no}", num_processes=ranks,
                   process_id=rank, backend="gloo")
    port = _Port()
    if mode == "fill":
        fill_cases(port)
        host_cases(port)
        align_cases(port)
        port.dist.barrier()
    else:
        withhold(port, mode, rank)
    sys.stdout.flush()
    # A withheld run leaves a receiver thread waiting inside Gloo: end the
    # process without tearing the group down.
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())

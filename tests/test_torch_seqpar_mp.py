"""The port's sequence parallelism across two real processes on the CPU
(torch.distributed, Gloo; tests/torch_seqpar_mp_worker.py), against the
JAX package's seqpar on one process over the same total number of
devices (its virtual CPU devices).

Each rank drives a mesh of CPU shards; one pair's segments go over every
rank's shards in rank order, the boundary column crossing ranks in both
directions (rank 0 -> rank 1 inside a round, rank 1 -> rank 0 at a round's
wrap).  Checked: seqpar_fill's finals on every rank equal the JAX ones
(compat and textbook, wildcard under a random scheme, the ragged batch
with an empty db and an empty query, tile lanes 128 and 256, 2 and 4
shards a rank), each rank filling only its own shards' segments; the shard
fill's host build with its columns relayed between ranks through host
buffers (parallel/relay.ColumnRelay) equal to the plain twin; seqpar_align
on every rank equal to the JAX one; and a rank that sends nothing makes
the waiting rank raise, naming the shards and the rank, within a bound."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.io.encode import pack_batch as jax_pack_batch
from sequencealigning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sequencealigning_tpu.parallel.seqpar import seqpar_align as jax_align
from sequencealigning_tpu.parallel.seqpar import seqpar_fill as jax_fill

from sequencealigning_tpu_torch.ops.nw_affine_tiled import seqpar_lanes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_seqpar_mp_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_seqpar_mp_worker import (  # noqa: E402
    ALIGN_CASES,
    FILL_CASES,
    HOST_CASES,
    WITHHOLD_TIMEOUT_S,
)

RANKS = 2
MODES = ("fill", "withhold_plain", "withhold_host")
# Seconds a worker may take (it also bounds a hang).
WORKER_TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def started():
    """Every mode's two ranks, started at once (so they run while the JAX
    side computes)."""
    procs = {}
    for mode in MODES:
        port = _free_port()
        procs[mode] = [
            subprocess.Popen([sys.executable, WORKER, str(r), str(RANKS),
                              str(port), mode],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             cwd=REPO, text=True)
            for r in range(RANKS)]
    yield procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def results(started, jax_results):
    """{mode: per rank, {tag: [payload, ...]}}, each worker having exited
    with 0."""
    out = {}
    for mode, procs in started.items():
        out[mode] = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, (mode, p.returncode, stdout, stderr)
            got = {}
            for line in stdout.splitlines():
                tag, _, payload = line.partition(" ")
                got.setdefault(tag, []).append(json.loads(payload))
            out[mode].append(got)
    return out


@pytest.fixture(scope="module")
def jax_results(started):
    """The JAX seqpar on one process over each case's total devices."""
    out = {}
    for name, (make, n, tl, compat, wildcard, sk) in FILL_CASES.items():
        pairs = make()
        batch = jax_pack_batch(pairs, batch_size=8)
        out[name] = np.asarray(jax_fill(
            batch.query, batch.db, batch.query_len, batch.db_len,
            mesh=jax_make_mesh(shape=(RANKS * n,)), tile_lanes=tl,
            compat=compat, wildcard=wildcard,
            scheme=JaxScheme(**sk)))[:len(pairs)]
    for name, (make, n, kw) in ALIGN_CASES.items():
        s1, s2 = make()
        out[name] = list(jax_align(s1, s2, mesh=jax_make_mesh(
            shape=(RANKS * n,)), **kw))
    return out


def _by_case(results, mode, tag):
    return [{p["case"]: p for p in rank.get(tag, [])}
            for rank in results[mode]]


def _check_partition(segs_by_rank, n, n_used):
    """Rank r filled exactly the segments k of its own shards (k % D in
    r * n .. r * n + n - 1, D = RANKS * n), each once, and the ranks
    together every segment 0 .. n_used - 1."""
    D = RANKS * n
    for r, segs in enumerate(segs_by_rank):
        assert len(segs) == len(set(segs)), (r, segs)
        assert all(r * n <= k % D < (r + 1) * n for k in segs), (r, segs)
    assert sorted(sum(segs_by_rank, [])) == list(range(n_used))


@pytest.mark.parametrize("case", list(FILL_CASES))
def test_seqpar_fill_over_ranks_matches_jax(results, jax_results, case):
    """seqpar_fill under a two-rank group equals the JAX seqpar_fill over
    the same total devices on every rank, and each rank fills only its own
    shards' segments (not the whole pair)."""
    make, n, tl, *_ = FILL_CASES[case]
    ranks = _by_case(results, "fill", "FILL")
    pairs = make()
    for r in range(RANKS):
        np.testing.assert_array_equal(np.array(ranks[r][case]["finals"]),
                                      jax_results[case], err_msg=f"rank {r}")
    L2 = max(len(s2) for _s1, s2 in pairs)
    W = seqpar_lanes(L2, RANKS * n, tl)
    _check_partition([ranks[r][case]["segments"] for r in range(RANKS)], n,
                     -(-L2 // W))


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_shard_fill_through_the_relay_matches_plain(results, case):
    """The shard fill's host build, its columns between ranks moved by the
    relay through host buffers in messages of a few rows, equals the plain
    twin across the same ranks on every rank; each rank's launches hold
    only its own shards' segments."""
    make, n, seg, strip, *_ = HOST_CASES[case]
    ranks = _by_case(results, "fill", "HOST")
    for r in range(RANKS):
        got = ranks[r][case]
        assert got["finals"] == got["plain"], f"rank {r}"
        assert got["messages"]["sent"] > 0 and got["messages"]["received"] > 0
    assert ranks[0][case]["finals"] == ranks[1][case]["finals"]
    L2 = max(len(s2) for _s1, s2 in make())
    _check_partition([ranks[r][case]["segments"] for r in range(RANKS)], n,
                     -(-L2 // seg))


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_seqpar_align_over_ranks_matches_jax(results, jax_results, case):
    """seqpar_align under a two-rank group returns the JAX seqpar_align's
    score and aligned strings on every rank."""
    ranks = _by_case(results, "fill", "ALIGN")
    for r in range(RANKS):
        assert ranks[r][case]["result"] == jax_results[case], f"rank {r}"


@pytest.mark.parametrize("mode", ["withhold_plain", "withhold_host"])
def test_withheld_column_raises_on_every_rank(results, mode):
    """Rank 0 sends no column (the plain twin's sends, resp. the relay's
    sender threads): rank 1, waiting on shard 1's column, raises within the
    relay's bound naming the shards and the rank, and rank 0 raises too;
    nothing hangs and nothing falls back to a fill of its own."""
    ranks = results[mode]
    for r in range(RANKS):
        assert "NO_RAISE" not in ranks[r], (r, ranks[r])
        assert len(ranks[r]["RAISED"]) == 1, (r, ranks[r])
    waited = ranks[1]["RAISED"][0]
    assert "shard 1 -> shard 2" in waited["message"], waited
    assert "rank 0" in waited["message"], waited
    assert waited["seconds"] < WITHHOLD_TIMEOUT_S + 30, waited

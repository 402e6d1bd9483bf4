"""Sequence parallelism in the port (parallel/seqpar.py): one pair's DP
matrix spread over a mesh of devices, against the JAX package's seqpar on
its 8 virtual CPU devices (exact, int32).

The port runs on ``["cpu"] * 8`` through the plain twin
(ops.nw_affine_tiled.shard_fill_torch); the shard fill's segment logic --
the segments' lane offsets, the columns inside a launch and the boundary
buffers between launches, the corner's launch, rounds chained from the
last device to the first -- runs through its host build
(csrc/host_check.cpp::hc_tiled_shard_fill, one call a launch, the launches
in turn) against the plain twin.  The CUDA launches themselves run in
chip_smoke.py's phase 25."""

import random

import numpy as np
import pytest
import torch

from sequencealigning_tpu.errors import AlignmentError as JaxAlignmentError
from sequencealigning_tpu.io.encode import pack_batch as jax_pack_batch
from sequencealigning_tpu.ops import traceback as jax_traceback
from sequencealigning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sequencealigning_tpu.parallel.seqpar import seqpar_align as jax_align
from sequencealigning_tpu.parallel.seqpar import seqpar_fill as jax_fill

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.errors import AlignmentError
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import nw_affine_tiled as tiled
from sequencealigning_tpu_torch.parallel import seqpar, seqpar_align, \
    seqpar_fill

MESH = ["cpu"] * 8


def _pairs(seed, n=8, n1_hi=200, n2_lo=300, n2_hi=900):
    """tests/test_seqpar.py's pairs."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        n1 = rng.randint(1, n1_hi)
        n2 = rng.randint(n2_lo, n2_hi)
        out.append((bytes(rng.choice(b"ACGT") for _ in range(n1)),
                    bytes(rng.choice(b"ACGT") for _ in range(n2))))
    return out


def _chained_pairs():
    """tests/test_seqpar.py's 3-round batch (dbs past 8 x 128 lanes)."""
    rng = random.Random(71)
    pairs = []
    for n2 in (2900, 2500, 1500, 1024, 1025, 900, 40, 2048):
        n1 = rng.randint(1, 120)
        pairs.append((bytes(rng.choice(b"ACGT") for _ in range(n1)),
                      bytes(rng.choice(b"ACGT") for _ in range(n2))))
    return pairs


CASES = {
    "pairs61": lambda: _pairs(61),
    "edges": lambda: _pairs(67, n=6, n2_lo=1, n2_hi=600)
    + [(b"", b"ACG"), (b"AC", b"")],
    "chained": _chained_pairs,
}


@pytest.fixture(scope="module")
def jax_finals():
    """The JAX seqpar_fill's finals of every case, compat and textbook, on
    the JAX package's 8-device mesh (computed once)."""
    mesh = jax_make_mesh()
    out = {}
    for name, make in CASES.items():
        pairs = make()
        batch = jax_pack_batch(pairs, batch_size=8)
        for compat in (True, False):
            out[name, compat] = np.asarray(jax_fill(
                batch.query, batch.db, batch.query_len, batch.db_len,
                mesh=mesh, tile_lanes=128, compat=compat))[:len(pairs)]
    return out


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_seqpar_fill_matches_jax(jax_finals, case, compat):
    """The port's seqpar_fill on ["cpu"] * 8 equals the JAX one on its 8
    devices: the batch of test_seqpar's oracle check, its short and empty
    edges, and its batch chaining 3 rounds past the mesh's 1024 lanes."""
    pairs = CASES[case]()
    batch = pack_batch(pairs, batch_size=8)
    got = seqpar_fill(batch.query, batch.db, batch.query_len, batch.db_len,
                      mesh=MESH, tile_lanes=128, compat=compat)
    assert got.dtype == np.int32 and got.shape == (len(pairs), 3)
    np.testing.assert_array_equal(got, jax_finals[case, compat])


def test_seqpar_fill_needs_a_mesh_of_one_kind(monkeypatch):
    """A mesh of CPU and CUDA devices is refused before any work (the
    CUDA check of make_mesh faked to pass)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    batch = pack_batch([(b"ACGT", b"ACG")], batch_size=8)
    with pytest.raises(ValueError, match="mixes"):
        seqpar_fill(batch.query, batch.db, batch.query_len, batch.db_len,
                    mesh=[torch.device("cpu"), torch.device("cuda", 0)])


# ---------------------------------------------------------------------------
# The shard fill's host build against the plain twin
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host():
    if csrc.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/host_check.cpp")
    return csrc.host_check()


def _host_shard(host, tb, n_dev, seg_lanes, strip_lanes, chunk_rows, scheme,
                compat, wildcard, items=None):
    """The mesh's launches of hc_tiled_shard_fill, called in turn until all
    have run (each stops before a strip whose boundary buffer another
    launch has not completed): (0, finals), (1, None) when a full turn made
    no progress (the launches wait on each other), or (rc, None) for a
    launch's error."""
    B, L1 = tb.query.shape
    nrow = L1 + 1
    S = seg_lanes // strip_lanes
    sched, strips, nseg = tiled.shard_schedule(tb.db_len.numpy(), n_dev,
                                               seg_lanes, strip_lanes)
    sched = sched if items is None else items
    bufs, table, _inbox, _outbox = tiled.shard_buffers(
        strips, S, nseg, ["cpu"] * n_dev, nrow)
    table_t = torch.from_numpy(table)
    runs = []
    for d in range(n_dev):
        n = len(sched[d])
        runs.append(dict(
            n=n, items=torch.from_numpy(np.ascontiguousarray(sched[d])),
            fin=torch.zeros((B, 3), dtype=torch.int32),
            col=torch.full((max(n, 1) * 2 * nrow,), 12345, dtype=torch.int32),
            ctr=torch.zeros(2 + 8 * B + 2 * n, dtype=torch.int32)))
    pending = [r for r in runs if r["n"]]
    while pending:
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
                return rc, None
            if rc == 0:
                pending.remove(r)
            moved |= rc == 0 or int(r["ctr"][0]) > before
        if not moved:
            return 1, None
    del bufs
    finals = sum(r["fin"] for r in runs)
    return 0, tiled._empty_db_corners(finals, tb.query_len, tb.db_len,
                                      scheme, compat)


def _shard_batch(seed):
    """A ragged batch (queries up to 90 bp, dbs up to 1100, the first 400
    bp longer -- past 8 devices x 128 lanes), every other db a mutated copy
    of its query, with an empty db and an empty query."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(6):
        s1 = rng.choice(alpha, int(rng.integers(1, 91)))
        s2 = rng.choice(alpha, int(rng.integers(1, 1101)))
        if i % 2:
            s2 = np.resize(s1, len(s2))
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        pairs.append((s1.tobytes(), s2.tobytes()))
    pairs[0] = (pairs[0][0], pairs[0][1] + b"ACGT" * 100)
    pairs += [(b"ACGTA", b""), (b"", b"ACGTTGCA")]
    return to_device(pack_batch(pairs), "cpu")


def _random_scheme(rng):
    return ScoringScheme(match_=int(rng.integers(1, 8)),
                         mismatch=-int(rng.integers(1, 9)),
                         gap_open=-int(rng.integers(0, 12)),
                         gap_extend=-int(rng.integers(1, 6)))


@pytest.mark.parametrize("seg_lanes", [128, 256])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_host_shard_fill_matches_plain(host, n_dev, seg_lanes):
    """The shard fill's launches run serially through the kernels' cell and
    staging (128-lane strips, so a 256-lane segment hands its column over
    inside the launch too; chunks of 8 rows) equal the plain twin at the
    same mesh and segment width, under a random scheme, compat or textbook,
    wildcard or not: corners in every round and on every device."""
    rng = np.random.default_rng(100 * n_dev + seg_lanes)
    scheme = _random_scheme(rng)
    compat, wildcard = bool(rng.integers(2)), bool(rng.integers(2))
    tb = _shard_batch(n_dev + seg_lanes)
    want = tiled.shard_fill_torch(*tb, ["cpu"] * n_dev, seg_lanes, 128,
                                  scheme, compat, wildcard)
    rc, got = _host_shard(host, tb, n_dev, seg_lanes, 128, 8, scheme, compat,
                          wildcard)
    assert rc == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_host_shard_fill_reports_launches_waiting_on_each_other(host):
    """Launch 0's tickets not segment-major (segment 2 before segment 0)
    under one CTA a launch: launch 0 waits on segment 1, whose launch waits
    on segment 0 -- neither gets anywhere."""
    tb = _shard_batch(5)
    sched, _strips, _nseg = tiled.shard_schedule(tb.db_len.numpy(), 2, 128,
                                                 128)
    seg0 = sched[0][:, 1] == 0
    cyclic = [np.concatenate([sched[0][~seg0], sched[0][seg0]]), sched[1]]
    rc, _ = _host_shard(host, tb, 2, 128, 128, 8, ScoringScheme(), True,
                        False, items=cyclic)
    assert rc == 1
    rc, _ = _host_shard(host, tb, 2, 128, 128, 8, ScoringScheme(), True,
                        False)
    assert rc == 0


def test_shard_schedule_and_boundaries():
    """Items are segment-major, then by strip, then by pair; a pair's
    strips of one segment are consecutive in the counters; every strip's
    in-launch producer holds an earlier ticket; segment k runs on launch
    k % D and its boundary buffer lies there."""
    n2s = np.array([700, 0, 129, 3000, 1])
    D, seg, strip = 3, 256, 128
    items, strips, nseg = tiled.shard_schedule(n2s, D, seg, strip)
    np.testing.assert_array_equal(strips, [6, 0, 2, 24, 1])
    assert nseg == 12 and sum(len(i) for i in items) == strips.sum()
    for d, it in enumerate(items):
        k = it[:, 1] // 2
        assert (k % D == d).all()
        key = k * 1000 + (it[:, 1] % 2) * 100 + it[:, 0]
        assert (np.diff(key) > 0).all()
        assert sorted(it[:, 2]) == list(range(len(it)))
        ticket = {(int(b), int(s)): (t, int(g)) for t, (b, s, g) in
                  enumerate(it)}
        for (b, s), (t, g) in ticket.items():
            if s % 2:
                tp, gp = ticket[b, s - 1]
                assert tp < t and gp == g - 1
    held = tiled.shard_boundaries(strips, 2, D)
    assert sorted(sum(held, [])) == sorted(
        [(0, 1), (0, 2)] + [(3, k) for k in range(1, 12)])
    for d, pairs in enumerate(held):
        assert all(k % D == d for _b, k in pairs)
    bufs, table, inbox, outbox = tiled.shard_buffers(strips, 2, nseg,
                                                     ["cpu"] * D, 41)
    assert inbox == [] and outbox == []
    assert table.shape == (5 * nseg,)
    assert (table.reshape(5, nseg)[:, 0] == 0).all()
    assert all(int(b.abs().sum()) == 0 for b in bufs if b is not None)
    assert (table != 0).sum() == len(sum(held, []))


def test_seqpar_lanes_follow_the_jax_rule():
    assert tiled.seqpar_lanes(900, 8, 128) == 128
    assert tiled.seqpar_lanes(200_000, 4, 4096) == 4096
    assert tiled.seqpar_lanes(1000, 2, 4096) == 512
    assert tiled.seqpar_lanes(10, 8, 4096) == 128
    assert [tiled.shard_strip_lanes(w) for w in (4096, 1536, 384, 128)] == [
        1024, 512, 128, 128]


def test_peer_access_is_checked_for_distinct_cards():
    """Distinct consecutive cards need peer access (the producer writes
    into the consumer's memory); without it the check raises naming both.
    A card named several times needs none."""
    c0, c1, c2 = (torch.device("cuda", i) for i in range(3))
    asked = []

    def no_peer(a, b):
        asked.append((a, b))
        return False

    with pytest.raises(RuntimeError, match="cuda:0 cannot write into "
                       "cuda:1"):
        tiled.check_peer_access([c0, c1], 2, can_access=no_peer)
    assert asked == [(c0, c1)]
    assert tiled.check_peer_access([c0, c1, c2], 5,
                                   can_access=lambda a, b: True) == [
        (c0, c1), (c1, c2), (c2, c0)]
    assert tiled.check_peer_access([c0, c1], 1, can_access=no_peer) == []
    asked.clear()
    assert tiled.check_peer_access([c0] * 4, 13, can_access=no_peer) == []
    assert asked == []


def test_shard_wrapper_refuses_cpu_tensors():
    tb = to_device(pack_batch([(b"ACGT", b"ACGTT")]), "cpu")
    launches = tiled.tiled_shard_fill_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tiled.tiled_shard_fill_cuda(*tb, ["cpu"], 128, ScoringScheme(),
                                    True, False)
    assert tiled.tiled_shard_fill_cuda.launches == launches


# ---------------------------------------------------------------------------
# seqpar_align
# ---------------------------------------------------------------------------


def _edited_pair(n, edits, seed):
    """tests/test_seqpar.py's certified-alignment pair: a random db and a
    query carrying substitutions and 1 bp indels."""
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


ALIGN_CASES = {
    # test_seqpar_align_certified_alignment: chains a second round.
    "certified": (lambda: _edited_pair(1500, 12, 29),
                  dict(tile_lanes=128, compat=False, band=128)),
    # test_seqpar_align_mm_fallback_past_band_cap.
    "mm_fallback": (lambda: (b"ACGT" * 120, b"T" * 400 + b"ACGT" * 120),
                    dict(tile_lanes=128, compat=False, band=128,
                         max_band=128)),
}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_seqpar_align_matches_jax(case):
    """The same score and the same aligned strings as the JAX seqpar_align:
    the banded path certified by the mesh-exact score, and the Myers-Miller
    alignment past the band cap."""
    make, kw = ALIGN_CASES[case]
    s1, s2 = make()
    want = jax_align(s1, s2, **kw)
    got = seqpar_align(s1, s2, mesh=MESH, **kw)
    assert got == tuple(want)
    assert got[1].replace("-", "").encode() == s1
    assert got[2].replace("-", "").encode() == s2


def test_seqpar_align_walk_error_degrades_unlike_jax(monkeypatch):
    """The named divergence from the JAX package: a walk that fails
    validation (AlignmentError) escapes the JAX seqpar_align, while the
    port's goes to the Myers-Miller fallback, certified by the mesh-exact
    score."""
    s1, s2 = _edited_pair(400, 6, 31)
    kw = dict(tile_lanes=128, compat=False, band=128)
    score = jax_align(s1, s2, **kw)[0]

    def broken(*_args, **_kwargs):
        raise AlignmentError("walk failed validation")

    def jax_broken(*_args, **_kwargs):
        raise JaxAlignmentError("walk failed validation")

    monkeypatch.setattr(jax_traceback, "banded_diag_fast4_traceback_pair",
                        jax_broken)
    with pytest.raises(JaxAlignmentError):
        jax_align(s1, s2, **kw)
    monkeypatch.setattr(seqpar, "banded_diag_fast4_traceback_pair", broken)
    got, a1, a2 = seqpar_align(s1, s2, mesh=MESH, **kw)
    assert got == score
    assert a1.replace("-", "").encode() == s1
    assert a2.replace("-", "").encode() == s2
    assert _rescore(a1, a2, ScoringScheme()) == score


def _rescore(a1, a2, sch):
    """Textbook affine score of an alignment (test_seqpar's rescore)."""
    got, prev = 0, None
    for c1, c2 in zip(a1, a2):
        op = "D" if c1 == "-" else ("I" if c2 == "-" else "M")
        if op == "M":
            got += sch.match_ if c1 == c2 else sch.mismatch
        else:
            got += sch.gap_extend + (sch.gap_open if op != prev else 0)
        prev = op
    return got

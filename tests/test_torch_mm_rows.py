"""The Myers-Miller row kernel's arithmetic and level schedule
(csrc/mm_rows.cuh through csrc/host_check.cpp's hc_mm_rows: the strips of
a level's nodes run serially in ticket order, each strip's wavefront a step
at a time, its threads in a loop) against the plain version, rows_torch,
every column 0..n exactly: random schemes, offsets and forward / reversed
sweeps, the column-0 chain with tb in {0, o}, widths across the kernel's
thread and strip boundaries at 2, 4, 8 and 16 lanes a thread, levels of
several nodes of different widths and heights, and rows that fall below
NEG_INF (held against the JAX package's _rows_fn too); then the port's
mm_align with each level's rows through hc_mm_rows against the JAX
package's mm_align (exact ops strings)."""

import dataclasses

import numpy as np
import pytest
import torch

import sequencealigning_tpu.ops.mm_align as jax_mm
from sequencealigning_tpu.config import ScoringScheme as JaxScheme
import sequencealigning_tpu_torch.ops.mm_align as port
from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme


@pytest.fixture(scope="module")
def host():
    if csrc.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/host_check.cpp")
    return csrc.host_check()


def _run(host, sq, plan, ctr, lanes=None):
    """hc_mm_rows over a planned level (at the plan's lanes a thread unless
    lanes is given), out and the hand-over columns poisoned (no word of
    which holds a row's tag): (rc, out)."""
    s = sq.scheme
    words = plan.words
    out = torch.full((words[2],), 0x5a5a5a5a, dtype=torch.int32)
    bnd = torch.full((max(words[1], 1),), 0x5a5a5a5a, dtype=torch.int32)
    rc = host.hc_mm_rows(
        *(t.data_ptr() for t in (sq.qf, sq.qr, sq.df, sq.dr)),
        plan.table.ctypes.data, len(plan.table), lanes or plan.lanes,
        words[3], out.data_ptr(), bnd.data_ptr(), ctr.data_ptr(), s.match_,
        s.mismatch, s.gap_open, s.gap_extend)
    return rc, out


def _hc_level(host, qf, qr, df, dr, nodes, scheme, lpt=0):
    """hc_mm_rows on CPU tensors (one level launch), its buffers sized by
    hc_mm_rows_plan: a (4, n + 1) int32 tensor a node."""
    plan = port.plan_level(nodes, host, lpt)
    ctr = torch.zeros(plan.words[0], dtype=torch.int32)
    seqs = type("S", (), dict(qf=qf, qr=qr, df=df, dr=dr, scheme=scheme))
    rc, out = _run(host, seqs, plan, ctr)
    assert rc == 0
    assert int(ctr[0]) == plan.words[3] and int(ctr[1]) == 0
    return [out[o: o + 4 * (n + 1)].view(4, n + 1)
            for o, (_f, _r, n) in zip(plan.out_offsets, nodes)]


def _seqs(rng, m0, n0, alphabet=4, scheme=ScoringScheme()):
    q = rng.integers(1, alphabet + 1, m0).astype(np.int32)
    d = rng.integers(1, alphabet + 1, n0).astype(np.int32)
    return port._Seqs(q, d, scheme, "cpu")


def _check(host, sq, fwd, rev, n, lpt=0):
    args = (sq.qf, sq.qr, sq.df, sq.dr, fwd, rev, n, sq.scheme)
    got = _hc_level(host, sq.qf, sq.qr, sq.df, sq.dr, [(fwd, rev, n)],
                    sq.scheme, lpt=lpt)[0]
    want = port.node_rows_torch(*args)
    assert torch.equal(got, want), (fwd, rev, n, lpt)
    return got


def _random_scheme(rng):
    return ScoringScheme(match_=int(rng.integers(1, 9)),
                         mismatch=-int(rng.integers(1, 12)),
                         gap_open=-int(rng.integers(0, 13)),
                         gap_extend=-int(rng.integers(1, 8)))


@pytest.mark.parametrize("lpt", [2, 4, 0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_rows_random_nodes(host, seed, lpt):
    """Random schemes (every other one the default), sequences of up to
    256 codes (N included), nodes at random offsets with tb, te in
    {0, o}: hc_mm_rows equals rows_torch on every column."""
    rng = np.random.default_rng(100 + seed)
    for trial in range(6):
        sch = ScoringScheme() if trial % 2 == 0 else _random_scheme(rng)
        sq = _seqs(rng, int(rng.integers(2, 257)), int(rng.integers(1, 257)),
                   alphabet=5, scheme=sch)
        qa, qb = sorted(int(x) for x in rng.choice(sq.m0 + 1, 2,
                                                   replace=False))
        if qb - qa < 2:
            qa, qb = 0, sq.m0
        da, db_ = sorted(int(x) for x in rng.integers(0, sq.n0 + 1, 2))
        o = sch.gap_open
        tb, te = (int(rng.choice([0, o])) for _ in range(2))
        _check(host, sq, *sq.node(qa, qb, da, db_, tb, te), lpt=lpt)


@pytest.mark.parametrize("tb", ["zero", "open"])
@pytest.mark.parametrize("m,n", [(1, 1), (1, 0), (0, 1), (2, 1), (1, 5)])
def test_host_rows_smallest(host, m, n, tb):
    """One row and one column, each sweep on its own and both together,
    the column-0 chain from tb = 0 and tb = o."""
    rng = np.random.default_rng(7)
    sq = _seqs(rng, 6, 6)
    t = 0 if tb == "zero" else sq.scheme.gap_open
    for fwd, rev in (((1, m, 2, t), (0, 0, 0, 0)),
                     ((0, 0, 0, 0), (3, m, 1, t)),
                     ((2, m, 0, t), (1, m, 3, t))):
        _check(host, sq, fwd, rev, n)


@pytest.mark.parametrize("lpt", [2, 4, 8, 16])
def test_host_rows_thread_and_strip_boundaries(host, lpt):
    """Widths one below, at and one past a thread's lanes and a strip's
    (32 x lpt lanes), and two and three strips, forward and reversed:
    the wavefront's first and last threads, and the hand-over between
    strips, on every lanes-a-thread count (the kernel's 16, and narrower
    ones that put more boundaries in small inputs)."""
    W = 32 * lpt
    rng = np.random.default_rng(11 + lpt)
    sq = _seqs(rng, 80, 3 * W + 2)
    for n in sorted({lpt - 1, lpt, lpt + 1, W - 1, W, W + 1, 2 * W - 1,
                     2 * W, 2 * W + 1, 3 * W + 1}):
        _check(host, sq, (3, 40, 1, sq.scheme.gap_open),
               (10, 37, sq.n0 - n, 0), n, lpt=lpt)


@pytest.mark.parametrize("lpt", [4, 16])
def test_host_rows_below_neg_inf(host, lpt):
    """n ~ 5000 with e = -7: row 0's o + j*e passes -32768 (NEG_INF), and
    E[0] = NEG_INF and DD = NEG_INF leak into real lanes; the kernel's
    integers are rows_torch's, which are the JAX package's _rows_fn's."""
    sch = ScoringScheme(match_=5, mismatch=-4, gap_open=-10, gap_extend=-7)
    rng = np.random.default_rng(5)
    sq = _seqs(rng, 60, 5000, scheme=sch)
    n = 4990
    assert sch.gap_open + n * sch.gap_extend < NEG_INF
    fwd, rev = (5, 24, 3, sch.gap_open), (2, 30, 7, 0)
    got = _check(host, sq, fwd, rev, n, lpt=lpt)
    assert int(got[0].min()) < NEG_INF and int(got[2].min()) < NEG_INF
    sq_j = jax_mm._Seqs(sq.qf.numpy()[: sq.m0], sq.df.numpy()[1: 1 + sq.n0],
                        JaxScheme(**dataclasses.asdict(sch)))
    for k, (reverse, (q_off, m, d_off, tb)) in enumerate(((False, fwd),
                                                          (True, rev))):
        want = sq_j.rows(reverse, q_off, m, d_off, n, tb)
        for g, w in zip(got[2 * k: 2 * k + 2], want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("lpt", [2, 4])
def test_host_rows_tall_chain_below_neg_inf(host, lpt):
    """A tall, narrow node: ~4800 rows with e = -7, so the column-0 chain
    tb + i*e passes NEG_INF, below E[0] = NEG_INF: column 0 still takes
    the chain, as rows_torch writes it."""
    sch = ScoringScheme(match_=5, mismatch=-4, gap_open=-10, gap_extend=-7)
    rng = np.random.default_rng(8)
    sq = _seqs(rng, 9700, 100, scheme=sch)
    fwd, rev = (0, 4800, 0, sch.gap_open), (20, 4850, 5, 0)
    got = _check(host, sq, fwd, rev, 70, lpt=lpt)
    assert int(got[0, 0]) == sch.gap_open + 4800 * sch.gap_extend < NEG_INF
    assert int(got[2, 0]) == 4850 * sch.gap_extend < NEG_INF


@pytest.mark.parametrize("lpt", [2, 4, 8, 16])
def test_host_level_of_nodes(host, lpt):
    """One level launch over nodes of different widths and heights (a
    node narrower than a thread's lanes, one of several strips, a tall
    narrow one, one sweep idle, random schemes' worth of offsets and
    subsidies): each node's rows equal node_rows_torch's, so the tickets
    map to the right node, sweep and strip, and each node's hand-over
    columns and output rows are its own."""
    rng = np.random.default_rng(60 + lpt)
    sq = _seqs(rng, 700, 900, alphabet=5,
               scheme=ScoringScheme(match_=3, mismatch=-5, gap_open=-7,
                                    gap_extend=-2))
    o = sq.scheme.gap_open
    subs = [(0, 60, 0, 900, o, o), (100, 103, 40, 41, 0, o),
            (200, 260, 300, 300 + 15 * lpt + 3, o, 0),
            (300, 650, 10, 80, 0, 0), (650, 700, 500, 560, o, o)]
    nodes = [sq.node(*sub) for sub in subs]
    nodes.append(((5, 0, 3, 0), (7, 33, 11, o), 40))
    got = _hc_level(host, sq.qf, sq.qr, sq.df, sq.dr, nodes, sq.scheme,
                    lpt=lpt)
    for (fwd, rev, n), g in zip(nodes, got):
        want = port.node_rows_torch(sq.qf, sq.qr, sq.df, sq.dr, fwd, rev, n,
                                    sq.scheme)
        assert torch.equal(g, want), (fwd, rev, n, lpt)


def test_host_rows_refuse_unsupported_lanes(host):
    rng = np.random.default_rng(3)
    sq = _seqs(rng, 8, 8)
    nodes = [((0, 4, 0, 0), (0, 4, 0, 0), 8)]
    for lpt in (3, 32):
        with pytest.raises(ValueError, match="refused"):
            port.plan_level(nodes, host, lpt)
    plan = port.plan_level(nodes, host, 4)
    ctr = torch.zeros(plan.words[0], dtype=torch.int32)
    assert _run(host, sq, plan, ctr, lanes=3)[0] == -1
    with pytest.raises(ValueError, match="refused"):
        port.plan_level([((0, -1, 0, 0), (0, 4, 0, 0), 8)], host, 4)


def test_host_rows_unmet_hand_over(host):
    """Tickets from 2 on leave the first node's strips 0 unrun: its forward
    sweep's strip 1 finds no word of the rows it needs in the hand-over
    column, and the host build says so (-4), as the kernel's stalled wait
    sets the status word the wrapper raises on."""
    rng = np.random.default_rng(4)
    sq = _seqs(rng, 40, 200)
    nodes = [((0, 20, 0, -8), (0, 20, 0, -8), 200),
             ((20, 10, 5, 0), (3, 12, 9, 0), 30)]
    plan = port.plan_level(nodes, host, 2)
    # 4 strips a sweep of 22-row columns, 1 strip a sweep of 14.
    assert (plan.lanes, plan.words) == (
        2, (2, 2 * (2 * 4 * 2 * 22 + 2 * 2 * 14), 4 * 201 + 4 * 31,
            2 * 4 + 2 * 1))
    ctr = torch.zeros(plan.words[0], dtype=torch.int32)
    ctr[0] = 2
    rc, _out = _run(host, sq, plan, ctr)
    assert rc == -4 and int(ctr[0]) == 3


@pytest.mark.parametrize("widths", [
    (0,), (100_000,), (270_335,), (270_336,), (400_000,), (100_000,) * 2,
    (100_000,) * 3, (1500,) * 64, (3000,) * 64])
def test_host_rows_lane_rule_and_scratch(host, widths):
    """The kernel's lanes a thread, 16, at every level's width, also where
    a level's strips outnumber a 132-SM grid's 1,056 warps (270,336
    columns and up, three nodes of 100,001); ctr holds the ticket and the
    status word, bnd a hand-over column (two 64-bit words a row, max(m) + 2
    rows) a strip of each sweep, out a node's four rows of n + 1, and the
    tickets and the output rows run node by node."""
    nodes = [((0, 300, 0, 0), (0, 301, 0, 0), n) for n in widths]
    plan = port.plan_level(nodes, host, 0)
    strips = [-(-(n + 1) // 512) for n in widths]
    assert plan.lanes == 16
    assert plan.words == (2, 2 * 2 * sum(strips) * 2 * 303,
                          sum(4 * (n + 1) for n in widths), 2 * sum(strips))
    assert plan.first_tickets == [2 * sum(strips[:k])
                                  for k in range(len(widths))]
    assert plan.out_offsets == [sum(4 * (n + 1) for n in widths[:k])
                                for k in range(len(widths))]


def test_mm_rows_cuda_refuses_cpu_tensors():
    rng = np.random.default_rng(3)
    sq = _seqs(rng, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        port.mm_rows_cuda(sq.qf, sq.qr, sq.df, sq.dr,
                          [((0, 4, 0, 0), (0, 4, 0, 0), 8)], sq.scheme)
    assert port.mm_rows_cuda.launches == 0


def _jax(scheme):
    return JaxScheme(**dataclasses.asdict(scheme))


@pytest.mark.parametrize("lpt", [2, 4])
@pytest.mark.parametrize("cutoff", [32, 600])
def test_mm_align_through_host_rows_matches_jax(host, monkeypatch, cutoff,
                                                lpt):
    """The port's mm_align on the CPU through the level driver, every
    level's rows from one hc_mm_rows launch (the kernel's loop) and
    _DIRECT_CELLS lowered on both modules: its ops strings equal the JAX
    package's."""
    calls = []

    def rows_via_host(qf, qr, df, dr, nodes, scheme):
        calls.append(len(nodes))
        return _hc_level(host, qf, qr, df, dr, nodes, scheme, lpt=lpt)

    monkeypatch.setattr(port, "level_rows", rows_via_host)
    monkeypatch.setattr(port, "_DIRECT_CELLS", cutoff)
    monkeypatch.setattr(jax_mm, "_DIRECT_CELLS", cutoff)
    rng = np.random.default_rng(40 + cutoff)
    conv = np.frombuffer(b"ACGT", np.uint8)
    schemes = (ScoringScheme(), ScoringScheme(match_=3, mismatch=-5,
                                              gap_open=-7, gap_extend=-2))
    for k, (n, cut) in enumerate(((250, (60, 130)), (200, (0, 0)),
                                  (120, (10, 25)))):
        a = rng.integers(0, 4, n)
        b = np.concatenate([a[: cut[0]], a[cut[1]:]])
        idx = rng.random(len(b)) < 0.05
        b[idx] = rng.integers(0, 4, idx.sum())
        s1, s2 = bytes(conv[a]), bytes(conv[b])
        sch = schemes[k % 2]
        got = port.mm_align(s1, s2, sch, device="cpu")
        assert got == jax_mm.mm_align(s1, s2, _jax(sch))
        assert len(got) - got.count("I") == len(s2)
    assert calls and max(calls) > 1

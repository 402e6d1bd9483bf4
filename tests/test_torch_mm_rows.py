"""The Myers-Miller row kernel's arithmetic and strip schedule
(csrc/mm_rows.cuh through csrc/host_check.cpp's hc_mm_rows: the strips run
serially in ticket order, each warp's threads in a loop) against the plain
version, rows_torch, every column 0..n exactly: random schemes, offsets and
forward / reversed sweeps, the column-0 chain with tb in {0, o}, widths
across the kernel's thread and strip boundaries, and rows that fall below
NEG_INF (held against the JAX package's _rows_fn too); then the port's
mm_align with its node rows through hc_mm_rows against the JAX
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


def _scratch(host, n, m_f, m_r, lpt=0):
    """hc_mm_rows_scratch: the lanes a thread and the int32 words of ctr and
    of bnd."""
    words = np.zeros(2, np.int64)
    lanes = host.hc_mm_rows_scratch(n, m_f, m_r, lpt, words.ctypes.data)
    return lanes, int(words[0]), int(words[1])


def _hc_rows(host, qf, qr, df, dr, fwd, rev, n, scheme, lpt=0):
    """hc_mm_rows on CPU tensors, its scratch sized by hc_mm_rows_scratch:
    (4, n + 1) int32."""
    lanes, ctr_words, bnd_words = _scratch(host, n, fwd[1], rev[1], lpt)
    assert lanes > 0
    out = torch.full((4, n + 1), 0x5a5a5a5a, dtype=torch.int32)
    bnd = torch.full((bnd_words,), 0x5a5a5a5a, dtype=torch.int32)
    ctr = torch.zeros(ctr_words, dtype=torch.int32)
    rc = host.hc_mm_rows(
        *(t.data_ptr() for t in (qf, qr, df, dr)), out.data_ptr(),
        bnd.data_ptr(), ctr.data_ptr(), *fwd, *rev, n, scheme.match_,
        scheme.mismatch, scheme.gap_open, scheme.gap_extend, lpt)
    assert rc == 0
    assert int(ctr[0]) == ctr_words - 2 and int(ctr[1]) == 0
    return out


def _seqs(rng, m0, n0, alphabet=4, scheme=ScoringScheme()):
    q = rng.integers(1, alphabet + 1, m0).astype(np.int32)
    d = rng.integers(1, alphabet + 1, n0).astype(np.int32)
    return port._Seqs(q, d, scheme, "cpu")


def _check(host, sq, fwd, rev, n, lpt=0):
    args = (sq.qf, sq.qr, sq.df, sq.dr, fwd, rev, n, sq.scheme)
    got = _hc_rows(host, *args, lpt=lpt)
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


@pytest.mark.parametrize("lpt", [2, 4])
def test_host_rows_thread_and_strip_boundaries(host, lpt):
    """Widths one below, at and one past a thread's lanes and a strip's
    (32 x lpt lanes), and two and three strips, forward and reversed."""
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


def test_host_rows_refuse_unsupported_lanes(host):
    rng = np.random.default_rng(3)
    sq = _seqs(rng, 8, 8)
    out = torch.zeros((4, 9), dtype=torch.int32)
    bnd = torch.zeros(64, dtype=torch.int32)
    ctr = torch.zeros(4, dtype=torch.int32)
    rc = host.hc_mm_rows(
        *(t.data_ptr() for t in (sq.qf, sq.qr, sq.df, sq.dr)),
        out.data_ptr(), bnd.data_ptr(), ctr.data_ptr(), 0, 4, 0, 0, 0, 4, 0,
        0, 8, 5, -4, -8, -6, 3)
    assert rc == -1


def test_host_rows_unmet_hand_over(host):
    """Tickets from 2 on leave both sweeps' strip 0 unrun: the forward
    sweep's strip 1 cannot wait for it, and the host build says so (-4),
    as the kernel's stalled wait sets the status word the wrapper raises
    on."""
    rng = np.random.default_rng(4)
    sq = _seqs(rng, 40, 200)
    lanes, ctr_words, bnd_words = _scratch(host, 200, 20, 20, 2)
    assert (lanes, ctr_words, bnd_words) == (2, 2 + 2 * 4, 4 * 4 * 21)
    out = torch.zeros((4, 201), dtype=torch.int32)
    bnd = torch.zeros(bnd_words, dtype=torch.int32)
    ctr = torch.zeros(ctr_words, dtype=torch.int32)
    ctr[0] = 2
    rc = host.hc_mm_rows(
        *(t.data_ptr() for t in (sq.qf, sq.qr, sq.df, sq.dr)),
        out.data_ptr(), bnd.data_ptr(), ctr.data_ptr(), 0, 20, 0, -8, 0,
        20, 0, -8, 200, 5, -4, -8, -6, 2)
    assert rc == -4 and int(ctr[0]) == 3


@pytest.mark.parametrize("n,lanes", [(0, 4), (33790, 4), (33791, 4),
                                     (33792, 8), (67583, 8), (67584, 16),
                                     (100_000, 16), (400_000, 16)])
def test_host_rows_lane_rule_and_scratch(host, n, lanes):
    """The lanes a thread by width (132 SMs): 4 while both sweeps' strips
    of 128 columns fit 4 warps an SM, then 8, then 16 at any width; ctr
    holds the ticket, the status word and a count a strip of each sweep,
    bnd a column of max(m) + 1 rows' pairs a strip of each sweep."""
    got, ctr_words, bnd_words = _scratch(host, n, 300, 301)
    strips = -(-(n + 1) // (32 * lanes))
    assert got == lanes
    assert ctr_words == 2 + 2 * strips
    assert bnd_words == 2 * strips * 2 * 302


def test_mm_rows_cuda_refuses_cpu_tensors():
    rng = np.random.default_rng(3)
    sq = _seqs(rng, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        port.mm_rows_cuda(sq.qf, sq.qr, sq.df, sq.dr, (0, 4, 0, 0),
                          (0, 4, 0, 0), 8, sq.scheme)
    assert port.mm_rows_cuda.launches == 0


def test_seqs_rows_is_one_sweep_of_node_rows():
    """_Seqs.rows (one sweep, the other idle) equals the matching half of
    _Seqs.node_rows."""
    rng = np.random.default_rng(9)
    sq = _seqs(rng, 50, 70)
    fwd, rev = (4, 20, 6, -8), (3, 25, 10, 0)
    CC, DD, RR, SS = sq.node_rows(fwd, rev, 50)
    for got, want in ((sq.rows(False, *fwd[:3], 50, fwd[3]), (CC, DD)),
                      (sq.rows(True, *rev[:3], 50, rev[3]), (RR, SS))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _jax(scheme):
    return JaxScheme(**dataclasses.asdict(scheme))


@pytest.mark.parametrize("lpt", [2, 4])
@pytest.mark.parametrize("cutoff", [32, 600])
def test_mm_align_through_host_rows_matches_jax(host, monkeypatch, cutoff,
                                                lpt):
    """The port's mm_align on the CPU with every node's rows from
    hc_mm_rows (the kernel's loop) and _DIRECT_CELLS lowered on both
    modules: its ops strings equal the JAX package's."""
    calls = []

    def rows_via_host(qf, qr, df, dr, fwd, rev, n, scheme):
        calls.append(n)
        return _hc_rows(host, qf, qr, df, dr, fwd, rev, n, scheme, lpt=lpt)

    monkeypatch.setattr(port, "node_rows", rows_via_host)
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
    assert calls

"""The port's per-pair global Gotoh fill (kernel #7, ops.nw_affine) against
the JAX package's nw_affine_batch (exact: integer finals and the direction
words must be equal): the plain fill against the lax twin, score-only and
with the full dirs, compat and textbook, wildcard on and off, one tiny case
against the Pallas kernel in interpret mode; the CUDA kernel's cell loop
(csrc/host_check.cpp, also split over forced 128-lane CTAs) against the
plain fill, its dirs on each pair's cells; the host walker on the plain
fill's dirs and on the kernel's, whose bytes outside the pairs' matrices
are 0."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import nw_affine as jax_nw
from sequencealigning_tpu.ops import traceback as jax_tb
from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import dirbits
from sequencealigning_tpu_torch.ops import nw_affine as port
from sequencealigning_tpu_torch.ops import traceback as tb

SCHEMES = [ScoringScheme(),
           ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the test's plain torch ops: the suite runs
    several workers on the machine's cores, and wide per-step ops across
    threads that other workers hold stall at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed, n, hi1, hi2, alphabet=b"ACGTN"):
    """Pairs of 0..hi bp, every other db a mutated copy of its query."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(0, hi1 + 1)))
        n2 = int(rng.integers(0, hi2 + 1))
        s2 = rng.choice(alpha, n2)
        if i % 2 and len(s1):
            s2 = np.resize(s1, n2).copy()
            s2[rng.integers(max(n2, 1)):] = rng.choice(alpha)
        out.append((s1.tobytes(), s2.tobytes()))
    return out


def _batch(seed, n=10, hi1=70, hi2=140):
    pairs = _pairs(seed, n, hi1, hi2)
    return pairs, pack_batch(pairs, batch_size=16)


def _jax(batch, scheme, compat, wildcard, with_dirs, backend="lax"):
    return jax_nw.nw_affine_batch(
        batch.query.astype(np.int32), batch.db.astype(np.int32),
        batch.query_len, batch.db_len,
        scheme=JaxScheme(**dataclasses.asdict(scheme)), compat=compat,
        wildcard=wildcard, with_dirs=with_dirs, backend=backend, chunk=64,
    )


@pytest.mark.parametrize("with_dirs", [False, True])
@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_plain_fill_matches_jax_lax(compat, wildcard, with_dirs):
    _pairs_, batch = _batch(1 + 2 * compat + wildcard)
    scheme = SCHEMES[int(wildcard)]
    want = _jax(batch, scheme, compat, wildcard, with_dirs)
    got = port.nw_affine_batch(*to_device(batch, "cpu"), scheme=scheme,
                               compat=compat, wildcard=wildcard,
                               with_dirs=with_dirs)
    np.testing.assert_array_equal(got.finals, np.asarray(want.finals))
    if with_dirs:
        np.testing.assert_array_equal(got.dirs.numpy(),
                                      np.asarray(want.dirs))
    else:
        assert got.dirs is None and want.dirs is None


def test_plain_fill_matches_jax_pallas_interpret():
    """One tiny batch against the TPU kernel itself (interpret mode): the
    finals, and the direction bytes of every diagonal (the kernel pads to
    whole 64-diagonal chunks and fills the bytes past D_total; the lax
    layout ends at D_total with zero bytes)."""
    _pairs_, batch = _batch(9, n=8, hi1=20, hi2=40)
    want = _jax(batch, ScoringScheme(), True, False, True, backend="pallas")
    got = port.nw_affine_batch(*to_device(batch, "cpu"), with_dirs=True)
    np.testing.assert_array_equal(got.finals, np.asarray(want.finals))
    d_total = batch.query.shape[1] + batch.db.shape[1] + 1
    w = got.dirs.shape[0]
    last = np.uint32((1 << (8 * (d_total - 4 * (w - 1)))) - 1)
    kernel = np.asarray(want.dirs)[:w].copy()
    kernel[-1] &= last
    np.testing.assert_array_equal(got.dirs.numpy(), kernel)


def test_plain_fill_sums_the_capture_lanes():
    """The capture adds M/I/D over every lane of n2mask on diagonal dsum,
    as the lax twin's masked sum does (here two lanes a pair)."""
    _pairs_, batch = _batch(4, n=8, hi1=30, hi2=60)
    tb_ = to_device(batch, "cpu")
    s2v, dsum, n2mask = port.gotoh_layout(tb_.db, tb_.query_len,
                                          tb_.db_len)
    n2mask[:, 0] = 1
    scheme = ScoringScheme()
    L1, L2 = batch.query.shape[1], batch.db.shape[1]
    got, _ = port.gotoh_fill_torch(tb_.query, s2v, dsum, n2mask, L1, L2,
                                   scheme, True, False, False)
    want, _ = jax_nw._gotoh_fill_lax(
        jnp.asarray(tb_.query.numpy()), jnp.asarray(s2v.numpy()),
        jnp.asarray(dsum.numpy()), jnp.asarray(n2mask.numpy()) != 0, L1, L2,
        JaxScheme(), True, False, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def host():
    if csrc.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/host_check.cpp")
    return csrc.host_check()


def _host_fill(host, tb_, s2v, dsum, n2mask, L1, L2, scheme, compat,
               wildcard, with_dirs, cta_lanes=0):
    """hc_gotoh_fill (kernel #7's warp-ring schedule run serially, the
    split planned for 132 SMs or forced), its corners from corner_lanes:
    (finals, dirs), the dirs pre-filled with a pattern it must overwrite."""
    B, P = s2v.shape
    D_total = L1 + L2 + 1
    n1, n2 = port.corner_lanes(dsum, n2mask)
    finals = torch.zeros((B, 3), dtype=torch.int32)
    dirs = torch.full((-(-D_total // 4), B, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    rc = host.hc_gotoh_fill(
        tb_.query.data_ptr(), s2v.data_ptr(), n1.data_ptr(), n2.data_ptr(),
        finals.data_ptr(), dirs.data_ptr(), B, L1, P, D_total,
        scheme.match_, scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        2 if with_dirs else 0, int(compat), int(wildcard), cta_lanes,
        status.data_ptr(), 0, 0, 0,
    )
    assert rc == 0
    return finals, dirs


def _pair_cells(dirs, query_len, db_len):
    """(cells, lane 0) masks over the bytes of a (W, B, P) dirs tensor:
    each pair's cells 0 <= x <= n2, 0 <= y <= n1, and lane 0."""
    W, B, P = dirs.shape
    d = np.arange(W)[:, None, None, None] * 4 + np.arange(4)
    x = np.arange(P)[None, None, :, None]
    n1 = np.asarray(query_len)[None, :, None, None]
    n2 = np.asarray(db_len)[None, :, None, None]
    return (x <= n2) & (d - x >= 0) & (d - x <= n1), x == 0


@pytest.mark.parametrize("cta_lanes", [0, 128])
@pytest.mark.parametrize("with_dirs", [False, True])
@pytest.mark.parametrize("compat,wildcard", [(True, False), (False, True)])
def test_host_cell_loop_matches_plain(host, compat, wildcard, with_dirs,
                                      cta_lanes):
    """Kernel #7's cell loop (stream_cell in global mode in the per-pair
    warp rings, the corner capture at lane n2) through host_check.cpp,
    split as planned or over forced 128-lane CTAs (the cluster geometry):
    finals equal; dirs equal on each pair's cells, lane 0's D bits (the
    plain roll takes them from lane P-1) aside, and 0 on every other
    byte."""
    _pairs_, batch = _batch(11, n=8, hi1=60, hi2=300)
    scheme = SCHEMES[int(wildcard)]
    tb_ = to_device(batch, "cpu")
    s2v, dsum, n2mask = port.gotoh_layout(tb_.db, tb_.query_len,
                                          tb_.db_len)
    L1, L2 = batch.query.shape[1], batch.db.shape[1]
    B, P = s2v.shape
    assert P == 512
    want_f, want_d = port.gotoh_fill_torch(tb_.query, s2v, dsum, n2mask, L1,
                                           L2, scheme, compat, wildcard,
                                           with_dirs)
    shape = port.pair_launch_shape(host, P, B, cta_lanes)
    assert shape["ctas"] == (4 if cta_lanes else 2)
    finals, dirs = _host_fill(host, tb_, s2v, dsum, n2mask, L1, L2, scheme,
                              compat, wildcard, with_dirs, cta_lanes)
    assert torch.equal(finals, want_f)
    if with_dirs:
        g = dirs.numpy().view(np.uint8).reshape(*dirs.shape, 4)
        w = want_d.numpy().view(np.uint8).reshape(*dirs.shape, 4)
        cells, lane0 = _pair_cells(dirs, batch.query_len, batch.db_len)
        keep = np.where(lane0, 0xFF & ~(dirbits.DEXT | dirbits.DOPEN),
                        0xFF).astype(np.uint8)
        np.testing.assert_array_equal((g & keep)[cells], (w & keep)[cells])
        assert not g[~cells].any()


def test_host_walker_on_the_fill_dirs_matches_jax():
    """traceback_pair on the port's dirs gives the JAX walker's co-optimal
    alignments on the JAX dirs (the layout the host walker reads)."""
    pairs, batch = _batch(13, n=8, hi1=40, hi2=50)
    got = port.nw_affine_batch(*to_device(batch, "cpu"), with_dirs=True)
    want = _jax(batch, ScoringScheme(), True, False, True)
    wd = np.asarray(want.dirs)
    for b, (s1, s2) in enumerate(pairs):
        mine = _outcome(tb.traceback_pair, got.dirs[:, b, :].numpy(),
                        got.finals[b], s1, s2)
        ref = _outcome(jax_tb.traceback_pair, wd[:, b, :],
                       np.asarray(want.finals)[b], s1, s2)
        assert mine == ref, b


@pytest.mark.parametrize("compat", [True, False])
def test_host_walker_on_the_kernel_dirs_matches_jax(host, compat):
    """traceback_pair on kernel #7's dirs (the host build's: every byte
    outside each pair's matrix and lane 0's D bits 0) gives the JAX
    walker's co-optimal alignments on the JAX dirs: the walker reads only
    the pairs' cells, and no D bit of lane 0."""
    pairs, batch = _batch(17 + compat, n=12, hi1=45, hi2=150)
    tb_ = to_device(batch, "cpu")
    s2v, dsum, n2mask = port.gotoh_layout(tb_.db, tb_.query_len,
                                          tb_.db_len)
    L1, L2 = batch.query.shape[1], batch.db.shape[1]
    finals, dirs = _host_fill(host, tb_, s2v, dsum, n2mask, L1, L2,
                              ScoringScheme(), compat, False, True,
                              cta_lanes=128)
    cells, _ = _pair_cells(dirs, batch.query_len, batch.db_len)
    g = dirs.numpy().view(np.uint8).reshape(*dirs.shape, 4)
    assert (~cells).any() and not g[~cells].any()
    want = _jax(batch, ScoringScheme(), compat, False, True)
    wd = np.asarray(want.dirs)
    for b, (s1, s2) in enumerate(pairs):
        mine = _outcome(tb.traceback_pair, dirs[:, b, :].numpy(),
                        finals[b].numpy(), s1, s2)
        ref = _outcome(jax_tb.traceback_pair, wd[:, b, :],
                       np.asarray(want.finals)[b], s1, s2)
        assert mine == ref, b


def _outcome(fn, *args):
    """fn's result, or its error as (class name, message): the two
    packages' error classes are distinct."""
    try:
        return fn(*args)
    except Exception as e:
        return ("raised", type(e).__name__, str(e))


def test_wrappers_refuse_cpu_tensors_and_bad_layouts():
    _pairs_, batch = _batch(2, n=8, hi1=20, hi2=20)
    tb_ = to_device(batch, "cpu")
    s2v, dsum, n2mask = port.gotoh_layout(tb_.db, tb_.query_len,
                                          tb_.db_len)
    L1, L2 = batch.query.shape[1], batch.db.shape[1]
    args = (tb_.query, s2v, dsum, n2mask, L1, L2, ScoringScheme(), True,
            False, False)
    with pytest.raises(ValueError, match="CUDA"):
        port.gotoh_fill_cuda(*args)
    with pytest.raises(ValueError, match="dsum"):
        port.gotoh_fill(tb_.query, s2v, dsum[:, 0], n2mask, L1, L2,
                        ScoringScheme(), True, False, False)
    assert port.gotoh_fill_cuda.launches == 0

"""PyTorch port of the linear-gap NW fill vs the JAX package: the plain
fill against _linear_fill_lax (nw_linear_batch) on scores and the whole
path-bit tensor, global (compat and textbook) and local (two passes), and
the scores against the scalar oracle (exact: integers and bits equal);
the walker on the kernel's path bits (csrc/host_check.cpp), whose bytes
outside the pairs' matrices are 0, against the JAX walker."""

import dataclasses

import numpy as np
import pytest
import torch

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import nw_linear as jax_linear
from sequencealigning_tpu.ops import oracle_linear
from sequencealigning_tpu.ops import traceback as jax_tb
from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.errors import AlignmentError
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import nw_linear as port
from sequencealigning_tpu_torch.ops import traceback as tb

ALT = ScoringScheme(match_=2, mismatch=-3, gap_open=-5, gap_extend=-1)


def _pairs(seed, n, lo1, hi1, lo2, hi2, alphabet=b"ACGT"):
    """n pairs of lengths lo..hi; every other db a mutated copy of its
    query cut or padded to its drawn length."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo1, hi1 + 1)))
        n2 = int(rng.integers(lo2, hi2 + 1))
        if i % 2 and len(s1) and n2:
            s2 = np.resize(s1, n2).copy()
            s2[rng.integers(n2)] = rng.choice(alpha)
        else:
            s2 = rng.choice(alpha, n2)
        out.append((s1.tobytes(), s2.tobytes()))
    return out


CASES = {
    "ragged": lambda: _pairs(3, 11, 1, 120, 1, 120, b"ACGTN"),
    "query_longer": lambda: _pairs(5, 8, 150, 250, 20, 90),
    "db_longer": lambda: _pairs(7, 8, 10, 70, 160, 256),
    "empty_sides": lambda: _pairs(13, 5, 1, 60, 1, 60)
    + [(b"", b"ACGTA"), (b"GATTACA", b""), (b"", b"")],
}


def _both(pairs, scheme, compat, local, with_dirs):
    batch = pack_batch(pairs, batch_size=len(pairs))
    return _both_batch(batch, scheme, compat, local, with_dirs)


def _both_batch(batch, scheme, compat, local, with_dirs):
    want = jax_linear.nw_linear_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        scheme=JaxScheme(**dataclasses.asdict(scheme)), compat=compat,
        local=local, with_dirs=with_dirs)
    got = port.nw_linear_batch(*to_device(batch, "cpu"), scheme=scheme,
                               compat=compat, local=local,
                               with_dirs=with_dirs)
    return got, want


def _check_equal(got, want):
    np.testing.assert_array_equal(got.score, np.asarray(want.score))
    assert got.score.dtype == np.int32
    if want.dirs is None:
        assert got.dirs is None
    else:
        assert got.dirs.dtype == torch.uint32
        np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))


@pytest.mark.parametrize("with_dirs", [False, True])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_plain_fill_matches_lax(compat, local, with_dirs):
    """Scores and the whole path-bit tensor equal _linear_fill_lax over
    compat/textbook x global/local x bits on and off."""
    pairs = _pairs(17 + compat + 2 * local, 9, 1, 90, 1, 90)
    got, want = _both(pairs, ScoringScheme(), compat, local, with_dirs)
    _check_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("local", [False, True])
def test_plain_fill_shapes_match_lax(case, local):
    """Query longer and shorter than the db, a ragged batch with N (plain
    equality: N matches only N), pairs with n1 or n2 = 0, another
    scheme."""
    pairs = CASES[case]()
    batch = pack_batch(pairs, batch_size=len(pairs))
    got, want = _both_batch(batch, ALT, True, local, True)
    _check_equal(got, want)
    (B, L1), L2 = batch.query.shape, batch.db.shape[1]
    assert got.dirs.shape == (-(-(L1 + L2 + 1) // 4), B,
                              -(-(L2 + 1) // 128) * 128)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_scores_match_oracle(compat, local):
    jscheme = JaxScheme()
    pairs = _pairs(29, 10, 1, 50, 1, 50)
    batch = pack_batch(pairs, batch_size=len(pairs))
    res = port.nw_linear_batch(*to_device(batch, "cpu"), compat=compat,
                               local=local, with_dirs=False)
    for b, (s1, s2) in enumerate(pairs):
        assert int(res.score[b]) == oracle_linear.linear_score(
            s1, s2, jscheme, local=local, compat=compat), b


def test_fill_wrapper_refuses_cpu_tensors():
    batch = pack_batch(_pairs(2, 8, 5, 20, 5, 20), batch_size=8)
    seq1, s2v, n1v, n2v = port.linear_inputs(*to_device(batch, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        port.linear_fill_cuda(seq1, s2v, n1v, n2v, torch.zeros_like(n1v),
                              seq1.shape[1], batch.db.shape[1],
                              ScoringScheme(), True, False, True)
    assert port.linear_fill_cuda.launches == 0


def test_row_past_the_cuda_width_is_an_alignment_error(monkeypatch):
    """On CUDA a row past CUDA_LINEAR_LANES (16 CTAs of 8192 lanes) is an
    AlignmentError naming its lane count (a named divergence: the JAX
    fill has no lane limit); the CPU fills it.  The limit is lowered here
    so that a small batch reaches it, and the batch's tensors report CUDA
    to the check."""
    monkeypatch.setattr(port, "CUDA_LINEAR_LANES", 128)
    pairs = _pairs(4, 4, 100, 200, 130, 200)
    batch = pack_batch(pairs, batch_size=4)
    tb = to_device(batch, "cpu")
    got = port.nw_linear_batch(*tb, with_dirs=False)
    assert got.score.shape == (4,)
    lanes = -(-(batch.db.shape[1] + 1) // 128) * 128
    assert lanes > 128
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(AlignmentError, match=f"row of {lanes} lanes"):
        port.nw_linear_batch(*tb, with_dirs=False)


@pytest.fixture(scope="module")
def host():
    if csrc.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/host_check.cpp")
    return csrc.host_check()


def _host_bits(host, tb, scheme, compat, local, maxv):
    """The linear kernel's path bits (hc_linear_fill, the warp-ring
    schedule run serially over forced 128-lane CTAs): every byte outside
    each pair's matrix 0."""
    seq1, s2v, n1v, n2v = port.linear_inputs(*tb)
    l1, l2 = tb.query.shape[1], tb.db.shape[1]
    B, P = s2v.shape
    corner = torch.zeros((B,), dtype=torch.int32)
    runmax = torch.full((B,), port.NEGBIG, dtype=torch.int32)
    dirs = torch.full((-(-(l1 + l2 + 1) // 4), B, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    assert host.hc_linear_fill(
        seq1.data_ptr(), s2v.data_ptr(), n1v.data_ptr(), n2v.data_ptr(),
        maxv.data_ptr(), corner.data_ptr(), runmax.data_ptr(),
        dirs.data_ptr(), B, seq1.shape[1], P, l1 + l2 + 1, scheme.match_,
        scheme.mismatch, scheme.gap_open, scheme.gap_extend, 1, int(compat),
        int(local), 128, status.data_ptr(), 0, 0, 0) == 0
    return dirs.numpy()


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_walker_on_the_kernel_bits_matches_jax(host, compat, local):
    """linear_traceback_pair on the linear kernel's path bits (every byte
    outside each pair's matrix 0) gives the JAX walker's hits on the JAX
    bits: the DFS and its ISMAX seeds read only cells 0 <= x <= n2,
    0 <= y <= n1."""
    pairs = _pairs(31 + compat + 2 * local, 10, 1, 60, 1, 150) + [
        (b"", b"ACGTA"), (b"GATTACA", b"")]
    batch = pack_batch(pairs, batch_size=len(pairs))
    want = jax_linear.nw_linear_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        scheme=JaxScheme(), compat=compat, local=local, with_dirs=True)
    maxv = torch.tensor(np.asarray(want.score), dtype=torch.int32)
    dirs = _host_bits(host, to_device(batch, "cpu"), ScoringScheme(), compat,
                      local, maxv)
    wd = np.asarray(want.dirs)
    assert (dirs != wd).any()
    for b, (s1, s2) in enumerate(pairs):
        assert (tb.linear_traceback_pair(dirs[:, b, :], s1, s2, local=local)
                == jax_tb.linear_traceback_pair(wd[:, b, :], s1, s2,
                                                local=local)), b

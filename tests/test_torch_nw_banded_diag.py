"""PyTorch port of the anti-diagonal banded Gotoh fill vs the JAX package:
the plain fill against _banded_diag_lax (nw_banded_diag_batch,
backend="lax") on finals, band plan and the whole dirs tensor (exact:
integer results must be equal, dirs bit for bit)."""

import dataclasses

import numpy as np
import pytest
import torch

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import nw_banded_diag as jax_diag
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import nw_banded_diag as port

WILD = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
# An out-of-regime scheme for the std model (mismatch > 2 * gap_extend in
# penalty terms), where ref and std scores differ (tests/test_std_affine).
STD = ScoringScheme(match_=0, mismatch=-9, gap_open=-2, gap_extend=-3)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test's plain torch ops: the suite runs
    several workers on the machine's cores, and wide per-step ops across
    threads that other workers hold stall at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed, n, lo1, hi1, lo2, hi2, alphabet=b"ACGT", mutants=True):
    """n pairs of lengths lo..hi; with mutants, every other db is a mutated
    copy of its query cut or padded to its drawn length."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo1, hi1 + 1)))
        n2 = int(rng.integers(lo2, hi2 + 1))
        if mutants and i % 2:
            s2 = np.resize(s1, n2).copy()
            for _ in range(max(1, n2 // 12)):
                s2[rng.integers(n2)] = rng.choice(alpha)
        else:
            s2 = rng.choice(alpha, n2)
        out.append((s1.tobytes(), s2.tobytes()))
    return out


# name -> (pairs, band)
CASES = {
    "ragged": (lambda: _pairs(3, 11, 1, 120, 1, 120, b"ACGTN"), 16),
    "query_longer": (lambda: _pairs(5, 8, 150, 250, 20, 90), 64),
    "db_longer": (lambda: _pairs(7, 8, 10, 70, 160, 256), 32),
    "beyond_band": (lambda: _pairs(9, 8, 40, 60, 90, 110), 8),
    "corner_l_plus_128": (lambda: [(a, a[::-1]) for a, _ in
                                   _pairs(11, 8, 30, 60, 1, 1)], 127),
}


def _jax_fill(batch, band, scheme, compat, wildcard, with_dirs, model="ref"):
    return jax_diag.nw_banded_diag_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, band=band,
        scheme=JaxScheme(**dataclasses.asdict(scheme)), compat=compat,
        wildcard=wildcard, with_dirs=with_dirs, backend="lax", model=model,
    )


def _check_equal(got, want):
    np.testing.assert_array_equal(got.finals, np.asarray(want.finals))
    assert (got.k_lo, got.k_lo_even) == (want.k_lo, want.k_lo_even)
    if want.dirs is None:
        assert got.dirs is None
    else:
        assert got.dirs.dtype == torch.uint32
        np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("with_dirs", [False, "fast4", "full"])
def test_plain_fill_matches_lax(with_dirs, compat, wildcard):
    """Finals, band plan and the whole dirs tensor equal _banded_diag_lax
    over dirs none/fast4/full x compat/textbook x wildcard."""
    scheme = WILD if wildcard else ScoringScheme()
    pairs = _pairs(17 + compat + 2 * wildcard, 9, 1, 90, 1, 90, b"ACGTN")
    batch = pack_batch(pairs, batch_size=16)
    want = _jax_fill(batch, 16, scheme, compat, wildcard, with_dirs)
    got = port.nw_banded_diag_batch(
        *to_device(batch, "cpu"), band=16, scheme=scheme, compat=compat,
        wildcard=wildcard, with_dirs=with_dirs,
    )
    _check_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("with_dirs", ["fast4", "full"])
def test_plain_fill_shapes_match_lax(case, with_dirs):
    """Query longer and shorter than the db, a length difference beyond the
    band, a ragged batch with N, and the L += 128 corner of the plan."""
    make, band = CASES[case]
    pairs = make()
    batch = pack_batch(pairs, batch_size=8)
    want = _jax_fill(batch, band, ScoringScheme(), True, True, with_dirs)
    got = port.nw_banded_diag_batch(*to_device(batch, "cpu"), band=band,
                                    wildcard=True, with_dirs=with_dirs)
    _check_equal(got, want)
    plan = port.plan_band(batch.query_len, batch.db_len, band,
                          batch.query.shape[1], batch.db.shape[1])
    assert got.dirs.shape[2] == plan.L
    if case == "corner_l_plus_128":
        assert plan.k_lo % 2 and plan.L == 256


@pytest.mark.parametrize("with_dirs", [False, "fast4"])
@pytest.mark.parametrize("wildcard", [False, True])
def test_plain_fill_std_model_matches_lax(wildcard, with_dirs):
    """model="std" (gap opens from any state, textbook): finals and the
    whole fast4 dirs equal the lax twin; its scores equal the std oracle
    and differ from the reference model's on some pairs."""
    pairs = _pairs(41 + wildcard, 12, 5, 70, 5, 70)
    batch = pack_batch(pairs, batch_size=16)
    want = _jax_fill(batch, 64, STD, False, wildcard, with_dirs, "std")
    got = port.nw_banded_diag_batch(
        *to_device(batch, "cpu"), band=64, scheme=STD, compat=False,
        wildcard=wildcard, with_dirs=with_dirs, model="std",
    )
    _check_equal(got, want)
    jax_std = JaxScheme(**dataclasses.asdict(STD))
    n_div = 0
    for b, (s1, s2) in enumerate(pairs):
        want_std = oracle_gotoh.gotoh_score(s1, s2, jax_std, compat=False,
                                            model="std")
        assert int(got.finals[b].max()) == want_std, b
        n_div += want_std != oracle_gotoh.gotoh_score(s1, s2, jax_std,
                                                      compat=False)
    assert n_div > 0


def test_std_model_refusals_match_jax():
    batch = pack_batch([(b"ACGT", b"ACGT")], batch_size=8)
    tb = to_device(batch, "cpu")
    for kw in (dict(compat=True), dict(compat=False, with_dirs="full"),
               dict(compat=False, model="nope")):
        kw.setdefault("model", "std")
        with pytest.raises(ValueError) as want:
            _jax_fill(batch, 16, STD, kw["compat"], False,
                      kw.get("with_dirs", False), kw["model"])
        with pytest.raises(ValueError) as got:
            port.nw_banded_diag_batch(*tb, band=16, scheme=STD, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="dirs mode"):
        port.nw_banded_diag_batch(*tb, with_dirs="half")


def test_inputs_match_jax_layout():
    """init_windows / entering_streams equal _init_state /
    _entering_streams (the -1 padding included) on a skewed batch."""
    import jax.numpy as jnp

    pairs = _pairs(23, 8, 100, 200, 5, 40)
    batch = pack_batch(pairs, batch_size=8)
    tb = to_device(batch, "cpu")
    plan = port.plan_band(batch.query_len, batch.db_len, 24,
                          batch.query.shape[1], batch.db.shape[1])
    q = jnp.asarray(batch.query, jnp.int32)
    d = jnp.asarray(batch.db, jnp.int32)
    _, s1w0, s2w0, _, _ = jax_diag._init_state(q, d, plan.he, plan.L)
    c1s, c2s = jax_diag._entering_streams(q, d, plan.he, plan.L, plan.n_need)
    for g, w in zip(port.init_windows(tb.query, tb.db, plan.he, plan.L)
                    + port.entering_streams(tb.query, tb.db, plan.he, plan.L,
                                            plan.n_need),
                    (s1w0, s2w0, c1s, c2s)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_finals_match_oracle_at_full_band():
    """With a band covering the whole matrix the banded finals are the
    unbanded Gotoh corner values (scalar oracle)."""
    pairs = _pairs(31, 8, 1, 40, 1, 40)
    batch = pack_batch(pairs, batch_size=8)
    res = port.nw_banded_diag_batch(*to_device(batch, "cpu"), band=64,
                                    compat=False)
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=False)
        assert int(res.finals[b].max()) == max(m[-1, -1], i_[-1, -1],
                                               d[-1, -1]), b


def test_fill_wrapper_refuses_cpu_tensors():
    batch = pack_batch(_pairs(2, 8, 5, 20, 5, 20), batch_size=8)
    plan, ins = port.band_inputs(*to_device(batch, "cpu"), 16)
    with pytest.raises(ValueError, match="CUDA"):
        port.banded_diag_fill_cuda(*ins, plan, ScoringScheme(), True, False,
                                   "fast4")
    assert port.banded_diag_fill_cuda.launches == 0


def test_fill_wrapper_refuses_a_band_past_the_kernel_width(one_thread):
    """A band wider than the former cluster's reach (131072 lanes) is not
    refused for its width: the kernel's tiled route takes every band, so
    the wrapper goes on to the device check; the plain version fills it."""
    batch = pack_batch(_pairs(3, 8, 5, 20, 5, 20), batch_size=8)
    plan, ins = port.band_inputs(*to_device(batch, "cpu"), 131_100)
    assert plan.L > 131_072
    with pytest.raises(ValueError, match="banded_diag_fill_cuda needs CUDA"):
        port.banded_diag_fill_cuda(*ins, plan, ScoringScheme(), True, False,
                                   "fast4")
    assert port.banded_diag_fill_cuda.launches == 0
    fin, dirs = port.banded_diag_fill_torch(*ins, plan, ScoringScheme(),
                                            True, False, "fast4")
    assert fin.shape == (8, 3) and dirs.shape[2] == plan.L


@pytest.mark.parametrize("band", [8200, 130_900])
def test_fill_wrapper_takes_bands_past_one_block(band):
    """Bands of 8193-131072 lanes (past one CTA) are not refused for their
    width: the wrapper goes on to the device check, and the tile rule cuts
    them into strips of at most 512 lanes."""
    batch = pack_batch(_pairs(3, 8, 5, 20, 5, 20), batch_size=8)
    plan, ins = port.band_inputs(*to_device(batch, "cpu"), band)
    assert 8192 < plan.L <= 131_072
    with pytest.raises(ValueError, match="CUDA tensors"):
        port.banded_diag_fill_cuda(*ins, plan, ScoringScheme(), True, False,
                                   "fast4")
    assert port.banded_diag_fill_cuda.launches == 0
    tiles = port.band_tiles(8, plan.L, plan.n_need, 132)
    assert tiles.strips > 1 and tiles.strip_lanes <= 512

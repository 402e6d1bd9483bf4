"""PyTorch port of the banded row sweep (kernel #8's fill) vs the JAX
package: the plain fill against _banded_fill_lax (nw_banded_batch,
backend="lax") on finals, k_lo and the whole dirs tensor, one tiny batch
against the Pallas kernel in interpret mode, and the full bytes against the
port's anti-diagonal banded fill cell for cell (exact: integer results must
be equal, dirs bit for bit)."""

import dataclasses

import numpy as np
import pytest
import torch

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import nw_banded as jax_banded
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import nw_banded as port
from sequencealigning_tpu_torch.ops import nw_banded_diag as diag

WILD = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)


def _pairs(seed, n, lo1, hi1, lo2, hi2, alphabet=b"ACGT", mutants=True):
    """n pairs of lengths lo..hi; with mutants, every other db is a mutated
    copy of its query cut or padded to its drawn length."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo1, hi1 + 1)))
        n2 = int(rng.integers(lo2, hi2 + 1))
        if mutants and i % 2 and len(s1):
            s2 = np.resize(s1, n2).copy()
            for _ in range(max(1, n2 // 12)):
                if n2:
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
    "empty_sides": (lambda: _pairs(13, 6, 1, 60, 1, 60)
                    + [(b"", b"ACGTA"), (b"GATTACA", b""), (b"", b"")], 12),
}


def _jax_fill(batch, band, scheme, compat, wildcard, with_dirs,
              backend="lax"):
    return jax_banded.nw_banded_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, band=band,
        scheme=JaxScheme(**dataclasses.asdict(scheme)), compat=compat,
        wildcard=wildcard, with_dirs=with_dirs, backend=backend,
    )


def _row_codes(dirs, per, rows):
    """(rows, B, K) per-row codes of the first `rows` rows of a packed
    dirs tensor of `per` rows a word."""
    bits = 32 // per
    w = np.asarray(dirs)[:, None]
    shifts = (bits * np.arange(per, dtype=np.uint32))[None, :, None, None]
    codes = (w >> shifts) & ((1 << bits) - 1)
    return codes.reshape(-1, *codes.shape[2:])[:rows]


def _check_equal(got, want, rows=None):
    """Finals, k_lo and the dirs; with rows, only the codes of rows 0 ..
    rows - 1 (the Pallas kernel sweeps rows past the db to whole chunks,
    and its batch to 8)."""
    np.testing.assert_array_equal(got.finals, np.asarray(want.finals))
    assert got.k_lo == want.k_lo
    if want.dirs is None:
        assert got.dirs is None
        return
    assert got.dirs.dtype == torch.uint32
    if rows is None:
        np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))
        return
    B = got.dirs.shape[1]
    np.testing.assert_array_equal(
        _row_codes(got.dirs.numpy(), 4, rows),
        _row_codes(np.asarray(want.dirs)[:, :B], 4, rows))


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("with_dirs", [False, "fast4", "full"])
def test_plain_fill_matches_lax(with_dirs, compat, wildcard):
    """Finals, k_lo and the whole dirs tensor equal _banded_fill_lax over
    dirs none/fast4/full x compat/textbook x wildcard."""
    scheme = WILD if wildcard else ScoringScheme()
    pairs = _pairs(17 + compat + 2 * wildcard, 9, 1, 90, 1, 90, b"ACGTN")
    batch = pack_batch(pairs, batch_size=9)
    want = _jax_fill(batch, 16, scheme, compat, wildcard, with_dirs)
    got = port.nw_banded_batch(
        *to_device(batch, "cpu"), band=16, scheme=scheme, compat=compat,
        wildcard=wildcard, with_dirs=with_dirs,
    )
    _check_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("with_dirs", ["fast4", "full"])
def test_plain_fill_shapes_match_lax(case, with_dirs):
    """Query longer and shorter than the db, a length difference beyond the
    band, a ragged batch with N, and pairs with n1 or n2 = 0."""
    make, band = CASES[case]
    pairs = make()
    batch = pack_batch(pairs, batch_size=len(pairs))
    want = _jax_fill(batch, band, ScoringScheme(), True, True, with_dirs)
    got = port.nw_banded_batch(*to_device(batch, "cpu"), band=band,
                               wildcard=True, with_dirs=with_dirs)
    _check_equal(got, want)
    k_lo, K = port.band_range(batch.query_len, batch.db_len, band)
    per = 8 if with_dirs == "fast4" else 4
    assert got.k_lo == k_lo
    assert got.dirs.shape == (-(-(batch.db.shape[1] + 1) // per),
                              len(pairs), K)


@pytest.mark.parametrize("with_dirs", [False, True])
def test_plain_fill_matches_pallas_interpret(with_dirs):
    """One tiny batch against the Pallas kernel itself (interpret mode):
    finals, and the dirs words of the real rows (the kernel pads its rows
    to whole chunks and its batch to 8)."""
    pairs = _pairs(47, 8, 2, 40, 2, 40)
    batch = pack_batch(pairs, batch_size=8)
    want = _jax_fill(batch, 16, ScoringScheme(), True, False, with_dirs,
                     backend="pallas")
    got = port.nw_banded_batch(*to_device(batch, "cpu"), band=16,
                               with_dirs=with_dirs)
    _check_equal(got, want, rows=batch.db.shape[1] + 1)


def test_row_streams_match_jax_layout():
    """row_streams equals _device_row_streams (lax layout, xp = L2 + 1),
    the -1 padding included, on a skewed batch."""
    import jax.numpy as jnp

    pairs = _pairs(23, 8, 100, 200, 5, 40)
    batch = pack_batch(pairs, batch_size=8)
    tb = to_device(batch, "cpu")
    k_lo, K = port.band_range(batch.query_len, batch.db_len, 24)
    want = jax_banded._device_row_streams(
        jnp.asarray(batch.query), jnp.asarray(batch.db), k_lo, K,
        batch.db.shape[1], batch.db.shape[1] + 1)
    for g, w in zip(port.row_streams(tb.query, tb.db, k_lo, K), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_finals_match_oracle_at_full_band():
    """With a band covering the whole matrix the banded finals are the
    unbanded Gotoh corner values (scalar oracle)."""
    pairs = _pairs(31, 8, 1, 40, 1, 40)
    batch = pack_batch(pairs, batch_size=8)
    res = port.nw_banded_batch(*to_device(batch, "cpu"), band=64,
                               compat=False, with_dirs=False)
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=False)
        assert int(res.finals[b].max()) == max(m[-1, -1], i_[-1, -1],
                                               d[-1, -1]), b


def full_bytes_diff(rdirs, k_lo, gdirs, k_lo_even, n1s, n2s):
    """Cells whose full bytes differ between the row layout (rdirs, (X4, B,
    K)) and the wavefront layout (gdirs, (Aw, B, L)), over every cell
    0 <= x <= n2, 0 <= y <= n1 but the origin in the row band
    [k_lo, k_hi = k_lo + K - 1], on row 0 only the H-argmax bits (the row
    sweep writes no parent bits there, and no walker reads them).  Returns
    {(x, k): (row byte, wavefront byte)} of the differing cells."""
    K = rdirs.shape[2]
    out = {}
    for b in range(len(n1s)):
        x = np.arange(n2s[b] + 1)[:, None]
        y = np.arange(n1s[b] + 1)[None, :]
        x, y = np.broadcast_arrays(x, y)
        k = y - x
        keep = (k >= k_lo) & (k < k_lo + K) & ~((x == 0) & (y == 0))
        x, y, k = x[keep], y[keep], k[keep]
        r = (rdirs[x >> 2, b, k - k_lo] >> (8 * (x & 3))) & 0xFF
        aidx = x + y - 1
        g = (gdirs[aidx >> 2, b, (k - k_lo_even) >> 1]
             >> (8 * (aidx & 3))) & 0xFF
        mask = np.where(x == 0, 7, 0xFF)
        for i in np.flatnonzero((r & mask) != (g & mask)):
            out[(int(x[i]), int(k[i]))] = (int(r[i]), int(g[i]))
    return out


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("band,lo,hi", [(8, 0, 90), (40, 0, 90),
                                        (128, 280, 300)])
def test_full_bytes_equal_the_diag_fill_inside_the_band(compat, band, lo,
                                                        hi):
    """The row sweep's full bytes equal the anti-diagonal fill's cell for
    cell on the band's interior diagonals k_lo < k < k_hi - 1, and the
    finals are equal.  On its edge diagonals the two engines' -inf values
    differ by design, so docs/architecture.md's "cell-for-cell identical"
    holds only inside: the row sweep's I at k_lo is NEGBIG + o + e where
    the wavefront fill's is NEGBIG + e, and the wavefront fill keeps row
    0's gap chain past k_hi, which reaches D at (1, k_hi) and leaves a D
    tie bit at (2, k_hi - 1)."""
    pairs = _pairs(5 + band, 12, lo, hi, lo, hi, b"ACGTN")
    batch = pack_batch(pairs, batch_size=12)
    tb = to_device(batch, "cpu")
    r = port.nw_banded_batch(*tb, band=band, compat=compat, wildcard=True,
                             with_dirs="full")
    g = diag.nw_banded_diag_batch(*tb, band=band, compat=compat,
                                  wildcard=True, with_dirs="full")
    np.testing.assert_array_equal(r.finals, g.finals)
    k_hi = r.k_lo + r.dirs.shape[2] - 1
    diff = full_bytes_diff(r.dirs.numpy(), r.k_lo, g.dirs.numpy(),
                           g.k_lo_even, [len(a) for a, _ in pairs],
                           [len(b) for _, b in pairs])
    assert all(k == r.k_lo or k >= k_hi - 1 for _x, k in diff), diff
    top = [c for c in diff if c[1] >= k_hi - 1]
    if band == 128 and compat:
        # The wavefront fill's compat row-0 chain (in D) past the band:
        # a D tie bit.  The textbook chain lies in I, which D never reads.
        assert set(top) == {(2, k_hi - 1)}
        assert all(diff[c][0] ^ diff[c][1] == 0x20 for c in top)
    elif not compat:
        assert not top


def test_fill_wrapper_refuses_cpu_tensors():
    batch = pack_batch(_pairs(2, 8, 5, 20, 5, 20), batch_size=8)
    k_lo, ins = port.row_inputs(*to_device(batch, "cpu"), 16)
    with pytest.raises(ValueError, match="CUDA"):
        port.banded_row_fill_cuda(*ins, k_lo, ScoringScheme(), True, False,
                                  "fast4")
    with pytest.raises(ValueError, match="dirs mode"):
        port.banded_row_fill(*ins, k_lo, ScoringScheme(), True, False,
                             "half")
    assert port.banded_row_fill_cuda.launches == 0

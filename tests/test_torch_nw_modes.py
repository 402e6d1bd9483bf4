"""PyTorch port of the per-pair semi-global / local Gotoh fill vs the JAX
package: the plain fill against _fill_modes_lax / nw_affine_modes_batch
(lax and Pallas interpret) and brute force (exact: integer results must be
equal, direction words bit for bit)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dataclasses

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import nw_affine_modes as jax_modes
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import nw_affine_modes as port
from tests.test_affine_modes import _pairs, brute_force_mode


def _skewed(seed, n, hi1, hi2, alphabet=b"ACGTN"):
    """n pairs with lengths 1..hi1 / 1..hi2; every third db a mutated
    slice of its query (a local hit)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(1, hi1 + 1)))
        s2 = rng.choice(alpha, int(rng.integers(1, hi2 + 1)))
        if i % 3 == 0 and len(s1) > 6:
            s2 = s1[3: 3 + min(hi2, len(s1) - 3)].copy()
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        out.append((s1.tobytes(), s2.tobytes()))
    return out


SCHEMES = [ScoringScheme(),
           ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)]


def jax_scheme(scheme):
    """The JAX package's ScoringScheme with the port scheme's values."""
    return JaxScheme(**dataclasses.asdict(scheme))


@pytest.mark.parametrize("hi1,hi2", [(220, 25), (20, 230), (60, 60)])
@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_plain_fill_matches_lax(local, wildcard, hi1, hi2):
    """Per-lane argmax buffers and every dirs word equal _fill_modes_lax,
    skewed both ways (n1 >> n2 and n2 >> n1)."""
    scheme = SCHEMES[wildcard]
    pairs = _skewed(7 + local + 2 * wildcard + hi1, 8, hi1, hi2)
    batch = pack_batch(pairs, batch_size=8)
    tb = to_device(batch, "cpu")
    l1, l2 = batch.query.shape[1], batch.db.shape[1]
    s2v = port.modes_layout(tb.db)
    bv_j, bd_j, dirs_j = jax_modes._fill_modes_lax(
        jnp.asarray(batch.query, jnp.int32), jnp.asarray(s2v.numpy()),
        jnp.asarray(batch.query_len)[:, None],
        jnp.asarray(batch.db_len)[:, None],
        l1, l2, jax_scheme(scheme), wildcard, local, True,
    )
    bv, bd, dirs = port.fill_modes_torch(
        tb.query, s2v, tb.query_len, tb.db_len, l1, l2, scheme, wildcard,
        local, True,
    )
    np.testing.assert_array_equal(bv.numpy(), np.asarray(bv_j))
    np.testing.assert_array_equal(bd.numpy(), np.asarray(bd_j))
    assert dirs.dtype == torch.uint32
    assert dirs.shape[0] == -(-(l1 + l2 + 1) // 4)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))


@pytest.mark.parametrize("local", [False, True])
def test_batch_matches_lax_entry(local):
    """The port's batch entry against nw_affine_modes_batch(backend="lax"):
    end cells and dirs; no dirs when none are asked for."""
    pairs = _skewed(29 + local, 13, 90, 70, alphabet=b"ACGT")
    batch = pack_batch(pairs, batch_size=16)
    want = jax_modes.nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, local=local,
        backend="lax",
    )
    tb = to_device(batch, "cpu")
    got = port.nw_affine_modes_batch(*tb, local=local)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))
    for b in range(len(pairs)):
        assert port.modes_end_cell(got, b) == jax_modes.modes_end_cell(want, b)
    bare = port.nw_affine_modes_batch(*tb, local=local, with_dirs=False)
    assert bare.dirs is None
    np.testing.assert_array_equal(bare.best, got.best)


def test_batch_matches_pallas_interpret():
    """The port's fill against the JAX Pallas kernel in interpret mode,
    which sweeps whole 128-diagonal chunks: the codes of the D_total real
    diagonals must be equal."""
    pairs = _skewed(41, 8, 30, 36)
    batch = pack_batch(pairs, batch_size=8)
    want = jax_modes.nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, local=True,
        backend="pallas",
    )
    got = port.nw_affine_modes_batch(*to_device(batch, "cpu"), local=True)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))

    def diag_bytes(words):
        shifts = np.arange(4, dtype=np.uint32)[None, :, None, None] * 8
        b = (words[:, None] >> shifts) & 0xFF
        return b.reshape(-1, *words.shape[1:])[: d_total]

    d_total = batch.query.shape[1] + batch.db.shape[1] + 1
    np.testing.assert_array_equal(diag_bytes(got.dirs.numpy()),
                                  diag_bytes(np.asarray(want.dirs)))


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_scores_match_brute_force(mode):
    pairs = _pairs(89 if mode == "semi" else 97)
    batch = pack_batch(pairs, batch_size=8)
    res = port.nw_affine_modes_batch(*to_device(batch, "cpu"),
                                     local=mode == "local")
    for b, (s1, s2) in enumerate(pairs):
        assert res.best[b] == brute_force_mode(s1, s2, mode), (b, s1, s2)


def test_modes_reduce_ties_match_jax():
    """Ties go to the smallest lane, then that lane's recorded diagonal,
    exactly as the JAX reduction (torch.argmax returns the first maximal
    index)."""
    rng = np.random.default_rng(3)
    bv = rng.integers(-3, 3, (64, 256)).astype(np.int32)
    bv[5] = 7
    bv[9, [4, 200]] = 50
    bd = rng.integers(0, 500, (64, 256)).astype(np.int32)
    got = port.modes_reduce(torch.from_numpy(bv), torch.from_numpy(bd))
    want = jax_modes.modes_reduce(jnp.asarray(bv), jnp.asarray(bd))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][5]) == 0 and int(got[1][9]) == 4

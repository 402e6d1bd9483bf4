"""PyTorch port of the tiled long-pair Gotoh fill vs the JAX package: the
plain batched fill, the folded fill (1-4 pairs) and the single-pair entry
against nw_affine_tiled_batch / _fold_batch / _single with backend="lax" at
the same tile_lanes (exact: integer finals must be equal), mirroring
tests/test_nw_tiled.py; plus the kernel wrappers' refusal of CPU tensors."""

import dataclasses

import numpy as np
import pytest
import torch

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import nw_affine_tiled as jax_tiled
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import nw_affine_tiled as port

WILD = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)


def _seq(rng, n, alphabet=b"ACGT"):
    return rng.choice(np.frombuffer(alphabet, np.uint8), n).tobytes()


def _pairs(seed, lens, alphabet=b"ACGT"):
    """Pairs of the given (n1, n2) lengths; every other db a mutated copy of
    its query cut or padded to n2."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (n1, n2) in enumerate(lens):
        s1 = _seq(rng, n1, alphabet)
        if i % 2 and n1 and n2:
            s2 = bytearray(np.resize(np.frombuffer(s1, np.uint8), n2))
            for _ in range(max(1, n2 // 15)):
                s2[int(rng.integers(n2))] = int(rng.choice(
                    np.frombuffer(alphabet, np.uint8)))
            s2 = bytes(s2)
        else:
            s2 = _seq(rng, n2, alphabet)
        out.append((s1, s2))
    return out


def _random_lens(seed, n, lo=1, hi=256):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(lo, hi + 1)), int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def _jax_scheme(scheme):
    return JaxScheme(**dataclasses.asdict(scheme))


def _oracle(s1, s2, scheme, compat):
    m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, scheme=_jax_scheme(scheme),
                                       compat=compat)
    return (int(m[-1, -1]), int(i_[-1, -1]), int(d[-1, -1]))


@pytest.mark.parametrize("tile_lanes", [128, 256])
@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_plain_tiled_batch_matches_lax(compat, wildcard, tile_lanes):
    """Multi-tile boundary carries (tile_lanes 128/256 at up to 256 bp):
    the plain batched fill equals the lax fill, N pairs included under the
    wildcard scheme."""
    scheme = WILD if wildcard else ScoringScheme()
    pairs = _pairs(31 + compat + 2 * wildcard, _random_lens(7 + tile_lanes, 9),
                   b"ACGTN" if wildcard else b"ACGT")
    batch = pack_batch(pairs, batch_size=9)
    want = jax_tiled.nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        scheme=_jax_scheme(scheme), compat=compat, wildcard=wildcard,
        tile_lanes=tile_lanes, backend="lax",
    )
    got = port.nw_affine_tiled_batch(
        *to_device(batch, "cpu"), scheme=scheme, compat=compat,
        wildcard=wildcard, tile_lanes=tile_lanes,
    )
    assert got.dtype == np.int32 and got.shape == (9, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compat", [True, False])
def test_plain_tiled_degenerate_lengths(compat):
    """A single-character db, an empty db and an empty query inside a
    batch: the closed-form corners and the other rows equal the lax fill
    and the oracle."""
    pairs = _pairs(37, _random_lens(3, 5, hi=150)) + [
        (b"ACGT", b"A"), (b"ACG", b""), (b"", b"ACGTT"), (b"", b"")]
    batch = pack_batch(pairs)
    want = jax_tiled.nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, compat=compat,
        tile_lanes=128, backend="lax",
    )
    got = port.nw_affine_tiled_batch(*to_device(batch, "cpu"), compat=compat,
                                     tile_lanes=128)
    np.testing.assert_array_equal(got, want)
    for b, (s1, s2) in enumerate(pairs):
        assert tuple(int(v) for v in got[b]) == _oracle(
            s1, s2, ScoringScheme(), compat), b


FOLD_CASES = {
    1: [(50, 256)],
    2: [(120, 250), (40, 37)],
    3: [(9, 230), (130, 130), (1, 256)],
    4: [(200, 120), (64, 64), (2, 3), (111, 240)],
}


@pytest.mark.parametrize("tile_lanes", [128, 256])
@pytest.mark.parametrize("B", sorted(FOLD_CASES))
@pytest.mark.parametrize("compat", [True, False])
def test_plain_fold_batch_matches_lax(compat, B, tile_lanes):
    """The folded fill for B = 1..4 pairs (fold = 8 // ceil_pow2(B) rows a
    pair, virtual tiles of fold * W lanes with their row seams and several
    tiles) equals the lax folded fill."""
    pairs = _pairs(23 + B + compat, FOLD_CASES[B])
    batch = pack_batch(pairs)
    want = jax_tiled.nw_affine_tiled_fold_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, compat=compat,
        tile_lanes=tile_lanes, backend="lax",
    )
    got = port.nw_affine_tiled_fold_batch(
        *to_device(batch, "cpu"), compat=compat, tile_lanes=tile_lanes)
    assert got.shape == (B, 3)
    np.testing.assert_array_equal(got, want)


def test_plain_fold_batch_wildcard_matches_lax():
    pairs = _pairs(29, [(180, 210), (150, 256), (30, 40)], b"ACGTN")
    batch = pack_batch(pairs)
    want = jax_tiled.nw_affine_tiled_fold_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        scheme=_jax_scheme(WILD), compat=False, wildcard=True,
        tile_lanes=128, backend="lax",
    )
    got = port.nw_affine_tiled_fold_batch(
        *to_device(batch, "cpu"), scheme=WILD, compat=False, wildcard=True,
        tile_lanes=128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compat", [True, False])
def test_plain_fold_batch_degenerate_lengths(compat):
    """Empty query / empty db rows inside a fold batch take the closed-form
    corners and do not disturb the other rows."""
    pairs = [(b"ACGT" * 10, b""), (b"", b"ACGTT" * 8), (b"ACCA", b"ACCA")]
    batch = pack_batch(pairs)
    want = jax_tiled.nw_affine_tiled_fold_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, compat=compat,
        tile_lanes=128, backend="lax",
    )
    got = port.nw_affine_tiled_fold_batch(*to_device(batch, "cpu"),
                                          compat=compat, tile_lanes=128)
    np.testing.assert_array_equal(got, want)


def test_plain_fold_batch_past_4_pairs_takes_the_batched_fill():
    """Past 4 pairs the port's fold entry refuses, and the batched fill (the
    aligner's route there) equals what the JAX fold entry falls through to."""
    pairs = _pairs(41, _random_lens(5, 6, hi=140))
    batch = pack_batch(pairs)
    want = jax_tiled.nw_affine_tiled_fold_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, backend="lax")
    with pytest.raises(ValueError, match="1-4 pairs"):
        port.nw_affine_tiled_fold_batch(*to_device(batch, "cpu"))
    got = port.nw_affine_tiled_batch(*to_device(batch, "cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compat", [True, False])
def test_plain_single_matches_lax(compat):
    """The single-pair entry (B = 1 of the folded fill, 8 rows of 128
    lanes) at lengths spanning virtual-tile seams, and the empty sides."""
    rng = np.random.default_rng(13)
    for n1, n2 in [(50, 256), (120, 1100), (7, 40), (256, 257), (1, 1),
                   (0, 30), (30, 0)]:
        s1, s2 = _seq(rng, n1), _seq(rng, n2)
        want = jax_tiled.nw_affine_tiled_single(
            s1, s2, compat=compat, tile_lanes=128, backend="lax")
        got = port.nw_affine_tiled_single(s1, s2, compat=compat,
                                          tile_lanes=128, device="cpu")
        assert got.shape == (3,)
        np.testing.assert_array_equal(got, want, err_msg=f"{n1} x {n2}")


def test_plain_tiled_fills_take_any_tiling():
    """The finals are the exact corner values whatever the tiling (the CUDA
    kernels choose their own widths): the batched fill at tile widths of
    128, 256 and one tile, and the folded fill, all equal the oracle."""
    pairs = _pairs(61, [(200, 230), (90, 256), (256, 17)])
    tb = to_device(pack_batch(pairs), "cpu")
    want = np.asarray([_oracle(a, b, ScoringScheme(), True) for a, b in pairs])
    for tile in (128, 256, 4096):
        got = port.tiled_fill_torch(*tb, ScoringScheme(), True, False,
                                    tile_lanes=tile)
        np.testing.assert_array_equal(got.numpy(), want)
    got = port.tiled_fold_fill_torch(*tb, ScoringScheme(), True, False,
                                     tile_lanes=128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_row_sweep_finals_match_lax_and_oracle(compat, wildcard):
    """The row-sweep finals (the kernels' plain check at full width) equal
    the lax tiled fill and the oracle, empty sides and N pairs included."""
    scheme = WILD if wildcard else ScoringScheme()
    pairs = _pairs(71 + compat + 2 * wildcard, _random_lens(17, 9),
                   b"ACGTN" if wildcard else b"ACGT") + [
        (b"ACGT", b"A"), (b"ACG", b""), (b"", b"ACGTT"), (b"", b"")]
    batch = pack_batch(pairs)
    want = jax_tiled.nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        scheme=_jax_scheme(scheme), compat=compat, wildcard=wildcard,
        tile_lanes=128, backend="lax",
    )
    got = port.gotoh_finals_rows_torch(*to_device(batch, "cpu"), scheme,
                                       compat, wildcard)
    assert got.dtype == torch.int32 and got.shape == (len(pairs), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    if not wildcard:
        for b, (s1, s2) in enumerate(pairs):
            assert tuple(int(v) for v in got[b]) == _oracle(
                s1, s2, scheme, compat), b


# A scheme whose boundary gap chains pass NEG_INF within a few hundred bp.
STEEP = ScoringScheme(match_=5, mismatch=-4, gap_open=-8, gap_extend=-100)


def floor_pairs():
    """A 400 bp query against a 30 bp db (the query's chain passes NEG_INF
    at 328 bp), the transpose (the db's chain) and a pair of similar
    lengths."""
    rng = np.random.default_rng(0)
    return [(_seq(rng, 400), _seq(rng, 30)), (_seq(rng, 30), _seq(rng, 400)),
            (_seq(rng, 350), _seq(rng, 300))]


@pytest.mark.parametrize("compat", [True, False])
def test_tiled_fills_floor_the_boundary_h_unlike_jax(compat):
    """Where a boundary gap chain passes NEG_INF, H of the x = 0 column is
    the maximum of its planes, NEG_INF, as in the scalar oracle and every
    other fill: the plain tiled, folded and seqpar shard fills equal the
    oracle, where the JAX tiled fill's raw chain scores below it."""
    from sequencealigning_tpu_torch.parallel.seqpar import seqpar_fill

    pairs = floor_pairs()
    batch = pack_batch(pairs)
    tb = to_device(batch, "cpu")
    want = np.array([_oracle(s1, s2, STEEP, compat) for s1, s2 in pairs])
    for got in (
            port.tiled_fill_torch(*tb, STEEP, compat, False, tile_lanes=128),
            port.tiled_fold_fill_torch(*tb, STEEP, compat, False,
                                       tile_lanes=128),
            seqpar_fill(batch.query, batch.db, batch.query_len, batch.db_len,
                        mesh=["cpu"] * 2, tile_lanes=128, scheme=STEEP,
                        compat=compat)):
        np.testing.assert_array_equal(np.asarray(got), want)
    jax_got = np.asarray(jax_tiled.nw_affine_tiled_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        scheme=_jax_scheme(STEEP), compat=compat, tile_lanes=128,
        backend="lax"))
    assert (jax_got[0] < want[0]).all()
    np.testing.assert_array_equal(jax_got[1:], want[1:])


def test_tiled_wrappers_refuse_cpu_tensors_and_bad_widths():
    tb = to_device(pack_batch(_pairs(3, [(20, 30), (10, 12)])), "cpu")
    for fn in (port.tiled_fill_cuda, port.tiled_fold_fill_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*tb, ScoringScheme(), True, False)
        with pytest.raises(ValueError, match="strip width"):
            fn(*tb, ScoringScheme(), True, False, strip_lanes=100)
    with pytest.raises(ValueError, match="1-4 pairs"):
        port.tiled_fold_fill_cuda(
            *to_device(pack_batch(_pairs(4, [(5, 5)] * 5)), "cpu"),
            ScoringScheme(), True, False)
    too_long = tb.db_len.clone()
    too_long[0] = tb.db.shape[1] + 1
    with pytest.raises(ValueError, match="n2v reaches outside"):
        port.tiled_fill_cuda(*tb[:3], too_long, ScoringScheme(), True, False)
    assert port.tiled_fill_cuda.launches == 0
    assert port.tiled_fold_fill_cuda.launches == 0


def test_entries_route_by_device():
    """CPU tensors take the plain fills; the wrappers are reached only for
    CUDA tensors (a CPU tensor that reports is_cuda reaches them)."""

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    tb = to_device(pack_batch(_pairs(5, [(20, 30), (10, 12)])), "cpu")
    with pytest.raises(ValueError, match="sa_tiled_fill needs CUDA"):
        port.nw_affine_tiled_batch(tb.query.as_subclass(OnCard), *tb[1:])
    with pytest.raises(ValueError, match="sa_tiled_fold_fill needs CUDA"):
        port.nw_affine_tiled_fold_batch(tb.query.as_subclass(OnCard),
                                        *tb[1:])

"""PyTorch port of the device walks (fast4 and textbook modes) vs the JAX
package's walks and the host walkers (exact: op codes, end cells, status
and alignments must be equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequencealigning_tpu.ops import traceback_device as jax_tbd
from sequencealigning_tpu.ops.nw_affine_modes import nw_affine_modes_batch
from sequencealigning_tpu.ops.nw_affine_stream import nw_affine_stream_batch
from sequencealigning_tpu.ops.nw_affine_stream_modes import (
    nw_affine_stream_modes_batch,
)
from sequencealigning_tpu.ops.nw_banded_diag import nw_banded_diag_batch
from sequencealigning_tpu.ops.traceback import (
    banded_diag_fast4_traceback_pair,
    fast4_traceback_pair,
    local_affine_traceback_pair,
    semi_global_traceback_pair,
)
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import traceback_device as port


def _pairs(seed, n=24, lo=2, hi=40):
    """Random pairs, a third of them high-identity mutants (the production
    distribution)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for _ in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        if rng.random() < 0.3:
            s2 = s1.copy()
            for _ in range(max(1, len(s1) // 10)):
                s2[rng.integers(len(s1))] = rng.choice(alpha)
        else:
            s2 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        out.append((s1.tobytes(), s2.tobytes()))
    return out


def _fill(pairs, compat):
    """The JAX lax fill in fast4 mode; dirs as a writable host array."""
    batch = pack_batch(pairs, batch_size=len(pairs))
    res = nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        compat=compat, with_dirs="fast4", backend="lax", np_slots=3,
    )
    return res, np.array(res.dirs)


def _seeds(pairs, finals, plan):
    bs = np.arange(len(pairs))
    return [
        np.asarray([len(b) for _, b in pairs], np.int32),
        np.asarray([len(a) for a, _ in pairs], np.int32),
        jax_tbd.seed_planes(finals[: len(pairs)]),
        (bs // plan.np_slots).astype(np.int32),
        ((bs % plan.np_slots) * plan.s).astype(np.int32),
    ]


@pytest.mark.parametrize("compat,seed", [(True, 7), (False, 23)])
def test_plain_walk_matches_jax_walk(compat, seed):
    pairs = _pairs(seed)
    res, dirs = _fill(pairs, compat)
    seeds = _seeds(pairs, res.finals, res.plan)
    t_steps = int(res.plan.l1 + res.plan.l2)
    (xf_j, yf_j), packed_j, _ = jax_tbd._walk_fast4(
        res.dirs, *(jnp.asarray(s) for s in seeds), t_steps=t_steps
    )
    xf, yf, packed, n_ops = port.walk_fast4_torch(
        torch.from_numpy(dirs), *(torch.from_numpy(s) for s in seeds),
        t_steps=t_steps,
    )
    packed_j = np.asarray(packed_j)
    assert packed.shape[1] == port.packed_width(t_steps) == packed_j.shape[1]
    np.testing.assert_array_equal(packed.numpy(), packed_j)
    np.testing.assert_array_equal(xf.numpy(), np.asarray(xf_j))
    np.testing.assert_array_equal(yf.numpy(), np.asarray(yf_j))
    ops = jax_tbd.decode_packed_ops(packed_j, seeds[1], seeds[0])
    np.testing.assert_array_equal(n_ops.numpy(), [len(o) for o in ops])


@pytest.mark.parametrize("compat", [True, False])
def test_device_align_matches_host_walker(compat):
    pairs = _pairs(41 + compat, n=20, hi=33)
    res, dirs = _fill(pairs, compat)
    alns, scores = port.fast4_stream_align_device(
        torch.from_numpy(dirs), res.finals,
        [a for a, _ in pairs], [b for _, b in pairs], res.plan,
    )
    for b, (s1, s2) in enumerate(pairs):
        row, _slot, off = res.plan.pair_coords(b)
        want_score, want = fast4_traceback_pair(
            dirs[:, row, :], res.finals[b], s1, s2, compat=compat,
            d_offset=off,
        )
        assert int(scores[b]) == want_score
        assert alns[b] == want[0], (b, s1, s2)


def test_seed_planes_and_decoders_match_jax():
    finals = np.array(
        [[5, 5, 5], [1, 5, 5], [1, 2, 5], [9, 1, 1], [-3, -9, -3]], np.int32
    )
    np.testing.assert_array_equal(
        port.seed_planes(finals), jax_tbd.seed_planes(finals)
    )
    pairs = _pairs(91, n=16, hi=37)
    res, dirs = _fill(pairs, True)
    seeds = _seeds(pairs, res.finals, res.plan)
    _, _, packed, _ = port.walk_fast4_torch(
        torch.from_numpy(dirs), *(torch.from_numpy(s) for s in seeds),
        t_steps=int(res.plan.l1 + res.plan.l2),
    )
    packed = packed.numpy()
    s1s = [a for a, _ in pairs]
    s2s = [b for _, b in pairs]
    assert port.decode_packed_ops(packed, seeds[1], seeds[0]) == \
        jax_tbd.decode_packed_ops(packed, seeds[1], seeds[0])
    got = port.decode_packed_alignments(packed, s1s, s2s)
    assert got == jax_tbd.decode_packed_alignments(packed, s1s, s2s)
    assert all(a is not None for a in got)
    # A stream with a code after the stop decodes to None in both.
    bad = packed.copy()
    bad[3, -1] |= np.uint32(1) << 30
    assert port.decode_packed_alignments(bad, s1s, s2s)[3] is None
    assert jax_tbd.decode_packed_alignments(bad, s1s, s2s)[3] is None


def test_decode_rejects_inconsistent_ops():
    packed = np.zeros((1, 1), np.uint32)
    packed[0, 0] = 0b0101  # two M steps for a 1x1 pair
    assert port.decode_packed_ops(packed, np.array([1]), np.array([1])) == [None]


# ---------------------------------------------------------------------------
# Textbook modes walk
# ---------------------------------------------------------------------------


def _modes_fill(pairs, local, streamed):
    """A JAX lax modes fill (per-pair or streamed) and its walk seeds:
    (dirs as a writable host array, end cells, rows, offsets, t_steps,
    scores)."""
    batch = pack_batch(pairs, batch_size=-(-len(pairs) // 8) * 8)
    B = len(pairs)
    if streamed:
        res = nw_affine_stream_modes_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            "local" if local else "semi", backend="lax", np_slots=3,
        )
        bs = np.arange(B)
        rowp = bs // res.plan.np_slots
        off = (bs % res.plan.np_slots) * res.plan.s
        t_steps = int(res.plan.l1 + res.plan.l2)
    else:
        res = nw_affine_modes_batch(
            batch.query, batch.db, batch.query_len, batch.db_len,
            local=local, backend="lax",
        )
        rowp, off = np.arange(B), np.zeros(B)
        t_steps = int(batch.query.shape[1] + batch.db.shape[1])
    seeds = [np.array(a[:B], np.int32)
             for a in (res.best_x, res.best_y, rowp, off)]
    return np.array(res.dirs), seeds, t_steps, res.best[:B]


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_plain_modes_walk_matches_jax_walk(local, streamed):
    """walk_modes_torch against the JAX _walk_modes on both dirs layouts:
    packed ops, stop cells and status, with a corrupted pair (broken) and
    seeds outside the tensor (clipped, then broken)."""
    pairs = _pairs(61 + local + 2 * streamed, n=21, hi=45)
    dirs, seeds, t_steps, _ = _modes_fill(pairs, local, streamed)
    dirs[:, seeds[2][4], :] = 0
    seeds[0][7], seeds[1][8] = 10 ** 5, -2
    (xf_j, yf_j, st_j), packed_j, _ = jax_tbd._walk_modes(
        jnp.asarray(dirs), *(jnp.asarray(s) for s in seeds), local=local,
        t_steps=t_steps,
    )
    xf, yf, st, packed, n_ops = port.walk_modes_torch(
        torch.from_numpy(dirs), *(torch.from_numpy(s) for s in seeds),
        local, t_steps,
    )
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(xf.numpy(), np.asarray(xf_j))
    np.testing.assert_array_equal(yf.numpy(), np.asarray(yf_j))
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    assert st[4] == 2 and st[8] == 2
    counts = ((packed.numpy()[:, :, None] >> (2 * np.arange(16))) & 3) != 0
    np.testing.assert_array_equal(n_ops.numpy(), counts.sum((1, 2)))


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_modes_device_align_matches_host_walkers(local, streamed):
    """modes_walk_device + assemble_modes_alignments against the host
    walkers the JAX package falls back to, and against the JAX decode."""
    pairs = _pairs(83 + local + 2 * streamed, n=20, hi=40)
    dirs, seeds, t_steps, scores = _modes_fill(pairs, local, streamed)
    end_x, end_y, rowp, off = seeds
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    walked = port.modes_walk_device(torch.from_numpy(dirs), end_x, end_y,
                                    rowp, off, s1s, s2s, local, t_steps)
    want_walked = jax_tbd.modes_walk_device(
        jnp.asarray(dirs), end_x, end_y, rowp, off, s1s, s2s, local, t_steps
    )
    assert walked == want_walked
    assert all(w is not None for w in walked)
    got = port.assemble_modes_alignments(pairs, walked, scores, end_x, end_y,
                                         local)
    for b, (s1, s2) in enumerate(pairs):
        dirs_b = dirs[:, rowp[b], :]
        x, y = int(end_x[b]), int(end_y[b])
        if local:
            a1, a2, _, _ = local_affine_traceback_pair(dirs_b, x, y, s1, s2,
                                                       d_offset=int(off[b]))
        else:
            a1, a2 = semi_global_traceback_pair(dirs_b, x, y, s1, s2,
                                                d_offset=int(off[b]))
        assert got[b] == (int(scores[b]), [(a1, a2)]), b


def test_failed_modes_walk_needs_host_or_is_an_error():
    """A pair whose walk is None is re-walked through dirs_fetch where one
    is given (CPU), and is an AlignmentError naming the kernel without one
    (CUDA); empty pairs are answered directly."""
    pairs = _pairs(5, n=6, hi=20) + [(b"", b"ACG"), (b"TT", b"")]
    dirs, seeds, t_steps, scores = _modes_fill(pairs, True, False)
    end_x, end_y, rowp, off = seeds
    walked = port.modes_walk_device(
        torch.from_numpy(dirs), end_x, end_y, rowp, off,
        [a for a, _ in pairs], [b for _, b in pairs], True, t_steps,
    )
    full = port.assemble_modes_alignments(pairs, walked, scores, end_x,
                                          end_y, True)
    walked[2] = None
    fetched = []

    def fetch(b):
        fetched.append(b)
        return dirs[:, rowp[b], :], 0

    assert port.assemble_modes_alignments(
        pairs, walked, scores, end_x, end_y, True, dirs_fetch=fetch) == full
    assert fetched == [2]
    got = port.assemble_modes_alignments(pairs, walked, scores, end_x, end_y,
                                         True)
    assert "walk_modes_cuda" in str(got[2])
    assert got[:2] + got[3:] == full[:2] + full[3:]
    assert full[6:] == [(0, [("", "")]), (0, [("", "")])]
    semi = port.assemble_modes_alignments(pairs[6:], [None, None], [0, 0],
                                          [0, 0], [0, 0], False)
    assert semi == [(0, [("---", "ACG")]), (0, [("TT", "--")])]


# ---------------------------------------------------------------------------
# Banded (wavefront-packed) fast4 walk
# ---------------------------------------------------------------------------

# An out-of-regime scheme, where the std model's walks differ from ref's.
_STD = dict(match_=0, mismatch=-9, gap_open=-2, gap_extend=-3)


def _banded_fill(pairs, band, model="ref", compat=True):
    """The JAX lax banded fill in fast4 mode: (result, dirs as a writable
    host array, finals)."""
    from sequencealigning_tpu.config import ScoringScheme as JaxScheme

    batch = pack_batch(pairs, batch_size=-(-len(pairs) // 8) * 8)
    scheme = JaxScheme(**_STD) if model == "std" else JaxScheme()
    res = nw_banded_diag_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, band=band,
        scheme=scheme, compat=compat and model == "ref", wildcard=True,
        with_dirs="fast4", backend="lax", model=model,
    )
    return res, np.array(res.dirs), np.asarray(res.finals)


def _banded_seeds(pairs, finals):
    B = len(pairs)
    return [
        np.asarray([len(b) for _, b in pairs], np.int32),
        np.asarray([len(a) for a, _ in pairs], np.int32),
        jax_tbd.seed_planes(finals[:B]),
        np.arange(B, dtype=np.int32),
    ]


@pytest.mark.parametrize("model", ["ref", "std"])
def test_plain_banded_walk_matches_host_walker(model):
    """walk_banded_torch + decode against the host walker
    banded_diag_fast4_traceback_pair on every pair, ref and std, and its
    packed op stream against the JAX msub walk's compacted stream."""
    pairs = _pairs(101 + (model == "std"), n=22, hi=60)
    res, dirs, finals = _banded_fill(pairs, 24, model)
    std = model == "std"
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    alns, scores = port.banded_diag_align_device(
        torch.from_numpy(dirs), finals, s1s, s2s, res.k_lo_even, std=std)
    for b, (s1, s2) in enumerate(pairs):
        want_score, want = banded_diag_fast4_traceback_pair(
            dirs[:, b, :], finals[b], s1, s2, res.k_lo_even,
            compat=model == "ref", std=std)
        assert int(scores[b]) == want_score
        assert alns[b] == want[0], b
    seeds = _banded_seeds(pairs, finals)
    t_steps = int((seeds[0] + seeds[1]).max())
    xf, yf, packed, n_ops = port.walk_banded_torch(
        torch.from_numpy(dirs), *(torch.from_numpy(a) for a in seeds),
        res.k_lo_even, t_steps, std=std)
    (xf_j, yf_j), packed_j, _ = jax_tbd._walk_banded_diag_msub(
        res.dirs, *(jnp.asarray(a) for a in seeds), jnp.int32(res.k_lo_even),
        t_steps=t_steps, std=std, substeps=2, unroll=1)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    assert packed.shape[1] == port.banded_packed_width(t_steps)
    assert (xf.numpy() == 0).all() and (yf.numpy() == 0).all()
    np.testing.assert_array_equal(xf.numpy(), np.asarray(xf_j))
    np.testing.assert_array_equal(yf.numpy(), np.asarray(yf_j))
    counts = ((packed.numpy()[:, :, None] >> (2 * np.arange(16))) & 3) != 0
    np.testing.assert_array_equal(n_ops.numpy(), counts.sum((1, 2)))


def test_banded_walk_out_of_band_advances_unlike_jax_msub():
    """Named divergence from the reference (ops/traceback_device.py:234,
    ROADMAP section 3): where a read falls outside the band, the port's walk
    takes code 0 and advances, as the host walker does; the JAX msub walk
    freezes there, burns its step budget and never reaches the origin.  The
    dirs are cut to 12 lanes so the walks of these query-longer pairs start
    outside the band."""
    rng = np.random.default_rng(7)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(8):
        s2 = rng.choice(alpha, int(rng.integers(15, 30)))
        s1 = np.concatenate([s2, rng.choice(alpha, 30)])
        pairs.append((s1.tobytes(), s2.tobytes()))
    res, dirs, finals = _banded_fill(pairs, 8)
    cut = np.ascontiguousarray(dirs[:, :, :12])
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    alns, _ = port.banded_diag_align_device(
        torch.from_numpy(cut), finals, s1s, s2s, res.k_lo_even)
    for b, (s1, s2) in enumerate(pairs):
        _, want = banded_diag_fast4_traceback_pair(
            cut[:, b, :], finals[b], s1, s2, res.k_lo_even)
        assert alns[b] == want[0], b
    jax_alns, _ = jax_tbd.banded_diag_align_device(
        jnp.asarray(cut), finals, s1s, s2s, res.k_lo_even)
    assert all(a is None for a in jax_alns)
    assert all(a is not None for a in alns)

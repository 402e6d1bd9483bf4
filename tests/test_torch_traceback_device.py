"""PyTorch port of the fast4 device walk vs the JAX package's walk and the
host walker (exact: op codes, end cells and alignments must be equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequencealigning_tpu.io.encode import pack_batch
from sequencealigning_tpu.ops import traceback_device as jax_tbd
from sequencealigning_tpu.ops.nw_affine_stream import nw_affine_stream_batch
from sequencealigning_tpu.ops.traceback import fast4_traceback_pair
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

"""PyTorch port of the streamed Gotoh fill vs the JAX package: planning,
stream inputs, and the plain fill against gotoh_fill_stream_lax on the
whole finals and dirs tensors (exact: integer results must be equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import nw_affine_stream as jax_stream
from sequencealigning_tpu.ops import oracle_gotoh
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch, trim_for_stream
from sequencealigning_tpu_torch.ops import nw_affine_stream as port


def _pairs(seed, n, lo=1, hi=40, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    return [
        (
            rng.choice(alpha, int(rng.integers(lo, hi + 1))).tobytes(),
            rng.choice(alpha, int(rng.integers(lo, hi + 1))).tobytes(),
        )
        for _ in range(n)
    ]


def _padded(batch, plan):
    """The batch padded to plan.n_rows * plan.np_slots pairs, as
    nw_affine_stream_batch pads it (length-1 pads)."""
    n = plan.np_slots * plan.n_rows
    B = batch.query.shape[0]
    q = np.zeros((n, batch.query.shape[1]), np.int32)
    d = np.zeros((n, batch.db.shape[1]), np.int32)
    q[:B], d[:B] = batch.query, batch.db
    ql, dl = np.ones(n, np.int32), np.ones(n, np.int32)
    ql[:B], dl[:B] = batch.query_len, batch.db_len
    return q, d, ql, dl


@pytest.mark.parametrize(
    "n_pairs,l1,l2,np_slots,chunk",
    [(24, 127, 126, 3, 128), (16, 250, 40, 2, 64), (9, 33, 200, None, 32),
     (64, 2046, 2046, None, 128)],
)
def test_plan_and_stream_inputs_match_jax(n_pairs, l1, l2, np_slots, chunk):
    want = jax_stream.plan_stream(n_pairs, l1, l2, chunk=chunk, np_slots=np_slots)
    plan = port.plan_stream(n_pairs, l1, l2, chunk=chunk, np_slots=np_slots)
    assert tuple(plan) == tuple(want)
    for kw in ({}, dict(match_=80, mismatch=-4, gap_open=-8, gap_extend=-6)):
        assert port.stream_i16_neg(ScoringScheme(**kw), plan) == \
            jax_stream.stream_i16_neg(JaxScheme(**kw), want)
    rng = np.random.default_rng(n_pairs + l1)
    n = plan.np_slots * plan.n_rows
    q = rng.integers(0, 16, (n, l1)).astype(np.int32)
    d = rng.integers(0, 16, (n, l2)).astype(np.int32)
    ql = rng.integers(0, l1 + 1, n).astype(np.int32)
    dl = rng.integers(0, l2 + 1, n).astype(np.int32)
    exp = jax_stream.build_stream_inputs(q, d, ql, dl, want)
    got = port.build_stream_inputs(
        torch.from_numpy(q), torch.from_numpy(d),
        torch.from_numpy(ql), torch.from_numpy(dl), plan,
    )
    for e, g in zip(exp, got):
        np.testing.assert_array_equal(g.numpy(), e)
    for e, g in zip(jax_stream.capture_params(ql, dl, want),
                    port.capture_params(torch.from_numpy(ql),
                                        torch.from_numpy(dl), plan)):
        np.testing.assert_array_equal(g.numpy(), e)


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("dirs_mode", [None, "fast4", "full"])
@pytest.mark.parametrize("compat", [True, False])
def test_plain_fill_matches_lax(compat, dirs_mode, wildcard):
    pairs = _pairs(11 + 2 * compat, 21, alphabet=b"ACGTN")
    batch = trim_for_stream(pack_batch(pairs, batch_size=24))
    plan = port.plan_stream(24, batch.query.shape[1], batch.db.shape[1],
                            np_slots=3)
    q, d, ql, dl = _padded(batch, plan)
    qs, ds, dsy, n2y, _, _ = jax_stream.build_stream_inputs(q, d, ql, dl, plan)
    NP = plan.np_slots
    (fm, fi, fd), dirs_j = jax_stream.gotoh_fill_stream_lax(
        jnp.asarray(qs), jnp.asarray(ds),
        jnp.asarray(dsy[:NP, :, 0]), jnp.asarray(n2y[:NP, :, 0]),
        jax_stream.StreamPlan(*plan), JaxScheme(), compat, wildcard,
        dirs_mode,
    )
    finals_j = np.stack(
        [np.asarray(a).T.reshape(-1) for a in (fm, fi, fd)], axis=1
    )
    finals, dirs = port.gotoh_fill_stream_torch(
        torch.from_numpy(qs), torch.from_numpy(ds),
        torch.from_numpy(np.ascontiguousarray(dsy[:NP, :, 0])),
        torch.from_numpy(np.ascontiguousarray(n2y[:NP, :, 0])),
        plan, ScoringScheme(), compat, wildcard, dirs_mode,
    )
    np.testing.assert_array_equal(finals.numpy(), finals_j)
    if dirs_mode is None:
        assert dirs is None and dirs_j is None
    else:
        assert dirs.dtype == torch.uint32
        np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))


def test_batch_matches_pallas_interpret():
    """The port's batch entry against the JAX Pallas kernel run in
    interpret mode, fast4, on a batch with an N."""
    pairs = _pairs(43, 16, hi=14, alphabet=b"ACGTN")
    batch = pack_batch(pairs, batch_size=16)
    want = jax_stream.nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        with_dirs="fast4", backend="pallas", np_slots=2,
    )
    tb = to_device(batch, "cpu")
    got = port.nw_affine_stream_batch(
        tb.query, tb.db, tb.query_len, tb.db_len, with_dirs="fast4",
        np_slots=2,
    )
    assert tuple(got.plan) == tuple(want.plan)
    np.testing.assert_array_equal(got.finals, want.finals)
    np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))


@pytest.mark.parametrize("compat", [True, False])
def test_batch_finals_match_oracle(compat):
    pairs = _pairs(3 + compat, 20, lo=1, hi=60)
    batch = trim_for_stream(pack_batch(pairs, batch_size=24))
    tb = to_device(batch, "cpu")
    res = port.nw_affine_stream_batch(
        tb.query, tb.db, tb.query_len, tb.db_len, compat=compat,
        with_dirs=False,
    )
    assert res.dirs is None and res.finals.shape == (24, 3)
    for b, (s1, s2) in enumerate(pairs):
        m, i_, d = oracle_gotoh.gotoh_fill(s1, s2, compat=compat)
        assert tuple(res.finals[b]) == (m[-1, -1], i_[-1, -1], d[-1, -1]), b


def test_int16_state_not_ported():
    """int16 state is ported: the batch entry with "i16" and "auto" equals
    the JAX package's int16 lax fill (finals and fast4 dirs), and "auto"
    resolves to int16 where the JAX package's does off the TPU."""
    pairs = _pairs(5, 8)
    batch = pack_batch(pairs)
    tb = to_device(batch, "cpu")
    want = jax_stream.nw_affine_stream_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        with_dirs="fast4", backend="lax", state_dtype=jnp.int16,
    )
    for st in ("i16", "auto"):
        got = port.nw_affine_stream_batch(
            tb.query, tb.db, tb.query_len, tb.db_len, with_dirs="fast4",
            state_dtype=st,
        )
        np.testing.assert_array_equal(got.finals, want.finals)
        np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))
    assert port.resolve_stream_state("auto", ScoringScheme(), got.plan) == \
        torch.int16


@pytest.mark.parametrize("dirs_mode", [None, "fast4", "full"])
def test_plain_fill_with_query_longer_than_lanes(dirs_mode):
    """A trimmed batch whose query outgrows its db (S > P): the moving
    boundary lane p passes the lane width, where it takes neither db code
    nor boundary, as in gotoh_fill_stream_lax (the plain fill used to index
    past P here)."""
    rng = np.random.default_rng(8)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = [(rng.choice(alpha, int(rng.integers(150, 230))).tobytes(),
              rng.choice(alpha, int(rng.integers(5, 40))).tobytes())
             for _ in range(12)]
    batch = trim_for_stream(pack_batch(pairs, batch_size=16))
    plan = port.plan_stream(16, batch.query.shape[1], batch.db.shape[1],
                            np_slots=2)
    assert plan.s > plan.p
    q, d, ql, dl = _padded(batch, plan)
    qs, ds, dsy, n2y, _, _ = jax_stream.build_stream_inputs(q, d, ql, dl, plan)
    NP = plan.np_slots
    (fm, fi, fd), dirs_j = jax_stream.gotoh_fill_stream_lax(
        jnp.asarray(qs), jnp.asarray(ds),
        jnp.asarray(dsy[:NP, :, 0]), jnp.asarray(n2y[:NP, :, 0]),
        jax_stream.StreamPlan(*plan), JaxScheme(), False, False,
        dirs_mode,
    )
    finals, dirs = port.gotoh_fill_stream_torch(
        torch.from_numpy(qs), torch.from_numpy(ds),
        torch.from_numpy(np.ascontiguousarray(dsy[:NP, :, 0])),
        torch.from_numpy(np.ascontiguousarray(n2y[:NP, :, 0])),
        plan, ScoringScheme(), False, False, dirs_mode,
    )
    finals_j = np.stack(
        [np.asarray(a).T.reshape(-1) for a in (fm, fi, fd)], axis=1
    )
    np.testing.assert_array_equal(finals.numpy(), finals_j)
    if dirs_mode:
        np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))

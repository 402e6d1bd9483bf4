"""PyTorch port of the streamed semi-global / local Gotoh fill vs the JAX
package: the plain fill against gotoh_fill_stream_modes_lax and
nw_affine_stream_modes_batch (lax and Pallas interpret), with two or more
slots a row (exact: integer results must be equal, dirs bit for bit)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequencealigning_tpu.ops import nw_affine_stream as jax_stream
from sequencealigning_tpu.ops import nw_affine_stream_modes as jax_smodes
from sequencealigning_tpu.ops.nw_affine_modes import nw_affine_modes_batch
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import nw_affine_stream as stream
from sequencealigning_tpu_torch.ops import nw_affine_stream_modes as port
from tests.test_affine_modes import brute_force_mode
from tests.test_torch_nw_modes import SCHEMES, _skewed, jax_scheme


@pytest.mark.parametrize("np_slots,hi1,hi2", [(3, 60, 60), (2, 210, 30),
                                              (4, 25, 200)])
@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("mode", ["semi", "local"])
def test_plain_fill_matches_lax(mode, wildcard, np_slots, hi1, hi2):
    """Per-slot, per-lane argmax buffers and every dirs word equal
    gotoh_fill_stream_modes_lax, 2-4 slots a row, skewed both ways (a
    query longer than the lane width puts the moving boundary past P)."""
    scheme = SCHEMES[wildcard]
    pairs = _skewed(13 + np_slots + 2 * wildcard, 14, hi1, hi2)
    batch = pack_batch(pairs, batch_size=16)
    tb = to_device(batch, "cpu")
    plan, ins = stream.stream_inputs(*tb, np_slots=np_slots)
    assert plan.n_slots_g >= 2
    (bv_j, bd_j), dirs_j = jax_smodes.gotoh_fill_stream_modes_lax(
        *(jnp.asarray(t.numpy()) for t in ins),
        jax_stream.StreamPlan(*plan), jax_scheme(scheme), wildcard, mode, True,
    )
    (bv, bd), dirs = port.gotoh_fill_stream_modes_torch(
        *ins, plan, scheme, wildcard, mode, True
    )
    np.testing.assert_array_equal(bv.numpy(), np.asarray(bv_j))
    np.testing.assert_array_equal(bd.numpy(), np.asarray(bd_j))
    assert dirs.dtype == torch.uint32
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_batch_matches_lax_entry(mode):
    """The port's batch entry against nw_affine_stream_modes_batch(
    backend="lax"): plan, end cells and dirs."""
    pairs = _skewed(31, 40, 80, 80, alphabet=b"ACGT")
    batch = pack_batch(pairs, batch_size=40)
    want = jax_smodes.nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, mode,
        backend="lax",
    )
    got = port.nw_affine_stream_modes_batch(*to_device(batch, "cpu"), mode)
    assert tuple(got.plan) == tuple(want.plan)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))
    for b in range(len(pairs)):
        assert port.stream_modes_best(got, b) == \
            jax_smodes.stream_modes_best(want, b)


def test_batch_matches_pallas_interpret():
    pairs = _skewed(43, 16, 12, 14)
    batch = pack_batch(pairs, batch_size=16)
    want = jax_smodes.nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, "local",
        backend="pallas", np_slots=2,
    )
    got = port.nw_affine_stream_modes_batch(*to_device(batch, "cpu"),
                                            "local", np_slots=2)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_stream_matches_per_pair_engine_and_brute_force(mode):
    pairs = _skewed(211, 16, 12, 12, alphabet=b"ACGT")
    batch = pack_batch(pairs, batch_size=16)
    res = port.nw_affine_stream_modes_batch(*to_device(batch, "cpu"), mode,
                                            np_slots=2)
    plain = nw_affine_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        local=mode == "local", backend="lax",
    )
    for b, (s1, s2) in enumerate(pairs):
        assert port.stream_modes_best(res, b) == (
            int(plain.best[b]), int(plain.best_x[b]), int(plain.best_y[b]))
        assert res.best[b] == brute_force_mode(s1, s2, mode)


def test_int16_state_and_bad_mode_raise():
    """int16 state is ported (the batch entry equals the JAX package's
    int16 lax route); a mode other than semi or local still raises."""
    batch = pack_batch(_skewed(5, 8, 10, 10))
    tb = to_device(batch, "cpu")
    want = jax_smodes.nw_affine_stream_modes_batch(
        batch.query, batch.db, batch.query_len, batch.db_len, "local",
        backend="lax", state_dtype="i16",
    )
    got = port.nw_affine_stream_modes_batch(*tb, "local", state_dtype="i16")
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))
    with pytest.raises(ValueError, match="mode"):
        port.nw_affine_stream_modes_batch(*tb, "global")

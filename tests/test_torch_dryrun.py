"""The port's multi-device dry run (sequencealigning_tpu_torch.dryrun) on
1, 2 and 4 CPU shards against the JAX package's runner and seqpar on as
many of its 8 virtual CPU devices (tests/conftest.py), for the pairs that
__graft_entry__.dryrun_multichip draws (exact: integers)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sequencealigning_tpu.io.encode import pack_batch as jax_pack
from sequencealigning_tpu.parallel import runner as jax_runner_mod
from sequencealigning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sequencealigning_tpu.parallel.runner import (
    DataParallelRunner as JaxRunner,
)
from sequencealigning_tpu.parallel.seqpar import seqpar_fill as jax_seqpar
from sequencealigning_tpu_torch import dryrun
from sequencealigning_tpu_torch.io.encode import pack_batch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_matches_jax(n):
    """Every check of the dry run holds on ["cpu"] * n; its runner finals
    and its seqpar finals equal the JAX runner's scores and seqpar_fill on
    n devices."""
    out = dryrun.dryrun_multichip(n, devices=["cpu"] * n)
    assert out["devices"] == ["cpu"] * n
    pairs, long_pair = dryrun.dryrun_pairs(n)
    mesh = jax_make_mesh((n,), ("data",), devices=jax.devices()[:n])
    want = np.asarray(JaxRunner(mesh=mesh, backend="lax").scores(
        jax_pack(pairs, batch_size=8 * n)))
    np.testing.assert_array_equal(out["finals"], want)
    sp = jax_pack([long_pair], batch_size=8)
    want = np.asarray(jax_seqpar(sp.query, sp.db, sp.query_len, sp.db_len,
                                 mesh=mesh, tile_lanes=128))
    np.testing.assert_array_equal(out["seqpar"], want[:1])
    assert len(out["alignments"]) == 8 * n


class _Drawn(Exception):
    pass


def test_pairs_are_the_jax_dryrun_pairs(monkeypatch):
    """dryrun_pairs gives the batch __graft_entry__.dryrun_multichip hands
    its runner first (the JAX run stopped there)."""
    class Stop:
        def __init__(self, *a, **k):
            pass

        def scores(self, batch):
            raise _Drawn(batch)

    monkeypatch.setattr(jax_runner_mod, "DataParallelRunner", Stop)
    with pytest.raises(_Drawn) as got:
        graft.dryrun_multichip(2)
    want = pack_batch(dryrun.dryrun_pairs(2)[0], batch_size=16)
    batch = got.value.args[0]
    for k in ("query", "db", "query_len", "db_len"):
        np.testing.assert_array_equal(getattr(batch, k), getattr(want, k))


def test_dryrun_without_devices_needs_a_gpu():
    """With no devices named the dry run takes make_mesh(), which raises on
    a machine with no GPU; naming fewer devices than asked raises too."""
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(1)
    with pytest.raises(ValueError):
        dryrun.dryrun_multichip(2, devices=["cpu"])

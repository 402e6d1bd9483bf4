"""The port's soak (sequencealigning_tpu_torch.soak) on the CPU: every leg
checks and finds nothing at two seeds; a round draws what
benchmarks/soak.py draws; one round's values of each ported leg equal the
JAX functions' on the same inputs (integers and strings, exactly); a
planted fault is reported by its leg and makes the command exit 1; and
the command refuses to run without a GPU unless asked for the CPU."""

import dataclasses
import json
import multiprocessing
import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequencealigning_tpu import config as jcfg
from sequencealigning_tpu.io.encode import pack_batch as jax_pack
from sequencealigning_tpu.ops import mm_align as jax_mm
from sequencealigning_tpu.ops.nw_affine_modes import (
    modes_end_cell as jax_end_cell,
    nw_affine_modes_batch as jax_modes,
)
from sequencealigning_tpu.ops.nw_affine_stream import (
    nw_affine_stream_batch as jax_stream,
)
from sequencealigning_tpu.ops.nw_affine_stream_modes import (
    nw_affine_stream_modes_batch as jax_stream_modes,
    stream_modes_best as jax_modes_best,
)
from sequencealigning_tpu.ops.nw_affine_tiled import (
    nw_affine_tiled_batch as jax_tiled,
    nw_affine_tiled_fold_batch as jax_fold,
)
from sequencealigning_tpu.ops.nw_banded import nw_banded_batch as jax_banded
from sequencealigning_tpu.ops.nw_banded_diag import (
    nw_banded_diag_batch as jax_diag,
)
from sequencealigning_tpu.ops.wfa import (
    wfa_textbook_batch as jax_wfa,
    wfa_traceback_device as jax_wfa_tb,
)
from sequencealigning_tpu_torch import soak
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import mm_align as port_mm
from sequencealigning_tpu_torch.ops.nw_affine_modes import (
    modes_end_cell,
    nw_affine_modes_batch,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream import (
    nw_affine_stream_batch,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream_modes import (
    nw_affine_stream_modes_batch,
    stream_modes_best,
)
from sequencealigning_tpu_torch.ops.nw_affine_tiled import (
    nw_affine_tiled_batch,
    nw_affine_tiled_fold_batch,
)
from sequencealigning_tpu_torch.ops.nw_banded import nw_banded_batch
from sequencealigning_tpu_torch.ops.nw_banded_diag import nw_banded_diag_batch
from sequencealigning_tpu_torch.ops.wfa import (
    wfa_textbook_batch,
    wfa_traceback_device,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 40


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the plain versions' small torch ops: the
    suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,long_len", [(1, 0), (2, 120)])
def test_soak_on_cpu_checks_every_leg(seed, long_len):
    """Two rounds at 40 bp find no mismatch, every leg checks (the cross
    leg with long_len), and no kernel is launched on the CPU."""
    rep = soak.run_soak(2, seed, max_len=MAX_LEN, device="cpu",
                        long_len=long_len)
    assert rep.ok, [m.line() for m in rep.mismatches]
    legs = [g for g in soak.LEGS if long_len or g != "cross"]
    assert all(rep.checks.get(g, 0) > 0 for g in legs), rep.checks
    assert set(rep.checks) == set(legs)
    assert set(rep.launches) == set(soak.COUNTERS)
    assert not any(rep.launches.values())
    assert rep.pairs >= 2 * 32


def test_draws_are_the_jax_soak_draws():
    """draw_round consumes random.Random(seed) exactly as
    benchmarks/soak.py's round loop does (compat, scheme, pairs, nb,
    penalties, the out-of-regime mismatch), round after round."""
    rng, ref = random.Random(7), random.Random(7)
    for rnd in range(4):
        got = soak.draw_round(rng, rnd, 30)
        compat = ref.random() < 0.5
        sch = ScoringScheme() if rnd % 2 == 0 else ScoringScheme(
            match_=ref.randint(1, 9), mismatch=-ref.randint(1, 12),
            gap_open=-ref.randint(0, 14), gap_extend=-ref.randint(1, 8))
        pairs = []
        for _ in range(16):
            n1 = ref.randint(1, 30)
            n2 = ref.randint(1, 30)
            pairs.append((bytes(ref.choice(b"ACGT") for _ in range(n1)),
                          bytes(ref.choice(b"ACGT") for _ in range(n2))))
        nb = ref.choice([4, 24])
        ev = ref.randint(1, 6)
        mis = ref.randint(1, 2 * ev)
        go = ref.randint(0, 6)
        mis_oor = 2 * ev + ref.randint(1, 4)
        assert (got.compat, got.scheme, got.pairs, got.nb) == (
            compat, sch, pairs, nb)
        assert (got.pen.mismatch, got.pen.gap_open, got.pen.gap_extend) == (
            mis, go, ev)
        assert (got.pen_oor.mismatch, got.pen_oor.gap_open,
                got.pen_oor.gap_extend) == (mis_oor, go, ev)


def _jax(obj, cls):
    return cls(**dataclasses.asdict(obj))


def test_round_values_equal_jax():
    """One round's pairs through each ported leg's call, as the soak makes
    it, and through the JAX function: stream finals, int16 finals, the
    modes' best cells (streamed and per pair), banded and diag finals (the
    wide band and the narrow one), tiled and fold finals, the WFA fill's
    scores and converged flags and its device walk's alignments.  Round 1
    of seed 3: a drawn scheme, local modes."""
    rnd, rng = 1, random.Random(3)
    for k in range(rnd + 1):
        r = soak.draw_round(rng, k, MAX_LEN)
    sch, jsch = r.scheme, _jax(r.scheme, jcfg.ScoringScheme)
    compat = r.compat
    batch = pack_batch(r.pairs, batch_size=16)
    jb = jax_pack(r.pairs, batch_size=16)
    tb = to_device(batch, "cpu")
    ja = (jb.query, jb.db, jb.query_len, jb.db_len)

    got = nw_affine_stream_batch(*tb, scheme=sch, compat=compat,
                                 with_dirs="fast4", np_slots=2).finals
    want = jax_stream(*ja, scheme=jsch, compat=compat, with_dirs="fast4",
                      np_slots=2).finals
    np.testing.assert_array_equal(got, np.asarray(want))
    got = nw_affine_stream_batch(*tb, scheme=sch, compat=compat,
                                 with_dirs=False, np_slots=1,
                                 state_dtype="i16").finals
    want = jax_stream(*ja, scheme=jsch, compat=compat, with_dirs=False,
                      np_slots=1, state_dtype=jnp.int16).finals
    np.testing.assert_array_equal(got, np.asarray(want))

    mode = "semi" if rnd % 2 == 0 else "local"
    for state, jstate in (("i32", jnp.int32), ("i16", jnp.int16)):
        sres = nw_affine_stream_modes_batch(*tb, mode, scheme=sch,
                                            np_slots=2, with_dirs=False,
                                            state_dtype=state)
        jres = jax_stream_modes(*ja, mode, scheme=jsch, np_slots=2,
                                with_dirs=False, state_dtype=jstate)
        assert [stream_modes_best(sres, b) for b in range(16)] == [
            jax_modes_best(jres, b) for b in range(16)]
    plain = nw_affine_modes_batch(*tb, local=mode == "local", scheme=sch,
                                  with_dirs=False)
    jplain = jax_modes(*ja, local=mode == "local", scheme=jsch,
                       with_dirs=False)
    assert [modes_end_cell(plain, b) for b in range(16)] == [
        jax_end_cell(jplain, b) for b in range(16)]

    for band, dm in ((MAX_LEN, "full"), (MAX_LEN, "fast4"), (r.nb, False)):
        got = nw_banded_batch(*tb, band=band, scheme=sch, compat=compat,
                              with_dirs=dm).finals
        want = jax_banded(*ja, band=band, scheme=jsch, compat=compat,
                          with_dirs=dm).finals
        np.testing.assert_array_equal(got, np.asarray(want))
    for band, dm in ((r.nb, "fast4"), (MAX_LEN, False)):
        got = nw_banded_diag_batch(*tb, band=band, scheme=sch, compat=compat,
                                   with_dirs=dm).finals
        want = jax_diag(*ja, band=band, scheme=jsch, compat=compat,
                        with_dirs=dm).finals
        np.testing.assert_array_equal(got, np.asarray(want))

    got = nw_affine_tiled_batch(*tb, scheme=sch, compat=compat,
                                tile_lanes=128)
    want = jax_tiled(*ja, scheme=jsch, compat=compat, tile_lanes=128)
    np.testing.assert_array_equal(got, np.asarray(want))
    nf = 1 + rnd % 4
    got = nw_affine_tiled_fold_batch(*(t[:nf] for t in tb), scheme=sch,
                                     compat=compat, tile_lanes=128)
    want = jax_fold(*(a[:nf] for a in ja), scheme=jsch, compat=compat,
                    tile_lanes=128)
    np.testing.assert_array_equal(got, np.asarray(want))

    jpen = _jax(r.pen, jcfg.WfaPenalties)
    wres = wfa_textbook_batch(*tb, penalties=r.pen, band=MAX_LEN)
    jwres = jax_wfa(*ja, penalties=jpen, band=MAX_LEN)
    np.testing.assert_array_equal(wres.score, np.asarray(jwres.score))
    np.testing.assert_array_equal(wres.converged,
                                  np.asarray(jwres.converged))
    s1s = [a for a, _ in r.pairs]
    s2s = [b for _, b in r.pairs]
    assert wfa_traceback_device(wres, s1s, s2s, r.pen) == jax_wfa_tb(
        jwres, s1s, s2s, jpen)


def test_mm_leaf_cells_equals_the_lowered_cutoff(monkeypatch):
    """mm_align's leaf_cells (the soak's MM_LEAF_CELLS) gives the JAX
    mm_align's ops with its _DIRECT_CELLS lowered to the same size."""
    rng = random.Random(5)
    s1 = bytes(rng.choice(b"ACGT") for _ in range(70))
    s2 = bytes(rng.choice(b"ACGT") for _ in range(55))
    sch = ScoringScheme(match_=3, mismatch=-7, gap_open=-5, gap_extend=-2)
    monkeypatch.setattr(jax_mm, "_DIRECT_CELLS", soak.MM_LEAF_CELLS)
    assert port_mm.mm_align(s1, s2, sch, device="cpu",
                            leaf_cells=soak.MM_LEAF_CELLS) == jax_mm.mm_align(
        s1, s2, _jax(sch, jcfg.ScoringScheme))


def _run_main(capsys, *argv):
    rc = soak.main(["--device", "cpu", "--rounds", "1", "--max-len", "12",
                    *argv])
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


def test_planted_wrong_final_is_reported(monkeypatch, capsys):
    """A tiled fill that returns a wrong final (as the soak module calls
    it): the summary names the tiled leg for every pair, stderr has its
    MISMATCH lines, and the command exits 1."""
    real = soak.nw_affine_tiled_batch
    monkeypatch.setattr(soak, "nw_affine_tiled_batch",
                        lambda *a, **k: real(*a, **k) + 1)
    rc, summary, err = _run_main(capsys)
    assert rc == 1 and not summary["ok"]
    assert summary["mismatches_by_leg"] == {"tiled": 16}
    assert "[soak] MISMATCH tiled round=0 pair=0: got=" in err


def test_planted_raise_is_reported(monkeypatch, capsys):
    """A leg whose call raises is that leg's mismatch (pair -1), not a
    skip, and the other legs still run."""
    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(soak, "wfa_textbook_batch", boom)
    rc, summary, err = _run_main(capsys)
    assert rc == 1
    assert summary["mismatches_by_leg"] == {"wfa": 1}
    assert "[soak] MISMATCH wfa round=0 pair=-1: got=RuntimeError('planted')" \
        in err
    assert summary["checks"]["wfa-auto"] > 0 and summary["checks"]["mm"] > 0


def test_oracle_pool_checks_every_leg(monkeypatch):
    """The oracles in two worker processes (forced at 12 bp): every leg
    checks, no mismatch, and the pool is shut down."""
    monkeypatch.setattr(soak, "POOL_MIN_LEN", 0)
    monkeypatch.setattr(soak, "POOL_WORKERS", 2)
    rep = soak.run_soak(1, 4, max_len=12, device="cpu")
    assert rep.ok, [m.line() for m in rep.mismatches]
    assert set(rep.checks) == set(soak.LEGS) - {"cross"}
    assert not multiprocessing.active_children()


def test_soak_command_needs_a_gpu_unless_told_cpu():
    """Without --device cpu the command fails on a machine with no GPU,
    naming CUDA, and prints no summary."""
    p = subprocess.run(
        [sys.executable, "-m", "sequencealigning_tpu_torch.soak",
         "--rounds", "1", "--max-len", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "cuda" in p.stderr.lower()
    assert p.stdout.strip() == ""

"""PyTorch port of the Myers-Miller alignment vs the JAX package's
ops/mm_align.py on the same pairs and schemes (exact: the ops strings must
be equal), mirroring tests/test_mm_align.py: random pairs and schemes,
structured gaps, forced recursion through the level driver with
_DIRECT_CELLS lowered on both modules, and the torch score rows against the
JAX rows and the direct path."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import sequencealigning_tpu.ops.mm_align as jax_mm
from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import oracle_gotoh
import sequencealigning_tpu_torch.ops.mm_align as port
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.ops.traceback import _apply_ops


def _jax(scheme):
    return JaxScheme(**dataclasses.asdict(scheme))


def _check(s1, s2, scheme):
    """The port's ops equal the JAX package's, rescore to the textbook
    oracle and consume both sequences."""
    got = port.mm_align(s1, s2, scheme, device="cpu")
    assert got == jax_mm.mm_align(s1, s2, _jax(scheme)), (s1, s2, scheme)
    assert port.mm_score_ops(got, s1, s2, scheme) == oracle_gotoh.gotoh_score(
        s1, s2, scheme=_jax(scheme), compat=False)
    a1, a2 = _apply_ops(got, s1, s2)
    assert a1.replace("-", "").encode() == s1
    assert a2.replace("-", "").encode() == s2
    return got


@pytest.mark.parametrize("seed", [3, 5, 11])
def test_mm_matches_jax_random(seed):
    """Random pairs of 1-45 bp under the default scheme and random schemes
    where the standard affine model equals the reference's (mismatch >=
    2*(open+ext) and >= 2*ext in penalty terms)."""
    rng = random.Random(seed)
    for trial in range(12):
        s1 = bytes(rng.choice(b"ACGT") for _ in range(rng.randint(1, 45)))
        s2 = bytes(rng.choice(b"ACGT") for _ in range(rng.randint(1, 45)))
        ov = -rng.randint(0, 12)
        ev = -rng.randint(1, 7)
        bound = max(1, min(-2 * (ov + ev), -2 * ev))
        sch = ScoringScheme() if trial % 2 == 0 else ScoringScheme(
            match_=rng.randint(1, 8), mismatch=-rng.randint(1, bound),
            gap_open=ov, gap_extend=ev,
        )
        _check(s1, s2, sch)


def test_mm_structured_gaps_match_jax():
    """Large indels (the band-escape shape class) and the empty sides."""
    for s1, s2 in [
        (b"G" * 60 + b"A" * 40, b"A" * 40),
        (b"A" * 40, b"G" * 60 + b"A" * 40),
        (b"ACGT" * 30, b"ACGT" * 10 + b"TTTT" * 5 + b"ACGT" * 20),
        (b"A", b"C" * 30),
        (b"C" * 30, b"A"),
    ]:
        _check(s1, s2, ScoringScheme())
    assert port.mm_align(b"", b"ACG", device="cpu") == "DDD"
    assert port.mm_align(b"AC", b"", device="cpu") == "II"


@pytest.mark.parametrize("cutoff", [32, 400])
def test_mm_forced_recursion_matches_jax(monkeypatch, cutoff):
    """_DIRECT_CELLS lowered on both modules: the level driver's torch
    rows (several nodes a level), joins and subsidized leaves give the JAX
    package's ops."""
    monkeypatch.setattr(jax_mm, "_DIRECT_CELLS", cutoff)
    monkeypatch.setattr(port, "_DIRECT_CELLS", cutoff)
    rng = np.random.default_rng(9 + cutoff)
    conv = np.frombuffer(b"ACGT", np.uint8)
    for n, cut in ((240, (60, 120)), (180, (0, 0)), (90, (10, 15))):
        a = rng.integers(0, 4, n)
        b = np.concatenate([a[: cut[0]], a[cut[1]:]])
        idx = rng.random(len(b)) < 0.05
        b[idx] = rng.integers(0, 4, idx.sum())
        _check(bytes(conv[a]), bytes(conv[b]), ScoringScheme())


@pytest.mark.parametrize("seed", [0, 1])
def test_mm_level_driver_matches_jax(monkeypatch, seed):
    """The level driver with _DIRECT_CELLS lowered on both modules: one
    level_rows call a recursion level, several nodes in the deeper ones,
    the levels' node counts at most doubling, and ops strings equal to the
    JAX package's depth-first recursion, on pairs with long gaps (so some
    splits cross an open I run) under two schemes."""
    levels = []
    real = port.level_rows

    def spy(qf, qr, df, dr, nodes, scheme):
        levels.append(len(nodes))
        return real(qf, qr, df, dr, nodes, scheme)

    monkeypatch.setattr(port, "level_rows", spy)
    monkeypatch.setattr(jax_mm, "_DIRECT_CELLS", 48)
    monkeypatch.setattr(port, "_DIRECT_CELLS", 48)
    rng = np.random.default_rng(70 + seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    for sch in (ScoringScheme(), ScoringScheme(match_=3, mismatch=-5,
                                               gap_open=-7, gap_extend=-2)):
        for n, cut in ((200, (50, 110)), (160, (0, 0))):
            levels.clear()
            a = rng.integers(0, 4, n)
            b = np.concatenate([a[: cut[0]], a[cut[1]:]])
            idx = rng.random(len(b)) < 0.05
            b[idx] = rng.integers(0, 4, idx.sum())
            _check(bytes(conv[a]), bytes(conv[b]), sch)
            assert levels[0] == 1 and max(levels) > 2, levels
            assert all(y <= 2 * x for x, y in zip(levels, levels[1:]))


def test_mm_torch_rows_equal_jax_rows():
    """node_rows (the plain version on the CPU) and node_rows_torch equal
    the JAX package's jitted _rows_fn on the same offsets, forward and
    reversed, with and without the boundary subsidy."""
    rng = np.random.default_rng(4)
    q = rng.integers(1, 5, 70).astype(np.int32)
    d = rng.integers(1, 5, 90).astype(np.int32)
    scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    sq_p = port._Seqs(q, d, scheme, "cpu")
    sq_j = jax_mm._Seqs(q, d, _jax(scheme))
    seqs = (sq_p.qf, sq_p.qr, sq_p.df, sq_p.dr)
    for fwd, rev, n in (((0, 35, 0, -7), (10, 20, 30, 0), 50),
                        ((40, 30, 5, -7), (0, 35, 0, -7), 70),
                        ((2, 12, 1, 0), (30, 25, 5, 0), 85)):
        got = port.node_rows(*seqs, fwd, rev, n, scheme)
        assert torch.equal(got, port.node_rows_torch(*seqs, fwd, rev, n,
                                                     scheme))
        for k, (reverse, (q_off, m, d_off, tb)) in enumerate(((False, fwd),
                                                              (True, rev))):
            want = sq_j.rows(reverse, q_off, m, d_off, n, tb)
            for g, w in zip(got[2 * k: 2 * k + 2], want):
                np.testing.assert_array_equal(g.numpy(), w)
    CC, DD = port.rows_torch(sq_p.qf, sq_p.df, 0, 5, 0, 128, -7, scheme)
    assert CC.dtype == DD.dtype == torch.int32 and CC.shape == (129,)


def test_mm_torch_rows_path_equals_direct_path(monkeypatch):
    """Deep recursion (tiny direct-solve cutoff) through the torch rows
    scores as the direct-DP path on the same inputs, and as the oracle."""
    rng = random.Random(23)
    for _ in range(6):
        s1 = bytes(rng.choice(b"ACGT") for _ in range(rng.randint(8, 60)))
        s2 = bytes(rng.choice(b"ACGT") for _ in range(rng.randint(8, 60)))
        sch = ScoringScheme()
        direct = port.mm_score_ops(
            port.mm_align(s1, s2, sch, device="cpu"), s1, s2, sch)
        monkeypatch.setattr(port, "_DIRECT_CELLS", 32)
        deep = port.mm_score_ops(
            port.mm_align(s1, s2, sch, device="cpu"), s1, s2, sch)
        monkeypatch.undo()
        assert direct == deep == oracle_gotoh.gotoh_score(
            s1, s2, scheme=_jax(sch), compat=False), (s1, s2)


def test_mm_fallback_gate_matches_jax():
    """Under a scheme where adjacent cross-direction gap runs pay, the
    standard-model alignment beats the reference model's optimum; the
    aligner's gate answers the exact score with no alignment, as the JAX
    aligner does."""
    from sequencealigning_tpu import config as jax_config
    from sequencealigning_tpu.models.gotoh import GotohAligner as JaxGotoh
    from sequencealigning_tpu_torch.config import AlignConfig, Algo
    from sequencealigning_tpu_torch.models import GotohAligner

    sch = ScoringScheme(match_=5, mismatch=-100, gap_open=-1, gap_extend=-1)
    s1, s2 = b"AA", b"TT"
    exact = oracle_gotoh.gotoh_score(s1, s2, scheme=_jax(sch), compat=False)
    ops = port.mm_align(s1, s2, sch, device="cpu")
    assert port.mm_score_ops(ops, s1, s2, sch) > exact
    got = GotohAligner(AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, scoring=sch,
                                   compat=False), "cpu")._mm_fallback(
        (s1, s2), exact)
    want = JaxGotoh(jax_config.AlignConfig(
        algo=jax_config.Algo.NEEDLEMAN_WUNSCH, scoring=_jax(sch),
        compat=False))._mm_fallback((s1, s2), exact)
    assert got == want == dict(score=exact, aligned_query=None,
                               aligned_db=None)

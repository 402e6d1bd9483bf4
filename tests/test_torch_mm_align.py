"""PyTorch port of the Myers-Miller alignment vs the JAX package's
ops/mm_align.py on the same pairs and schemes (exact: the ops strings must
be equal), mirroring tests/test_mm_align.py: random pairs and schemes,
structured gaps, forced recursion with _DIRECT_CELLS lowered on both
modules, and the torch score rows against the JAX rows and the direct
path."""

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
    """_DIRECT_CELLS lowered on both modules: the recursion's torch rows,
    joins and subsidized leaves give the JAX package's ops."""
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


def test_mm_torch_rows_equal_jax_rows():
    """rows_torch equals the JAX package's jitted _rows_fn on the same
    offsets, forward and reversed, with and without the boundary subsidy."""
    rng = np.random.default_rng(4)
    q = rng.integers(1, 5, 70).astype(np.int32)
    d = rng.integers(1, 5, 90).astype(np.int32)
    scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    sq_p = port._Seqs(q, d, scheme, "cpu")
    sq_j = jax_mm._Seqs(q, d, _jax(scheme))
    for reverse, q_off, m, d_off, n, tb in ((False, 0, 35, 0, 90, -7),
                                            (True, 10, 20, 30, 50, 0),
                                            (False, 40, 30, 5, 70, -7)):
        got = sq_p.rows(reverse, q_off, m, d_off, n, tb)
        want = sq_j.rows(reverse, q_off, m, d_off, n, tb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
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

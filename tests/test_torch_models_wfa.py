"""The port's WfaAligner against the JAX package's on the same records, by
value: scores, alignment strings, CIGARs and per-pair errors, over the
compat route (native and oracle), the four textbook engines, band
doubling, the Gotoh fallback, the std full-width round, bounded ends-free
spans in semi-global and local, and the modes that are not implemented.
The two packages' configs are built from one another by value
(tests/test_torch_models._jax)."""

import dataclasses

import numpy as np
import pytest
import torch

from sequencealigning_tpu.models.wfa import WfaAligner as JaxWfa
from sequencealigning_tpu_torch.config import (
    AlignConfig,
    Algo,
    Mode,
    WfaPenalties,
)
from sequencealigning_tpu_torch.io.fasta import Record
from sequencealigning_tpu_torch.models import WfaAligner, get_aligner
from tests.test_torch_models import _jax, _view


def _records(seed, n=10, hi=90):
    """Pairs up to hi bp: mutants with substitutions and a short indel,
    unrelated pairs, an identical pair and an empty side each way."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(4, hi)))
        if i % 3 == 2:
            s2 = rng.choice(alpha, int(rng.integers(4, hi)))
        else:
            s2 = s1.copy()
            for _ in range(int(rng.integers(0, 5))):
                s2[rng.integers(len(s2))] = rng.choice(alpha)
            if i % 2:
                p = int(rng.integers(1, len(s2) - 2))
                s2 = np.concatenate([s2[:p], s2[p + int(rng.integers(1, 6)):]])
        pairs.append((s1.tobytes(), s2.tobytes()))
    pairs += [(b"ACGTTGCA", b"ACGTTGCA"), (b"", b"ACGT"), (b"ACGTA", b""),
              (b"", b"")]
    return [(Record(seq=a, name=b">q%d" % i), Record(seq=b, name=b">d%d" % i))
            for i, (a, b) in enumerate(pairs)]


def _both(config, recs, monkeypatch=None, caps=None):
    """(port results, JAX results) of one config on the CPU, the classes'
    caps lowered by monkeypatch where given."""
    for name, v in (caps or {}).items():
        monkeypatch.setattr(WfaAligner, name, v)
        monkeypatch.setattr(JaxWfa, name, v)
    got = _view(get_aligner(config, "cpu").align_batch(recs))
    want = _view(JaxWfa(_jax(config)).align_batch(recs))
    return got, want


def _penalty(a1, a2, p):
    pen, st = 0, "M"
    for c1, c2 in zip(a1, a2):
        if c1 == "-":
            pen += p.gap_extend if st == "D" else p.gap_open + p.gap_extend
            st = "D"
        elif c2 == "-":
            pen += p.gap_extend if st == "I" else p.gap_open + p.gap_extend
            st = "I"
        else:
            pen += 0 if c1 == c2 else p.mismatch
            st = "M"
    return pen


def test_get_aligner_gives_the_wfa_aligner():
    assert isinstance(get_aligner(AlignConfig(algo=Algo.WFA), "cpu"),
                      WfaAligner)


@pytest.mark.parametrize("no_native", [False, True])
def test_compat_matches_jax(monkeypatch, no_native):
    """The compat route: the native engine, or the oracle with
    SEQALIGN_NO_NATIVE (the reference's errors per pair included)."""
    if no_native:
        monkeypatch.setenv("SEQALIGN_NO_NATIVE", "1")
    recs = _records(3, n=8, hi=40)
    got, want = _both(AlignConfig(algo=Algo.WFA), recs)
    assert got == want
    assert any(g[7] is None for g in got)


SCHEMES = [WfaPenalties(), WfaPenalties(mismatch=9, gap_open=1, gap_extend=2)]


@pytest.mark.parametrize("engine", ["auto", "banded", "native", "wavefront"])
@pytest.mark.parametrize("scheme", [0, 1])
def test_textbook_engines_match_jax(engine, scheme):
    """Every textbook engine, in regime (the ref banded model) and out of
    it (std), equal to the JAX aligner; every alignment consumes its
    sequences and rescores to its penalty."""
    pen = SCHEMES[scheme]
    recs = _records(10 + scheme, hi=120)
    config = AlignConfig(algo=Algo.WFA, compat=False, band=16,
                         wfa_penalties=pen, wfa_engine=engine)
    got, want = _both(config, recs)
    assert got == want
    for g, (q, d) in zip(got, recs):
        assert g[7] is None, g
        assert g[3].replace("-", "").encode() == q.seq
        assert g[4].replace("-", "").encode() == d.seq
        assert _penalty(g[3], g[4], pen) == g[2]


@pytest.mark.parametrize("engine", ["auto", "native"])
def test_no_native_routes_match_jax(monkeypatch, engine):
    """With SEQALIGN_NO_NATIVE, auto takes the banded route and native the
    wavefront engine, in both packages."""
    monkeypatch.setenv("SEQALIGN_NO_NATIVE", "1")
    config = AlignConfig(algo=Algo.WFA, compat=False, band=8,
                         wfa_engine=engine)
    got, want = _both(config, _records(21, n=8))
    assert got == want


def test_native_cap_routes_the_rest_to_banded_as_jax(monkeypatch):
    """auto with the native leg's penalty cap lowered: the pairs past it
    go to the banded route, as in the JAX aligner."""
    config = AlignConfig(algo=Algo.WFA, compat=False, band=8)
    got, want = _both(config, _records(22), monkeypatch,
                      {"wfa_native_s_cap": 12})
    assert got == want


@pytest.mark.parametrize("engine", ["wavefront", "banded"])
def test_band_doubling_and_gotoh_fallback_match_jax(monkeypatch, engine):
    """A 60-long gap past lowered band caps: the wavefront engine's band
    doubling, the banded route's escalation, then the Gotoh fallback;
    exact penalties with alignments, equal to the JAX aligner."""
    from sequencealigning_tpu_torch.ops import oracle_wfa

    s1 = b"TTTT" * 20
    s2 = b"ACGTACGTACGT" * 5 + b"TTTT" * 20
    recs = [(Record(seq=s1, name=b">q"), Record(seq=s2, name=b">d"))]
    recs += _records(23, n=5)
    config = AlignConfig(algo=Algo.WFA, compat=False, band=2,
                         wfa_engine=engine)
    got, want = _both(config, recs, monkeypatch,
                      {"wfa_max_band": 4, "wfa_banded_max_band": 4})
    assert got == want
    assert got[0][2] == oracle_wfa.wfa_textbook_score(s1, s2)
    assert got[0][3].replace("-", "").encode() == s1


def test_wavefront_gotoh_fallback_past_the_band_cap(monkeypatch):
    """A band cap below the first band: every pair goes to the Gotoh
    fallback (first-only, penalty-converted), as in the JAX aligner."""
    config = AlignConfig(algo=Algo.WFA, compat=False, band=8,
                         wfa_engine="wavefront")
    got, want = _both(config, _records(24, n=6), monkeypatch,
                      {"wfa_max_band": 4})
    assert got == want


def test_std_full_width_round_matches_jax(monkeypatch):
    """Out of regime, past the banded route's lowered cap: one full-width
    std round (no Gotoh fallback), equal to the JAX aligner."""
    config = AlignConfig(algo=Algo.WFA, compat=False, band=2,
                         wfa_penalties=SCHEMES[1], wfa_engine="banded")
    got, want = _both(config, _records(25, n=8), monkeypatch,
                      {"wfa_banded_max_band": 4})
    assert got == want


@pytest.mark.parametrize("mode", [Mode.SEMI_GLOBAL, Mode.LOCAL])
@pytest.mark.parametrize("spans", [(5, 5, 5, 5), (3, 0, 0, 7), (0, 0, 0, 0)])
def test_spans_match_jax(mode, spans):
    """Bounded ends-free WFA in semi-global and local mode."""
    config = AlignConfig(algo=Algo.WFA, mode=mode, compat=False, band=8,
                         wfa_spans=spans)
    got, want = _both(config, _records(30, n=8))
    assert got == want
    assert sum(g[7] is None for g in got) >= 10


def test_spans_band_doubling_and_abort_cause_match_jax(monkeypatch):
    """The spans route's band doubling (caps lowered) and its engine
    abort: a pair past the offset log's 16 kb cap fails every pending pair
    with the cause, in both packages."""
    config = AlignConfig(algo=Algo.WFA, mode=Mode.SEMI_GLOBAL, compat=False,
                         band=1, wfa_spans=(2, 2, 2, 2))
    got, want = _both(config, _records(31, n=6), monkeypatch,
                      {"wfa_max_band": 2})
    assert got == want
    long = [(Record(seq=b"A" * 2 ** 14, name=b">q"),
             Record(seq=b"ACGT", name=b">d"))] + _records(32, n=2)
    got, want = _both(config, long)
    assert got == want
    assert all("16 kb" in g[7] for g in got)


@pytest.mark.parametrize("mode,compat", [(Mode.LOCAL, True),
                                         (Mode.SEMI_GLOBAL, True),
                                         (Mode.SEMI_GLOBAL, False),
                                         (Mode.LOCAL, False)])
def test_not_implemented_modes_match_jax(mode, compat):
    """Compat semi-global / local, and textbook ones without spans: each
    pair "not implemented", as the reference."""
    config = AlignConfig(algo=Algo.WFA, mode=mode, compat=compat)
    got, want = _both(config, _records(33, n=3))
    assert got == want
    assert [g[7] for g in got] == ["not implemented"] * len(got)


def test_failed_cuda_walk_is_a_pair_error(monkeypatch):
    """On a CUDA aligner the wavefront engine's pairs are walked by the
    walk kernel; a walk that fails validation is that pair's
    AlignmentError naming the kernel, never a host re-walk (here the
    fill and walk run on the CPU, pair 1's walk dropped)."""
    import sequencealigning_tpu_torch.models.wfa as wfa_mod

    recs = _records(34, n=6)
    config = AlignConfig(algo=Algo.WFA, compat=False, band=8,
                         wfa_engine="wavefront")
    want = _view(WfaAligner(config, "cpu").align_batch(recs))
    real_walk = wfa_mod.wfa_traceback_device
    real_to_device = wfa_mod.to_device

    def drop_pair_1(*args, **kwargs):
        alns = real_walk(*args, **kwargs)
        alns[1] = None
        return alns

    monkeypatch.setattr(wfa_mod, "wfa_traceback_device", drop_pair_1)
    monkeypatch.setattr(wfa_mod, "to_device",
                        lambda batch, dev: real_to_device(batch, "cpu"))
    port = WfaAligner(config, "cpu")
    port.device = torch.device("cuda")
    got = _view(port.align_batch(recs))
    assert got[:1] + got[2:] == want[:1] + want[2:]
    assert got[1][2:5] == (None,) * 3
    assert "wfa_walk_cuda" in got[1][7]
    # The same drop on the CPU is re-walked on the host.
    cpu = WfaAligner(config, "cpu")
    assert _view(cpu.align_batch(recs)) == want


def test_jax_config_helper_passes_the_wfa_fields():
    """tests/test_torch_models._jax carries the WFA fields and the band by
    value."""
    config = AlignConfig(algo=Algo.WFA, compat=False, band=24,
                         wfa_penalties=WfaPenalties(7, 3, 2),
                         wfa_engine="wavefront", wfa_spans=(1, 2, 3, 4),
                         wfa_max_steps=99)
    j = _jax(config)
    for f in ("band", "wfa_engine", "wfa_spans", "wfa_max_steps"):
        assert getattr(j, f) == getattr(config, f)
    for f in ("wfa_penalties", "wfa_pruning"):
        assert dataclasses.asdict(getattr(j, f)) == \
            dataclasses.asdict(getattr(config, f))
    assert j.algo.value == "wfa" and j.compat is False

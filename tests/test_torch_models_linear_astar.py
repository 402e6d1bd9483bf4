"""PyTorch port's LinearNWAligner and AStarAligner vs the JAX package's on
the same records (exact: scores, alignments, CIGARs and per-pair errors
must be equal), get_aligner's table, and the one named divergence: textbook
local A* is a per-pair "not implemented" in the port where the JAX aligner
silently aligns globally."""

import dataclasses

import numpy as np
import pytest

from sequencealigning_tpu import config as jax_config
from sequencealigning_tpu.models.astar import AStarAligner as JaxAStar
from sequencealigning_tpu.models.linear import LinearNWAligner as JaxLinear
from sequencealigning_tpu_torch import native
from sequencealigning_tpu_torch.config import AlignConfig, Algo, Mode
from sequencealigning_tpu_torch.io.fasta import Record
from sequencealigning_tpu_torch.models import (
    AStarAligner,
    LinearNWAligner,
    get_aligner,
)
from sequencealigning_tpu_torch.models import astar as astar_mod


def _jax(config):
    """The JAX package's AlignConfig with the port config's values."""
    kw = {f.name: getattr(config, f.name)
          for f in dataclasses.fields(config)}
    kw["algo"] = jax_config.Algo(config.algo.value)
    kw["mode"] = jax_config.Mode(config.mode.value)
    for name, cls in (("scoring", jax_config.ScoringScheme),
                      ("wfa_penalties", jax_config.WfaPenalties),
                      ("wfa_pruning", jax_config.WfaPruning)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return jax_config.AlignConfig(**kw)


def _records(seed, n=13, hi=60, alphabet=b"ACGTN", empty=False):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    recs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(1, hi)))
        s2 = s1.copy()
        for _ in range(int(rng.integers(0, 6))):
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        if i % 3 == 0:
            s2 = rng.choice(alpha, int(rng.integers(1, hi)))
        recs.append((Record(seq=s1.tobytes(), name=b">q%d" % i),
                     Record(seq=s2.tobytes(), name=b">d%d" % i)))
    if empty:
        recs += [(Record(seq=b"", name=b">e1"), Record(seq=b"AC", name=b">f1")),
                 (Record(seq=b"GA", name=b">e2"), Record(seq=b"", name=b">f2"))]
    return recs


def _astar_records(seed, n, empty=False):
    """Records the search (which keeps no closed set) finishes fast:
    mutated copies, every third pair an unrelated one of at most 10 bp."""
    recs = _records(seed, n=n, hi=50, empty=empty)
    rng = np.random.default_rng(seed)
    for i in range(0, n, 3):
        q, d = recs[i]
        recs[i] = (Record(seq=q.seq[:10], name=q.name),
                   Record(seq=bytes(rng.choice(list(b"ACGT"), 7)
                                    .astype(np.uint8)), name=d.name))
    return recs


def _view(results):
    return [
        (r.query_name, r.db_name, r.score, r.aligned_query, r.aligned_db,
         r.alignments, str(r.cigar), r.error)
        for r in results
    ]


@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.LOCAL, Mode.SEMI_GLOBAL])
@pytest.mark.parametrize("compat", [True, False])
def test_linear_aligner_matches_jax(compat, mode):
    """Global and local hits (all co-optimal alignments, up to 64 a pair)
    equal the JAX aligner's; semi-global is a per-pair "not implemented"
    in both."""
    recs = _records(3 + compat + 2 * list(Mode).index(mode), empty=True)
    config = AlignConfig(algo=Algo.NW_LINEAR, mode=mode, compat=compat)
    got = LinearNWAligner(config, device="cpu").align_batch(recs)
    assert _view(got) == _view(JaxLinear(_jax(config)).align_batch(recs))
    if mode is Mode.SEMI_GLOBAL:
        assert {r.error for r in got} == {"not implemented"}
    else:
        assert all(r.ok for r in got)


@pytest.mark.parametrize("mode", [Mode.GLOBAL, Mode.SEMI_GLOBAL])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("n", [1, 13])
def test_astar_aligner_matches_jax(compat, mode, n):
    """The native batch (2 pairs or more) and the single search (one
    pair): scores, strings and the empty-sequence errors equal the JAX
    aligner's (whose native library is built)."""
    recs = _astar_records(11 + n + compat, n=n, empty=n > 1)
    config = AlignConfig(algo=Algo.A_STAR, mode=mode, compat=compat)
    got = AStarAligner(config, device="cpu").align_batch(recs)
    assert _view(got) == _view(JaxAStar(_jax(config)).align_batch(recs))
    if n > 1:
        assert got[-1].error == ("One of the provided sequences was empty. "
                                 "Alignment is skipped")


def test_compat_local_astar_aligns_globally_as_jax():
    """Compat -m local keeps the reference's global search (src/main.rs:64
    hardcodes local=false), as the JAX aligner does."""
    recs = _astar_records(5, n=6)
    config = AlignConfig(algo=Algo.A_STAR, mode=Mode.LOCAL)
    got = AStarAligner(config, device="cpu").align_batch(recs)
    assert _view(got) == _view(JaxAStar(_jax(config)).align_batch(recs))
    assert all(r.ok for r in got)


def test_textbook_local_astar_is_not_implemented_unlike_jax():
    """The named divergence: textbook -m local -a a-star answers each pair
    with AlignmentError("not implemented"), where the JAX aligner
    (models/astar.py:46-49) silently returns the global alignment."""
    recs = _astar_records(7, n=5)
    config = AlignConfig(algo=Algo.A_STAR, mode=Mode.LOCAL, compat=False)
    got = AStarAligner(config, device="cpu").align_batch(recs)
    assert [r.error for r in got] == ["not implemented"] * 5
    jax_res = JaxAStar(_jax(config)).align_batch(recs)
    glob = AStarAligner(AlignConfig(algo=Algo.A_STAR, compat=False),
                        device="cpu").align_batch(recs)
    assert all(r.ok for r in jax_res)
    assert [r.score for r in jax_res] == [r.score for r in glob]


def test_astar_falls_back_to_the_oracle_where_native_cannot_allocate(
        monkeypatch):
    """A pair the native batch returns None for (an allocation failure)
    goes to the native single search, and where that returns None too, to
    the oracle, as in the JAX aligner; the results are unchanged."""
    recs = _astar_records(13, n=4)
    config = AlignConfig(algo=Algo.A_STAR)
    want = AStarAligner(config, device="cpu").align_batch(recs)
    real_batch = native.astar_align_batch_native
    calls = []

    def batch_drops_pair_1(*a, **k):
        out = real_batch(*a, **k)
        out[1] = None
        return out

    def single_fails(*a, **k):
        calls.append(a[:2])
        return None

    monkeypatch.setattr(astar_mod.native, "astar_align_batch_native",
                        batch_drops_pair_1)
    monkeypatch.setattr(astar_mod.native, "astar_align_native", single_fails)
    got = AStarAligner(config, device="cpu").align_batch(recs)
    assert _view(got) == _view(want)
    assert calls == [(recs[1][0].seq, recs[1][1].seq)]


@pytest.mark.parametrize("algo,cls", [(Algo.A_STAR, AStarAligner),
                                      (Algo.NW_LINEAR, LinearNWAligner)])
def test_get_aligner_maps_the_new_algorithms(algo, cls):
    assert type(get_aligner(AlignConfig(algo=algo), "cpu")) is cls
    assert AlignConfig().algo is Algo.A_STAR

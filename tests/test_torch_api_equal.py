"""The port's copies of the JAX package's public API against the originals
on the CPU, exact (every value is an integer or a string): the top-level
names, the co-optimal enumeration of the Gotoh oracle, the native
first-path walkers and the batch walkers over them (native and Python,
SEQALIGN_NO_NATIVE), the streamed fast4 device walk, the byte packer and
the WFA offset guard.  The two packages' classes are distinct, so results
are compared by value."""

import dataclasses
import enum
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sequencealigning_tpu as jsa
import sequencealigning_tpu_torch as sa
from sequencealigning_tpu import native as jax_native
from sequencealigning_tpu.models import get_aligner as jax_get_aligner
from sequencealigning_tpu.ops import dirbits as jax_dirbits
from sequencealigning_tpu.ops import oracle_gotoh as jax_oracle
from sequencealigning_tpu.ops import traceback as jax_tb
from sequencealigning_tpu.ops import traceback_device as jax_tbd
from sequencealigning_tpu.ops.nw_affine import (
    nw_affine_batch as jax_nw_affine_batch,
)
from sequencealigning_tpu.ops.nw_affine_stream import (
    nw_affine_stream_batch as jax_stream_batch,
)
from sequencealigning_tpu.utils import guards as jax_guards
from sequencealigning_tpu_torch import native
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io import encode
from sequencealigning_tpu_torch.models import banded as banded_model
from sequencealigning_tpu_torch.models import get_aligner
from sequencealigning_tpu_torch.ops import dirbits, nw_affine, oracle_gotoh
from sequencealigning_tpu_torch.ops import nw_affine_stream as stream
from sequencealigning_tpu_torch.ops import nw_banded_diag as banded
from sequencealigning_tpu_torch.ops import traceback as tb
from sequencealigning_tpu_torch.ops import traceback_device as tbd
from sequencealigning_tpu_torch.utils import guards

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# A scheme with many co-optimal paths (ties at most cells).
TIES = (0, -1, -1, -1)


def _pairs(seed, n=12, lo=1, hi=50, alphabet=b"ACGTN"):
    """Random pairs, every other one a one-substitution mutant."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        s2 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        if i % 2:
            s2 = np.resize(s1, len(s2))
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        out.append((s1.tobytes(), s2.tobytes()))
    return out


def _view(x):
    """A value of either package as plain Python data."""
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name, x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _view(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, torch.Tensor):
        return _view(x.numpy())
    if isinstance(x, BaseException):
        return ("raised", type(x).__name__, str(x))
    if isinstance(x, (list, tuple)):
        return [_view(v) for v in x]
    if isinstance(x, dict):
        return {k: _view(v) for k, v in x.items()}
    return x


def _outcome(fn, *args, **kwargs):
    """fn's result as plain data, or its error."""
    try:
        return _view(fn(*args, **kwargs))
    except Exception as e:  # compared by value across the two packages
        return _view(e)


def _class_view(cls):
    return [c.__name__ for c in cls.__mro__], [
        f.name for f in dataclasses.fields(cls)] if \
        dataclasses.is_dataclass(cls) else None


# ---------------------------------------------------------------------------
# the 16 top-level names
# ---------------------------------------------------------------------------


def _sample_pairs():
    return _pairs(3, n=5)


def _ascii_arrays(bad=False):
    """pack_arrays' inputs: (B, L) uint8 ASCII matrices and true lengths
    (with bad, a character outside the alphabet inside one query)."""
    pairs = _sample_pairs()
    q = np.zeros((len(pairs), 64), np.uint8)
    d = np.full((len(pairs), 64), ord("x"), np.uint8)
    for b, (s1, s2) in enumerate(pairs):
        q[b, : len(s1)] = np.frombuffer(s1, np.uint8)
        d[b, : len(s2)] = np.frombuffer(s2, np.uint8)
    if bad:
        q[1, 0] = ord("Z")
    return (q, d, np.asarray([len(a) for a, _ in pairs]),
            np.asarray([len(b) for _, b in pairs]))


def _fasta_outcome(pkg, name):
    try:
        recs = pkg.parse_fasta(os.path.join(GOLDEN, name))
    except pkg.CharError as e:
        return ("CharError", str(e), [(r.seq, r.name) for r in e.res.records],
                list(e.chars))
    return [(r.seq, r.name) for r in recs.records], recs.display()


TOP_LEVEL = {
    "AlignConfig": lambda p: (_class_view(p.AlignConfig), _view(
        p.AlignConfig()), _view(p.AlignConfig(
            algo=p.Algo.NEEDLEMAN_WUNSCH, mode=p.Mode.LOCAL, compat=False,
            first_only=True))),
    "Algo": lambda p: [(m.name, m.value) for m in p.Algo],
    "Mode": lambda p: [(m.name, m.value) for m in p.Mode],
    "ScoringScheme": lambda p: (_class_view(p.ScoringScheme), _view(
        p.ScoringScheme()), _view(p.ScoringScheme(3, -2, -5, -1))),
    "WfaPenalties": lambda p: (_class_view(p.WfaPenalties),
                               _view(p.WfaPenalties())),
    "WfaPruning": lambda p: (_class_view(p.WfaPruning),
                             _view(p.WfaPruning())),
    "AlignerError": lambda p: (_class_view(p.AlignerError),
                               str(p.AlignerError("x"))),
    "AlignmentError": lambda p: (_class_view(p.AlignmentError),
                                 str(p.AlignmentError("not implemented"))),
    "CharError": lambda p: (_class_view(p.CharError),
                            _fasta_outcome(p, "charerr_query.fa")),
    "FastaError": lambda p: (_class_view(p.FastaError), _outcome(
        p.parse_fasta, os.path.join(GOLDEN, "badext.txt"))),
    "PairBatch": lambda p: (_class_view(p.PairBatch),
                            _view(p.pack_batch(_sample_pairs()))),
    "Record": lambda p: (_class_view(p.Record), p.Record(
        b"ACGT", b">r").display()),
    "Records": lambda p: (_class_view(p.Records), p.Records(
        [p.Record(b"ACGT", b">r"), p.Record(b"GG", b">s")]).display()),
    "pack_arrays": lambda p: (
        _view(p.pack_arrays(*_ascii_arrays(), batch_size=8,
                            len_multiple=64)),
        _outcome(p.pack_arrays, *_ascii_arrays(bad=True))),
    "pack_batch": lambda p: (_view(p.pack_batch(_sample_pairs(),
                                                batch_size=8)),
                             _outcome(p.pack_batch, _sample_pairs(),
                                      batch_size=2)),
    "parse_fasta": lambda p: (_fasta_outcome(p, "queries.fa"),
                              _fasta_outcome(p, "db.fa")),
}


def test_top_level_names_are_the_jax_all():
    assert sorted(TOP_LEVEL) == sorted(set(jsa.__all__) - {"__version__"})
    assert set(jsa.__all__) <= set(sa.__all__)


@pytest.mark.parametrize("name", sorted(TOP_LEVEL))
def test_top_level_name_equal(name):
    """Each name of the JAX package's __all__, reached as sa.<name>, gives
    the same values: enum members, dataclass fields and defaults, error
    classes and messages, packed batches, parsed records."""
    assert TOP_LEVEL[name](sa) == TOP_LEVEL[name](jsa), name


def test_readme_python_api_example_runs_on_the_cpu():
    """README's Python API example, with the port in the JAX package's
    place (on the CPU), gives the JAX package's results."""
    out = {}
    for pkg, ga, kw in ((sa, get_aligner, {"device": "cpu"}),
                        (jsa, jax_get_aligner, {})):
        recs = pkg.parse_fasta(os.path.join(GOLDEN, "db.fa"))
        config = pkg.AlignConfig(algo=pkg.Algo.NEEDLEMAN_WUNSCH)
        aligner = ga(config, **kw)
        out[pkg.__name__] = [
            (r.score, r.cigar, None if r.error is None else str(r.error))
            for r in aligner.align_all_pairs(query=recs, db=recs)]
    assert out["sequencealigning_tpu_torch"] == out["sequencealigning_tpu"]
    assert len(out["sequencealigning_tpu"]) > 1


# ---------------------------------------------------------------------------
# the oracle's co-optimal enumeration
# ---------------------------------------------------------------------------


def _oracle_pairs():
    """The host walker cases' pairs, plus empty sides (boundary chains)."""
    return _pairs(11, n=10) + [(b"", b"ACG"), (b"GA", b""), (b"A", b"A")]


@pytest.mark.parametrize("scheme", ["default", "ties"])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("fn", ["gotoh_traceback_all", "gotoh_align_first"])
def test_oracle_enumeration_equal(fn, compat, scheme):
    """gotoh_traceback_all (every co-optimal alignment up to the cap, in
    the reference's print order) and gotoh_align_first against the JAX
    oracle's: scores, strings and AlignmentError messages."""
    kw = {"max_alignments": 16} if fn == "gotoh_traceback_all" else {}
    for s1, s2 in _oracle_pairs():
        schemes = []
        for mod in (sa, jsa):
            schemes.append(mod.ScoringScheme() if scheme == "default"
                           else mod.ScoringScheme(*TIES))
        got = _outcome(getattr(oracle_gotoh, fn), s1, s2, schemes[0],
                       compat, **kw)
        want = _outcome(getattr(jax_oracle, fn), s1, s2, schemes[1],
                        compat, **kw)
        assert got == want, (s1, s2)


def test_oracle_enumeration_equals_the_host_walker():
    """The port's oracle walk equals its host walker over the port's
    plain kernel #7 dirs (the two validate each other, as in JAX): the
    same alignments, or an AlignmentError from both (their messages name
    the panic differently, in JAX too)."""
    pairs = _pairs(11, n=10)
    res, dirs = _gotoh_dirs("port", True)
    raised = 0
    for b, (s1, s2) in enumerate(pairs):
        got = _outcome(oracle_gotoh.gotoh_traceback_all, s1, s2,
                       max_alignments=8)
        want = _outcome(tb.traceback_pair, dirs[:, b, :], res[b], s1, s2,
                        max_alignments=8)
        if got[0] == "raised":
            assert got[:2] == want[:2] == ("raised", "AlignmentError")
            raised += 1
        else:
            assert got == want
    assert raised < len(pairs)


# ---------------------------------------------------------------------------
# the native walkers and the batch walkers over them
# ---------------------------------------------------------------------------

_FILLS = {}


def _gotoh_dirs(source, compat):
    """(finals, (D4, B, P) full dirs) of _pairs(11, n=10): the port's plain
    kernel #7, or the JAX package's lax fill."""
    key = (source, compat)
    if key not in _FILLS:
        pairs = _pairs(11, n=10)
        batch = encode.pack_batch(pairs, batch_size=len(pairs))
        if source == "port":
            res = nw_affine.nw_affine_batch(*to_device(batch, "cpu"),
                                            compat=compat)
            _FILLS[key] = (np.asarray(res.finals), res.dirs.numpy())
        else:
            res = jax_nw_affine_batch(
                batch.query, batch.db, batch.query_len, batch.db_len,
                compat=compat, backend="lax")
            _FILLS[key] = (np.asarray(res.finals), np.array(res.dirs))
    return _FILLS[key]


def _stream_full(compat):
    pairs = _pairs(11, n=10)
    key = ("stream", compat)
    if key not in _FILLS:
        tb_ = to_device(encode.trim_for_stream(
            encode.pack_batch(pairs, batch_size=16)), "cpu")
        res = stream.nw_affine_stream_batch(*tb_, compat=compat,
                                            with_dirs=True, np_slots=2)
        _FILLS[key] = (res, res.dirs.numpy())
    return pairs, _FILLS[key]


def _banded_fast4(compat, band):
    pairs = _pairs(19, n=12)
    key = ("banded", compat, band)
    if key not in _FILLS:
        mb = to_device(encode.pack_batch(pairs, batch_size=12), "cpu")
        res = banded.nw_banded_diag_batch(*mb, band=band, compat=compat,
                                          wildcard=True, with_dirs="fast4")
        _FILLS[key] = (res, res.dirs.numpy())
    return pairs, _FILLS[key]


def test_native_available_equal():
    assert native.available() is True
    assert native.available() == jax_native.available()


@pytest.mark.parametrize("compat", [True, False])
def test_native_gotoh_first_path_equal(compat):
    """gotoh_first_path_native against the JAX package's on the same dirs
    bytes: per-pair dirs of the plain kernel #7, and the streamed layout's
    rows at each pair's diagonal offset; each path is the host walker's
    first alignment."""
    pairs = _pairs(11, n=10)
    finals, dirs = _gotoh_dirs("port", compat)
    for b, (s1, s2) in enumerate(pairs):
        args = (dirs[:, b, :], finals[b], len(s1), len(s2), compat)
        got = _outcome(native.gotoh_first_path_native, *args)
        assert got == _outcome(jax_native.gotoh_first_path_native, *args)
        walked = _outcome(tb.traceback_pair, dirs[:, b, :], finals[b], s1,
                          s2, compat=compat, max_alignments=1)
        if isinstance(got, str):
            assert _view([tb._apply_ops(got, s1, s2)]) == walked[1]
        else:  # the reference's panic, raised by both walkers
            assert got[:2] == walked[:2] == ("raised", "AlignmentError")
    pairs, (res, sdirs) = _stream_full(compat)
    for b, (s1, s2) in enumerate(pairs):
        row, _slot, off = res.plan.pair_coords(b)
        args = (np.ascontiguousarray(sdirs[:, row, :]), res.finals[b],
                len(s1), len(s2), compat)
        got = _outcome(native.gotoh_first_path_native, *args, d_offset=off)
        assert got == _outcome(jax_native.gotoh_first_path_native, *args,
                               d_offset=off)


def test_native_gotoh_first_path_boundary_panic_equal():
    """An empty query in compat mode walks the boundary chain: both
    native walkers raise the reference-panic AlignmentError alike."""
    pairs = [(b"", b"ACGTA"), (b"ACG", b"")]
    batch = encode.pack_batch(pairs, batch_size=2)
    res = nw_affine.nw_affine_batch(*to_device(batch, "cpu"))
    dirs, finals = res.dirs.numpy(), np.asarray(res.finals)
    for b, (s1, s2) in enumerate(pairs):
        args = (dirs[:, b, :], finals[b], len(s1), len(s2), True)
        assert _outcome(native.gotoh_first_path_native, *args) == \
            _outcome(jax_native.gotoh_first_path_native, *args)


@pytest.mark.parametrize("band", [4, 16])
@pytest.mark.parametrize("compat", [True, False])
def test_native_banded_diag_first_path_equal(compat, band):
    """banded_diag_fast4_first_path_native against the JAX package's on
    the same wavefront-packed fast4 dirs (band 4: pairs whose path leaves
    the band), and against the Python pair walker."""
    pairs, (res, d) = _banded_fast4(compat, band)
    for b, (s1, s2) in enumerate(pairs):
        args = (d, b, res.k_lo_even, len(s1), len(s2), res.finals[b])
        got = native.banded_diag_fast4_first_path_native(*args)
        assert got == jax_native.banded_diag_fast4_first_path_native(*args)
        _, alns = tb.banded_diag_fast4_traceback_pair(
            d[:, b, :], res.finals[b], s1, s2, res.k_lo_even, compat=compat)
        assert tb._apply_ops(got, s1, s2) == alns[0]


def _no_native(monkeypatch, native_on):
    if native_on:
        monkeypatch.delenv("SEQALIGN_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("SEQALIGN_NO_NATIVE", "1")


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("first_only", [True, False])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_traceback_batch_equal(monkeypatch, source, first_only, native_on):
    """traceback_batch over the port's plain kernel #7 dirs and over the
    JAX lax fill's, first-only on and off, native on and off
    (SEQALIGN_NO_NATIVE), against the JAX package's traceback_batch; the
    first-only native walks equal the Python ones."""
    pairs = _pairs(11, n=10)
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    _no_native(monkeypatch, native_on)
    for compat in (True, False):
        finals, dirs = _gotoh_dirs(source, compat)
        got = _view(tb.traceback_batch(dirs, finals, s1s, s2s, compat,
                                       max_alignments=6,
                                       first_only=first_only))
        want = _view(jax_tb.traceback_batch(dirs, finals, s1s, s2s, compat,
                                            max_alignments=6,
                                            first_only=first_only))
        assert got == want
        if first_only and native_on:
            monkeypatch.setenv("SEQALIGN_NO_NATIVE", "1")
            assert got == _view(tb.traceback_batch(
                dirs, finals, s1s, s2s, compat, first_only=True))
            monkeypatch.delenv("SEQALIGN_NO_NATIVE")


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("compat", [True, False])
def test_traceback_stream_batch_first_only_equal(monkeypatch, compat,
                                                 native_on):
    """traceback_stream_batch(..., first_only=True) in full mode (the
    native gotoh_first_path walk at each pair's row and offset) against
    the JAX package's, and against the co-optimal walk's first alignment;
    first_only is the 8th parameter, as in JAX."""
    pairs, (res, d) = _stream_full(compat)
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    _no_native(monkeypatch, native_on)
    args = (d, res.finals, s1s, s2s, res.plan, compat, 64, True)
    got = _view(tb.traceback_stream_batch(*args))
    assert got == _view(jax_tb.traceback_stream_batch(*args))
    full = tb.traceback_stream_batch(d, res.finals, s1s, s2s, res.plan,
                                     compat=compat)
    assert got == _view([r if isinstance(r, Exception) else (r[0], r[1][:1])
                         for r in full])


@pytest.mark.parametrize("native_on", [True, False])
def test_traceback_stream_batch_fast4_equal(monkeypatch, native_on):
    """The fast4 route with and without the native walker against the JAX
    package's."""
    pairs = _pairs(5, n=14)
    tb_ = to_device(encode.trim_for_stream(
        encode.pack_batch(pairs, batch_size=16)), "cpu")
    res = stream.nw_affine_stream_batch(*tb_, with_dirs="fast4", np_slots=2)
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    _no_native(monkeypatch, native_on)
    args = (res.dirs.numpy(), res.finals, s1s, s2s, res.plan)
    got = _view(tb.traceback_stream_batch(*args, dirs_mode="fast4"))
    assert got == _view(jax_tb.traceback_stream_batch(*args,
                                                      dirs_mode="fast4"))


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("band", [4, 16])
@pytest.mark.parametrize("compat", [True, False])
def test_banded_diag_fast4_traceback_batch_equal(monkeypatch, compat, band,
                                                 native_on):
    """banded_diag_fast4_traceback_batch over nw_banded_diag_batch's fast4
    dirs, native on and off, against the JAX package's: scores,
    alignments and per-pair errors."""
    pairs, (res, d) = _banded_fast4(compat, band)
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    _no_native(monkeypatch, native_on)
    args = (d, res.finals, s1s, s2s, res.k_lo_even, compat)
    assert _view(tb.banded_diag_fast4_traceback_batch(*args)) == \
        _view(jax_tb.banded_diag_fast4_traceback_batch(*args))


@pytest.mark.parametrize("native_on", [True, False])
def test_banded_host_route_walks_the_batch(monkeypatch, native_on):
    """BandedAligner first-only with the host walk goes through
    banded_diag_fast4_traceback_batch (once a batch) and gives the JAX
    aligner's results."""
    from sequencealigning_tpu.config import AlignConfig as JaxConfig
    from sequencealigning_tpu.config import Algo as JaxAlgo
    from sequencealigning_tpu.models.banded import BandedAligner as JaxBanded

    calls = []
    real = banded_model.banded_diag_fast4_traceback_batch

    def counted(*args, **kwargs):
        calls.append(len(args[2]))
        return real(*args, **kwargs)

    monkeypatch.setattr(banded_model, "banded_diag_fast4_traceback_batch",
                        counted)
    _no_native(monkeypatch, native_on)
    pairs = _pairs(23, n=9, lo=20, hi=60)
    recs = sa.Records([sa.Record(s, b">p%d" % i)
                       for i, (s, _) in enumerate(pairs)])
    dbs = sa.Records([sa.Record(d, b">d%d" % i)
                      for i, (_, d) in enumerate(pairs)])
    cfg = sa.AlignConfig(algo=sa.Algo.BANDED, band=8, first_only=True,
                         traceback="host")
    got = list(banded_model.BandedAligner(cfg, "cpu").align_all_pairs(
        recs, dbs))
    assert calls and sum(calls) == len(pairs) ** 2
    jrecs = jsa.Records([jsa.Record(r.seq, r.name) for r in recs.records])
    jdbs = jsa.Records([jsa.Record(r.seq, r.name) for r in dbs.records])
    jcfg = JaxConfig(algo=JaxAlgo.BANDED, band=8, first_only=True,
                     traceback="host")
    want = list(JaxBanded(jcfg).align_all_pairs(jrecs, jdbs))
    view = [(r.score, r.cigar, r.alignments,
             None if r.error is None else str(r.error)) for r in got]
    assert view == [(r.score, r.cigar, r.alignments,
                     None if r.error is None else str(r.error))
                    for r in want]


# ---------------------------------------------------------------------------
# the streamed fast4 device walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compat", [True, False])
def test_fast4_stream_walk_device_equal(compat):
    """fast4_stream_walk_device (the plain walk on CPU tensors) against the
    JAX package's on the JAX lax fill's dirs and on the port's plain
    fill's: op strings, failures and scores; its ops equal the host
    walker's and fast4_stream_align_device's alignments."""
    pairs = _pairs(29 if compat else 31, n=14, lo=2, hi=60)
    n1s = np.asarray([len(a) for a, _ in pairs], np.int32)
    n2s = np.asarray([len(b) for _, b in pairs], np.int32)
    batch = encode.pack_batch(pairs, batch_size=len(pairs))
    jres = jax_stream_batch(batch.query, batch.db, batch.query_len,
                            batch.db_len, compat=compat, with_dirs="fast4",
                            backend="lax", np_slots=3)
    jdirs = np.array(jres.dirs)
    tb_ = to_device(encode.trim_for_stream(
        encode.pack_batch(pairs, batch_size=16)), "cpu")
    pres = stream.nw_affine_stream_batch(*tb_, compat=compat,
                                         with_dirs="fast4", np_slots=2)
    for dirs, finals, plan in ((jdirs, np.asarray(jres.finals), jres.plan),
                               (pres.dirs.numpy(), pres.finals, pres.plan)):
        ops, scores = tbd.fast4_stream_walk_device(
            torch.from_numpy(dirs), finals, n1s, n2s, plan)
        jops, jscores = jax_tbd.fast4_stream_walk_device(
            jnp.asarray(dirs), finals, n1s, n2s, plan)
        assert ops == jops and scores.tolist() == np.asarray(
            jscores).tolist()
        assert all(o is not None for o in ops)
        host = tb.traceback_stream_batch(
            dirs, finals, [a for a, _ in pairs], [b for _, b in pairs],
            plan, compat=compat, dirs_mode="fast4")
        alns, _ = tbd.fast4_stream_align_device(
            torch.from_numpy(dirs), finals, [a for a, _ in pairs],
            [b for _, b in pairs], plan)
        for b, (s1, s2) in enumerate(pairs):
            assert [tb._apply_ops(ops[b], s1, s2)] == host[b][1]
            assert alns[b] == host[b][1][0]


# ---------------------------------------------------------------------------
# dirbits and guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_total", [1, 4, 5, 11, 32])
def test_pack_bytes_to_words_equal(d_total):
    """pack_bytes_to_words on random bytes (a tensor, and an array) gives
    the JAX package's words."""
    rng = np.random.default_rng(d_total)
    b = rng.integers(0, 256, (d_total, 3, 7), dtype=np.uint8)
    want = np.asarray(jax_dirbits.pack_bytes_to_words(jnp.asarray(b),
                                                      d_total))
    for arg in (torch.from_numpy(b), b):
        got = dirbits.pack_bytes_to_words(arg, d_total)
        assert got.dtype == torch.uint32
        assert got.numpy().tolist() == want.tolist()
        assert got.shape == want.shape


_OFFSET_CASES = {
    "in range": (np.array([[0, 3, 5], [2, 2, 1]]), np.array([5, 2])),
    "absent entries": (np.array([[-(2 ** 20), 3, -(2 ** 21)]]),
                       np.array([3])),
    "negative": (np.array([[0, -1, 2]]), np.array([4])),
    "past n2": (np.array([[0, 6, 2], [1, 1, 1]]), np.array([5, 9])),
    "past its own row's n2": (np.array([[5, 5], [5, 5]]), np.array([5, 4])),
}


@pytest.mark.parametrize("case", sorted(_OFFSET_CASES))
def test_check_offsets_equal(case):
    """check_offsets raises the same GuardError message where an offset
    present leaves [0, n2], and passes otherwise, as the JAX one."""
    offsets, n2v = _OFFSET_CASES[case]
    got = _outcome(guards.check_offsets, offsets, n2v, label="t")
    assert got == _outcome(jax_guards.check_offsets, offsets, n2v, label="t")
    assert (got is None) == (case in ("in range", "absent entries"))
    assert _outcome(guards.check_offsets, torch.from_numpy(offsets), n2v) \
        == _outcome(jax_guards.check_offsets, offsets, n2v)

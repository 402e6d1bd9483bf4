"""The port's own copies of the JAX package's host modules (config, errors,
io, native, the host walkers of ops.traceback, ops.dirbits, the Gotoh,
linear, A* and WFA oracles, utils) against their originals on the same inputs:
equal values, strings and error messages.  The two packages' classes are
distinct, so results are compared by value, never by identity."""

import dataclasses
import os

import numpy as np
import pytest

import sequencealigning_tpu.config as jax_config
import sequencealigning_tpu.errors as jax_errors
import sequencealigning_tpu.native as jax_native
import sequencealigning_tpu.ops.dirbits as jax_dirbits
import sequencealigning_tpu.ops.oracle_astar as jax_oracle_astar
import sequencealigning_tpu.ops.oracle_gotoh as jax_oracle
import sequencealigning_tpu.ops.oracle_linear as jax_oracle_linear
import sequencealigning_tpu.ops.oracle_wfa as jax_oracle_wfa
import sequencealigning_tpu.ops.traceback as jax_tb
import sequencealigning_tpu.utils.cigar as jax_cigar
import sequencealigning_tpu.utils.guards as jax_guards
import sequencealigning_tpu.utils.pprint as jax_pprint
import sequencealigning_tpu.utils.stats as jax_stats
from sequencealigning_tpu.io import encode as jax_encode
from sequencealigning_tpu.io import fasta as jax_fasta
from sequencealigning_tpu_torch import config, errors, native
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io import encode, fasta
from sequencealigning_tpu_torch.ops import dirbits, oracle_gotoh
from sequencealigning_tpu_torch.ops import oracle_astar, oracle_linear
from sequencealigning_tpu_torch.ops import oracle_wfa
from sequencealigning_tpu_torch.ops import nw_banded as row
from sequencealigning_tpu_torch.ops import nw_linear as linear
from sequencealigning_tpu_torch.ops import nw_affine_stream as stream
from sequencealigning_tpu_torch.ops import nw_affine_modes as modes
from sequencealigning_tpu_torch.ops import nw_banded_diag as banded
from sequencealigning_tpu_torch.ops import traceback as tb
from sequencealigning_tpu_torch.utils import cigar, guards, pprint, stats

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _pairs(seed, n=12, lo=1, hi=50, alphabet=b"ACGTN"):
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


def _outcome(fn, *args, **kwargs):
    """fn's result, or its error as (class name, message)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # compared by value across the two packages
        return ("raised", type(e).__name__, str(e))


def _records(res):
    if isinstance(res, tuple):
        return res
    return [(r.seq, r.name) for r in res]


# ---------------------------------------------------------------------------
# config, errors, dirbits
# ---------------------------------------------------------------------------


def test_config_values_equal():
    assert dataclasses.asdict(config.AlignConfig(algo=config.Algo.BANDED)) \
        == {**dataclasses.asdict(jax_config.AlignConfig(
            algo=jax_config.Algo.BANDED)),
            "algo": config.Algo.BANDED, "mode": config.Mode.GLOBAL}
    assert config.AlignConfig().band == jax_config.AlignConfig().band == 128
    assert [m.value for m in config.Mode] == [m.value for m in jax_config.Mode]
    assert [a.value for a in config.Algo] == [a.value for a in jax_config.Algo]
    assert dataclasses.asdict(config.ScoringScheme()) == \
        dataclasses.asdict(jax_config.ScoringScheme())
    for name in ("NEG_INF", "ENCODE", "DECODE", "PAD"):
        assert getattr(config, name) == getattr(jax_config, name), name
    # Distinct classes: a JAX-package enum is not the port's.
    assert config.Mode.GLOBAL is not jax_config.Mode.GLOBAL


def test_errors_and_dirbits_equal():
    for name in ("AlignerError", "FastaError", "AlignmentError"):
        assert str(getattr(errors, name)("m")) == \
            str(getattr(jax_errors, name)("m"))
        assert issubclass(getattr(errors, name), errors.AlignerError)
    e, j = errors.CharError([], ["x"]), jax_errors.CharError([], ["x"])
    assert (str(e), e.chars) == (str(j), j.chars)
    for name in ("HM", "HI", "HD", "IEXT", "IOPEN", "DEXT", "DOPEN", "LSTART"):
        assert getattr(dirbits, name) == getattr(jax_dirbits, name)


# ---------------------------------------------------------------------------
# io: FASTA and packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["queries.fa", "db.fa", "charerr_query.fa",
                                  "badext.txt", "missing.fa"])
@pytest.mark.parametrize("no_native", [False, True])
def test_parse_fasta_equal(monkeypatch, name, no_native):
    """parse_fasta of the golden files (and an unreadable one), through the
    native scan and the Python state machine: records, the recoverable
    CharError's chars and records, and the FastaError message."""
    if no_native:
        monkeypatch.setenv("SEQALIGN_NO_NATIVE", "1")
    path = os.path.join(GOLDEN, name)

    def run(mod):
        try:
            return _records(mod.parse_fasta(path))
        except (errors.CharError, jax_errors.CharError) as e:
            return ("char", e.chars, _records(e.res))
        except (errors.FastaError, jax_errors.FastaError) as e:
            return ("fasta", str(e))

    assert run(fasta) == run(jax_fasta)


@pytest.mark.parametrize("case", ["pack", "pack_batch_size", "trim",
                                  "empty_side"])
def test_pack_and_trim_equal(case):
    pairs = _pairs(3, n=10, hi=300)
    if case == "empty_side":
        pairs = pairs[:4] + [(b"", b"ACGT"), (b"A", b"")]
    kw = {"batch_size": 16} if case == "pack_batch_size" else {}
    got, want = encode.pack_batch(pairs, **kw), jax_encode.pack_batch(
        pairs, **kw)
    if case == "trim":
        got, want = encode.trim_for_stream(got), jax_encode.trim_for_stream(
            want)
    for f in ("query", "db", "query_len", "db_len", "valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype


def test_encode_helpers_equal():
    seq = b"ACGTNNACG"
    np.testing.assert_array_equal(encode.encode_seq(seq),
                                  jax_encode.encode_seq(seq))
    assert [encode.round_up(x, 128) for x in (1, 128, 129)] == \
        [jax_encode.round_up(x, 128) for x in (1, 128, 129)]
    assert _outcome(encode.encode_seq, b"ACGX") == \
        _outcome(jax_encode.encode_seq, b"ACGX")


def _ascii(seed, n, hi, alphabet=b"ACGTN"):
    """(n, hi + 3) uint8 ASCII rows with garbage past each true length."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(np.frombuffer(alphabet, np.uint8), (n, hi + 3))
    lens = rng.integers(0, hi + 1, n).astype(np.int32)
    rows[np.arange(hi + 3)[None, :] >= lens[:, None]] = ord("x")
    return rows, lens


def _fields_equal(got, want, names):
    for f in names:
        g, w = getattr(got, f), getattr(want, f)
        if w is None or isinstance(w, int):
            assert g == w, f
            continue
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype, f


@pytest.mark.parametrize("alphabet", [b"ACGT", b"ACGTN"])
@pytest.mark.parametrize("batch_size", [0, 16])
def test_wire_format_equal(alphabet, batch_size):
    """pack_arrays, pack_wire (with its _wire_enc) and wire_pack_codes:
    the same arrays, widths and N masks as the originals."""
    q, ql = _ascii(5, 11, 140, alphabet)
    d, dl = _ascii(6, 11, 260, alphabet)
    _fields_equal(encode.pack_arrays(q, d, ql, dl, batch_size=batch_size),
                  jax_encode.pack_arrays(q, d, ql, dl, batch_size=batch_size),
                  ("query", "db", "query_len", "db_len", "valid"))
    for validate in (True, False):
        got = encode.pack_wire(q, d, ql, dl, batch_size=batch_size,
                               validate=validate)
        want = jax_encode.pack_wire(q, d, ql, dl, batch_size=batch_size,
                                    validate=validate)
        _fields_equal(got, want, ("q2", "d2", "qn", "dn", "query_len",
                                  "db_len", "l1", "l2", "valid"))
        assert got.size == want.size
    codes = encode.pack_arrays(q, d, ql, dl).query
    for a, b in zip(encode.wire_pack_codes(codes),
                    jax_encode.wire_pack_codes(codes)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def test_wire_format_errors_equal():
    q, ql = _ascii(7, 4, 30)
    q[0, 0] = ord("Z")
    ql[0] = max(ql[0], 1)
    for fn in ("pack_arrays", "pack_wire"):
        assert _outcome(getattr(encode, fn), q, q, ql, ql) == \
            _outcome(getattr(jax_encode, fn), q, q, ql, ql)
    got = encode.pack_wire(q, q, ql, ql, validate=False)
    want = jax_encode.pack_wire(q, q, ql, ql, validate=False)
    np.testing.assert_array_equal(got.q2, want.q2)


# ---------------------------------------------------------------------------
# native runtime
# ---------------------------------------------------------------------------


def test_native_builds_into_the_port_build_dir():
    lib = native.get_lib()
    assert os.path.dirname(lib._name) == \
        os.path.abspath(os.path.join(GOLDEN, "..", "..", "build",
                                     "sequencealigning_tpu_torch"))


def _stream_fast4(pairs, compat=True):
    tb_ = to_device(encode.trim_for_stream(
        encode.pack_batch(pairs, batch_size=-(-len(pairs) // 8) * 8)), "cpu")
    res = stream.nw_affine_stream_batch(*tb_, compat=compat,
                                        with_dirs="fast4", np_slots=2)
    return res, res.dirs.numpy()


def test_native_fast4_walker_and_decoder_equal():
    pairs = _pairs(5, n=14)
    res, dirs = _stream_fast4(pairs)
    B = len(pairs)
    bs = np.arange(B)
    args = (dirs, res.finals[:B], bs // res.plan.np_slots,
            (bs % res.plan.np_slots) * res.plan.s,
            [len(a) for a, _ in pairs], [len(b) for _, b in pairs])
    ops = native.fast4_first_path_batch_native(*args)
    assert ops == jax_native.fast4_first_path_batch_native(*args)
    # Pack the walks as the device walk does (end to start) and decode.
    codes = {"M": 1, "I": 2, "D": 3}
    width = max(len(o) for o in ops) // 16 + 2
    packed = np.zeros((B, width), np.uint32)
    for b, o in enumerate(ops):
        for i, c in enumerate(reversed(o)):
            packed[b, i // 16] |= np.uint32(codes[c] << (2 * (i % 16)))
    packed[3, -1] = 1  # a code after the stop: inconsistent in both
    n1s = np.asarray([len(a) for a, _ in pairs])
    n2s = np.asarray([len(b) for _, b in pairs])
    s1p = np.zeros((B, n1s.max()), np.uint8)
    s2p = np.zeros((B, n2s.max()), np.uint8)
    for b, (a, d) in enumerate(pairs):
        s1p[b, : len(a)] = np.frombuffer(a, np.uint8)
        s2p[b, : len(d)] = np.frombuffer(d, np.uint8)
    got = native.walk_decode_batch_native(packed, s1p, s2p, n1s, n2s)
    assert got == jax_native.walk_decode_batch_native(packed, s1p, s2p, n1s,
                                                      n2s)
    assert got[3] is None and sum(g is None for g in got) == 1
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        contents = f.read()
    assert native.fasta_scan_native(contents) == \
        jax_native.fasta_scan_native(contents)


# ---------------------------------------------------------------------------
# host walkers and the oracle
# ---------------------------------------------------------------------------


def _walker_cases():
    """(name, port callable, JAX callable, args) for every copied walker,
    on fills made by the port's plain versions."""
    cases = []
    pairs = _pairs(11, n=10)
    for compat in (True, False):
        tb_ = to_device(encode.trim_for_stream(
            encode.pack_batch(pairs, batch_size=16)), "cpu")
        res = stream.nw_affine_stream_batch(*tb_, compat=compat,
                                            with_dirs=True, np_slots=2)
        full = res.dirs.numpy()
        cases.append((f"traceback_stream_batch compat={compat}",
                      tb.traceback_stream_batch, jax_tb.traceback_stream_batch,
                      (full, res.finals, [a for a, _ in pairs],
                       [b for _, b in pairs], res.plan),
                      {"compat": compat}))
        res4, f4 = _stream_fast4(pairs, compat)
        for b in range(4):
            row, _slot, off = res4.plan.pair_coords(b)
            cases.append((f"fast4 {compat} {b}", tb.fast4_traceback_pair,
                          jax_tb.fast4_traceback_pair,
                          (f4[:, row, :], res4.finals[b], *pairs[b]),
                          {"compat": compat, "d_offset": off}))
    mb = to_device(encode.pack_batch(pairs, batch_size=16), "cpu")
    for local in (False, True):
        mres = modes.nw_affine_modes_batch(*mb, local=local)
        for b in range(4):
            fn = (tb.local_affine_traceback_pair, jax_tb.
                  local_affine_traceback_pair) if local else (
                tb.semi_global_traceback_pair,
                jax_tb.semi_global_traceback_pair)
            cases.append((f"modes local={local} {b}", *fn,
                          (mres.dirs[:, b, :].numpy(), int(mres.best_x[b]),
                           int(mres.best_y[b]), *pairs[b]), {}))
    for with_dirs, model in (("full", "ref"), ("fast4", "ref"),
                             ("fast4", "std")):
        scheme = config.ScoringScheme(match_=0, mismatch=-9, gap_open=-2,
                                      gap_extend=-3) if model == "std" \
            else config.ScoringScheme()
        bres = banded.nw_banded_diag_batch(
            *mb, band=8, scheme=scheme, compat=model == "ref",
            wildcard=True, with_dirs=with_dirs, model=model)
        d = bres.dirs.numpy()
        for b in range(5):
            if with_dirs == "full":
                cases.append((f"banded full {b}",
                              tb.banded_diag_traceback_pair,
                              jax_tb.banded_diag_traceback_pair,
                              (d[:, b, :], bres.finals[b], *pairs[b],
                               bres.k_lo_even), {"max_alignments": 4}))
            else:
                cases.append((f"banded fast4 {model} {b}",
                              tb.banded_diag_fast4_traceback_pair,
                              jax_tb.banded_diag_fast4_traceback_pair,
                              (d[:, b, :], bres.finals[b], *pairs[b],
                               bres.k_lo_even),
                              {"compat": model == "ref",
                               "std": model == "std"}))
    return cases


_WALKER_CASES = None


def _walker_case(i):
    global _WALKER_CASES
    if _WALKER_CASES is None:
        _WALKER_CASES = _walker_cases()
    return _WALKER_CASES[i]


@pytest.mark.parametrize("i", range(33))
def test_host_walkers_equal(i):
    """Every copied host walker against its original on the same dirs:
    alignments, scores and per-pair AlignmentError messages."""
    name, port_fn, jax_fn, args, kw = _walker_case(i)
    got = _outcome(port_fn, *args, **kw)
    want = _outcome(jax_fn, *args, **kw)
    if name.startswith("traceback_stream_batch"):
        got = [g if isinstance(g, tuple) else ("raised", str(g)) for g in got]
        want = [w if isinstance(w, tuple) else ("raised", str(w))
                for w in want]
    assert got == want, name


def test_walker_case_count():
    assert len(_walker_cases()) == 33


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("model", ["ref", "std"])
def test_oracle_gotoh_equal(compat, model):
    scheme = config.ScoringScheme(match_=0, mismatch=-9, gap_open=-2,
                                  gap_extend=-3)
    jscheme = jax_config.ScoringScheme(**dataclasses.asdict(scheme))
    for s1, s2 in _pairs(21, n=6, hi=30, alphabet=b"ACGT"):
        if model == "std" and compat:
            continue
        assert oracle_gotoh.gotoh_score(s1, s2, scheme, compat, model) == \
            jax_oracle.gotoh_score(s1, s2, jscheme, compat, model)
        got = oracle_gotoh.gotoh_fill(s1, s2, scheme, compat, model=model)
        want = jax_oracle.gotoh_fill(s1, s2, jscheme, compat, model=model)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------


def test_utils_equal():
    pairs = [("AC-GT--A", "ACTG-TTA"), ("----", "ACGT"), ("A", "A")]
    for a, b in pairs:
        assert str(cigar.cigar_from_pair(a, b)) == \
            str(jax_cigar.cigar_from_pair(a, b))
        assert cigar.ops_from_pair(a, b) == jax_cigar.ops_from_pair(a, b)
        assert pprint.bars(a, b) == jax_pprint.bars(a, b)
    ops = list("MMIDDM")
    assert str(cigar.cigar_from_ops(ops)) == str(jax_cigar.cigar_from_ops(ops))
    for score, n1, n2 in ((40, 100, 120), (-3, 5, 9)):
        assert stats.e_value(score, n1, n2) == jax_stats.e_value(score, n1, n2)
        assert stats.bit_score(score) == jax_stats.bit_score(score)
    assert guards.score_bounds(10, 14, config.ScoringScheme()) == \
        jax_guards.score_bounds(10, 14, jax_config.ScoringScheme())
    finals = np.array([[60, -32768, -40000], [10, 12, 3]], np.int32)
    for args in ((finals[:1], [12], [12]), (finals[1:], [30], [2])):
        assert _outcome(guards.check_finals, *args) == \
            _outcome(jax_guards.check_finals, *args)
    assert _outcome(guards.check_finals, finals[1:], [30], [2])[1] == \
        "GuardError"



# ---------------------------------------------------------------------------
# The row-layout banded walkers, the linear walker, the linear and A*
# oracles, and their native entry points
# ---------------------------------------------------------------------------


def _result_view(r):
    """A walker's (score, alignments) or its AlignmentError, by value."""
    if isinstance(r, Exception):
        return ("raised", type(r).__name__, str(r))
    return r


def _row_and_linear_cases():
    """(name, port callable, JAX callable, args, kwargs) for the row-layout
    banded walkers (pair and batch) and the linear walker, on fills made
    by the port's plain versions."""
    cases = []
    pairs = _pairs(31, n=10)
    mb = to_device(encode.pack_batch(pairs, batch_size=16), "cpu")
    for compat in (True, False):
        full = row.nw_banded_batch(*mb, band=8, compat=compat, wildcard=True,
                                   with_dirs="full")
        f4 = row.nw_banded_batch(*mb, band=8, compat=compat, wildcard=True,
                                 with_dirs="fast4")
        d, d4 = full.dirs.numpy(), f4.dirs.numpy()
        for b in range(4):
            cases.append((f"row full {compat} {b}", tb.banded_traceback_pair,
                          jax_tb.banded_traceback_pair,
                          (d[:, b, :], full.finals[b], *pairs[b], full.k_lo),
                          {"compat": compat, "max_alignments": 4}))
            cases.append((f"row fast4 {compat} {b}",
                          tb.banded_fast4_traceback_pair,
                          jax_tb.banded_fast4_traceback_pair,
                          (d4[:, b, :], f4.finals[b], *pairs[b], f4.k_lo),
                          {"compat": compat}))
        cases.append((f"row fast4 batch {compat}",
                       tb.banded_fast4_traceback_batch,
                       jax_tb.banded_fast4_traceback_batch,
                       (d4[:, :10], f4.finals[:10], [a for a, _ in pairs],
                        [b for _, b in pairs], f4.k_lo), {"compat": compat}))
    for compat in (True, False):
        for local in (False, True):
            res = linear.nw_linear_batch(*mb, compat=compat, local=local)
            for b in range(4):
                cases.append((f"linear {compat} {local} {b}",
                              tb.linear_traceback_pair,
                              jax_tb.linear_traceback_pair,
                              (res.dirs[:, b, :].numpy(), *pairs[b]),
                              {"local": local}))
    return cases


_ROW_CASES = None
N_ROW_CASES = 34


@pytest.mark.parametrize("i", range(N_ROW_CASES))
def test_row_and_linear_walkers_equal(i):
    """The row-layout banded walkers (co-optimal full, fast4 pair, the
    native-first fast4 batch) and the linear DFS walker against their
    originals on the same dirs: alignments, scores, hit starts and
    per-pair AlignmentError messages."""
    global _ROW_CASES
    if _ROW_CASES is None:
        _ROW_CASES = _row_and_linear_cases()
    assert len(_ROW_CASES) == N_ROW_CASES
    name, port_fn, jax_fn, args, kw = _ROW_CASES[i]
    got = _outcome(port_fn, *args, **kw)
    want = _outcome(jax_fn, *args, **kw)
    if name.startswith("row fast4 batch"):
        got = [_result_view(g) for g in got]
        want = [_result_view(w) for w in want]
    assert got == want, name


def test_native_banded_fast4_walker_equal():
    """The native row-layout fast4 walker against the JAX package's on
    every pair of a fill, and against the Python pair walker."""
    pairs = _pairs(37, n=12)
    mb = to_device(encode.pack_batch(pairs, batch_size=12), "cpu")
    res = row.nw_banded_batch(*mb, band=12, wildcard=True, with_dirs="fast4")
    d = res.dirs.numpy()
    for b, (s1, s2) in enumerate(pairs):
        args = (d, b, res.k_lo, len(s1), len(s2), res.finals[b])
        got = native.banded_fast4_first_path_native(*args)
        assert got == jax_native.banded_fast4_first_path_native(*args)
        _, alns = tb.banded_fast4_traceback_pair(d[:, b, :], res.finals[b],
                                                 s1, s2, res.k_lo)
        assert tb._apply_ops(got, s1, s2) == alns[0]


def _astar_pairs(seed):
    """Pairs the search (which keeps no closed set) finishes fast in
    Python: mutated copies up to 60 bp, unrelated pairs up to 10 bp, and
    an empty side each way."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    similar = []
    for _ in range(6):
        s1 = rng.choice(alpha, int(rng.integers(20, 61)))
        s2 = s1.copy()
        for _ in range(3):
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        similar.append((s1.tobytes(), s2[: len(s2) - int(rng.integers(0, 3))]
                        .tobytes()))
    return (similar + _pairs(seed + 1, n=4, hi=10)
            + [(b"", b"ACG"), (b"AC", b"")])


@pytest.mark.parametrize("semi", [False, True])
def test_native_astar_equal(semi):
    """The native A* search, single and threaded batch, against the JAX
    package's native entry points and the port's oracle: scores, strings,
    and the empty-sequence error."""
    scheme = config.ScoringScheme()
    a = (scheme.match_, scheme.mismatch, scheme.gap_open, scheme.gap_extend,
         scheme.epsilon)
    pairs = _astar_pairs(41)
    s1s, s2s = [p[0] for p in pairs], [p[1] for p in pairs]
    got = native.astar_align_batch_native(s1s, s2s, *a, semi_global=semi)
    assert got == jax_native.astar_align_batch_native(s1s, s2s, *a,
                                                      semi_global=semi)
    for (s1, s2), g in zip(pairs, got):
        one = _outcome(native.astar_align_native, s1, s2, *a,
                       semi_global=semi)
        assert one == _outcome(jax_native.astar_align_native, s1, s2, *a,
                               semi_global=semi)
        assert one == _outcome(oracle_astar.astar_align, s1, s2, scheme,
                               semi_global=semi)
        assert g == (one if isinstance(g, tuple) else one[2])


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_oracle_linear_equal(compat, local):
    scheme = config.ScoringScheme(match_=2, mismatch=-3, gap_open=-5,
                                  gap_extend=-1)
    jscheme = jax_config.ScoringScheme(**dataclasses.asdict(scheme))
    for s1, s2 in _pairs(43, n=5, hi=30, alphabet=b"ACGT"):
        got = oracle_linear.linear_fill(s1, s2, scheme, local, compat)
        want = jax_oracle_linear.linear_fill(s1, s2, jscheme, local, compat)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        assert oracle_linear.linear_score(s1, s2, scheme, local, compat) == \
            jax_oracle_linear.linear_score(s1, s2, jscheme, local, compat)
        assert oracle_linear.linear_traceback(s1, s2, scheme, local, compat) \
            == jax_oracle_linear.linear_traceback(s1, s2, jscheme, local,
                                                  compat)


def test_oracle_astar_equal():
    scheme = config.ScoringScheme()
    jscheme = jax_config.ScoringScheme()
    for semi in (False, True):
        for s1, s2 in _astar_pairs(47):
            assert _outcome(oracle_astar.astar_align, s1, s2, scheme,
                            semi_global=semi) == _outcome(
                jax_oracle_astar.astar_align, s1, s2, jscheme,
                semi_global=semi)


# ---------------------------------------------------------------------------
# The WFA oracle and the native WFA entry points
# ---------------------------------------------------------------------------


def _wfa_pairs(seed):
    """Near-identical pairs (which the compat WFA converges on), unrelated
    pairs (which it may never converge on), an identical pair and empty
    sides."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(8):
        s1 = rng.choice(alpha, int(rng.integers(3, 40)))
        s2 = s1.copy()
        for _ in range(int(rng.integers(0, 3))):
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        if i % 3 == 2:
            s2 = rng.choice(alpha, int(rng.integers(3, 40)))
        out.append((s1.tobytes(), s2.tobytes()))
    return out + [(b"ACGTAC", b"ACGTAC"), (b"", b"ACG"), (b"AC", b""),
                  (b"", b"")]


_WFA_SCHEMES = [(4, 2, 6), (9, 1, 2), (1, 5, 1)]


@pytest.mark.parametrize("scheme", range(len(_WFA_SCHEMES)))
def test_oracle_wfa_equal(scheme):
    """wfa_align (its score, the ocean's traceback) and wfa_textbook_score
    against the originals: equal values and error messages."""
    pen = config.WfaPenalties(*_WFA_SCHEMES[scheme])
    jpen = jax_config.WfaPenalties(*_WFA_SCHEMES[scheme])
    prune, jprune = config.WfaPruning(), jax_config.WfaPruning()
    for s1, s2 in _wfa_pairs(51 + scheme):
        def run(mod, p, pr):
            score, ocean = mod.wfa_align(s1, s2, penalties=p, pruning=pr,
                                         max_steps=120)
            return score, mod.wfa_traceback(ocean, s1, s2)

        assert _outcome(run, oracle_wfa, pen, prune) == \
            _outcome(run, jax_oracle_wfa, jpen, jprune)
        assert _outcome(oracle_wfa.wfa_textbook_score, s1, s2, pen) == \
            _outcome(jax_oracle_wfa.wfa_textbook_score, s1, s2, jpen)


@pytest.mark.parametrize("scheme", range(len(_WFA_SCHEMES)))
def test_native_wfa_entry_points_equal(scheme):
    """wfa_compat_align_native, wfa_textbook_align_batch_native (with and
    without a penalty cap) and wfa_textbook_traceback_native against the
    JAX package's on the same inputs: results, declined pairs and error
    messages; the compat results against the port's oracle."""
    from sequencealigning_tpu.io.encode import pack_batch as jax_pack
    from sequencealigning_tpu.ops import wfa as jax_wfa

    pen = config.WfaPenalties(*_WFA_SCHEMES[scheme])
    jpen = jax_config.WfaPenalties(*_WFA_SCHEMES[scheme])
    pairs = _wfa_pairs(61 + scheme)
    for s1, s2 in pairs:
        got = _outcome(native.wfa_compat_align_native, s1, s2, pen,
                       config.WfaPruning(), 400)
        assert got == _outcome(jax_native.wfa_compat_align_native, s1, s2,
                               jpen, jax_config.WfaPruning(), 400)
        if isinstance(got, tuple) and got[0] != "raised":
            score, ocean = oracle_wfa.wfa_align(s1, s2, penalties=pen,
                                                max_steps=400)
            assert got == (score, *oracle_wfa.wfa_traceback(ocean, s1, s2))
    for kw in ({}, {"s_max": 24}):
        got = native.wfa_textbook_align_batch_native(pairs, pen, **kw)
        assert got == jax_native.wfa_textbook_align_batch_native(
            pairs, jpen, **kw)
        assert (None in got) == bool(kw)
    batch = jax_pack(pairs, batch_size=16)
    res = jax_wfa.wfa_textbook_batch(batch.query, batch.db, batch.query_len,
                                     batch.db_len, penalties=jpen, band=48)
    hist = np.asarray(res.hist)
    for b, (s1, s2) in enumerate(pairs):
        args = (hist, b, res.k_lo, int(res.score[b]), s1, s2)
        got = native.wfa_textbook_traceback_native(*args, pen,
                                                   stride=res.stride)
        assert got == jax_native.wfa_textbook_traceback_native(
            *args, jpen, stride=res.stride)
        assert got is not None

"""The port's textbook WFA engine (ops/wfa.py) against the JAX one, run as
its own tests run it (JAX on the CPU): the plain fill's per-pair results
and offset log, the 16 kb cap, the host walkers, and the plain device walk
decoded by the native decoder.  Integers are held equal exactly."""

import numpy as np
import pytest
import torch

import sequencealigning_tpu.ops.wfa as jax_wfa
from sequencealigning_tpu.config import WfaPenalties as JaxPenalties
from sequencealigning_tpu.errors import AlignmentError as JaxAlignmentError
from sequencealigning_tpu_torch.config import WfaPenalties
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.errors import AlignmentError
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import wfa
from sequencealigning_tpu_torch.ops.traceback_device import (
    decode_packed_alignments,
)


def _pairs(seed, n=13, hi=60, alphabet=b"ACGT"):
    """Random pairs up to hi bp: mutants (substitutions, a cut tail, an
    indel) and unrelated pairs, with an empty pair, an identical pair and
    an empty side each way."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        a = rng.choice(alpha, int(rng.integers(1, hi))).tobytes()
        if i % 2:
            b = bytearray(a)
            for _ in range(int(rng.integers(0, 4))):
                b[rng.integers(len(b))] = int(rng.choice(alpha))
            if i % 4 == 1 and len(b) > 8:
                p = int(rng.integers(1, len(b) - 4))
                del b[p: p + int(rng.integers(1, 4))]
            b = bytes(b[: len(b) - int(rng.integers(0, 4))])
        else:
            b = rng.choice(alpha, int(rng.integers(1, hi))).tobytes()
        out.append((a, b))
    return out + [(b"", b""), (b"ACGTAC", b"ACGTAC"), (b"", b"ACG"),
                  (b"GATT", b"")]


# (penalties, band, spans, pair seed): in regime, out of regime, several
# spans, a band small enough to escape, zero mismatch / extend penalties.
CASES = [
    ((4, 2, 6), 16, (0, 0, 0, 0), 1),
    ((9, 2, 2), 8, (0, 0, 0, 0), 2),
    ((4, 2, 6), 4, (5, 5, 5, 5), 3),
    ((4, 2, 6), 8, (0, 0, 0, 0), 4),
    ((4, 0, 3), 8, (3, 0, 0, 7), 5),
    ((1, 5, 1), 2, (0, 0, 0, 0), 6),
    ((3, 1, 0), 8, (0, 0, 0, 0), 7),
    ((4, 2, 6), 1, (0, 2, 4, 1), 8),
]


def _both(pen, band, spans, pairs, **kw):
    batch = pack_batch(pairs, batch_size=-(-len(pairs) // 8) * 8)
    port = wfa.wfa_textbook_batch(*to_device(batch, "cpu"),
                                  penalties=WfaPenalties(*pen), band=band,
                                  spans=spans, **kw)
    want = jax_wfa.wfa_textbook_batch(
        batch.query, batch.db, batch.query_len, batch.db_len,
        penalties=JaxPenalties(*pen), band=band, spans=spans, **kw)
    return port, want


def _assert_fill_equal(port, want):
    np.testing.assert_array_equal(port.score, np.asarray(want.score))
    np.testing.assert_array_equal(port.converged, np.asarray(want.converged))
    np.testing.assert_array_equal(port.end_k, np.asarray(want.end_k))
    assert (port.k_lo, port.stride, port.spans) == \
        (want.k_lo, want.stride, want.spans)
    smax = int(port.score.max())
    rows = smax // port.stride + 1 if smax >= 0 else 1
    ph, wh = port.hist, np.asarray(want.hist)
    assert ph.dtype == np.int16 and ph.shape[1:] == wh.shape[1:]
    np.testing.assert_array_equal(ph[:rows], wh[:rows])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_textbook_batch_matches_jax(case):
    """score, converged, end_k, k_lo, stride and the log's rows up to the
    batch's deepest score through the plain fill, equal to the JAX
    engine's."""
    pen, band, spans, seed = CASES[case]
    port, want = _both(pen, band, spans, _pairs(seed))
    _assert_fill_equal(port, want)


def test_escape_reports_nonconvergence_as_jax():
    """A pair whose penalty (1200) lies past the chunks that s_max lets
    run (scores up to 512) does not converge, in both; a 40-long indel in
    a band of 4 converges on its in-band optimum in both."""
    s1 = b"ACGT" * 10 + b"T" * 40
    s2 = b"T" * 40 + b"ACGT" * 10
    pairs = [(b"A" * 300, b"T" * 300), (s1, s2)]
    port, want = _both((4, 2, 6), 4, (0, 0, 0, 0), pairs, s_max=8)
    _assert_fill_equal(port, want)
    assert list(port.converged[:2]) == [False, True]
    with pytest.raises(AlignmentError, match="did not converge"):
        wfa.wfa_traceback_host(port, 0, *pairs[0])


def test_s_max_cap_stops_the_chunk_loop_as_jax():
    """s_max bounds the chunks queued (a chunk that starts below it runs
    whole), as the JAX loop: the same convergence at a small cap."""
    pairs = _pairs(9, n=6, hi=120) + [(b"A" * 90, b"T" * 90)]
    port, want = _both((4, 2, 6), 32, (0, 0, 0, 0), pairs, s_max=8)
    _assert_fill_equal(port, want)


def test_offset_cap_error_matches_jax():
    """Pairs of 16 kb or more: the same AlignmentError before any fill."""
    long = b"A" * (2 ** 14)
    batch = pack_batch([(long, b"ACGT")], batch_size=8)
    with pytest.raises(AlignmentError) as got:
        wfa.wfa_textbook_batch(*to_device(batch, "cpu"))
    with pytest.raises(JaxAlignmentError) as want:
        jax_wfa.wfa_textbook_batch(batch.query, batch.db, batch.query_len,
                                   batch.db_len)
    assert str(got.value) == str(want.value)
    assert "16 kb" in str(got.value)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # compared by value across the two packages
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("no_native", [False, True])
@pytest.mark.parametrize("case", [0, 1, 6])
def test_traceback_host_matches_jax(monkeypatch, case, no_native):
    """wfa_traceback_host (the native walker, or the Python one with
    SEQALIGN_NO_NATIVE) on every pair: the same penalty and strings, and
    the same error for an unconverged pair."""
    if no_native:
        monkeypatch.setenv("SEQALIGN_NO_NATIVE", "1")
    pen, band, spans, seed = CASES[case]
    pairs = _pairs(seed)
    port, want = _both(pen, band, spans, pairs)
    for b, (s1, s2) in enumerate(pairs):
        got = _outcome(wfa.wfa_traceback_host, port, b, s1, s2,
                       WfaPenalties(*pen))
        assert got == _outcome(jax_wfa.wfa_traceback_host, want, b, s1, s2,
                               JaxPenalties(*pen)), b


@pytest.mark.parametrize("case", [2, 4, 7])
def test_ends_free_traceback_host_matches_jax(case):
    pen, band, spans, seed = CASES[case]
    pairs = _pairs(seed)
    port, want = _both(pen, band, spans, pairs)
    for b, (s1, s2) in enumerate(pairs):
        got = _outcome(wfa.wfa_ends_free_traceback_host, port, b, s1, s2,
                       WfaPenalties(*pen))
        assert got == _outcome(jax_wfa.wfa_ends_free_traceback_host, want, b,
                               s1, s2, JaxPenalties(*pen)), b


@pytest.mark.parametrize("case", [0, 1, 3, 5, 6])
def test_plain_device_walk_matches_jax_and_host(case):
    """The plain walk decoded by the native decoder (wfa_traceback_device on
    CPU tensors) against the JAX device walk, and every walked pair against
    the host walker."""
    pen, band, spans, seed = CASES[case]
    pairs = _pairs(seed)
    port, want = _both(pen, band, spans, pairs)
    s1s, s2s = [p[0] for p in pairs], [p[1] for p in pairs]
    got = wfa.wfa_traceback_device(port, s1s, s2s, WfaPenalties(*pen))
    assert got == jax_wfa.wfa_traceback_device(want, s1s, s2s,
                                               JaxPenalties(*pen))
    walked = 0
    for b, a in enumerate(got):
        if a is None:
            assert not port.converged[b]
            continue
        walked += 1
        assert wfa.wfa_traceback_host(port, b, *pairs[b],
                                      WfaPenalties(*pen))[1:] == a
    assert walked >= len(pairs) - 6


def test_plain_walk_outputs():
    """The plain walk's packed codes, op counts and flags: codes in walk
    order that decode to the host walker's strings, n_ops their count, a
    pair that did not converge not ok and all 0."""
    pairs = _pairs(11, n=9) + [(b"A" * 300, b"T" * 300)]
    pen = WfaPenalties()
    batch = pack_batch(pairs, batch_size=16)
    res = wfa.wfa_textbook_batch(*to_device(batch, "cpu"), penalties=pen,
                                 band=2, s_max=8)
    s1s, s2s = [p[0] for p in pairs], [p[1] for p in pairs]
    seeds = wfa.walk_seeds(res, s1s, s2s, "cpu")
    W = wfa.walk_width(int(seeds.budget.max()))
    packed, n_ops, ok = wfa.wfa_walk_torch(res.device_hist(), seeds,
                                           res.k_lo, res.stride, pen, W)
    assert packed.dtype == torch.uint32 and packed.shape == (len(pairs), W)
    assert torch.equal(ok, torch.from_numpy(res.converged[: len(pairs)]))
    alns = decode_packed_alignments(packed.numpy(), s1s, s2s)
    for b in range(len(pairs)):
        if not ok[b]:
            assert int(n_ops[b]) == 0 and not packed[b].any()
            continue
        a1, a2 = alns[b]
        assert int(n_ops[b]) == len(a1)
        assert (a1, a2) == wfa.wfa_traceback_host(res, b, *pairs[b], pen)[1:]
    assert not bool(ok.all())


def test_cuda_wrappers_refuse_cpu_tensors():
    batch = pack_batch(_pairs(12, n=3), batch_size=8)
    tb = to_device(batch, "cpu")
    k_lo, K = wfa.band_plan(batch.query_len, batch.db_len, 8, (0, 0, 0, 0))
    f = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
    with pytest.raises(ValueError, match="CUDA"):
        wfa.wfa_chunk_cuda(f, 0, 1)
    hist = wfa.wfa_chunk(f, 0, 1)
    res = wfa.WfaBatchResult(f.score.numpy(), f.done.numpy() != 0, [hist],
                             k_lo)
    seeds = wfa.walk_seeds(res, [b""] * 3, [b""] * 3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        wfa.wfa_walk_cuda(hist, seeds, k_lo, 2, WfaPenalties(), 4)


def test_ring_and_lattice_offsets():
    """A zero penalty reads the row the JAX ring's length back; the ring
    has a row more than the JAX ring, so no step reads the slot it
    writes."""
    assert wfa.ring_rows(WfaPenalties()) == 6
    assert wfa.lattice_offsets(WfaPenalties()) == (2, 4, 3)
    assert wfa.lattice_offsets(WfaPenalties(3, 1, 0)) == (3, 1, 4)
    for pen in (WfaPenalties(), WfaPenalties(0, 2, 6), WfaPenalties(3, 1, 0),
                WfaPenalties(9, 2, 2)):
        R = wfa.ring_rows(pen)
        assert all(1 <= o < R for o in wfa.lattice_offsets(pen))
    assert wfa.fill_lanes_per_thread(640) == 1
    assert wfa.fill_lanes_per_thread(1152) == 2
    assert wfa.fill_lanes_per_thread(640, 3) == 3

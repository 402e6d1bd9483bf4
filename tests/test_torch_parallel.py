"""The port's data-parallel runner and streaming pipeline
(sequencealigning_tpu_torch.parallel) on eight CPU shards (``["cpu"] * 8``)
against the JAX package's runner on its 8 virtual CPU devices
(tests/conftest.py): the same finals from both kernels (the plain one is
kernel #7), the same fused fill+walk strings, the same modes end cells and
walks, and the same stream_align callbacks with and without cigars, across
a checkpoint resume and with first_batch_index (exact: integers and strings
must be equal; errors compared by class name and message)."""

import json
import random

import numpy as np
import pytest
import torch

from sequencealigning_tpu.io.encode import pack_batch as jax_pack
from sequencealigning_tpu.io.encode import pack_wire as jax_pack_wire
from sequencealigning_tpu.parallel.runner import (
    DataParallelRunner as JaxRunner,
)
from sequencealigning_tpu.parallel.streaming import (
    stream_align as jax_stream,
)
from sequencealigning_tpu_torch.io.encode import pack_batch, pack_wire
from sequencealigning_tpu_torch.parallel import (
    DataParallelRunner,
    stream_align,
)
from sequencealigning_tpu_torch.parallel import streaming
from sequencealigning_tpu_torch.parallel.runner import to_host

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the test's plain torch ops: the suite runs
    several workers on the machine's cores, and wide per-step ops across
    threads that other workers hold stall at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed, n, alphabet=b"ACGT", lo=3, hi=24):
    rng = random.Random(seed)
    return [
        (bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, hi))),
         bytes(rng.choice(alphabet) for _ in range(rng.randint(lo, hi))))
        for _ in range(n)
    ]


def _value(results):
    """Per-pair results with errors as (class name, message)."""
    return [
        r if isinstance(r, tuple) else (type(r).__name__, str(r))
        for r in results
    ]


def _collect(stream, pairs, runner, **kw):
    got = {}
    key = "on_alignments" if kw.get("cigars") else "on_result"
    kw[key] = lambda i, t: got.__setitem__(
        i, _value(t) if kw.get("cigars") else np.asarray(t).copy())
    n = stream(pairs, runner=runner, **kw)
    return n, got


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("kernel", ["stream", "plain"])
def test_scores_match_jax_runner(kernel, gather):
    """Both kernels give the JAX runner's finals (5 pairs: the batch is
    padded past them), gathered onto the first device or left in per-device
    blocks."""
    pairs = _pairs(61, 5, b"ACGTN")
    want = np.asarray(JaxRunner(backend="lax", kernel=kernel,
                                gather=gather).scores(jax_pack(pairs)))
    got = DataParallelRunner(CPU8, kernel=kernel, gather=gather).scores(
        pack_batch(pairs))
    assert isinstance(got, list) != gather
    np.testing.assert_array_equal(to_host(got), want)


def test_both_kernels_agree():
    pairs = _pairs(67, 21)
    stream, plain = (DataParallelRunner(CPU8, kernel=k).scores(
        pack_batch(pairs)) for k in ("stream", "plain"))
    np.testing.assert_array_equal(to_host(stream), to_host(plain))


@pytest.fixture(scope="module")
def runners():
    return (JaxRunner(backend="lax", np_slots=2, traceback="device"),
            DataParallelRunner(CPU8, np_slots=2, traceback="device"))


@pytest.fixture(scope="module")
def stream_args(runners):
    pairs = _pairs(5, 40, b"ACGTN")
    jr, tr = runners
    ja = jr._stream_args(jax_pack(pairs))
    ta = tr._stream_args(pack_batch(pairs))
    assert ja[1] == ta[1]  # the same plan
    return pairs, ja, ta


def test_fused_fill_walk_matches_jax(runners, stream_args):
    jr, tr = runners
    pairs, (ja, plan, jb, jn), (ta, _plan, tb_, tn) = stream_args
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    jf, jh = jr.fill_walk_from_stream_args(ja, plan, jb, jn, s1, s2)
    tf, th = tr.fill_walk_from_stream_args(ta, plan, tb_, tn, s1, s2)
    np.testing.assert_array_equal(to_host(tf), np.asarray(jf))
    assert _value(tr.device_walk_fast4_finish(th, tf, s1, s2)) == \
        _value(jr.device_walk_fast4_finish(jh, jf, s1, s2))


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_fused_modes_fill_walk_matches_jax(runners, stream_args, mode):
    jr, tr = runners
    pairs, (ja, plan, jb, jn), (ta, _plan, tb_, tn) = stream_args
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    jo = jr.fill_walk_modes_from_stream_args(ja, plan, jb, jn, mode)
    to = tr.fill_walk_modes_from_stream_args(ta, plan, tb_, tn, mode)
    for k in range(3):
        np.testing.assert_array_equal(to_host(to[k]), np.asarray(jo[k]))
    assert tr.device_walk_modes_finish(to[3], s1, s2) == \
        jr.device_walk_modes_finish(jo[3], s1, s2)


def test_sync_walks_match_jax(runners):
    """fill_with_dirs + device_walk_fast4, fill_modes + device_walk_modes
    (the synchronous wrappers) and the host walk route."""
    jr, tr = runners
    pairs = _pairs(8, 24)
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    jf, jd, plan = jr.fill_with_dirs(jax_pack(pairs))
    tf, td, _ = tr.fill_with_dirs(pack_batch(pairs))
    want = _value(jr.device_walk_fast4(jd, plan, np.asarray(jf), s1, s2))
    assert _value(tr.device_walk_fast4(td, plan, tf, s1, s2)) == want
    assert _value(tr.host_walk_fast4(td, plan, tf, s1, s2)) == want
    jb, jx, jy, jd, plan = jr.fill_modes(jax_pack(pairs), "local")
    tb_, tx, ty, td, _ = tr.fill_modes(pack_batch(pairs), "local")
    assert tr.device_walk_modes(td, plan, tx, ty, s1, s2, "local") == \
        jr.device_walk_modes(jd, plan, np.asarray(jx), np.asarray(jy), s1,
                             s2, "local")


@pytest.mark.parametrize("cigars,mode", [
    (False, "global"), (False, "semi"), (True, "global"), (True, "local"),
])
def test_stream_align_matches_jax(cigars, mode):
    """Scores-only and cigars streams, over 2 batches of byte pairs (the
    second ragged), on the device and host walk routes."""
    pairs = _pairs(19, 13, b"ACGTN")
    kw = dict(batch_size=8, cigars=cigars, mode=mode)
    want = _collect(jax_stream, pairs, JaxRunner(backend="lax", np_slots=2),
                    **kw)
    for route in ("device", "host"):
        got = _collect(stream_align, pairs,
                       DataParallelRunner(CPU8, np_slots=2, traceback=route),
                       **kw)
        assert got[0] == want[0] == 13
        assert sorted(got[1]) == sorted(want[1]) == [0, 1]
        for i in want[1]:
            if cigars:
                assert got[1][i] == want[1][i], (route, i)
            else:
                np.testing.assert_array_equal(got[1][i], want[1][i])


def test_stream_align_prepacked_batches_match_jax():
    """PairBatch and WireBatch input (scores only)."""
    pairs = _pairs(23, 16, b"ACGTN")
    q = [np.frombuffer(p[0], np.uint8) for p in pairs]
    d = [np.frombuffer(p[1], np.uint8) for p in pairs]

    def mat(rows):
        out = np.full((len(rows), 32), ord("A"), np.uint8)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out, np.asarray([len(r) for r in rows], np.int32)

    (qm, ql), (dm, dl) = mat(q), mat(d)
    halves = (slice(0, 8), slice(8, 16))
    port_in = [pack_batch(pairs[h]) for h in halves]
    jax_in = [jax_pack(pairs[h]) for h in halves]
    port_wire = [pack_wire(qm[h], dm[h], ql[h], dl[h]) for h in halves]
    jax_wire = [jax_pack_wire(qm[h], dm[h], ql[h], dl[h]) for h in halves]
    for mine, theirs in ((port_in, jax_in), (port_wire, jax_wire)):
        want = _collect(jax_stream, theirs, JaxRunner(backend="lax"))
        got = _collect(stream_align, mine, DataParallelRunner(CPU8))
        assert got[0] == want[0] == 16
        for i in (0, 1):
            np.testing.assert_array_equal(got[1][i], want[1][i])


def test_stream_checkpoint_resume_matches_jax(tmp_path):
    """A cigars stream that fails in batch 1's drain resumes from its
    checkpoint and re-delivers only the batches that did not complete,
    byte-equal to an uninterrupted run and to the JAX stream; a checkpoint
    refuses other alignment semantics."""
    pairs = _pairs(101, 24)
    runner = DataParallelRunner(CPU8, traceback="device")
    want = _collect(jax_stream, pairs, JaxRunner(backend="lax"),
                    batch_size=8, cigars=True)
    ckpt = str(tmp_path / "c.json")
    seen = {}

    def boom(i, t):
        seen[i] = _value(t)
        if i == 1:
            raise RuntimeError("simulated crash")

    with pytest.raises(RuntimeError, match="simulated crash"):
        stream_align(pairs, runner, batch_size=8, cigars=True,
                     checkpoint_path=ckpt, on_alignments=boom)
    with open(ckpt) as f:
        assert json.load(f) == {"next_batch": 1, "mode": "global",
                                "cigars": True}
    n, resumed = _collect(stream_align, pairs, runner, batch_size=8,
                          cigars=True, checkpoint_path=ckpt)
    assert n == 16 and sorted(resumed) == [1, 2]
    assert seen[0] == want[1][0]
    for i, t in resumed.items():
        assert t == want[1][i], i
    for kw in ({"mode": "local", "cigars": True}, {"cigars": False}):
        with pytest.raises(ValueError, match="mix alignment semantics"):
            stream_align(pairs, runner, batch_size=8, checkpoint_path=ckpt,
                         **kw)


def test_stream_first_batch_index_matches_jax(tmp_path):
    """The reader seeks past completed input and declares the stream's
    first batch index: numbering, callbacks and the checkpoint cursor line
    up with the full run."""
    pairs = _pairs(13, 16)
    want = _collect(jax_stream, pairs[8:], JaxRunner(backend="lax",
                                                     np_slots=1),
                    batch_size=4, first_batch_index=2)
    ckpt = str(tmp_path / "c.json")
    got = _collect(stream_align, pairs[8:],
                   DataParallelRunner(CPU8, np_slots=1), batch_size=4,
                   first_batch_index=2, checkpoint_path=ckpt)
    assert got[0] == want[0] == 8
    assert sorted(got[1]) == sorted(want[1]) == [2, 3]
    for i in (2, 3):
        np.testing.assert_array_equal(got[1][i], want[1][i])
    with open(ckpt) as f:
        assert json.load(f)["next_batch"] == 4


def test_failed_drain_stops_dispatch_unlike_jax(monkeypatch):
    """A drain that fails stops the stream before the next dispatch.  This
    is a named divergence from the reference, whose stream loop
    (parallel/streaming.py:303 in the JAX package) still dispatches one
    more batch after a failed drain: with one batch in flight and batch
    0's callback raising, the JAX stream dispatches 2 batches, the port 1."""
    pairs = _pairs(29, 40)
    counts = {}

    def count(runner, name, key):
        real = getattr(runner, name)

        def counting(*args, **kwargs):
            counts[key] = counts.get(key, 0) + 1
            return real(*args, **kwargs)

        monkeypatch.setattr(runner, name, counting)

    def boom(i, scores):
        raise RuntimeError("drain failed")

    jr = JaxRunner(backend="lax", np_slots=1)
    tr = DataParallelRunner(CPU8, np_slots=1)
    count(jr, "scores_from_stream_args", "jax")
    count(tr, "scores_from_stream_args", "port")
    for stream, runner in ((jax_stream, jr), (stream_align, tr)):
        with pytest.raises(RuntimeError, match="drain failed"):
            stream(iter(pairs), runner, batch_size=8, max_in_flight=1,
                   on_result=boom)
    assert counts == {"jax": 2, "port": 1}


def test_stream_threads_stop_after_a_failure():
    """After a failed stream no pipeline thread of it stays alive."""
    import threading

    before = set(threading.enumerate())

    def boom(i, scores):
        raise RuntimeError("drain failed")

    with pytest.raises(RuntimeError, match="drain failed"):
        stream_align(iter(_pairs(31, 64)), DataParallelRunner(["cpu"]),
                     batch_size=8, max_in_flight=1, on_result=boom)
    assert set(threading.enumerate()) - before == set()


def test_runner_refuses_int16_state_and_unknown_knobs():
    """int16 state is ported: the runner with state_dtype "i16" or "auto"
    gives the JAX runner's int16 scores; unknown knobs still raise."""
    batch = pack_batch(_pairs(73, 16), batch_size=16)
    want = np.asarray(JaxRunner(backend="lax", kernel="stream",
                                state_dtype="auto").scores(batch))
    for st in ("i16", "auto"):
        got = DataParallelRunner(CPU8, state_dtype=st).scores(batch)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="stream state"):
        DataParallelRunner(CPU8, state_dtype="int8")
    with pytest.raises(ValueError, match="kernel"):
        DataParallelRunner(CPU8, kernel="tiled")
    with pytest.raises(ValueError, match="traceback"):
        DataParallelRunner(CPU8, traceback="tpu")
    with pytest.raises(ValueError, match="fill_modes requires"):
        DataParallelRunner(CPU8, kernel="plain").fill_modes(
            pack_batch(_pairs(1, 4)), "semi")
    assert streaming.process_count() == 1

@pytest.mark.parametrize("mode", ["global", "semi", "local"])
def test_runner_int16_fused_routes_match_jax(mode):
    """The runner with state_dtype "i16" (resolved on each batch's plan)
    against the JAX runner with the same knob: the fused fill-and-walk
    routes give the same finals or end cells and the same walked
    alignments, and so does the port's int32 runner."""
    pairs = _pairs(88, 40, b"ACGTN")
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    jr = JaxRunner(backend="lax", np_slots=2, traceback="device",
                   state_dtype="i16")
    ja, plan, jb, jn = jr._stream_args(jax_pack(pairs))
    got = {}
    for st in ("i16", "i32"):
        tr = DataParallelRunner(CPU8, np_slots=2, traceback="device",
                                state_dtype=st)
        ta, tplan, tb_, tn = tr._stream_args(pack_batch(pairs))
        assert tplan == plan
        if mode == "global":
            assert tr.stream_state(plan) == (torch.int16 if st == "i16"
                                             else torch.int32)
            tf, th = tr.fill_walk_from_stream_args(ta, plan, tb_, tn, s1, s2)
            got[st] = (to_host(tf)[:len(pairs)].max(axis=1).tolist(),
                       _value(tr.device_walk_fast4_finish(th, tf, s1, s2)))
        else:
            to = tr.fill_walk_modes_from_stream_args(ta, plan, tb_, tn, mode)
            got[st] = ([to_host(t).tolist() for t in to[:3]],
                       tr.device_walk_modes_finish(to[3], s1, s2))
    if mode == "global":
        jf, jh = jr.fill_walk_from_stream_args(ja, plan, jb, jn, s1, s2)
        want = (np.asarray(jf)[:len(pairs)].max(axis=1).tolist(),
                _value(jr.device_walk_fast4_finish(jh, jf, s1, s2)))
    else:
        jo = jr.fill_walk_modes_from_stream_args(ja, plan, jb, jn, mode)
        want = ([np.asarray(t).tolist() for t in jo[:3]],
                jr.device_walk_modes_finish(jo[3], s1, s2))
    assert got["i16"] == want
    assert got["i32"] == want

"""PyTorch port's GotohAligner vs the JAX package's on the same records
(exact: scores, alignments, CIGARs and per-pair errors must be equal)."""

import dataclasses

import numpy as np
import pytest
import torch

from sequencealigning_tpu import config as jax_config
from sequencealigning_tpu.models.banded import BandedAligner as JaxBanded
from sequencealigning_tpu.models.gotoh import GotohAligner as JaxGotoh
from sequencealigning_tpu_torch.config import AlignConfig, Algo, Mode
from sequencealigning_tpu_torch.io.fasta import Record
from sequencealigning_tpu_torch.models import (
    BandedAligner,
    GotohAligner,
    get_aligner,
)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test's plain torch ops: the suite runs
    several workers on the machine's cores, and wide per-step ops across
    threads that other workers hold stall at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(config):
    """The JAX package's AlignConfig with the port config's values (the
    two packages' classes and enums are distinct; compare by value)."""
    kw = {f.name: getattr(config, f.name)
          for f in dataclasses.fields(config)}
    kw["algo"] = jax_config.Algo(config.algo.value)
    kw["mode"] = jax_config.Mode(config.mode.value)
    for name, cls in (("scoring", jax_config.ScoringScheme),
                      ("wfa_penalties", jax_config.WfaPenalties),
                      ("wfa_pruning", jax_config.WfaPruning)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return jax_config.AlignConfig(**kw)


def _records(seed, n=13, hi=60):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
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
    return recs


def _view(results):
    return [
        (r.query_name, r.db_name, r.score, r.aligned_query, r.aligned_db,
         r.alignments, str(r.cigar), r.error)
        for r in results
    ]


@pytest.mark.parametrize("first_only", [True, False])
@pytest.mark.parametrize("compat", [True, False])
def test_port_aligner_matches_jax(compat, first_only):
    recs = _records(5 + compat + 2 * first_only)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, compat=compat,
                         first_only=first_only)
    port = GotohAligner(config, device="cpu")
    got = port.align_batch(recs)
    assert _view(got) == _view(JaxGotoh(_jax(config)).align_batch(recs))
    # Compat co-optimal walks may hit the reference's boundary-chain panic,
    # a per-pair error in both packages.
    assert sum(r.ok for r in got) >= len(recs) - 2
    assert port.host_fallbacks == 0


def test_compat_local_mode_is_per_pair_not_implemented():
    recs = _records(9, n=4)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.LOCAL)
    got = get_aligner(config, "cpu").align_batch(recs)
    assert _view(got) == _view(JaxGotoh(_jax(config)).align_batch(recs))
    assert [r.error for r in got] == ["not implemented"] * 4


def test_unported_routes_raise():
    """int16 stream state is ported: textbook local's streamed route and
    the global path with stream_state "i16" or "auto" answer as the JAX
    aligner with the same knob (and as int32), and an uncertified "i16"
    scheme x shape raises ValueError naming int16, as in the JAX package.
    (Every algorithm has
    an aligner since WFA was ported: tests/test_torch_models_wfa.py.)"""
    from sequencealigning_tpu_torch.config import ScoringScheme

    recs = _records(1, n=32)
    for st in ("i16", "auto"):
        for config in (
            AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.LOCAL,
                        compat=False, stream_state=st),
            AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, stream_state=st),
            AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, stream_state=st,
                        first_only=True),
        ):
            sub = recs if config.mode is Mode.LOCAL else recs[:4]
            got = _view(get_aligner(config, "cpu").align_batch(sub))
            assert got == _view(JaxGotoh(_jax(config)).align_batch(sub))
            i32 = dataclasses.replace(config, stream_state="i32")
            assert got == _view(get_aligner(i32, "cpu").align_batch(sub))
    big = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, stream_state="i16",
                      scoring=ScoringScheme(match_=5, mismatch=-400,
                                            gap_open=-800, gap_extend=-600))
    with pytest.raises(ValueError, match="int16"):
        get_aligner(big, "cpu").align_batch(recs[:4])


def _drop_walk_of_pair_2(monkeypatch, gotoh_mod):
    real = gotoh_mod.fast4_stream_align_device

    def drop_pair_2(*args, **kwargs):
        alns, scores = real(*args, **kwargs)
        alns[2] = None
        return alns, scores

    monkeypatch.setattr(gotoh_mod, "fast4_stream_align_device", drop_pair_2)


def test_failed_device_walk_is_rewalked_on_host(monkeypatch):
    """On the CPU (the device walk route forced: "auto" walks there on
    the host), a pair whose walk fails validation is re-walked on the host
    from its dirs row, counted in host_fallbacks, with the same result."""
    import sequencealigning_tpu_torch.models.gotoh as gotoh_mod

    recs = _records(21, n=6)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True,
                         traceback="device")
    want = _view(GotohAligner(config, device="cpu").align_batch(recs))
    _drop_walk_of_pair_2(monkeypatch, gotoh_mod)
    port = GotohAligner(config, device="cpu")
    assert _view(port.align_batch(recs)) == want
    assert port.host_fallbacks == 1


def _runner_on_cpu(monkeypatch):
    """A CUDA aligner's first-only batches take the data-parallel runner's
    fill+walk; with no card here the runner is built as the aligner builds
    it, on the CPU."""
    import torch

    real = GotohAligner._dp_runner

    def on_cpu(self):
        device, self.device = self.device, torch.device("cpu")
        try:
            return real(self)
        finally:
            self.device = device

    monkeypatch.setattr(GotohAligner, "_dp_runner", on_cpu)


def test_failed_cuda_walk_is_a_pair_error_not_a_host_walk(monkeypatch):
    """On a CUDA aligner (first-only batches through the runner's
    fill+walk) a failed device walk becomes that pair's error; the host
    never re-walks it.  The tensors stay on the CPU here (no card): the
    aligner's device says cuda and the runner's dirs report is_cuda (the
    plain walk walks them)."""
    import torch

    import sequencealigning_tpu_torch.parallel.runner as runner_mod
    from sequencealigning_tpu_torch.parallel import DataParallelRunner

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    recs = _records(21, n=6)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True)
    want = _view(GotohAligner(config, device="cpu").align_batch(recs))
    real_fill = DataParallelRunner._stream_fill_body
    real_walk = runner_mod.walk_fast4
    real_decode = runner_mod.decode_packed_alignments

    def fill(self, *args, **kwargs):
        finals, dirs = real_fill(self, *args, **kwargs)
        return finals, dirs.as_subclass(OnCard)

    def decode_dropping_pair_2(*args, **kwargs):
        alns = real_decode(*args, **kwargs)
        alns[2] = None
        return alns

    monkeypatch.setattr(DataParallelRunner, "_stream_fill_body", fill)
    monkeypatch.setattr(runner_mod, "walk_fast4", lambda dirs, *a, **k:
                        real_walk(dirs.as_subclass(torch.Tensor), *a, **k))
    monkeypatch.setattr(runner_mod, "decode_packed_alignments",
                        decode_dropping_pair_2)
    monkeypatch.setattr(GotohAligner, "_dirs_budget",
                        lambda self: self.dirs_host_budget)
    _runner_on_cpu(monkeypatch)
    port = GotohAligner(config, device="cpu")
    port.device = torch.device("cuda")
    got = _view(port.align_batch(recs))
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert got[2][2:6] == (None,) * 4
    assert "walk_fast4_cuda" in got[2][7]
    assert port.host_fallbacks == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_lane_ceilings(monkeypatch, device):
    """Below long_pair_lanes an aligner on either device takes every width
    (the CUDA fills split a row over a cluster past 8192 lanes) and matches
    the JAX aligner; past it the batch takes the long-pair path and still
    matches the JAX aligner (no refusal).  The tensors stay on the CPU here:
    only the aligner's device says cuda."""
    import torch

    import sequencealigning_tpu_torch.models.gotoh as gotoh_mod
    import sequencealigning_tpu_torch.ops.nw_affine_tiled as tiled_mod

    recs = _records(3, n=3, hi=120)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True)
    real_to_device = gotoh_mod.to_device
    for mod in (gotoh_mod, tiled_mod):
        monkeypatch.setattr(mod, "to_device",
                            lambda batch, dev: real_to_device(batch, "cpu"))
    monkeypatch.setattr(GotohAligner, "_dirs_budget",
                        lambda self, host_fetch=None: self.dirs_host_budget)
    _runner_on_cpu(monkeypatch)
    port = GotohAligner(config, device="cpu")
    port.device = torch.device(device)
    want = _view(JaxGotoh(_jax(config)).align_batch(recs))
    assert _view(port.align_batch(recs)) == want
    assert port.host_fallbacks == 0
    for cls in (GotohAligner, JaxGotoh):
        monkeypatch.setattr(cls, "long_pair_lanes", 64)
    want = _view(JaxGotoh(_jax(config)).align_batch(recs))
    assert _view(port.align_batch(recs)) == want
    assert all(r[7] is None for r in want)


def _long_records(seed, n, length=200, indel=5):
    """n near-identical pairs of ~length bp (a substitution every 17 bp, a
    deletion of `indel` bp in the db), as tests/test_nw_tiled.py's
    long-pair case."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(n):
        s1 = rng.choice(alpha, length - 7 * i)
        s2 = s1.copy()
        s2[::17] = rng.choice(alpha, len(s2[::17]))
        s2 = np.delete(s2, np.arange(50, 50 + indel))
        recs.append((Record(seq=s1.tobytes(), name=b">q%d" % i),
                     Record(seq=s2.tobytes(), name=b">d%d" % i)))
    return recs


def _long_pair(monkeypatch, max_band=None):
    """Lower long_pair_lanes (and the band cap) on both packages."""
    for cls in (GotohAligner, JaxGotoh):
        monkeypatch.setattr(cls, "long_pair_lanes", 64)
        if max_band is not None:
            monkeypatch.setattr(cls, "long_pair_max_band", max_band)


@pytest.mark.parametrize("first_only", [True, False])
@pytest.mark.parametrize("compat", [True, False])
def test_long_path_band_doubling_matches_jax(monkeypatch, compat,
                                             first_only):
    """The long-pair path (tiled exact scores, banded fills doubling from
    band 128 until each banded score equals the exact one): scores,
    strings, CIGARs and errors equal the JAX aligner's; one pair needs a
    band past 128 (a 150 bp deletion)."""
    recs = _long_records(43 + compat, 3)
    rng = np.random.default_rng(5)
    s1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), 420)
    recs.append((Record(seq=s1.tobytes(), name=b">qi"),
                 Record(seq=np.delete(s1, np.arange(100, 250)).tobytes(),
                        name=b">di")))
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, compat=compat,
                         first_only=first_only)
    _long_pair(monkeypatch)
    got = GotohAligner(config, "cpu").align_batch(recs)
    assert _view(got) == _view(JaxGotoh(_jax(config)).align_batch(recs))
    assert all(r.ok and r.aligned_query is not None for r in got)


@pytest.mark.parametrize("compat", [True, False])
def test_long_path_myers_miller_escape_matches_jax(monkeypatch, compat):
    """With the band cap at 2 the optimum (a 60 bp gap) escapes every band:
    Myers-Miller recovers the alignment (compat: rescored with the leading
    chain's extra extension) exactly as the JAX aligner does."""
    recs = [(Record(seq=b"G" * 60 + b"A" * 40, name=b">q"),
             Record(seq=b"A" * 40, name=b">d")),
            (Record(seq=b"ACGT" * 25, name=b">q2"),
             Record(seq=b"ACGT" * 10 + b"TTTT" * 5 + b"ACGT" * 12,
                    name=b">d2"))]
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, compat=compat)
    _long_pair(monkeypatch, max_band=2)
    got = GotohAligner(config, "cpu").align_batch(recs)
    assert _view(got) == _view(JaxGotoh(_jax(config)).align_batch(recs))
    assert got[0].ok and got[0].aligned_query is not None


@pytest.mark.parametrize("lens,route", [
    ([(90, 95), (100, 92), (88, 99)], "fold"),   # similar sizes: one launch
    ([(100, 100), (4, 3)], "single"),            # mixed: serial singles
    ([(70, 75)] * 6, "batch"),                   # 6 pairs: the batched fill
])
def test_long_batch_fold_routing(monkeypatch, lens, route):
    """The long path routes 1-4 similar-sized pairs to one folded fill,
    other batches under 6 pairs to serial singles, larger ones to the
    batched fill (tests/test_nw_tiled.py's routing cases), and matches the
    JAX aligner either way."""
    import sequencealigning_tpu_torch.models.gotoh as gotoh_mod

    calls = []
    for name, tag in (("nw_affine_tiled_fold_batch", "fold"),
                      ("nw_affine_tiled_single", "single"),
                      ("nw_affine_tiled_batch", "batch")):
        real = getattr(gotoh_mod, name)

        def spy(*args, _real=real, _tag=tag, **kwargs):
            calls.append(_tag)
            return _real(*args, **kwargs)

        monkeypatch.setattr(gotoh_mod, name, spy)
    rng = np.random.default_rng(51)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    recs = [(Record(seq=rng.choice(alpha, a).tobytes(), name=b">q"),
             Record(seq=rng.choice(alpha, b).tobytes(), name=b">d"))
            for a, b in lens]
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True)
    _long_pair(monkeypatch)
    got = GotohAligner(config, "cpu").align_batch(recs)
    assert calls == [route] * (len(lens) if route == "single" else 1)
    assert _view(got) == _view(JaxGotoh(_jax(config)).align_batch(recs))
    assert all(r.ok for r in got)


def test_long_path_failed_cuda_walk_is_a_pair_error(monkeypatch):
    """On a CUDA aligner the resolved pairs are walked by the banded device
    walk; a walk that fails validation is that pair's AlignmentError naming
    the kernel (here a CPU dirs tensor that reports is_cuda, walked by the
    plain walk), never a host re-walk."""
    import torch

    import sequencealigning_tpu_torch.models.gotoh as gotoh_mod
    import sequencealigning_tpu_torch.ops.nw_affine_tiled as tiled_mod
    import sequencealigning_tpu_torch.ops.traceback_device as tbd

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    recs = _long_records(7, 3)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True)
    _long_pair(monkeypatch)
    want = _view(GotohAligner(config, "cpu").align_batch(recs))
    real_walk = tbd.banded_diag_align_device
    real_fill = gotoh_mod.nw_banded_diag_batch
    real_to_device = gotoh_mod.to_device

    def drop_pair_1(dirs, *args, **kwargs):
        alns, scores = real_walk(dirs.as_subclass(torch.Tensor), *args,
                                 **kwargs)
        alns[1] = None
        return alns, scores

    def fill(*args, **kwargs):
        res = real_fill(*args, **kwargs)
        return res._replace(dirs=res.dirs.as_subclass(OnCard))

    monkeypatch.setattr(tbd, "banded_diag_align_device", drop_pair_1)
    monkeypatch.setattr(gotoh_mod, "nw_banded_diag_batch", fill)
    for mod in (gotoh_mod, tiled_mod):
        monkeypatch.setattr(mod, "to_device",
                            lambda batch, dev: real_to_device(batch, "cpu"))
    port = GotohAligner(config, "cpu")
    port.device = torch.device("cuda")
    got = _view(port.align_batch(recs))
    assert got[:1] + got[2:] == want[:1] + want[2:]
    assert got[1][2:5] == (None,) * 3
    assert "walk_banded_cuda" in got[1][7]


def _modes_records(seed, n):
    """Pairs for the textbook modes: local hits (a mutated slice of the
    query), unrelated pairs, and empty sequences on either side."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(1, 70)))
        s2 = rng.choice(alpha, int(rng.integers(1, 70)))
        if i % 3 == 1 and len(s1) > 8:
            s2 = s1[4: 4 + int(rng.integers(3, len(s1) - 3))].copy()
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        if i == 2:
            s1 = s1[:0]
        if i == 5:
            s2 = s2[:0]
        recs.append((Record(seq=s1.tobytes(), name=b">q%d" % i),
                     Record(seq=s2.tobytes(), name=b">d%d" % i)))
    return recs


@pytest.mark.parametrize("n", [8, 40])  # per-pair route / streamed route
@pytest.mark.parametrize("mode", [Mode.LOCAL, Mode.SEMI_GLOBAL])
def test_port_textbook_modes_match_jax(mode, n):
    """Textbook semi-global and local on the CPU: scores, aligned strings,
    CIGARs and errors equal the JAX aligner's, pair for pair, on both the
    per-pair (< 32 pairs) and the streamed route, empty pairs included."""
    recs = _modes_records(17 + n, n)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=mode, compat=False)
    port = GotohAligner(config, device="cpu")
    got = port.align_batch(recs)
    assert _view(got) == _view(JaxGotoh(_jax(config)).align_batch(recs))
    assert all(r.ok for r in got) and port.host_fallbacks == 0
    assert all(r.alignments is None for r in got)


def test_compat_semi_global_is_per_pair_not_implemented():
    recs = _records(9, n=4)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.SEMI_GLOBAL)
    got = get_aligner(config, "cpu").align_batch(recs)
    assert _view(got) == _view(JaxGotoh(_jax(config)).align_batch(recs))
    assert [r.error for r in got] == ["not implemented"] * 4


def _drop_modes_walk_of_pair_1(monkeypatch, gotoh_mod):
    real = gotoh_mod.modes_walk_device

    def drop(*args, **kwargs):
        walked = real(*args, **kwargs)
        walked[1] = None
        return walked

    monkeypatch.setattr(gotoh_mod, "modes_walk_device", drop)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_failed_modes_walk(monkeypatch, device):
    """A failed modes walk (the device walk route) is re-walked on the host
    on the CPU (counted in host_fallbacks, same result) and is that pair's
    AlignmentError naming the kernel on CUDA (the tensors stay on the CPU
    here: only the aligner's device says cuda)."""
    import torch

    import sequencealigning_tpu_torch.models.gotoh as gotoh_mod

    recs = _modes_records(3, 8)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.LOCAL,
                         compat=False, traceback="device")
    want = _view(GotohAligner(config, device="cpu").align_batch(recs))
    _drop_modes_walk_of_pair_1(monkeypatch, gotoh_mod)
    real_to_device = gotoh_mod.to_device
    monkeypatch.setattr(gotoh_mod, "to_device",
                        lambda batch, dev: real_to_device(batch, "cpu"))
    monkeypatch.setattr(GotohAligner, "_dirs_budget",
                        lambda self, host_fetch=None: self.dirs_host_budget)
    port = GotohAligner(config, device="cpu")
    port.device = torch.device(device)
    got = _view(port.align_batch(recs))
    if device == "cpu":
        assert got == want and port.host_fallbacks == 1
    else:
        assert got[:1] + got[2:] == want[:1] + want[2:]
        assert got[1][2:5] == (None,) * 3
        assert "walk_modes_cuda" in got[1][7]
        assert port.host_fallbacks == 0


@pytest.mark.parametrize("n", [8, 40])
def test_modes_cuda_lane_ceiling(monkeypatch, n):
    """Textbook modes pairs of any width run on a CUDA aligner as on the
    CPU (no 8192-lane refusal is left; the tensors stay on the CPU here)."""
    import torch

    import sequencealigning_tpu_torch.models.gotoh as gotoh_mod

    recs = _modes_records(11, n)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.SEMI_GLOBAL,
                         compat=False)
    monkeypatch.setattr(GotohAligner, "_dirs_budget",
                        lambda self, host_fetch=None: self.dirs_host_budget)
    real_to_device = gotoh_mod.to_device
    monkeypatch.setattr(gotoh_mod, "to_device",
                        lambda batch, dev: real_to_device(batch, "cpu"))
    port = GotohAligner(config, device="cpu")
    want = _view(port.align_batch(recs))
    assert all(r[7] is None for r in want)
    port.device = torch.device("cuda")
    assert _view(port.align_batch(recs)) == want


def test_modes_chunked_drain_equals_unchunked(monkeypatch):
    """A modes batch over the dirs budget fills in drained sub-batches with
    identical results."""
    recs = _modes_records(23, 12)
    config = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.SEMI_GLOBAL,
                         compat=False)
    want = _view(GotohAligner(config, device="cpu").align_batch(recs))
    monkeypatch.setattr(GotohAligner, "dirs_host_budget", 200_000)
    port = GotohAligner(config, device="cpu")
    from sequencealigning_tpu_torch.io.encode import pack_batch

    batch = pack_batch([(q.seq, d.seq) for q, d in recs], batch_size=16)
    assert port._dirs_chunks(batch, 12, per_byte=1.0) > 1
    assert _view(port.align_batch(recs)) == want


# ---------------------------------------------------------------------------
# Banded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first_only", [True, False])
@pytest.mark.parametrize("compat", [True, False])
def test_port_banded_aligner_matches_jax(compat, first_only):
    """BandedAligner on the CPU against the JAX BandedAligner: scores,
    alignments, CIGARs and per-pair errors, N-wildcard pairs and length
    differences near the band included; get_aligner routes -a banded."""
    recs = _records(31 + compat + 2 * first_only, n=11, hi=120)
    config = AlignConfig(algo=Algo.BANDED, compat=compat,
                         first_only=first_only, band=16)
    port = get_aligner(config, "cpu")
    assert isinstance(port, BandedAligner)
    got = port.align_batch(recs)
    assert _view(got) == _view(JaxBanded(_jax(config)).align_batch(recs))
    assert sum(r.ok for r in got) >= len(recs) - 2


def test_banded_local_is_per_pair_not_implemented():
    recs = _records(9, n=4)
    config = AlignConfig(algo=Algo.BANDED, mode=Mode.LOCAL, compat=False,
                         first_only=True)
    got = get_aligner(config, "cpu").align_batch(recs)
    assert _view(got) == _view(JaxBanded(_jax(config)).align_batch(recs))
    assert [r.error for r in got] == ["not implemented"] * 4


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_failed_banded_walk(monkeypatch, device):
    """A failed banded device walk is re-walked on the host when the dirs
    lie on the CPU (same result) and is that pair's AlignmentError naming
    the kernel when they lie on the card (here a CPU tensor that reports
    is_cuda, walked by the plain walk)."""
    import torch

    import sequencealigning_tpu_torch.models.banded as banded_mod
    import sequencealigning_tpu_torch.ops.traceback_device as tbd

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    recs = _records(13, n=6)
    config = AlignConfig(algo=Algo.BANDED, first_only=True, band=32)
    want = _view(BandedAligner(config, device="cpu").align_batch(recs))
    real = tbd.banded_diag_align_device
    real_fill = banded_mod.nw_banded_diag_batch

    def drop_pair_2(dirs, *args, **kwargs):
        alns, scores = real(dirs.as_subclass(torch.Tensor), *args, **kwargs)
        alns[2] = None
        return alns, scores

    def fill(*args, **kwargs):
        res = real_fill(*args, **kwargs)
        if device == "cuda":
            res = res._replace(dirs=res.dirs.as_subclass(OnCard))
        return res

    monkeypatch.setattr(tbd, "banded_diag_align_device", drop_pair_2)
    monkeypatch.setattr(banded_mod, "nw_banded_diag_batch", fill)
    got = _view(BandedAligner(config, device="cpu").align_batch(recs))
    if device == "cpu":
        assert got == want
    else:
        assert got[:2] + got[3:] == want[:2] + want[3:]
        assert got[2][2:5] == (None,) * 3
        assert "walk_banded_cuda" in got[2][7]


def test_banded_band_past_the_cuda_width_is_per_pair_error(monkeypatch,
                                                         one_thread):
    """On CUDA a band needing more than the former cluster's 131072 lanes
    is not refused: the fill's tiled route takes it in one launch and every
    pair aligns as on the CPU.  No card here: the kernel wrapper runs on
    CPU tensors that report is_cuda, and its library is the host build of
    the kernels' loops (csrc/host_check.cpp), whose banded fill runs the
    CUDA kernel's tile schedule."""
    import sequencealigning_tpu_torch.ops.nw_banded_diag as nbd

    recs = _records(17, n=3, hi=30)
    config = AlignConfig(algo=Algo.BANDED, first_only=True, band=131_100)
    want = _view(BandedAligner(config, "cpu").align_batch(recs))
    assert all(w[7] is None for w in want)
    calls = _fake_banded_kernel(monkeypatch)
    monkeypatch.setattr(nbd, "banded_diag_fill", nbd.banded_diag_fill_cuda)
    got = _view(BandedAligner(config, "cpu").align_batch(recs))
    assert got == want
    assert calls == ["sa_banded_fill"]
    assert nbd.banded_diag_fill_cuda.launches == 1
    assert nbd.banded_diag_fill_cuda.last_launch["strips"] > 100


def _fake_banded_kernel(monkeypatch):
    """Route the banded fill and walk wrappers to the host build of the
    kernels' loops, on CPU tensors that pass their device checks.  Returns
    the list of fill entries called."""
    import contextlib
    import types

    import torch

    import sequencealigning_tpu_torch.ops.nw_banded_diag as nbd
    from sequencealigning_tpu_torch import csrc

    host = csrc.host_check()
    calls = []

    class Lib:
        sa_sm_count = staticmethod(lambda: 132)
        sa_banded_resident_ctas = staticmethod(lambda *a: 16)

        @staticmethod
        def sa_banded_fill(*args):
            calls.append("sa_banded_fill")
            # minus lpt, threads, the grid and the stream
            return host.hc_banded_fill(*args[:-4])

        @staticmethod
        def sa_walk_banded(*args):
            return host.hc_walk_banded(*args[:-1])

    monkeypatch.setattr(csrc, "kernels", lambda: Lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(nbd.banded_diag_fill_cuda, "launches", 0)
    return calls


def test_banded_band_past_the_cuda_width_equals_jax(one_thread):
    """-a banded --band 131100 (L > 131072 lanes) on pairs of <= 30 bp:
    the port (CPU) gives the JAX BandedAligner's scores and strings."""
    recs = _records(19, n=4, hi=30)
    config = AlignConfig(algo=Algo.BANDED, band=131_100)
    got = _view(BandedAligner(config, "cpu").align_batch(recs))
    assert got == _view(JaxBanded(_jax(config)).align_batch(recs))
    assert all(g[7] is None for g in got)

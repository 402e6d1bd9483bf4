"""The banded fill's wide route (past a cluster's 131072 lanes: one launch a
wavefront, the lanes' state in device memory; csrc/nw_banded_diag.cu
band_wide_step) through its host build (csrc/host_check.cpp,
hc_banded_wide_fill, which runs the kernel's per-lane code
nw_banded_diag.cuh::band_wide_lane) against the plain fill, exact, at small
bands where it is forced; and the wrapper's routing to it."""

import contextlib
import types

import numpy as np
import pytest
import torch

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.ops import nw_banded_diag as port

_DIRS = {False: 0, "fast4": 1, "full": 2}
WILD = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the test's plain torch ops: the suite runs
    several workers on the machine's cores, and wide per-step ops across
    threads that other workers hold stall at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host():
    if csrc.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/host_check.cpp")
    return csrc.host_check()


def _inputs(seed, band, n=9, hi=90):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(0, hi)))
        s2 = rng.choice(alpha, int(rng.integers(1, hi)))
        if i % 2 and len(s1):
            s2 = np.resize(s1, len(s2)).copy()
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        pairs.append((s1.tobytes(), s2.tobytes()))
    batch = pack_batch(pairs, batch_size=16)
    return port.band_inputs(*to_device(batch, "cpu"), band)


def _host_wide(host, plan, ins, scheme, compat, wildcard, dirs_mode, model):
    B, L = ins[0].shape
    n_iters = ins[2].shape[1]
    finals = torch.zeros((B, 3), dtype=torch.int32)
    w = -(-2 * n_iters // (8 if dirs_mode == "fast4" else 4))
    dirs = torch.zeros((w, B, L), dtype=torch.uint32)
    rc = host.hc_banded_wide_fill(
        *(t.data_ptr() for t in ins), finals.data_ptr(), dirs.data_ptr(),
        B, L, n_iters, plan.he, plan.lane_limit(1), plan.lane_limit(0),
        scheme.match_, scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        _DIRS[dirs_mode], int(compat), int(wildcard), int(model == "std"),
    )
    assert rc == 0
    return finals, dirs


@pytest.mark.parametrize("model,compat,wildcard,dirs_mode,band", [
    ("ref", True, False, "fast4", 8),
    ("ref", True, True, "full", 40),
    ("ref", False, False, False, 16),
    ("ref", False, True, "fast4", 300),
    ("std", False, False, "fast4", 24),
    ("std", False, True, False, 24),
])
def test_host_wide_route_matches_plain(host, model, compat, wildcard,
                                       dirs_mode, band):
    scheme = WILD if wildcard else ScoringScheme()
    plan, ins = _inputs(band, band)
    want_f, want_d = port.banded_diag_fill_torch(
        *ins, plan, scheme, compat, wildcard, dirs_mode, model)
    got_f, got_d = _host_wide(host, plan, ins, scheme, compat, wildcard,
                              dirs_mode, model)
    assert torch.equal(got_f, want_f)
    if dirs_mode:
        assert torch.equal(got_d, want_d)


@pytest.fixture
def fake_card(host, monkeypatch):
    """banded_diag_fill_cuda on CPU tensors that pass its device check,
    with its library the host build.  Yields the list of entries called."""
    calls = []

    class Lib:
        sa_fill_ctas = staticmethod(host.hc_fill_ctas)

        @staticmethod
        def sa_banded_wide_fill(*args):
            calls.append("wide")
            # minus the scratch state (argument 8) and the stream
            return host.hc_banded_wide_fill(*args[:8], *args[9:-1])

        @staticmethod
        def sa_banded_fill(*args):
            calls.append("cluster")
            return host.hc_banded_fill(*args[:-1])

    monkeypatch.setattr(csrc, "kernels", lambda: Lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(port.banded_diag_fill_cuda, "launches", 0)
    monkeypatch.setattr(port.banded_wide_fill_cuda, "launches", 0)
    return calls


def test_wrapper_routes_wide_bands_and_forced_widths(fake_card):
    """Within a cluster's reach the wrapper takes the cluster entry (at its
    own or a forced CTA width); the wide route, given the band directly,
    gives the same finals and dirs as the plain fill.  Past the reach the
    wrapper takes the wide route itself and refuses a CTA width.  (The
    aligner through it: test_torch_models.py::
    test_banded_band_past_the_cuda_width_is_per_pair_error.)"""
    scheme = ScoringScheme()
    plan, ins = _inputs(5, 300)
    assert plan.L > 256
    a = (plan, scheme, True, False, "fast4")
    want = port.banded_diag_fill_torch(*ins, *a)
    for got in (port.banded_diag_fill_cuda(*ins, *a),
                port.banded_diag_fill_cuda(*ins, *a, cta_lanes=128),
                port.banded_wide_fill_cuda(*ins, *a)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert fake_card == ["cluster", "cluster", "wide"]
    assert port.banded_diag_fill_cuda.launches == 2
    assert port.banded_wide_fill_cuda.launches == 1
    wide = plan._replace(L=port.CUDA_BAND_LANES + 128)
    with pytest.raises(ValueError, match="no CTA width"):
        port.banded_diag_fill_cuda(*ins, wide, scheme, True, False, "fast4",
                                   cta_lanes=128)

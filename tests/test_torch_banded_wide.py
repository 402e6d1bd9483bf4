"""Bands past one strip on the banded fill's tiled route (csrc/
nw_banded_diag.cu: each pair's band in strips x blocks of iterations, the
tiles handed out by a global ticket), which since it replaced the cluster
split and the wide route (one launch a wavefront past 131072 lanes) takes
every band width: its host build (csrc/host_check.cpp, hc_banded_fill, the
kernel's tile schedule run serially in ticket order through
nw_banded_diag.cuh) against the plain fill, exact, at small bands forced
into many narrow tiles; and the wrapper's tiles and launches."""

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


def _host_tiled(host, plan, ins, scheme, compat, wildcard, dirs_mode, model,
                strip_lanes, block_iters):
    B, L = ins[0].shape
    n_iters = ins[2].shape[1]
    tiles = port.band_tiles(B, L, n_iters, 132, strip_lanes, block_iters)
    finals = torch.zeros((B, 3), dtype=torch.int32)
    w = -(-2 * n_iters // (8 if dirs_mode == "fast4" else 4))
    dirs = torch.zeros((w, B, L), dtype=torch.uint32)
    state = torch.zeros((2, B, L, 4), dtype=torch.int32)
    ctr = torch.zeros(2 + 8 * B + B * tiles.strips, dtype=torch.int32)
    rc = host.hc_banded_fill(
        *(t.data_ptr() for t in ins), finals.data_ptr(), dirs.data_ptr(),
        state.data_ptr(), ctr.data_ptr(), B, L, n_iters, plan.he,
        plan.lane_limit(1), plan.lane_limit(0), scheme.match_,
        scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        _DIRS[dirs_mode], int(compat), int(wildcard), int(model == "std"),
        tiles.strip_lanes, tiles.block_iters, 0,
    )
    assert rc == 0
    return finals, dirs, tiles


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
    """Each band forced into strips of 32 lanes in blocks of 8 iterations
    (4-24 strips a pair, 12-24 blocks, far more tiles than a grid of a few
    CTAs holds at once, as the bands past 131072 lanes have) equals the
    plain fill: finals and the whole dirs tensor."""
    scheme = WILD if wildcard else ScoringScheme()
    plan, ins = _inputs(band, band)
    want_f, want_d = port.banded_diag_fill_torch(
        *ins, plan, scheme, compat, wildcard, dirs_mode, model)
    got_f, got_d, tiles = _host_tiled(host, plan, ins, scheme, compat,
                                      wildcard, dirs_mode, model, 32, 8)
    assert tiles.strips >= 4 and tiles.rows >= 12
    assert torch.equal(got_f, want_f)
    if dirs_mode:
        assert torch.equal(got_d, want_d)


@pytest.fixture
def fake_card(host, monkeypatch):
    """banded_diag_fill_cuda on CPU tensors that pass its device check,
    with its library the host build (132 SMs, 16 resident CTAs).  Yields
    the list of entries called."""
    calls = []

    class Lib:
        sa_sm_count = staticmethod(lambda: 132)
        sa_banded_resident_ctas = staticmethod(lambda *a: 16)

        @staticmethod
        def sa_banded_fill(*args):
            calls.append("tiled")
            # minus lpt, threads, the grid and the stream
            return host.hc_banded_fill(*args[:-4])

    monkeypatch.setattr(csrc, "kernels", lambda: Lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(port.banded_diag_fill_cuda, "launches", 0)
    return calls


def test_wrapper_routes_wide_bands_and_forced_widths(fake_card):
    """The wrapper takes the one tiled entry at its own tiles and at forced
    strips and blocks, each equal to the plain fill (finals and dirs), one
    launch a call, its shape in last_launch (the grid at most the resident
    CTAs); a band past 131072 lanes (the former wide route's) is no
    different: strips of at most 512 lanes, one launch.  (The aligner
    through it: test_torch_models.py::
    test_banded_band_past_the_cuda_width_is_per_pair_error.)"""
    scheme = ScoringScheme()
    plan, ins = _inputs(5, 300)
    assert plan.L > 256
    a = (plan, scheme, True, False, "fast4")
    want = port.banded_diag_fill_torch(*ins, *a)
    shapes = []
    for kw in ({}, dict(strip_lanes=128), dict(strip_lanes=32,
                                               block_iters=4)):
        got = port.banded_diag_fill_cuda(*ins, *a, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        shapes.append(dict(port.banded_diag_fill_cuda.last_launch))
    assert fake_card == ["tiled"] * 3
    assert port.banded_diag_fill_cuda.launches == 3
    assert [s["strip_lanes"] for s in shapes] == [128, 128, 32]
    assert shapes[2]["block_iters"] == 4 and shapes[2]["tiles"] > 16
    assert all(s["ctas"] <= 16 for s in shapes)
    wide = port.band_tiles(16, 131_456, 1001, 132)
    assert wide.strip_lanes == 512 and wide.strips == 257
    port._check_tiles(wide, 131_456, 1001)

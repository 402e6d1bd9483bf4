"""The CUDA kernels' per-cell and per-step arithmetic (csrc/*.cuh), built
for the host through csrc/host_check.cpp, against the plain PyTorch
versions on the same small batches (exact), plus the kernel wrappers'
refusal of CPU tensors."""

import numpy as np
import pytest
import torch

from sequencealigning_tpu.config import ScoringScheme
from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.ops import nw_affine_stream as fill
from sequencealigning_tpu_torch.ops import traceback_device as walk

_DIRS = {None: 0, "fast4": 1, "full": 2}


@pytest.fixture(scope="module")
def host():
    if csrc.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/host_check.cpp")
    return csrc.host_check()


def _stream(seed, n=21, np_slots=3, scheme=ScoringScheme()):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = [
        (rng.choice(alpha, int(rng.integers(1, 90))).tobytes(),
         rng.choice(alpha, int(rng.integers(1, 90))).tobytes())
        for _ in range(n)
    ]
    batch = trim_for_stream(pack_batch(pairs, batch_size=24))
    plan = fill.plan_stream(24, batch.query.shape[1], batch.db.shape[1],
                            np_slots=np_slots)
    tb = to_device(batch, "cpu")
    qs, ds, dsy, n2y, _, _ = fill.build_stream_inputs(
        tb.query, tb.db, tb.query_len, tb.db_len, plan
    )
    NP = plan.np_slots
    return pairs, plan, qs, ds, dsy[:NP, :, 0].contiguous(), \
        n2y[:NP, :, 0].contiguous()


def _host_fill(host, plan, qs, ds, dsum, n2, scheme, compat, wildcard,
               dirs_mode):
    R, P, NP = plan.n_rows, plan.p, plan.np_slots
    finals = torch.zeros((R * NP, 3), dtype=torch.int32)
    upack = 8 if dirs_mode == "fast4" else 4
    dirs = torch.zeros((plan.t_total // upack, R, P), dtype=torch.uint32)
    rc = host.hc_stream_fill(
        qs.data_ptr(), ds.data_ptr(), dsum.data_ptr(), n2.data_ptr(),
        finals.data_ptr(), dirs.data_ptr(), R, plan.t_total, P, plan.s, NP,
        scheme.match_, scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        _DIRS[dirs_mode], int(compat), int(wildcard),
    )
    assert rc == 0
    return finals, dirs


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("dirs_mode", [None, "fast4", "full"])
@pytest.mark.parametrize("compat", [True, False])
def test_host_fill_matches_plain(host, compat, dirs_mode, wildcard):
    scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2) \
        if wildcard else ScoringScheme()
    _, plan, qs, ds, dsum, n2 = _stream(17 + compat)
    finals, dirs = _host_fill(host, plan, qs, ds, dsum, n2, scheme, compat,
                              wildcard, dirs_mode)
    want_f, want_d = fill.gotoh_fill_stream_torch(
        qs, ds, dsum, n2, plan, scheme, compat, wildcard, dirs_mode
    )
    np.testing.assert_array_equal(finals.numpy(), want_f.numpy())
    if dirs_mode:
        np.testing.assert_array_equal(dirs.numpy(), want_d.numpy())


@pytest.mark.parametrize("compat", [True, False])
def test_host_walk_matches_plain(host, compat):
    pairs, plan, qs, ds, dsum, n2 = _stream(29 + compat)
    finals, dirs = fill.gotoh_fill_stream_torch(
        qs, ds, dsum, n2, plan, ScoringScheme(), compat, False, "fast4"
    )
    B = len(pairs)
    bs = np.arange(B)
    seeds = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
        [len(b) for _, b in pairs], [len(a) for a, _ in pairs],
        walk.seed_planes(finals.numpy()[:B]),
        bs // plan.np_slots, (bs % plan.np_slots) * plan.s,
    )]
    t_steps = plan.l1 + plan.l2
    want = walk.walk_fast4_torch(dirs, *seeds, t_steps=t_steps)
    W = walk.packed_width(t_steps)
    packed = torch.empty((B, W), dtype=torch.uint32)
    xf, yf, n_ops = (torch.empty(B, dtype=torch.int32) for _ in range(3))
    rc = host.hc_walk_fast4(
        dirs.data_ptr(), plan.n_rows, plan.p,
        *(s.data_ptr() for s in seeds), B, W,
        packed.data_ptr(), xf.data_ptr(), yf.data_ptr(), n_ops.data_ptr(),
    )
    assert rc == 0
    for got, exp in zip((xf, yf, packed, n_ops), want):
        np.testing.assert_array_equal(got.numpy(), exp.numpy())
    assert (n_ops > 0).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    _, plan, qs, ds, dsum, n2 = _stream(3)
    with pytest.raises(ValueError, match="CUDA"):
        fill.gotoh_fill_stream_cuda(qs, ds, dsum, n2, plan, ScoringScheme(),
                                    True, False, "fast4")
    dirs = torch.zeros((plan.t_total // 8, plan.n_rows, plan.p),
                       dtype=torch.uint32)
    seed = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        walk.walk_fast4_cuda(dirs, seed, seed, seed, seed, seed, t_steps=8)
    assert fill.gotoh_fill_stream_cuda.launches == 0
    assert walk.walk_fast4_cuda.launches == 0

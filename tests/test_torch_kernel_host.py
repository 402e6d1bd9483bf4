"""The CUDA kernels' per-cell and per-step arithmetic and loops (csrc/*.cuh
through csrc/host_check.cpp, built for the host) against the plain PyTorch
versions on the same small batches (exact): the global streamed fill and
fast4 walk, the per-pair and streamed modes fills and the modes walk (the
walks' staged schedule: sheared windows, batches, restagings and the slow
path, the warp's run found by a loop over its lanes), the
three fills with their rows split over 2-4 forced 128- or 256-lane CTAs
(the cluster split's geometry, cluster_split.cuh), the banded fill's tile
schedule run serially in ticket order (the rule's tiles, and forced narrow
strips in short blocks) and the banded walk, the tiled
fills' strip schedule run serially in ticket order with the carried column
in ring slots (kernels #4 and #5) and their DPX helpers,
the banded row sweep (kernel #8) with its scan carried across forced
narrow chunks, the linear fill in one block and split over 2 CTAs, and
the WFA wavefront fill (lanes a thread forced, bands past 1024 lanes) and
walk; plus the kernel wrappers' refusal of CPU tensors."""

import numpy as np
import pytest
import torch

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch, trim_for_stream
from sequencealigning_tpu_torch.ops import dirbits
from sequencealigning_tpu_torch.ops import nw_affine
from sequencealigning_tpu_torch.ops import nw_affine_modes as modes
from sequencealigning_tpu_torch.ops import nw_banded
from sequencealigning_tpu_torch.ops import nw_banded_diag as banded
from sequencealigning_tpu_torch.ops import nw_linear
from sequencealigning_tpu_torch.ops import nw_affine_stream as fill
from sequencealigning_tpu_torch.ops import nw_affine_stream_modes as smodes
from sequencealigning_tpu_torch.ops import nw_affine_tiled as tiled
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


def _ring_args(lpt=0, chunk=0, slots=0, wrap=0):
    """The warp rings' knobs as the kernels take them (0: the default)."""
    return (lpt, chunk, slots, wrap)


def _host_fill(host, plan, qs, ds, dsum, n2, scheme, compat, wildcard,
               dirs_mode, cta_lanes=0, rc_only=False, **ring):
    """hc_stream_fill (the kernel's warp-ring schedule run serially):
    (finals, dirs), or its return code with rc_only."""
    R, P, NP = plan.n_rows, plan.p, plan.np_slots
    finals = torch.zeros((R * NP, 3), dtype=torch.int32)
    upack = 8 if dirs_mode == "fast4" else 4
    dirs = torch.full((plan.t_total // upack, R, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    rc = host.hc_stream_fill(
        qs.data_ptr(), ds.data_ptr(), dsum.data_ptr(), n2.data_ptr(),
        finals.data_ptr(), dirs.data_ptr(), status.data_ptr(), R,
        plan.t_total, P, plan.s, NP, scheme.match_, scheme.mismatch,
        scheme.gap_open, scheme.gap_extend, _DIRS[dirs_mode], int(compat),
        int(wildcard), cta_lanes, *_ring_args(**ring),
    )
    if rc_only:
        return rc
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
    got = _host_fast4_walk(host, dirs, seeds, t_steps)
    for g, exp in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    assert (got[3] > 0).all()


def _host_fast4_walk(host, dirs, seeds, t_steps):
    """hc_walk_fast4 (the kernel's staged schedule run serially): (xf, yf,
    packed, n_ops, words read by the slow path, the ring's restagings)."""
    B = seeds[0].shape[0]
    W = walk.packed_width(t_steps)
    packed = torch.full((B, W), 0x5a5a5a5a, dtype=torch.uint32)
    xf, yf, n_ops = (torch.empty(B, dtype=torch.int32) for _ in range(3))
    slow = torch.zeros(2, dtype=torch.int64)
    rc = host.hc_walk_fast4(
        dirs.data_ptr(), *dirs.shape, *(s.data_ptr() for s in seeds), B, W,
        packed.data_ptr(), xf.data_ptr(), yf.data_ptr(), n_ops.data_ptr(),
        slow.data_ptr(),
    )
    assert rc == 0
    return xf, yf, packed, n_ops, int(slow[0]), int(slow[1])


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


# ---------------------------------------------------------------------------
# Textbook modes: kernels A (per-pair fill), B (streamed fill), C (walk)
# ---------------------------------------------------------------------------


def _modes_batch(seed, n, hi1, hi2):
    """A padded per-pair modes batch (pack_batch layout, no trim), lengths
    0..hi, a third of the db a mutated slice of the query."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(0, hi1 + 1)))
        s2 = rng.choice(alpha, int(rng.integers(0, hi2 + 1)))
        if i % 3 == 1 and len(s1) > 4:
            s2 = s1[2: 2 + min(hi2, len(s1) - 2)].copy()
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        pairs.append((s1.tobytes(), s2.tobytes()))
    batch = pack_batch(pairs, batch_size=-(-n // 8) * 8)
    return pairs, to_device(batch, "cpu")


def _host_modes_fill(host, seq1, s2v, n1, n2, l2, scheme, local, wildcard,
                     with_dirs, cta_lanes=0, lpt=0, chunk=0, slots=0):
    """hc_modes_fill (the kernel's warp-ring schedule run serially, the
    split planned for 132 SMs or forced): (bv, bd, dirs), the dirs tensor
    pre-filled with a pattern the kernel must overwrite."""
    B, P = s2v.shape
    D_total = seq1.shape[1] + l2 + 1
    out = torch.zeros((2, B, P), dtype=torch.int32)
    dirs = torch.full((-(-D_total // 4), B, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    rc = host.hc_modes_fill(
        seq1.data_ptr(), s2v.data_ptr(), n1.data_ptr(), n2.data_ptr(),
        out.data_ptr(), dirs.data_ptr(), B, seq1.shape[1], P, D_total,
        scheme.match_, scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        2 if with_dirs else 0, int(local), int(wildcard), cta_lanes,
        status.data_ptr(), lpt, chunk, slots,
    )
    assert rc == 0
    return out[0], out[1], dirs


def _assert_pair_dirs(got, want, n1s, n2s):
    """Kernel A's dirs against the plain version's: every cell 0 <= x <=
    n2, 0 <= y <= n1 of each pair equal, lane 0's D bits (which the plain
    roll takes from lane P-1) masked; every other byte 0."""
    W, B, P = got.shape
    g = got.numpy().view(np.uint8).reshape(W, B, P, 4)
    w = want.numpy().view(np.uint8).reshape(W, B, P, 4)
    d = np.arange(W)[:, None, None, None] * 4 + np.arange(4)
    x = np.arange(P)[None, None, :, None]
    n1 = np.asarray(n1s)[None, :, None, None]
    n2 = np.asarray(n2s)[None, :, None, None]
    valid = (x <= n2) & (d - x >= 0) & (d - x <= n1)
    keep = np.where(x == 0, 0xFF & ~(dirbits.DEXT | dirbits.DOPEN),
                    0xFF).astype(np.uint8)
    np.testing.assert_array_equal((g & keep)[valid], (w & keep)[valid])
    assert not g[~valid].any()


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("hi1,hi2", [(200, 30), (25, 140)])
def test_host_modes_fill_matches_plain(host, local, wildcard, hi1, hi2):
    """Kernel A's loop (the MODE cell and the per-lane argmax, a pair split
    over CTAs whose warps sweep only their own cells) against
    fill_modes_torch, skewed both ways: the argmax buffers equal, the dirs
    equal on each pair's cells and 0 elsewhere."""
    scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2) \
        if wildcard else ScoringScheme()
    _, tb = _modes_batch(5 + local + 2 * wildcard, 11, hi1, hi2)
    s2v = modes.modes_layout(tb.db)
    args = (tb.query, s2v, tb.query_len, tb.db_len)
    l1, l2 = tb.query.shape[1], tb.db.shape[1]
    want = modes.fill_modes_torch(*args, l1, l2, scheme, wildcard, local, True)
    got = _host_modes_fill(host, *args, l2, scheme, local, wildcard, True)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    _assert_pair_dirs(got[2], want[2], tb.query_len, tb.db_len)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("knobs", [
    dict(cta_lanes=128), dict(cta_lanes=128, lpt=2, chunk=5, slots=3),
    dict(lpt=8, chunk=1, slots=1), dict(cta_lanes=256, chunk=32, slots=2),
    dict(lpt=16, chunk=7), dict(cta_lanes=128, lpt=2, chunk=1, slots=64),
])
def test_host_modes_fill_split_matches_plain(host, local, knobs):
    """Kernel A forced into small CTAs (128-256 lanes), 2-16 lanes a
    thread, chunks of 1-32 steps and 1-64 slots, on ragged pairs up to 256
    bp (several warps a pair, so the warps' starting state from the
    triangle above the matrix is read by the row-0 cells' I bits)."""
    _, tb = _modes_batch(71 + local, 12, 256, 256)
    s2v = modes.modes_layout(tb.db)
    args = (tb.query, s2v, tb.query_len, tb.db_len)
    l1, l2 = tb.query.shape[1], tb.db.shape[1]
    scheme = ScoringScheme(match_=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    want = modes.fill_modes_torch(*args, l1, l2, scheme, True, local, True)
    got = _host_modes_fill(host, *args, l2, scheme, local, True, True,
                           **knobs)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    _assert_pair_dirs(got[2], want[2], tb.query_len, tb.db_len)
    bv, bd, _ = _host_modes_fill(host, *args, l2, scheme, local, True, False,
                                 **knobs)
    np.testing.assert_array_equal(bv.numpy(), want[0].numpy())
    np.testing.assert_array_equal(bd.numpy(), want[1].numpy())


@pytest.mark.parametrize("P,B,cta_lanes,lpt,want", [
    (2048, 31, 0, 0, (4, 192, 3)), (2048, 1, 0, 0, (2, 128, 8)),
    (2048, 16, 0, 0, (2, 192, 6)), (2048, 32, 0, 0, (4, 192, 3)),
    (2176, 31, 0, 0, (4, 192, 3)), (2176, 1, 0, 0, (2, 128, 9)),
    (128, 8, 0, 0, (2, 64, 1)), (16384, 31, 0, 0, (16, 352, 3)),
    (65536, 4, 0, 0, (8, 512, 16)), (2048, 1, 128, 2, (2, 64, 16)),
    (2048, 31, 2048, 0, (8, 256, 1)), (131072, 1, 8192, 0, (16, 512, 16)),
    (2176, 512, 0, 0, (4, 192, 3)), (2176, 4096, 0, 0, (4, 192, 3)),
    (2048, 64, 0, 0, (4, 192, 3)), (640, 4096, 0, 0, (2, 192, 2)),
    (384, 4096, 0, 0, (2, 192, 1)),
])
def test_modes_pair_plan(host, P, B, cta_lanes, lpt, want):
    """The per-pair fills' split: CTAs of 256 lanes, fewer a pair where B
    pairs would pass 3/4 of 132 SMs but three at least from 768 lanes a
    pair, two from 512 (at most 16, at most 8192 lanes a CTA), 2 lanes a
    thread where 256 threads hold the CTA's lanes."""
    got = modes.pair_launch_shape(host, P, B, cta_lanes, lpt, kernel="modes")
    assert (got["lanes_per_thread"], got["threads"], got["ctas"]) == want
    assert (got["chunk"], got["ring_slots"]) == (32, 2)


@pytest.mark.parametrize("P,B,cta_lanes,lpt,chunk,slots", [
    (2048, 1, 100, 0, 0, 0), (2048, 1, 128, 3, 0, 0), (2048, 1, 2048, 4, 0, 0),
    (2048, 1, 0, 0, 33, 0), (2048, 1, 0, 0, 16, 5), (200, 1, 0, 0, 0, 0),
    (262144, 1, 0, 0, 0, 0), (2048, 0, 0, 0, 0, 0),
])
def test_modes_pair_plan_refuses(host, P, B, cta_lanes, lpt, chunk, slots):
    """Out-of-range splits and rings raise in the wrapper."""
    with pytest.raises(ValueError, match="out of the CUDA modes"):
        modes.pair_launch_shape(host, P, B, cta_lanes, lpt, chunk, slots,
                                kernel="modes")


def _host_stream_modes(host, plan, qs, ds, dsum, n2, scheme, local, wildcard,
                       with_dirs, cta_lanes=0, **ring):
    R, P, NP = plan.n_rows, plan.p, plan.np_slots
    out = torch.empty((2, NP, R, P), dtype=torch.int32)
    out[0].fill_(modes.NEGBIG)
    out[1].zero_()
    dirs = torch.full((plan.t_total // 4, R, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    rc = host.hc_stream_modes_fill(
        qs.data_ptr(), ds.data_ptr(), dsum.data_ptr(), n2.data_ptr(),
        out.data_ptr(), dirs.data_ptr(), status.data_ptr(), R, plan.t_total,
        P, plan.s, NP, scheme.match_, scheme.mismatch, scheme.gap_open,
        scheme.gap_extend, 2 if with_dirs else 0, int(local), int(wildcard),
        cta_lanes, *_ring_args(**ring),
    )
    assert rc == 0
    return out[0], out[1], dirs


@pytest.mark.parametrize("with_dirs", [False, True])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("np_slots,hi1,hi2", [(3, 90, 90), (2, 200, 20)])
def test_host_stream_modes_fill_matches_plain(host, local, with_dirs,
                                              np_slots, hi1, hi2):
    """Kernel B's loop (one argmax register pair a lane, written at the
    lane's turnover) against gotoh_fill_stream_modes_torch, with 2-3 slots
    a row and a query longer than the lane width (S > P)."""
    _, tb = _modes_batch(31 + local, 13, hi1, hi2)
    plan, ins = fill.stream_inputs(*tb, np_slots=np_slots)
    mode = "local" if local else "semi"
    (bv, bd), dirs = smodes.gotoh_fill_stream_modes_torch(
        *ins, plan, ScoringScheme(), True, mode, with_dirs
    )
    got = _host_stream_modes(host, plan, *ins, ScoringScheme(), local, True,
                             with_dirs)
    np.testing.assert_array_equal(got[0].numpy(), bv.numpy())
    np.testing.assert_array_equal(got[1].numpy(), bd.numpy())
    if with_dirs:
        np.testing.assert_array_equal(got[2].numpy(), dirs.numpy())
    else:
        assert dirs is None


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_host_walk_modes_matches_plain(host, local, streamed):
    """Kernel C's staged schedule (walk_modes_staged) against
    walk_modes_torch on both dirs layouts, with a corrupted pair (broken
    status) and clipped out-of-range seeds."""
    pairs, tb = _modes_batch(47 + local + 2 * streamed, 16, 70, 70)
    mode = "local" if local else "semi"
    B = len(pairs)
    if streamed:
        res = smodes.nw_affine_stream_modes_batch(*tb, mode, np_slots=2)
        bs = np.arange(B)
        rowp = bs // res.plan.np_slots
        off = (bs % res.plan.np_slots) * res.plan.s
        t_steps = res.plan.l1 + res.plan.l2
    else:
        res = modes.nw_affine_modes_batch(*tb, local=local)
        rowp, off = np.arange(B), np.zeros(B)
        t_steps = tb.query.shape[1] + tb.db.shape[1]
    dirs = res.dirs.clone()
    dirs[:, int(rowp[3]), :] = 0  # pair 3's cells lose their H bits
    x0 = np.asarray(res.best_x[:B], np.int32)
    y0 = np.asarray(res.best_y[:B], np.int32)
    x0[5], y0[6] = 10 ** 6, -3  # out of the tensor: clipped, then broken
    seeds = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
             for a in (x0, y0, rowp, off)]
    want = walk.walk_modes_torch(dirs, *seeds, local, t_steps)
    got = _host_modes_walk(host, dirs, seeds, local, t_steps)
    for g, exp in zip(got[:5], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    st = got[2]
    hit = (rowp == rowp[3]) | np.isin(np.arange(B), (5, 6))
    assert (st.numpy()[[3, 6]] == 2).all()
    assert (st.numpy()[~hit] == 1).all()


def _host_modes_walk(host, dirs, seeds, local, t_steps):
    """hc_walk_modes (the kernel's staged schedule run serially): (xf, yf,
    st, packed, n_ops, words read by the slow path, the ring's
    restagings)."""
    B = seeds[0].shape[0]
    W = walk.packed_width(t_steps)
    packed = torch.full((B, W), 0x5a5a5a5a, dtype=torch.uint32)
    xf, yf, st, n_ops = (torch.empty(B, dtype=torch.int32) for _ in range(4))
    slow = torch.zeros(2, dtype=torch.int64)
    rc = host.hc_walk_modes(
        dirs.data_ptr(), *dirs.shape, *(s.data_ptr() for s in seeds), B, W,
        int(local), packed.data_ptr(), xf.data_ptr(), yf.data_ptr(),
        st.data_ptr(), n_ops.data_ptr(), slow.data_ptr(),
    )
    assert rc == 0
    return xf, yf, st, packed, n_ops, int(slow[0]), int(slow[1])


# ---------------------------------------------------------------------------
# The fast4 and modes walks' staged schedule (walk_fast4_staged /
# walk_modes_staged run serially by hc_walk_fast4 / hc_walk_modes)
# ---------------------------------------------------------------------------


def _gapped_pairs(seed, n, hi, long_gap=0):
    """n ragged pairs up to hi bp: a quarter identical, a quarter random,
    the rest mutated copies (substitutions, an insertion and a deletion of
    up to 12 bp, or of long_gap bp where given) inside random flanks."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(n):
        core = rng.choice(alpha, int(rng.integers(hi // 2, hi + 1)))
        if i % 4 == 0:
            pairs.append((core.tobytes(), core.tobytes()))
            continue
        if i % 4 == 1:
            other = rng.choice(alpha, int(rng.integers(1, hi + 1)))
            pairs.append((core.tobytes(), other.tobytes()))
            continue
        mut = core.copy()
        for _ in range(len(mut) // 40):
            mut[rng.integers(len(mut))] = rng.choice(alpha)
        g = long_gap or int(rng.integers(1, 13))
        at = int(rng.integers(1, len(mut) - 1))
        mut = np.concatenate([mut[:at], rng.choice(alpha, g), mut[at:]])
        at = int(rng.integers(1, len(mut) - g - 1))
        mut = np.concatenate([mut[:at], mut[at + g:]])
        flank = rng.choice(alpha, int(rng.integers(0, 20)))
        pairs.append((np.concatenate([flank, core]).tobytes(),
                      np.concatenate([mut, flank[: len(flank) // 2]])
                      .tobytes()))
    return pairs


def _shift_diagonals(dirs, per, shift):
    """A (W', R, P) dirs tensor holding dirs' codes `shift` anti-diagonals
    later (8 nibbles or 4 bytes a word): a pair read at off + shift there
    reads what it read at off here."""
    bits = 32 // per
    w = dirs.numpy().astype(np.uint64)
    codes = ((w[:, None] >> (bits * np.arange(per, dtype=np.uint64))[
        None, :, None, None]) & ((1 << bits) - 1))
    codes = codes.reshape(-1, *dirs.shape[1:])
    t = codes.shape[0] + shift
    out = np.zeros((-(-t // per) * per,) + codes.shape[1:], np.uint64)
    out[shift: shift + codes.shape[0]] = codes
    out = out.reshape(-1, per, *codes.shape[1:])
    words = (out << (bits * np.arange(per, dtype=np.uint64))[
        None, :, None, None]).sum(1)
    return torch.from_numpy(words.astype(np.uint32))


# Cheap gaps, so that the walks of _gapped_pairs' long indels take them.
_CHEAP_GAPS = ScoringScheme(match_=2, mismatch=-3, gap_open=-4, gap_extend=-1)


def _fast4_walk_case(seed, n=8, hi=600, long_gap=0, shift=0):
    """A streamed fast4 fill (2 slots a row) of _gapped_pairs (cheap gaps
    with long_gap), its dirs moved `shift` anti-diagonals, and its walk
    seeds."""
    pairs = _gapped_pairs(seed, n, hi, long_gap)
    tb = to_device(trim_for_stream(pack_batch(pairs, batch_size=8)), "cpu")
    plan, ins = fill.stream_inputs(*tb, np_slots=2)
    scheme = _CHEAP_GAPS if long_gap else ScoringScheme()
    finals, dirs = fill.gotoh_fill_stream_torch(*ins, plan, scheme, True,
                                                False, "fast4")
    if shift:
        dirs = _shift_diagonals(dirs, 8, shift)
    bs = np.arange(n)
    seeds = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
        [len(b) for _, b in pairs], [len(a) for a, _ in pairs],
        walk.seed_planes(finals.numpy()[:n]),
        bs // plan.np_slots, (bs % plan.np_slots) * plan.s + shift,
    )]
    return dirs, seeds, plan.l1 + plan.l2


@pytest.mark.parametrize("seed", [61, 62])
@pytest.mark.parametrize("shift", [0, 3, 5])
def test_host_staged_fast4_walk_matches_plain(host, shift, seed):
    """hc_walk_fast4 against walk_fast4_torch on walks of up to ~1200 steps
    (19 or more staged batches of 64 anti-diagonals), indels of up to 12
    bp, random pairs (long gaps, the ring restaged), identical pairs (M runs
    cut only by the ring's batches and min(x, y)), at offsets that are not
    multiples of 8."""
    dirs, seeds, t_steps = _fast4_walk_case(seed + shift, shift=shift)
    assert int(((seeds[0] + seeds[1] + seeds[4]) >> 6).max()) >= 19
    want = walk.walk_fast4_torch(dirs, *seeds, t_steps=t_steps)
    got = _host_fast4_walk(host, dirs, seeds, t_steps)
    for g, exp in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())


@pytest.mark.parametrize("gap", [40, 90])
def test_host_staged_fast4_walk_long_gaps_restage(host, gap):
    """Indels of 40 and 90 bp move the walk off the diagonal its windows
    were staged on: the ring is restaged from the walk's cell (counted)
    instead of a direct load a step, and the walk still equals
    walk_fast4_torch; identical pairs (one M run a pair, cut only by the
    ring's batches and min(x, y)) neither restage nor read by the slow
    path."""
    dirs, seeds, t_steps = _fast4_walk_case(7, n=8, hi=400, long_gap=gap)
    want = walk.walk_fast4_torch(dirs, *seeds, t_steps=t_steps)
    got = _host_fast4_walk(host, dirs, seeds, t_steps)
    for g, exp in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    assert got[5] > 0
    same = [torch.from_numpy(t.numpy()[::4].copy()) for t in seeds]
    got = _host_fast4_walk(host, dirs, same, t_steps)
    want = walk.walk_fast4_torch(dirs, *same, t_steps=t_steps)
    for g, exp in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    assert got[4] == 0 and got[5] == 0


def _modes_walk_case(seed, local, streamed, n=8, hi=500, long_gap=0,
                     shift=0):
    """A modes fill of _gapped_pairs (cheap gaps with long_gap), streamed
    (2 slots a row) or per pair (kernel #6's layout), its dirs moved
    `shift` anti-diagonals, and its walk seeds at the pairs' end cells."""
    pairs = _gapped_pairs(seed, n, hi, long_gap)
    tb = to_device(pack_batch(pairs, batch_size=8), "cpu")
    scheme = _CHEAP_GAPS if long_gap else ScoringScheme()
    if streamed:
        res = smodes.nw_affine_stream_modes_batch(
            *tb, "local" if local else "semi", scheme=scheme, np_slots=2)
        bs = np.arange(n)
        rowp = bs // res.plan.np_slots
        off = (bs % res.plan.np_slots) * res.plan.s
        t_steps = res.plan.l1 + res.plan.l2
    else:
        res = modes.nw_affine_modes_batch(*tb, local=local, scheme=scheme)
        rowp, off = np.arange(n), np.zeros(n)
        t_steps = tb.query.shape[1] + tb.db.shape[1]
    dirs = _shift_diagonals(res.dirs, 4, shift) if shift else res.dirs
    seeds = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
        res.best_x[:n], res.best_y[:n], rowp, off + shift)]
    return dirs, seeds, t_steps


@pytest.mark.parametrize("shift", [0, 1, 6])
@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_host_staged_modes_walk_matches_plain(host, local, streamed, shift):
    """hc_walk_modes against walk_modes_torch on both layouts: walks of up
    to ~1000 steps (16 or more staged batches), runs cut by min(x, y) (semi
    stops at x or y == 0) and by local's LSTART stop inside the random
    flanks, indels and random pairs, at offsets that are not multiples of
    4."""
    dirs, seeds, t_steps = _modes_walk_case(83 + 2 * local + streamed, local,
                                            streamed, shift=shift)
    assert int(((seeds[0] + seeds[1] + seeds[3]) >> 6).max()) >= 15
    want = walk.walk_modes_torch(dirs, *seeds, local, t_steps)
    got = _host_modes_walk(host, dirs, seeds, local, t_steps)
    for g, exp in zip(got[:5], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    assert (got[2].numpy() == 1).all()


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_host_staged_modes_walk_long_gaps_and_step_cap(host, local,
                                                       streamed):
    """Indels of 80 bp restage the ring (counted) and still equal
    walk_modes_torch; with t_steps cut to 100 (a cap of 512 steps) the
    longer walks are broken (st = 2) at the cap, as the plain walk's."""
    dirs, seeds, t_steps = _modes_walk_case(5 + local, local, streamed,
                                            hi=800, long_gap=80)
    want = walk.walk_modes_torch(dirs, *seeds, local, t_steps)
    got = _host_modes_walk(host, dirs, seeds, local, t_steps)
    for g, exp in zip(got[:5], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    assert got[6] > 0
    want = walk.walk_modes_torch(dirs, *seeds, local, 100)
    got = _host_modes_walk(host, dirs, seeds, local, 100)
    for g, exp in zip(got[:5], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    capped = got[4].numpy() == 512
    assert capped.any() and (got[2].numpy()[capped] == 2).all()


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_host_staged_modes_walk_broken_and_clipped_seeds(host, local,
                                                         streamed):
    """test_host_walk_modes_matches_plain's corrupted pair (no H bits:
    broken) and seeds outside the tensor, above the rows and past the lanes
    (read by the slow path with clipped indices, then broken), as the plain
    walk's; the slow path is taken and counted."""
    pairs, tb = _modes_batch(47 + local + 2 * streamed, 16, 70, 70)
    B = len(pairs)
    if streamed:
        res = smodes.nw_affine_stream_modes_batch(
            *tb, "local" if local else "semi", np_slots=2)
        bs = np.arange(B)
        rowp = bs // res.plan.np_slots
        off = (bs % res.plan.np_slots) * res.plan.s
        t_steps = res.plan.l1 + res.plan.l2
    else:
        res = modes.nw_affine_modes_batch(*tb, local=local)
        rowp, off = np.arange(B), np.zeros(B)
        t_steps = tb.query.shape[1] + tb.db.shape[1]
    dirs = res.dirs.clone()
    dirs[:, int(rowp[3]), :] = 0
    x0 = np.asarray(res.best_x[:B], np.int32)
    y0 = np.asarray(res.best_y[:B], np.int32)
    x0[5], y0[6], x0[7] = 10 ** 6, -3, dirs.shape[2] + 40
    seeds = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
             for a in (x0, y0, rowp, off)]
    want = walk.walk_modes_torch(dirs, *seeds, local, t_steps)
    got = _host_modes_walk(host, dirs, seeds, local, t_steps)
    for g, exp in zip(got[:5], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    assert (got[2].numpy()[[3, 6]] == 2).all()
    assert got[5] > 0


@pytest.mark.parametrize("P", [28, 34])
def test_host_staged_walks_refuse_bad_shapes(host, P):
    """Rows under 32 lanes or not a multiple of 4 return -1."""
    dirs = torch.zeros((4, 2, P), dtype=torch.uint32)
    seed = torch.ones(2, dtype=torch.int32)
    out = [torch.empty((2, 32), dtype=torch.uint32)] + [
        torch.empty(2, dtype=torch.int32) for _ in range(4)]
    assert host.hc_walk_fast4(
        dirs.data_ptr(), *dirs.shape, *(seed.data_ptr(),) * 5, 2, 32,
        *(t.data_ptr() for t in out[:4]), None) == -1
    assert host.hc_walk_modes(
        dirs.data_ptr(), *dirs.shape, *(seed.data_ptr(),) * 4, 2, 32, 1,
        *(t.data_ptr() for t in out), None) == -1


@pytest.mark.parametrize("P", [16, 34])
def test_staged_walk_wrappers_refuse_other_lanes(P):
    """walk_fast4_cuda and walk_modes_cuda refuse rows of P < 32 or not a
    multiple of 4 (a ValueError; no plain walk takes over on the card)."""
    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    dirs = torch.zeros((4, 2, P), dtype=torch.uint32).as_subclass(OnCard)
    seed = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="32 lanes"):
        walk.walk_fast4_cuda(dirs, seed, seed, seed, seed, seed, 8)
    with pytest.raises(ValueError, match="32 lanes"):
        walk.walk_modes_cuda(dirs, seed, seed, seed, seed, True, 8)
    assert walk.walk_fast4_cuda.launches == 0
    assert walk.walk_modes_cuda.launches == 0


def test_modes_wrappers_refuse_cpu_tensors():
    _, tb = _modes_batch(3, 8, 20, 20)
    s2v = modes.modes_layout(tb.db)
    with pytest.raises(ValueError, match="CUDA"):
        modes.modes_fill_cuda(tb.query, s2v, tb.query_len, tb.db_len,
                              tb.query.shape[1], tb.db.shape[1],
                              ScoringScheme(), False, True, True)
    plan, ins = fill.stream_inputs(*tb)
    with pytest.raises(ValueError, match="CUDA"):
        smodes.gotoh_fill_stream_modes_cuda(*ins, plan, ScoringScheme(),
                                            False, "local", True)
    dirs = torch.zeros((4, 8, 128), dtype=torch.uint32)
    seed = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        walk.walk_modes_cuda(dirs, seed, seed, seed, seed, True, 8)
    assert modes.modes_fill_cuda.launches == 0
    assert smodes.gotoh_fill_stream_modes_cuda.launches == 0
    assert walk.walk_modes_cuda.launches == 0


# ---------------------------------------------------------------------------
# The cluster split of the fills (forced small CTAs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,cta_lanes,want", [
    (2048, 0, 1), (8192, 0, 1), (8320, 0, 3), (32768, 0, 8), (32896, 0, 5),
    (49152, 0, 6), (2048, 512, 4), (384, 256, 2), (384, 128, 3),
    (4096, 128, 0), (2048, 100, 0), (8200, 0, 0), (131072, 0, 16),
    (131200, 0, 0),
])
def test_split_plan(host, P, cta_lanes, want):
    """CTAs a row of P lanes takes: one block up to 8192 lanes, 4096- or
    8192-lane CTAs past it (at most 8 up to 49152 lanes, 16 up to 131072,
    the linear fill's reach), forced widths (a short last CTA included),
    and refusals (more than 16 CTAs, widths or P off the 128 grid)."""
    assert host.hc_fill_ctas(P, cta_lanes) == want


def _split_pairs(seed, n, hi1, hi2):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(1, hi1 + 1)))
        s2 = rng.choice(alpha, int(rng.integers(hi2 // 2, hi2 + 1)))
        if i % 2:
            s2 = np.resize(s1, len(s2))
        out.append((s1.tobytes(), s2.tobytes()))
    return out


@pytest.mark.parametrize("cta_lanes", [128, 256])
@pytest.mark.parametrize("dirs_mode", ["fast4", "full"])
def test_host_split_fill_matches_plain(host, dirs_mode, cta_lanes):
    """The global streamed fill with each row split over 3 CTAs of 128
    lanes, or 2 CTAs of 256 and 128 (P = 384), equals the plain fill."""
    pairs = _split_pairs(61 + cta_lanes, 14, 120, 300)
    tb = to_device(trim_for_stream(pack_batch(pairs, batch_size=16)), "cpu")
    plan, ins = fill.stream_inputs(*tb, np_slots=2)
    assert plan.p == 384
    assert host.hc_fill_ctas(plan.p, cta_lanes) == (3 if cta_lanes == 128
                                                    else 2)
    finals, dirs = _host_fill(host, plan, *ins, ScoringScheme(), True, True,
                              dirs_mode, cta_lanes)
    want_f, want_d = fill.gotoh_fill_stream_torch(
        *ins, plan, ScoringScheme(), True, True, dirs_mode)
    np.testing.assert_array_equal(finals.numpy(), want_f.numpy())
    np.testing.assert_array_equal(dirs.numpy(), want_d.numpy())


@pytest.mark.parametrize("local", [False, True])
def test_host_split_stream_modes_fill_matches_plain(host, local):
    """The streamed modes fill split over 4 CTAs of 128 lanes (the modes
    batch is not trimmed: P = 512)."""
    pairs = _split_pairs(71 + local, 14, 150, 300)
    tb = to_device(pack_batch(pairs, batch_size=16), "cpu")
    plan, ins = fill.stream_inputs(*tb, np_slots=2)
    assert host.hc_fill_ctas(plan.p, 128) == 4
    mode = "local" if local else "semi"
    (bv, bd), dirs = smodes.gotoh_fill_stream_modes_torch(
        *ins, plan, ScoringScheme(), False, mode, True)
    got = _host_stream_modes(host, plan, *ins, ScoringScheme(), local, False,
                             True, cta_lanes=128)
    for g, w in zip(got, (bv, bd, dirs)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("local", [False, True])
def test_host_split_modes_fill_matches_plain(host, local):
    """The per-pair modes fill split over 4 CTAs of 128 lanes (P = 512)."""
    pairs, tb = _modes_batch(83 + local, 9, 120, 300)
    s2v = modes.modes_layout(tb.db)
    assert s2v.shape[1] == 512 and host.hc_fill_ctas(512, 128) == 4
    args = (tb.query, s2v, tb.query_len, tb.db_len)
    l1, l2 = tb.query.shape[1], tb.db.shape[1]
    want = modes.fill_modes_torch(*args, l1, l2, ScoringScheme(), False,
                                  local, True)
    got = _host_modes_fill(host, *args, l2, ScoringScheme(), local, False,
                           True, cta_lanes=128)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    _assert_pair_dirs(got[2], want[2], tb.query_len, tb.db_len)


def test_host_split_refuses_bad_widths(host):
    _, plan, qs, ds, dsum, n2 = _stream(5)
    R, P, NP = plan.n_rows, plan.p, plan.np_slots
    finals = torch.zeros((R * NP, 3), dtype=torch.int32)
    rc = host.hc_stream_fill(
        qs.data_ptr(), ds.data_ptr(), dsum.data_ptr(), n2.data_ptr(),
        finals.data_ptr(), None, None, R, plan.t_total, P, plan.s, NP, 5, -4,
        -8, -6, 0, 1, 0, 100, *_ring_args())
    assert rc == -1


# ---------------------------------------------------------------------------
# The streamed fills' warp-ring schedule (stream_ring.cuh): block shapes,
# forced lanes a thread / chunks / slots, rows past 512 threads, turnovers
# and lane n2 = P - 2 at warp edges and the wrap, and a schedule whose waits
# cannot be met
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,cta_lanes,is_modes,lpt,want", [
    (2048, 0, 0, 0, (8, 256, 1)), (2176, 0, 1, 0, (4, 544, 1)),
    (2176, 0, 0, 0, (8, 288, 1)), (2304, 0, 1, 0, (8, 288, 1)),
    (4096, 0, 0, 0, (8, 512, 1)), (4096, 0, 1, 0, (8, 512, 1)),
    (8192, 0, 0, 0, (16, 512, 1)), (8320, 0, 0, 0, (8, 512, 3)),
    (8320, 0, 1, 0, (8, 512, 3)), (40960, 0, 0, 0, (16, 512, 5)),
    (1152, 0, 1, 2, (2, 576, 1)), (2048, 0, 0, 2, (2, 1024, 1)),
    (4096, 0, 0, 4, (4, 1024, 1)), (384, 0, 0, 8, (8, 64, 1)),
    (2048, 512, 0, 0, (8, 64, 4)),
    (2176, 0, 0, 2, None), (2304, 0, 1, 4, None), (2048, 0, 0, 3, None),
    (8200, 0, 0, 0, None),
])
def test_stream_plan(host, P, cta_lanes, is_modes, lpt, want):
    """The streamed fills' block shape (lanes a thread, threads, CTAs): 8
    lanes a thread for the global fill and 4 for the modes, more where the
    threads would pass the instance's bound (512; 544 for the modes'
    4-lane instance, 1024 for the global one), forced lanes a thread within
    it, and refusals."""
    if want is None:
        with pytest.raises(ValueError, match="range"):
            fill.stream_launch_shape(host, P, cta_lanes, bool(is_modes), lpt)
        return
    shape = fill.stream_launch_shape(host, P, cta_lanes, bool(is_modes), lpt)
    assert (shape["lanes_per_thread"], shape["threads"], shape["ctas"]) == \
        want


@pytest.mark.parametrize("chunk,slots,wrap,modes,want", [
    (0, 0, 0, False, (16, 4, 256)), (0, 0, 0, True, (32, 2, 256)),
    (8, 0, 0, False, (8, 4, 256)), (24, 0, 4, True, (24, 2, 4)),
    (5, 3, 1, False, (5, 3, 1)), (33, 0, 0, False, None),
    (16, 5, 0, True, None), (8, 0, 3, False, None),
])
def test_ring_knobs(host, chunk, slots, wrap, modes, want):
    """The warp rings' defaults, resolved in stream_ring.cuh: chunks of 16
    steps (the modes' 32), as many slots as fit 64 entries (at most 4),
    256 wrap words; refusals past those limits or for a wrap ring that is
    not a power of two."""
    if want is None:
        with pytest.raises(ValueError, match="range"):
            fill.stream_launch_shape(host, 2048, 0, modes, 0, chunk, slots,
                                     wrap)
        return
    shape = fill.stream_launch_shape(host, 2048, 0, modes, 0, chunk, slots,
                                     wrap)
    assert (shape["chunk"], shape["ring_slots"], shape["wrap_words"]) == want


def test_stream_instances_from_build_log():
    """The registers and spills of each streamed-fill instance, int32 and
    int16, parsed from -Xptxas -v output, its state and template arguments
    decoded; other kernels are left out."""
    name = ("_ZN12_GLOBAL__N_118stream_ring_kernelILi4ELi2ELi2ELb0ELb1EEEvPKi"
            "S2_S2_S2_PiPjS3_iiiiiN2sa6SchemeENS5_5SplitENS_4RingE")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    56 bytes stack frame, 52 bytes spill stores, 60 bytes spill "
        "loads",
        "ptxas info    : Used 96 registers, 34000 bytes smem",
        "ptxas info    : Compiling entry function '_Z5otherPi' for 'sm_90a'",
        "ptxas info    : Used 32 registers",
    ])
    name16 = ("_ZN12_GLOBAL__N_120stream_ring16_kernelILi8ELi1ELi0ELb1ELb0E"
              "EEvPKiS2_S2_S2_PiPjS3_iiiiiN2sa6SchemeEiNS4_5SplitENS4_9Ring"
              "ShapeE")
    log += "\n" + "\n".join([
        f"ptxas info    : Compiling entry function '{name16}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name16}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, 34000 bytes smem",
    ])
    got = csrc.stream_instances(log)
    assert got == [dict(entry=name, registers=96, stack=56, spill_stores=52,
                        spill_loads=60, state="i32", lanes_per_thread=4,
                        dirs="full", mode="local", compat=False,
                        wildcard=True),
                   dict(entry=name16, registers=90, stack=0, spill_stores=0,
                        spill_loads=0, state="i16", lanes_per_thread=8,
                        dirs="fast4", mode="global", compat=True,
                        wildcard=False)]
    assert [r["registers"] for r in csrc.kernel_resources(log, "other")] == \
        [32]


def _ring_batch(seed, n, np_slots, lo1, hi1, l2s, hi2=None, trim=True):
    """n pairs with queries of lo1..hi1 bp and dbs of the lengths l2s
    (cycled; lengths drawn up to hi2 where l2s is None), a third of the dbs
    a mutated copy of the query; the streamed layout with np_slots slots a
    row."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(n):
        n2 = l2s[i % len(l2s)] if l2s else int(rng.integers(1, hi2 + 1))
        s1 = rng.choice(alpha, int(rng.integers(lo1, hi1 + 1)))
        s2 = rng.choice(alpha, n2)
        if i % 3 == 1:
            s2 = np.resize(s1, n2)
            s2[rng.integers(n2)] = rng.choice(alpha)
        pairs.append((s1.tobytes(), s2.tobytes()))
    batch = pack_batch(pairs, batch_size=-(-n // 8) * 8)
    if trim:
        batch = trim_for_stream(batch)
    tb = to_device(batch, "cpu")
    return fill.stream_inputs(*tb, np_slots=np_slots)


def _check_ring_fill(host, plan, ins, compat, wildcard, dirs_mode,
                     cta_lanes=0, **ring):
    scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2) \
        if wildcard else ScoringScheme()
    finals, dirs = _host_fill(host, plan, *ins, scheme, compat, wildcard,
                              dirs_mode, cta_lanes, **ring)
    want_f, want_d = fill.gotoh_fill_stream_torch(
        *ins, plan, scheme, compat, wildcard, dirs_mode)
    np.testing.assert_array_equal(finals.numpy(), want_f.numpy())
    np.testing.assert_array_equal(dirs.numpy(), want_d.numpy())


def _check_ring_modes(host, plan, ins, local, wildcard, cta_lanes=0, **ring):
    scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2) \
        if wildcard else ScoringScheme()
    mode = "local" if local else "semi"
    (bv, bd), dirs = smodes.gotoh_fill_stream_modes_torch(
        *ins, plan, scheme, wildcard, mode, True)
    got = _host_stream_modes(host, plan, *ins, scheme, local, wildcard, True,
                             cta_lanes, **ring)
    for g, w in zip(got, (bv, bd, dirs)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("dirs_mode", ["fast4", "full"])
@pytest.mark.parametrize("lpt,chunk,slots,np_slots", [
    (2, 1, 1, 2), (2, 5, 3, 3), (4, 8, 2, 4), (4, 32, 2, 2), (8, 3, 4, 3),
    (8, 16, 4, 4),
])
def test_host_ring_knobs_fill_matches_plain(host, lpt, chunk, slots,
                                            np_slots, dirs_mode):
    """The global fill over 384 lanes (6, 3 or 2 warps, the last half
    real at 8 lanes a thread) in forced chunks and slots, 2-4 slots a row:
    finals and the whole dirs tensor equal the plain fill's."""
    plan, ins = _ring_batch(101 + lpt + chunk, 20, np_slots, 1, 200, None,
                            hi2=300)
    assert plan.p == 384
    _check_ring_fill(host, plan, ins, lpt % 4 == 0, lpt == 8, dirs_mode,
                     lpt=lpt, chunk=chunk, slots=slots)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("lpt,chunk,slots,np_slots", [
    (2, 7, 2, 3), (4, 16, 4, 4), (8, 2, 1, 2), (2, 32, 2, 4),
])
def test_host_ring_knobs_modes_match_plain(host, lpt, chunk, slots,
                                           np_slots, local):
    """The textbook modes over 384+ lanes (untrimmed) in forced lanes a
    thread, chunks and slots, 2-4 slots a row: argmax buffers and the whole
    dirs tensor equal the plain fill's."""
    plan, ins = _ring_batch(131 + lpt + local, 20, np_slots, 1, 200, None,
                            hi2=290, trim=False)
    assert plan.p >= 384
    _check_ring_modes(host, plan, ins, local, lpt == 2, lpt=lpt, chunk=chunk,
                      slots=slots)


@pytest.mark.parametrize("kind", ["fast4", "local", "semi"])
def test_host_ring_past_512_threads(host, kind):
    """A row of 1152 lanes at 2 lanes a thread: 576 threads, 18 warps."""
    plan, ins = _ring_batch(151, 8, 1, 20, 60, [1100, 1150, 1024, 1149])
    assert plan.p == 1152
    assert fill.stream_launch_shape(host, plan.p, 0, kind != "fast4", 2)[
        "threads"] == 576
    if kind == "fast4":
        _check_ring_fill(host, plan, ins, True, False, "fast4", lpt=2)
    else:
        _check_ring_modes(host, plan, ins, kind == "local", False, lpt=2,
                          chunk=12)


@pytest.mark.parametrize("local", [False, True])
def test_host_ring_turnover_at_warp_edges(host, local):
    """Pairs whose last column (n2) lies on either side of a warp edge (64
    lanes a warp at 2 lanes a thread): every lane turns over at p == x, and
    the semi-global argmax's column sits at the edges."""
    plan, ins = _ring_batch(171 + local, 24, 3, 30, 140,
                            [63, 64, 65, 127, 128, 129, 191, 192])
    _check_ring_modes(host, plan, ins, local, False, lpt=2, chunk=9)


@pytest.mark.parametrize("kind", ["fast4", "full", "local"])
@pytest.mark.parametrize("P,lpt", [(128, 2), (256, 4), (256, 8)])
def test_host_ring_lane_next_to_wrap(host, P, lpt, kind):
    """Pairs with n2 = P - 2, so a real lane borders lane P-1, whose D bits
    finish lane 0's words through the wrap ring."""
    plan, ins = _ring_batch(191 + P + lpt, 12, 2, 1, P + 40,
                            [P - 2, P - 3, 5])
    assert plan.p == P
    if kind == "local":
        _check_ring_modes(host, plan, ins, True, False, lpt=lpt)
    else:
        _check_ring_fill(host, plan, ins, False, False, kind, lpt=lpt,
                         chunk=8)


@pytest.mark.parametrize("dirs_mode,chunk,wrap,lpt,met", [
    ("fast4", 32, 1, 2, False), ("full", 16, 2, 2, False),
    ("fast4", 32, 1, 16, False), ("fast4", 8, 1, 2, True),
    ("full", 8, 2, 2, True), ("fast4", 20, 4, 16, True),
])
def test_host_ring_unmet_schedule(host, dirs_mode, chunk, wrap, lpt, met):
    """A wrap ring of fewer words than a chunk completes deadlocks the row
    (-4, the kernel's stalled wait), of several warps or of one (24 threads
    at 16 lanes a thread); a ring of as many words meets every wait and
    equals the plain fill."""
    plan, ins = _ring_batch(211, 12, 2, 1, 100, [300, 120, 7])
    assert plan.p == 384
    if met:
        _check_ring_fill(host, plan, ins, True, False, dirs_mode, lpt=lpt,
                         chunk=chunk, wrap=wrap)
        return
    rc = _host_fill(host, plan, *ins, ScoringScheme(), True, False,
                    dirs_mode, rc_only=True, lpt=lpt, chunk=chunk, wrap=wrap)
    assert rc == -4


class _Event:
    """A stand-in for a CUDA event: ended or not, counting its waits."""

    def __init__(self, ended):
        self.ended, self.waits = ended, 0

    def query(self):
        return self.ended

    def synchronize(self):
        self.waits += 1
        self.ended = True


@pytest.mark.parametrize("ended,status,wait,raises", [
    (True, 0, False, False), (True, 1, False, True),
    (False, 1, False, False), (False, 1, True, True),
    (False, 0, True, False),
])
def test_stream_stall_check_reads_ended_launches(monkeypatch, ended, status,
                                                 wait, raises):
    """A streamed fill's status word is read once its launch has ended (or
    with wait, after waiting for it): a stalled one raises, a clean one is
    dropped, one still running is left for a later check."""
    watch = fill._Watch("sa_stream_fill",
                        torch.tensor([status], dtype=torch.int32),
                        _Event(ended))
    monkeypatch.setattr(fill, "_watches", [watch])
    if raises:
        with pytest.raises(RuntimeError, match="spin limit"):
            fill.check_stream_stalls(wait=wait)
    else:
        fill.check_stream_stalls(wait=wait)
    assert fill._watches == ([] if ended or wait else [watch])
    assert watch.done.waits == (1 if ended or wait else 0)


def test_runner_to_host_checks_stream_stalls(monkeypatch):
    """The runner's to_host reads the stall words of the fills that have
    ended, after reading the result."""
    from sequencealigning_tpu_torch.parallel import runner

    watch = fill._Watch("sa_stream_modes_fill",
                        torch.tensor([1], dtype=torch.int32), _Event(True))
    monkeypatch.setattr(fill, "_watches", [watch])
    with pytest.raises(RuntimeError, match="sa_stream_modes_fill"):
        runner.to_host(torch.arange(3))
    np.testing.assert_array_equal(runner.to_host([torch.arange(2)] * 2),
                                  [0, 1, 0, 1])


def test_forced_ring_is_scoped():
    """forced_ring's knobs hold inside its context only."""
    assert fill._RING.get() == {}
    with fill.forced_ring(lanes_per_thread=2, chunk=32):
        assert fill._RING.get() == dict(lanes_per_thread=2, chunk=32)
        with fill.forced_ring(wrap_words=1):
            assert fill._RING.get() == dict(wrap_words=1)
        assert fill._RING.get()["chunk"] == 32
    assert fill._RING.get() == {}


# ---------------------------------------------------------------------------
# Banded fill and walk
# ---------------------------------------------------------------------------


def _banded(seed, n=10, hi=120, band=16):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(1, hi + 1)))
        s2 = np.resize(s1, int(rng.integers(1, hi + 1))) if i % 2 else \
            rng.choice(alpha, int(rng.integers(1, hi + 1)))
        pairs.append((s1.tobytes(), s2.tobytes()))
    tb = to_device(pack_batch(pairs, batch_size=-(-n // 8) * 8), "cpu")
    plan, ins = banded.band_inputs(*tb, band)
    return pairs, plan, ins


def _host_banded(host, plan, ins, scheme, compat, wildcard, dirs_mode,
                 model="ref", strip_lanes=0, block_iters=0, sms=132,
                 order=0, rc_only=False):
    """hc_banded_fill (the kernel's tile schedule run serially in ticket
    order) over the wrapper's tiles (band_tiles' rule for a card of `sms`
    SMs, or the forced strips and blocks): (finals, dirs), or its return
    code with rc_only."""
    B, L = ins[0].shape
    n_iters = ins[2].shape[1]
    tiles = banded.band_tiles(B, L, n_iters, sms, strip_lanes, block_iters)
    finals = torch.zeros((B, 3), dtype=torch.int32)
    dirs = torch.full((-(-2 * n_iters // (8 if dirs_mode == "fast4" else 4)),
                       B, L), 0x5a5a5a5a, dtype=torch.uint32)
    state = torch.full((2, B, L, 4), 12345, dtype=torch.int32)
    ctr = torch.zeros(2 + 8 * B + B * tiles.strips, dtype=torch.int32)
    rc = host.hc_banded_fill(
        *(t.data_ptr() for t in ins), finals.data_ptr(), dirs.data_ptr(),
        state.data_ptr(), ctr.data_ptr(), B, L, n_iters, plan.he,
        plan.lane_limit(1), plan.lane_limit(0), scheme.match_,
        scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        {False: 0, "fast4": 1, "full": 2}[dirs_mode], int(compat),
        int(wildcard), int(model == "std"), tiles.strip_lanes,
        tiles.block_iters, order,
    )
    if rc_only:
        return rc
    assert rc == 0
    return finals, dirs


def _std_or_ref(model):
    return ScoringScheme(match_=0, mismatch=-9, gap_open=-2, gap_extend=-3) \
        if model == "std" else ScoringScheme()


@pytest.mark.parametrize("model,compat,wildcard,dirs_mode", [
    ("ref", True, True, "fast4"), ("ref", True, False, "full"),
    ("ref", False, True, "full"), ("ref", False, False, False),
    ("std", False, True, "fast4"), ("std", False, False, False),
])
def test_host_banded_fill_matches_plain(host, model, compat, wildcard,
                                        dirs_mode):
    """The banded kernel's tile schedule at the tile rule's shape (one
    tile of all the iterations for each pair of a 10-pair batch on a card
    of 8 SMs; every cell mode, both parities' neighbour reads) against
    banded_diag_fill_torch: finals and the whole dirs tensor."""
    scheme = _std_or_ref(model)
    pairs, plan, ins = _banded(7 + compat + 2 * wildcard + (model == "std"))
    want_f, want_d = banded.banded_diag_fill_torch(
        *ins, plan, scheme, compat, wildcard, dirs_mode, model)
    finals, dirs = _host_banded(host, plan, ins, scheme, compat, wildcard,
                                dirs_mode, model, sms=8)
    np.testing.assert_array_equal(finals.numpy(), want_f.numpy())
    if dirs_mode:
        np.testing.assert_array_equal(dirs.numpy(), want_d.numpy())


@pytest.mark.parametrize("strip_lanes,strips", [(128, 3), (256, 2)])
@pytest.mark.parametrize("model,compat,dirs_mode", [
    ("ref", True, "fast4"), ("ref", False, "full"), ("std", False, "fast4"),
])
def test_host_split_banded_fill_matches_plain(host, model, compat, dirs_mode,
                                              strip_lanes, strips):
    """The banded fill with each pair's band of 384 lanes cut into 3 strips
    of 128 lanes, or 2 of 256 and 128, on the tiled route (each tile its
    strip plus a 32-lane halo over blocks of 32 iterations, its end lanes
    taking the band's edge rule, only its own lanes kept), equals the
    plain fill: finals and the whole dirs tensor."""
    scheme = _std_or_ref(model)
    pairs, plan, ins = _banded(53 + compat + 2 * (model == "std"), n=9,
                               hi=200, band=150)
    tiles = banded.band_tiles(16, plan.L, plan.n_need, 132, strip_lanes)
    assert plan.L == 384 and tiles.strips == strips and tiles.rows > 1
    want_f, want_d = banded.banded_diag_fill_torch(
        *ins, plan, scheme, compat, True, dirs_mode, model)
    finals, dirs = _host_banded(host, plan, ins, scheme, compat, True,
                                dirs_mode, model, strip_lanes)
    np.testing.assert_array_equal(finals.numpy(), want_f.numpy())
    np.testing.assert_array_equal(dirs.numpy(), want_d.numpy())


def _banded_long(seed, skew):
    """8 pairs of 200-256 bp (every other one a copy of its query) at band
    8, so a tile's lanes lie inside the matrix for most of its blocks (the
    lean cell without its mask); skew: the dbs cut to 40-90 bp."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(8):
        s1 = rng.choice(alpha, int(rng.integers(200, 257)))
        n2 = int(rng.integers(40, 91)) if skew else int(rng.integers(200, 257))
        s2 = np.resize(s1, n2) if i % 2 else rng.choice(alpha, n2)
        pairs.append((s1.tobytes(), s2.tobytes()))
    tb = to_device(pack_batch(pairs, batch_size=8), "cpu")
    return banded.band_inputs(*tb, 8)


@pytest.mark.parametrize("strip_lanes,block_iters", [
    (128, 4), (128, 8), (32, 8), (32, 12), (64, 20), (0, 0),
])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("model,compat,wildcard,dirs_mode", [
    ("ref", True, True, "fast4"), ("ref", False, False, "full"),
    ("ref", True, False, False), ("std", False, True, "fast4"),
])
def test_host_banded_tiles_match_plain(host, model, compat, wildcard,
                                       dirs_mode, skew, strip_lanes,
                                       block_iters):
    """Forced narrow strips (32-128 lanes) in short blocks (4-20
    iterations; the last block shorter: 129 or 257 iterations) and the
    rule's own tiles, on equal-length and skewed batches: strips at both
    band edges, tiles wholly inside the matrix, tiles past the effective
    band, the x = 0 / y = 0 ramp, each block's start state read from the
    other parity's buffer.  Finals and the whole dirs tensor equal the
    plain fill's."""
    scheme = _std_or_ref(model)
    if wildcard and model == "ref":
        scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7,
                               gap_extend=-2)
    plan, ins = _banded_long(61 + skew, skew)
    tiles = banded.band_tiles(8, plan.L, plan.n_need, 132, strip_lanes,
                              block_iters)
    assert plan.n_need % tiles.block_iters or tiles.rows == 1
    want_f, want_d = banded.banded_diag_fill_torch(
        *ins, plan, scheme, compat, wildcard, dirs_mode, model)
    finals, dirs = _host_banded(host, plan, ins, scheme, compat, wildcard,
                                dirs_mode, model, strip_lanes, block_iters)
    np.testing.assert_array_equal(finals.numpy(), want_f.numpy())
    if dirs_mode:
        np.testing.assert_array_equal(dirs.numpy(), want_d.numpy())


def test_host_banded_refuses_an_out_of_order_schedule(host):
    """A tile whose producers (the previous block's strips s - 1 .. s + 1)
    hold later tickets would wait on CTAs that may not run: the serial
    schedule reports the unmet wait (-4); in ticket order it runs (0)."""
    plan, ins = _banded_long(5, False)
    args = (host, plan, ins, ScoringScheme(), True, False, "fast4", "ref",
            32, 8)
    assert _host_banded(*args, rc_only=True) == 0
    assert _host_banded(*args, order=1, rc_only=True) == -4


def test_band_tiles_rule():
    """The tile rule: a batch of at least one pair an SM whose band fits a
    CTA takes one tile a pair (no halo, 8 lanes a thread); fewer pairs cut
    their bands into strips in blocks of 64 iterations with a 64-lane halo
    at 2 lanes a thread: of 128 lanes while that gives at most two tiles an
    SM (none for a band of fewer than 3), else about one tile an SM (a
    multiple of 32 lanes, 128-512); forced strips and blocks are kept."""
    t = banded.band_tiles(1024, 256, 5121, 132)
    assert (t.strips, t.rows, t.halo, t.lanes_per_thread, t.threads) == \
        (1, 1, 0, 8, 32)
    t = banded.band_tiles(2, 10240, 100_001, 132)
    assert (t.strip_lanes, t.strips, t.block_iters, t.halo) == \
        (128, 80, 64, 64)
    assert (t.lanes_per_thread, t.threads) == (2, 128)
    assert t.rows == 1563 and 2 * t.strips >= 132
    t = banded.band_tiles(4, 300_288, 1001, 132)
    assert (t.strip_lanes, t.strips, t.lanes_per_thread, t.threads) == \
        (512, 587, 2, 320)
    t = banded.band_tiles(8, 256, 100_001, 132)
    assert (t.strip_lanes, t.strips, t.rows, t.threads) == (256, 1, 1, 128)
    t = banded.band_tiles(8, 384, 100_001, 132)
    assert (t.strip_lanes, t.strips, t.block_iters) == (128, 3, 64)
    t = banded.band_tiles(8, 8704, 8800, 132)
    assert (t.strip_lanes, t.strips) == (512, 17)
    t = banded.band_tiles(8, 384, 300, 132, strip_lanes=128, block_iters=8)
    assert (t.strip_lanes, t.strips, t.block_iters, t.rows, t.halo) == \
        (128, 3, 8, 38, 8)
    t = banded.band_tiles(8, 384, 300, 132, strip_lanes=1000)
    assert (t.strip_lanes, t.strips, t.rows, t.halo) == (384, 1, 1, 0)
    for L, n in ((128, 50), (2048, 9000), (4096, 9000), (131_456, 2000)):
        for B in (1, 4, 200):
            t = banded.band_tiles(B, L, n, 132)
            assert t.strips * t.strip_lanes >= L > (t.strips - 1) * \
                t.strip_lanes
            assert t.halo <= t.strip_lanes and t.threads <= 512
            assert t.threads * t.lanes_per_thread >= min(
                L, t.strip_lanes + 2 * t.halo)


def test_host_banded_refuses_bad_widths(host):
    """A strip width off the 8-lane grid, a block of iterations not a
    multiple of 4 (with several blocks), or a halo wider than a strip is
    refused (-1), as the kernel's entry refuses it; the wrapper raises for
    them before a launch."""
    pairs, plan, ins = _banded(5, n=8, hi=60, band=16)
    B, L = ins[0].shape
    n_iters = ins[2].shape[1]
    finals = torch.zeros((B, 3), dtype=torch.int32)
    state = torch.zeros((2, B, L, 4), dtype=torch.int32)
    ctr = torch.zeros(2 + 8 * B + 64 * B, dtype=torch.int32)
    for lanes, iters in ((100, 8), (-128, 8), (0, 8), (32, 6), (32, 40),
                         (8, 12)):
        rc = host.hc_banded_fill(
            *(t.data_ptr() for t in ins), finals.data_ptr(), None,
            state.data_ptr(), ctr.data_ptr(), B, L, n_iters, plan.he,
            plan.lane_limit(1), plan.lane_limit(0), 5, -4, -8, -6, 0, 1, 0, 0,
            lanes, iters, 0)
        assert rc == -1, (lanes, iters)
        if lanes > 0:
            with pytest.raises(ValueError):
                banded._check_tiles(banded.band_tiles(B, L, n_iters, 132,
                                                      lanes, iters),
                                    L, n_iters)


@pytest.mark.parametrize("std", [False, True])
def test_host_banded_walk_matches_plain(host, std):
    """walk_banded_pair against walk_banded_torch, with a dirs tensor cut
    to fewer lanes so some reads fall outside the band."""
    model = "std" if std else "ref"
    pairs, plan, ins = _banded(19 + std, n=12, hi=90, band=8)
    scheme = ScoringScheme(match_=0, mismatch=-9, gap_open=-2, gap_extend=-3) \
        if std else ScoringScheme()
    finals, dirs = banded.banded_diag_fill_torch(*ins, plan, scheme, False,
                                                 True, "fast4", model)
    dirs = dirs[:, :, : plan.L - 64].contiguous()
    B = len(pairs)
    seeds = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
        [len(b) for _, b in pairs], [len(a) for a, _ in pairs],
        walk.seed_planes(finals.numpy()[:B]), np.arange(B),
    )]
    t_steps = int((seeds[0] + seeds[1]).max())
    want = walk.walk_banded_torch(dirs, *seeds, plan.k_lo_even, t_steps,
                                  std=std)
    got = _host_banded_walk(host, dirs, seeds, plan.k_lo_even, t_steps, std)
    for g, exp in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    assert (got[0].numpy() == 0).all() and (got[1].numpy() == 0).all()


def _host_banded_walk(host, dirs, seeds, k_lo_even, t_steps, std, win=0):
    """hc_walk_banded (the kernel's staged window run serially): (xf, yf,
    packed, n_ops, reads taken by the slow path)."""
    B = seeds[0].shape[0]
    WP = walk.banded_packed_width(t_steps)
    packed = torch.full((B, WP), 0x5a5a5a5a, dtype=torch.uint32)
    xf, yf, n_ops = (torch.empty(B, dtype=torch.int32) for _ in range(3))
    slow = torch.zeros(1, dtype=torch.int64)
    rc = host.hc_walk_banded(
        dirs.data_ptr(), *dirs.shape, *(s.data_ptr() for s in seeds),
        k_lo_even, B, WP, int(std), packed.data_ptr(), xf.data_ptr(),
        yf.data_ptr(), n_ops.data_ptr(), win, slow.data_ptr(),
    )
    assert rc == 0
    return xf, yf, packed, n_ops, int(slow)


def _banded_walk_case(seed, band, std, identical=False, n=12, hi=180):
    """A banded fast4 fill of ragged pairs (every other db a copy of its
    query, or all with identical) and its walk seeds."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(1, hi + 1)))
        s2 = s1.copy() if identical else (
            np.resize(s1, int(rng.integers(1, hi + 1))) if i % 2 else
            rng.choice(alpha, int(rng.integers(1, hi + 1))))
        pairs.append((s1.tobytes(), s2.tobytes()))
    tb = to_device(pack_batch(pairs, batch_size=-(-n // 8) * 8), "cpu")
    plan, ins = banded.band_inputs(*tb, band)
    scheme = ScoringScheme(match_=0, mismatch=-9, gap_open=-2, gap_extend=-3) \
        if std else ScoringScheme()
    finals, dirs = banded.banded_diag_fill_torch(
        *ins, plan, scheme, False, True, "fast4", "std" if std else "ref")
    seeds = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
        [len(b) for _, b in pairs], [len(a) for a, _ in pairs],
        walk.seed_planes(finals.numpy()[:n]), np.arange(n),
    )]
    return plan, dirs, seeds, int((seeds[0] + seeds[1]).max())


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("band", [1, 2, 8, 33, 59, 70])
@pytest.mark.parametrize("win", [0, 1, 2, 3, 16])
def test_host_banded_walk_window_matches_plain(host, band, std, win):
    """The staged window (32 lanes a row by default, forced down to 1-16
    so some or most words take the slow path) against walk_banded_torch,
    at bands 1-70 (band 70's 141 diagonals span more band lanes than a
    window holds), std and ref; walks of up to 360 steps cross up to 6
    staged batches of 8 rows; the slow path is taken where the window is
    tiny."""
    plan, dirs, seeds, t_steps = _banded_walk_case(19 + band + std, band, std)
    want = walk.walk_banded_torch(dirs, *seeds, plan.k_lo_even, t_steps,
                                  std=std)
    got = _host_banded_walk(host, dirs, seeds, plan.k_lo_even, t_steps, std,
                            win)
    for g, exp in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    if 0 < win <= 3:
        assert got[4] > 0


@pytest.mark.parametrize("win", [1, 32])
def test_host_banded_walk_stays_in_window_on_one_lane(host, win):
    """Identical pairs walk the main diagonal (M moves keep the band lane),
    so every read comes from the staged rows, even a one-lane window."""
    plan, dirs, seeds, t_steps = _banded_walk_case(5, 8, False,
                                                   identical=True)
    want = walk.walk_banded_torch(dirs, *seeds, plan.k_lo_even, t_steps)
    got = _host_banded_walk(host, dirs, seeds, plan.k_lo_even, t_steps,
                            False, win)
    for g, exp in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())
    assert got[4] == 0


@pytest.mark.parametrize("win", [33, -1, 64, -32])
def test_host_banded_walk_refuses_bad_windows(host, win):
    plan, dirs, seeds, t_steps = _banded_walk_case(3, 8, False, n=8, hi=30)
    B = seeds[0].shape[0]
    WP = walk.banded_packed_width(t_steps)
    out = [torch.empty((B, WP), dtype=torch.uint32)] + [
        torch.empty(B, dtype=torch.int32) for _ in range(3)]
    assert host.hc_walk_banded(
        dirs.data_ptr(), *dirs.shape, *(s.data_ptr() for s in seeds),
        plan.k_lo_even, B, WP, 0, *(t.data_ptr() for t in out), win,
        None) == -1


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("win", [0, 1])
def test_host_banded_walk_crosses_batches(host, std, win):
    """Walks of 600-1200 steps: each crosses 9 or more staged batches of 8
    rows (64 anti-diagonals), the ring's two halves restaged in turn, and
    still equals walk_banded_torch."""
    plan, dirs, seeds, t_steps = _banded_walk_case(41 + std, 12, std, n=8,
                                                   hi=600)
    assert int(((seeds[0] + seeds[1] - 1) >> 6).max()) >= 9
    want = walk.walk_banded_torch(dirs, *seeds, plan.k_lo_even, t_steps,
                                  std=std)
    got = _host_banded_walk(host, dirs, seeds, plan.k_lo_even, t_steps, std,
                            win)
    for g, exp in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), exp.numpy())


def test_banded_wrappers_refuse_cpu_tensors():
    pairs, plan, ins = _banded(3, n=8, hi=30)
    with pytest.raises(ValueError, match="CUDA"):
        banded.banded_diag_fill_cuda(*ins, plan, ScoringScheme(), True, True,
                                     "fast4")
    dirs = torch.zeros((4, 8, 128), dtype=torch.uint32)
    seed = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        walk.walk_banded_cuda(dirs, seed, seed, seed, seed, -8, 8)
    assert banded.banded_diag_fill_cuda.launches == 0
    assert walk.walk_banded_cuda.launches == 0


# ---------------------------------------------------------------------------
# Tiled fill (kernels #4 and #5)
# ---------------------------------------------------------------------------


def _tiled_batch(seed, n=10, hi=256, alphabet=b"ACGTN", hi2=None):
    """A ragged batch up to hi bp (dbs up to hi2, default hi), every other
    db a mutated copy of its query, with an empty db and an empty query."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(1, hi + 1)))
        s2 = rng.choice(alpha, int(rng.integers(1, (hi2 or hi) + 1)))
        if i % 2:
            s2 = np.resize(s1, len(s2))
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        pairs.append((s1.tobytes(), s2.tobytes()))
    pairs += [(b"ACGTA", b""), (b"", b"ACGT")]
    return to_device(pack_batch(pairs), "cpu")


def _host_tiled(host, tb, scheme, compat, wildcard, strip_lanes, chunk_rows,
                ctas_per_pair, items=None):
    """hc_tiled_fill over the wrapper's schedule and plan (its ring slots
    from ctas_per_pair): (rc, finals)."""
    B, L1 = tb.query.shape
    sched, strips = tiled.strip_schedule(tb.db_len.numpy(), strip_lanes)
    items = sched if items is None else items
    _cpp, ring, _ctas = tiled.strip_plan(
        strips, int(tb.query_len.max()), L1, strip_lanes, chunk_rows, 132,
        ctas_per_pair)
    finals = torch.zeros((B, 3), dtype=torch.int32)
    col = torch.full((B * ring * 2 * (L1 + 1),), 12345, dtype=torch.int32)
    ctr = torch.zeros(2 + 8 * B + 2 * len(items), dtype=torch.int32)
    items_t = torch.from_numpy(np.ascontiguousarray(items, np.int32))
    rc = host.hc_tiled_fill(
        *(t.data_ptr() for t in tb), finals.data_ptr(), col.data_ptr(),
        ctr.data_ptr(), items_t.data_ptr(), B, L1, tb.db.shape[1],
        len(items), len(items), scheme.match_, scheme.mismatch,
        scheme.gap_open, scheme.gap_extend, int(compat), int(wildcard),
        strip_lanes, chunk_rows, ring,
    )
    return rc, tiled._empty_db_corners(finals, tb.query_len, tb.db_len,
                                       scheme, compat)


_TILED_WANT = {}


def _tiled_want(compat, wildcard):
    """The batch of the strip tests (queries up to 200 bp, dbs up to 700,
    so strips of 128 lanes number up to 6 and reuse a ring of 2 or 4
    slots) and its plain finals."""
    if (compat, wildcard) not in _TILED_WANT:
        scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7,
                               gap_extend=-2) if wildcard else ScoringScheme()
        tb = _tiled_batch(71 + compat + 2 * wildcard, n=8, hi=200, hi2=700)
        want = tiled.tiled_fill_torch(*tb, scheme, compat, wildcard,
                                      tile_lanes=256)
        _TILED_WANT[compat, wildcard] = (scheme, tb, want)
    return _TILED_WANT[compat, wildcard]


@pytest.mark.parametrize("ctas_per_pair", [1, 3, 16])
@pytest.mark.parametrize("chunk_rows", [8, 128])
@pytest.mark.parametrize("strip_lanes", [128, 256])
@pytest.mark.parametrize("compat,wildcard", [(True, False), (False, True)])
def test_host_tiled_fill_matches_plain(host, compat, wildcard, strip_lanes,
                                       chunk_rows, ctas_per_pair):
    """The kernels' strip schedule run serially in ticket order (tile_cell,
    the carried column in ring slots of ctas_per_pair + 1 a pair, staged
    and published chunk_rows rows at a time, the counters every wait reads,
    the corner capture) equals the plain fill's finals on a ragged batch
    with n1 below the chunk, n2 below the strip, n2 = 0 and an empty
    query."""
    scheme, tb, want = _tiled_want(compat, wildcard)
    rc, got = _host_tiled(host, tb, scheme, compat, wildcard, strip_lanes,
                          chunk_rows, ctas_per_pair)
    assert rc == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_host_tiled_fill_refuses_bad_widths(host):
    tb = _tiled_batch(3, n=4, hi=40)
    B, L1 = tb.query.shape
    items, _ = tiled.strip_schedule(tb.db_len.numpy(), 128)
    items_t = torch.from_numpy(items)
    finals = torch.zeros((B, 3), dtype=torch.int32)
    col = torch.empty((B * 4 * 2 * (L1 + 1),), dtype=torch.int32)
    ctr = torch.zeros(2 + 8 * B + 2 * len(items), dtype=torch.int32)
    for lanes, rows, ring in ((100, 8, 2), (8192, 8, 2), (0, 8, 2),
                              (128, 0, 2), (128, 1, 2), (128, 100, 2),
                              (128, 256, 2), (128, 8, 1)):
        rc = host.hc_tiled_fill(
            *(t.data_ptr() for t in tb), finals.data_ptr(), col.data_ptr(),
            ctr.data_ptr(), items_t.data_ptr(), B, L1, tb.db.shape[1],
            len(items), len(items), 5, -4, -8, -6, 1, 0, lanes, rows, ring)
        assert rc == -1, (lanes, rows, ring)


def test_host_tiled_fill_refuses_an_out_of_order_schedule(host):
    """A strip whose producer holds a later ticket would wait on a CTA that
    may not run: the serial schedule reports the unmet wait (-4)."""
    scheme, tb, _ = _tiled_want(True, False)
    items, _ = tiled.strip_schedule(tb.db_len.numpy(), 128)
    rc, _ = _host_tiled(host, tb, scheme, True, False, 128, 8, 1,
                        items=items[::-1])
    assert rc == -4


def test_strip_schedule_and_plan():
    """Items are strip-major with each pair's strips consecutive in the
    counters; every strip's producer and its ring slot's last reader come
    earlier; the plan shares the resident CTAs over the pairs and keeps at
    least two ring slots."""
    n2s = np.array([700, 0, 129, 128, 1, 3000])
    items, strips = tiled.strip_schedule(n2s, 128)
    np.testing.assert_array_equal(strips, [6, 0, 2, 1, 1, 24])
    assert items.dtype == np.int32 and items.shape == (34, 3)
    assert (np.diff(items[:, 1]) >= 0).all()
    base = np.cumsum(strips) - strips
    np.testing.assert_array_equal(items[:, 2], base[items[:, 0]]
                                  + items[:, 1])
    assert sorted(items[:, 2]) == list(range(34))
    ticket = {(int(b), int(s)): t for t, (b, s, _) in enumerate(items)}
    for (b, s), t in ticket.items():
        if s:
            assert ticket[b, s - 1] < t
    cpp, ring, ctas = tiled.strip_plan(strips, 200, 256, 128, 8, 10)
    assert (cpp, ring, ctas) == (2, 3, 10)
    assert tiled.strip_plan(strips, 200, 256, 128, 8, 1000) == (4, 5, 20)
    assert tiled.strip_plan(strips, 200, 256, 128, 8, 1000, 1)[1] == 2
    assert tiled.strip_plan(np.array([1, 1]), 5, 8, 128, 8, 99)[1:] == (2, 2)


def test_host_tile_dpx_matches_plain_max(host):
    """The cell's DPX helpers (add_max: max(a + b, c), one VIADDMAX on the
    card; max3, one VIMNMX3) equal plain int32 maxima on their host
    form, on random scores and on -inf (config.NEG_INF) and large ones."""
    rng = np.random.default_rng(5)
    edge = np.array([-32768, -32768 - 8 - 6, -(1 << 24), -1, 0, 1,
                     (1 << 30) - 1, -(1 << 30)], np.int32)
    n = 4096
    a = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    b = rng.integers(-40, 40, n).astype(np.int32)
    c = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    k = len(edge)
    a[:k * k] = np.repeat(edge, k)
    c[:k * k] = np.tile(edge, k)
    b[:k * k] = np.tile([-14, -8, -6, 0, 3, 5, -4, 1], k)
    out = np.zeros(2 * n, np.int32)
    host.hc_tile_dpx(a.ctypes.data, b.ctypes.data, c.ctypes.data,
                     out.ctypes.data, n)
    want_am = np.maximum(a.astype(np.int64) + b, c)
    want_m3 = np.maximum(np.maximum(a, b), c)
    np.testing.assert_array_equal(out[:n], want_am)
    np.testing.assert_array_equal(out[n:], want_m3)


# ---------------------------------------------------------------------------
# Kernel #8 (the banded row sweep) and the linear fill
# ---------------------------------------------------------------------------


def _row_batch(seed, band, n=6, lo=60, hi=200):
    pairs = _skewed(seed, n, lo, hi)
    tb = to_device(pack_batch(pairs, batch_size=n), "cpu")
    return nw_banded.row_inputs(*tb, band)


def _skewed(seed, n, lo, hi, alphabet=b"ACGTN"):
    """n pairs of lo..hi bp, every other db a mutated cut of its query."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        s2 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        if i % 2:
            s2 = s1[int(rng.integers(0, 9)):].copy()
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        out.append((s1.tobytes(), s2.tobytes()))
    return out


def _host_row(host, k_lo, ins, scheme, compat, wildcard, dirs_mode, chunk):
    B, K = ins[0].shape
    xp = ins[1].shape[1]
    finals = torch.zeros((B, 3), dtype=torch.int32)
    per = 8 if dirs_mode == "fast4" else 4
    dirs = torch.zeros((-(-xp // per), B, K), dtype=torch.int32)
    rc = host.hc_banded_row_fill(
        *(t.data_ptr() for t in ins), finals.data_ptr(), dirs.data_ptr(),
        B, K, xp, xp - 1, k_lo, scheme.match_, scheme.mismatch,
        scheme.gap_open, scheme.gap_extend, _DIRS[dirs_mode], int(compat),
        int(wildcard), chunk)
    assert rc == 0
    return finals, dirs.view(torch.uint32)


@pytest.mark.parametrize("chunk", [0, 128])
@pytest.mark.parametrize("compat,wildcard,dirs_mode", [
    (True, True, "fast4"), (True, False, "full"), (False, True, "full"),
    (False, False, None), (False, True, "fast4")])
def test_host_banded_row_fill_matches_plain(host, compat, wildcard,
                                            dirs_mode, chunk):
    """Kernel #8's host build (nw_banded.cuh through host_check.cpp)
    equals the plain row sweep on bands of 384 and 512 lanes: on the
    rule's route (the warp route at these widths), and forced onto the
    block route in 128-lane chunks so that the scan's maximum is carried
    across three or four chunks a row."""
    k_lo, ins = _row_batch(7 + compat + 2 * wildcard, 140)
    assert ins[0].shape[1] >= 384
    scheme = ScoringScheme()
    got = _host_row(host, k_lo, ins, scheme, compat, wildcard, dirs_mode,
                    chunk)
    want = nw_banded.banded_row_fill_torch(*ins, k_lo, scheme, compat,
                                           wildcard, dirs_mode)
    assert torch.equal(got[0], want[0])
    if dirs_mode:
        assert torch.equal(got[1], want[1])


def _row_batch_of_width(seed, K, n=5):
    """A skewed batch (pairs of 60-90 bp, every other db a cut of its
    query) and the band that makes its lane range K lanes wide."""
    pairs = _skewed(seed, n, 60, 90)
    tb = to_device(pack_batch(pairs, batch_size=n), "cpu")
    diff = tb.query_len.numpy().astype(int) - tb.db_len.numpy().astype(int)
    span = max(0, diff.max()) - min(0, diff.min()) + 1
    band = (K - 64 - span) // 2
    k_lo, ins = nw_banded.row_inputs(*tb, band)
    assert ins[0].shape[1] == K, (K, ins[0].shape)
    return k_lo, ins


@pytest.mark.parametrize("route", ["warp", "block"])
@pytest.mark.parametrize("K", [128, 256, 384, 512])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("dirs_mode", [None, "fast4", "full"])
def test_host_banded_row_routes_match_plain(host, route, K, compat,
                                            dirs_mode):
    """Both routes of kernel #8's host build equal the plain row sweep on
    the finals and every word of the dirs, NEGBIG-masked lanes included,
    with and without wildcard codes: the warp route (nw_banded.cuh's
    passes: a warp a pair, 4 / 8 / 12 / 16 lanes a thread, the I chain a
    thread's fold and a warp's scan, the unmasked path where a thread's
    lanes all hold matrix cells), which the rule gives these widths, and
    the block route forced by a chunk width (128 lanes: the scan carried
    across chunks)."""
    chunk = 0 if route == "warp" else 128
    assert host.hc_banded_row_warp_lanes(K, chunk) == (
        K // 32 if route == "warp" else 0)
    k_lo, ins = _row_batch_of_width(K + compat, K)
    scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    for wildcard in (False, True):
        got = _host_row(host, k_lo, ins, scheme, compat, wildcard,
                        dirs_mode, chunk)
        want = nw_banded.banded_row_fill_torch(*ins, k_lo, scheme, compat,
                                               wildcard, dirs_mode)
        assert torch.equal(got[0], want[0]), (K, compat, wildcard)
        if dirs_mode:
            assert torch.equal(got[1], want[1]), (K, compat, wildcard)


def test_host_banded_row_fill_past_one_chunk(host):
    """A band past one block's 2048 lanes (K = 2432: two chunks of 512
    threads) and the same band in 256-lane chunks equal the plain sweep."""
    k_lo, ins = _row_batch(11, 1100, n=4, lo=40, hi=120)
    assert ins[0].shape[1] > 2048
    scheme = ScoringScheme()
    want = nw_banded.banded_row_fill_torch(*ins, k_lo, scheme, True, True,
                                           "full")
    for chunk in (0, 256):
        got = _host_row(host, k_lo, ins, scheme, True, True, "full", chunk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_host_banded_row_refuses_bad_widths(host):
    k_lo, ins = _row_batch(3, 20, n=2, lo=10, hi=30)
    B, K = ins[0].shape
    for chunk in (-128, 100, 4096):
        finals = torch.zeros((B, 3), dtype=torch.int32)
        assert host.hc_banded_row_fill(
            *(t.data_ptr() for t in ins), finals.data_ptr(), None, B, K,
            ins[1].shape[1], ins[1].shape[1] - 1, k_lo, 5, -4, -8, -6, 0, 1,
            0, chunk) == -1


def _host_linear(host, seq1, s2v, n1v, n2v, maxv, l1, l2, scheme, compat,
                 local, with_dirs, cta_lanes=0, lpt=0, chunk=0, slots=0):
    """hc_linear_fill (the kernel's warp-ring schedule run serially, the
    split planned for 132 SMs or forced): (corner, runmax, dirs), the dirs
    tensor pre-filled with a pattern the kernel must overwrite."""
    B, P = s2v.shape
    D_total = l1 + l2 + 1
    corner = torch.zeros((B,), dtype=torch.int32)
    runmax = torch.full((B,), nw_linear.NEGBIG, dtype=torch.int32)
    dirs = torch.full((-(-D_total // 4), B, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    assert host.hc_linear_fill(
        seq1.data_ptr(), s2v.data_ptr(), n1v.data_ptr(), n2v.data_ptr(),
        maxv.data_ptr(), corner.data_ptr(), runmax.data_ptr(),
        dirs.data_ptr(), B, seq1.shape[1], P, D_total, scheme.match_,
        scheme.mismatch, scheme.gap_open, scheme.gap_extend, int(with_dirs),
        int(compat), int(local), cta_lanes, status.data_ptr(), lpt, chunk,
        slots) == 0
    return corner, runmax, dirs


def _check_host_linear(host, tb, scheme, compat, local, **knobs):
    """Both passes of the linear kernel's loop against linear_fill_torch:
    corners and maxima equal, path bits equal on each pair's cells and 0
    elsewhere."""
    seq1, s2v, n1v, n2v = nw_linear.linear_inputs(*tb)
    l1, l2 = tb.query.shape[1], tb.db.shape[1]
    maxv = torch.zeros_like(n1v)
    for with_dirs in (False, True):
        want = nw_linear.linear_fill_torch(seq1, s2v, n1v, n2v, maxv, l1, l2,
                                           scheme, compat, local, with_dirs)
        got = _host_linear(host, seq1, s2v, n1v, n2v, maxv, l1, l2, scheme,
                           compat, local, with_dirs, **knobs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if with_dirs:
            _assert_pair_dirs(got[2], want[2], n1v, n2v)
        maxv = want[1].contiguous()


@pytest.mark.parametrize("cta_lanes", [0, 128])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("compat", [True, False])
def test_host_linear_fill_matches_plain(host, compat, local, cta_lanes):
    """The linear kernel's loop (nw_linear.cuh's cell in the per-pair warp
    rings, through host_check.cpp) equals the plain fill, pass 1 (scores)
    and pass 2 (path bits with ISMAX for local), split as planned and over
    CTAs of 128 lanes: corners and maxima equal, path bits equal on each
    pair's cells and 0 elsewhere."""
    pairs = _skewed(13 + compat + 2 * local, 7, 20, 200, b"ACGT")
    tb = to_device(pack_batch(pairs, batch_size=7), "cpu")
    assert tb.db.shape[1] + 1 > 128
    _check_host_linear(host, tb, ScoringScheme(), compat, local,
                       cta_lanes=cta_lanes)


def _ragged_pairs(seed, n, hi=256, alphabet=b"ACGTN"):
    """n pairs of 0..hi bp both ways, every third db a mutated cut of its
    query, then an empty query, an empty db, a pair shorter than a warp's
    lanes and a db shorter than one warp's lanes beside a long query (the
    pair's other warps wholly past n2)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)

    def seq(k):
        return rng.choice(alpha, k)

    pairs = []
    for i in range(n):
        s1 = seq(int(rng.integers(0, hi + 1)))
        s2 = seq(int(rng.integers(0, hi + 1)))
        if i % 3 == 1 and len(s1) > 4:
            s2 = s1[2:].copy()
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        pairs.append((s1, s2))
    pairs += [(seq(0), seq(40)), (seq(70), seq(0)), (seq(9), seq(13)),
              (seq(hi), seq(5))]
    return [(a.tobytes(), b.tobytes()) for a, b in pairs]


# The per-pair fills' knob sets: CTAs of 128-256 lanes, 2-16 lanes a
# thread, chunks of 1-32 steps, 1-64 slots.
PAIR_KNOBS = [
    dict(cta_lanes=128), dict(cta_lanes=128, lpt=2, chunk=5, slots=3),
    dict(lpt=8, chunk=1, slots=1), dict(cta_lanes=256, chunk=32, slots=2),
    dict(lpt=16, chunk=7), dict(cta_lanes=128, lpt=2, chunk=1, slots=64),
]


@pytest.mark.parametrize("compat,local", [(True, False), (False, True)])
@pytest.mark.parametrize("knobs", PAIR_KNOBS)
def test_host_linear_fill_split_matches_plain(host, compat, local, knobs):
    """The linear kernel's loop forced into small CTAs, 2-16 lanes a
    thread, short and long chunks and few and many slots, on ragged pairs
    up to 256 bp both ways (an empty side, a pair shorter than a warp, a
    warp wholly past n2, padded pairs)."""
    pairs = _ragged_pairs(91 + local, 10)
    tb = to_device(pack_batch(pairs, batch_size=16), "cpu")
    scheme = ScoringScheme(match_=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    _check_host_linear(host, tb, scheme, compat, local, **knobs)


def _host_gotoh(host, seq1, s2v, dsum, n2mask, l2, scheme, compat, wildcard,
                with_dirs, cta_lanes=0, lpt=0, chunk=0, slots=0):
    """hc_gotoh_fill (kernel #7's warp-ring schedule run serially) on a
    per-pair layout, its corners from corner_lanes: (finals, dirs), the
    dirs tensor pre-filled with a pattern the kernel must overwrite."""
    B, P = s2v.shape
    D_total = seq1.shape[1] + l2 + 1
    n1, n2 = nw_affine.corner_lanes(dsum, n2mask)
    finals = torch.zeros((B, 3), dtype=torch.int32)
    dirs = torch.full((-(-D_total // 4), B, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    assert host.hc_gotoh_fill(
        seq1.data_ptr(), s2v.data_ptr(), n1.data_ptr(), n2.data_ptr(),
        finals.data_ptr(), dirs.data_ptr(), B, seq1.shape[1], P, D_total,
        scheme.match_, scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        2 if with_dirs else 0, int(compat), int(wildcard), cta_lanes,
        status.data_ptr(), lpt, chunk, slots) == 0
    return finals, dirs


@pytest.mark.parametrize("compat,wildcard", [(True, False), (False, True)])
@pytest.mark.parametrize("knobs", PAIR_KNOBS)
def test_host_gotoh_fill_split_matches_plain(host, compat, wildcard, knobs):
    """Kernel #7's loop (the global cell and the corner capture) forced
    into small CTAs, 2-16 lanes a thread, short and long chunks and few and
    many slots, on ragged pairs up to 256 bp both ways (an empty side, a
    pair shorter than a warp, a warp wholly past n2, padded pairs): finals
    equal, score-only and with full dirs, the dirs equal on each pair's
    cells (lane 0's D bits aside) and 0 elsewhere."""
    pairs = _ragged_pairs(97 + compat, 10)
    tb = to_device(pack_batch(pairs, batch_size=16), "cpu")
    s2v, dsum, n2mask = nw_affine.gotoh_layout(tb.db, tb.query_len,
                                               tb.db_len)
    l1, l2 = tb.query.shape[1], tb.db.shape[1]
    scheme = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    for with_dirs in (False, True):
        want = nw_affine.gotoh_fill_torch(tb.query, s2v, dsum, n2mask, l1, l2,
                                          scheme, compat, wildcard, with_dirs)
        got = _host_gotoh(host, tb.query, s2v, dsum, n2mask, l2, scheme,
                          compat, wildcard, with_dirs, **knobs)
        assert torch.equal(got[0], want[0])
        if with_dirs:
            _assert_pair_dirs(got[1], want[1], tb.query_len, tb.db_len)


def test_sass_spills_finds_loops_and_spills():
    """csrc/sass_spills.py on a listing in cuobjdump's form: the loops are
    the backward branches, a spin wait is not a step loop, and each spill
    is placed inside the step loop or in the smallest loop around it."""
    from sequencealigning_tpu_torch.csrc import sass_spills

    body = ["        /*0000*/                   MOV R1, c[0x0][0x28] ;",
            "        /*0010*/                   STL [R1], R4 ;"]
    addr = 0x20
    for k in range(80):  # the step loop: 0x20 .. 0x520
        op = "LDL R5, [R1+0x4]" if k == 40 else "IMNMX R2, R2, R3, !PT"
        body.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 0x10
    body.append(f"        /*{addr:04x}*/                   @P0 BRA 0x20 ;")
    addr += 0x10
    spin = addr
    body.append(f"        /*{addr:04x}*/                   STL [R1+0x8], R6 ;")
    addr += 0x10
    body.append(f"        /*{addr:04x}*/                   @!P1 BRA.U !UP0, "
                f"{spin:#x} ;")
    # Past the last EXIT, a shuffle's divergent path branching back into
    # the step loop: no loop, its spill out of line.
    body += [f"        /*{addr + 0x10:04x}*/                   EXIT ;",
             f"        /*{addr + 0x20:04x}*/                   LDL R7, [R1] ;",
             f"        /*{addr + 0x30:04x}*/                   BRA 0x300 ;"]
    sass = "\n".join(["        Function : _Z18stream_ring_kernelv",
                      *body, "        .................."])
    funcs = sass_spills.functions(sass)
    assert list(funcs) == ["_Z18stream_ring_kernelv"]
    got = sass_spills.analyse(funcs["_Z18stream_ring_kernelv"], hot=64)
    assert (got["instructions"], got["ldl"], got["stl"]) == (88, 2, 2)
    assert got["hot_loops"] == [dict(first=0x20, last=0x520,
                                     instructions=81, spills=1, opcodes={})]
    assert [(o["address"], o["out_of_line"], o["smallest_loop"])
            for o in got["outside"]] == \
        [(0x10, False, None), (spin, False, 2), (addr + 0x20, True, None)]


def test_sass_spills_counts_packed_opcodes():
    """A step loop's DPX instructions and PRMTs by opcode with
    their modifiers (the packed 16x2 forms apart from the 32-bit ones),
    predicated ones included; instructions outside the loop are not
    counted."""
    from sequencealigning_tpu_torch.csrc import sass_spills

    ops = ["VIADDMNMX.S16x2 R1, R2, R3, R4, !PT",
           "VIMNMX.S16x2 R5, P1, P2, R6, R7, !PT",
           "@!P0 PRMT R9, R37, 0x5432, R9",
           "VIMNMX3.S16x2 R1, R2, R3, R4, !PT",
           "VIADDMNMX R5, R14, UR5, R13, PT"] * 14
    body = [f"        /*{16 * i:04x}*/                   {op} ;"
            for i, op in enumerate(ops)]
    n = len(ops)
    body += [f"        /*{16 * n:04x}*/                   @P0 BRA 0x0 ;",
             f"        /*{16 * n + 16:04x}*/                   PRMT R1, R2, "
             "0x7632, R3 ;",
             f"        /*{16 * n + 32:04x}*/                   EXIT ;"]
    funcs = sass_spills.functions("\n".join(
        ["        Function : k", *body]))
    got = sass_spills.analyse(funcs["k"], hot=64)
    assert got["hot_loops"][0]["opcodes"] == {
        "PRMT": 14, "VIADDMNMX": 14, "VIADDMNMX.S16x2": 14,
        "VIMNMX.S16x2": 14, "VIMNMX3.S16x2": 14}


# ---------------------------------------------------------------------------
# Textbook WFA: the wavefront fill and the walk over its offset log
# ---------------------------------------------------------------------------


def _wfa_batch(seed, n, hi):
    """Ragged pairs up to hi bp skewed both ways (mutants with indels,
    unrelated pairs), an empty side each way and an identical pair."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(0, hi + 1)))
        if i % 3 == 2:
            s2 = rng.choice(alpha, int(rng.integers(0, hi // 3 + 1)))
        else:
            s2 = s1.copy()
            for _ in range(int(rng.integers(0, 5))):
                if len(s2):
                    s2[rng.integers(len(s2))] = rng.choice(alpha)
            if len(s2) > 10:
                p = int(rng.integers(1, len(s2) - 8))
                s2 = np.concatenate([s2[:p], s2[p + int(rng.integers(1, 7)):]])
        pairs.append((s1.tobytes(), s2.tobytes()) if i % 2 else
                     (s2.tobytes(), s1.tobytes()))
    pairs += [(b"", b"ACGTN"), (b"ACG", b""), (b"GATTACA", b"GATTACA")]
    return pairs, to_device(pack_batch(pairs, batch_size=-(-len(pairs) // 8)
                                       * 8), "cpu")


def _host_wfa_chunk(host, f, u0, n_steps, lpt, shared=None, rc_only=False,
                    sms=132):
    """hc_wfa_chunk on a fill state (the kernel's schedule run serially;
    shared: the rings' route, None as the kernel picks it by shape; sms:
    the SMs its spare CTAs are sized by): the chunk's log, every row
    written over a poisoned buffer; f's per-pair results updated in place.
    rc_only: the return code alone."""
    from sequencealigning_tpu_torch.ops import wfa

    R, B, K = f.ring_m.shape
    L1, L2 = f.seq1.shape[1], f.seq2.shape[1]
    hist = torch.full((n_steps, 3, B, K), 0x5A5A, dtype=torch.int16)
    rc = host.hc_wfa_chunk(
        *(t.data_ptr() for t in (f.seq1, f.seq2, f.n1v, f.n2v, f.codes,
                                 f.ring_m, f.ring_i, f.ring_d, f.done,
                                 f.score, f.end_k, hist)),
        B, L1, L2, K, R, f.k_lo, u0, n_steps,
        wfa._score_stride(f.penalties), *wfa.lattice_offsets(f.penalties),
        *f.spans, lpt, sms, -1 if shared is None else int(shared))
    if rc_only:
        return rc
    assert rc == 0
    return hist


def _assert_chunks_equal(host, fk, fp, steps, lpt=1, shared=None, sms=132):
    """The host schedule (fk) against wfa_chunk_torch (fp) chunk by chunk
    from the seed over `steps` ((u0, n) a launch): every log row, done,
    score and end_k equal, and the rings of the pairs still running (the
    carry; the kernel keeps a pair's rings as they were at its
    convergence, the plain fill writes NEG rows on)."""
    from sequencealigning_tpu_torch.ops import wfa

    runlen = wfa.build_runlen(fp)
    for u0, n in steps:
        want = wfa.wfa_chunk_torch(fp, u0, n, runlen)
        got = _host_wfa_chunk(host, fk, u0, n, lpt, shared, sms=sms)
        assert torch.equal(got, want), (u0, n)
        for a, b in zip(fk[7:10], fp[7:10]):
            assert torch.equal(a, b)
        live = fk.done == 0
        for a, b in zip(fk[4:7], fp[4:7]):
            assert torch.equal(a[:, live], b[:, live]), (u0, n)


_CHUNK_STEPS = ((0, 1), (1, 37), (38, 5), (43, 400))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("lpt", [1, 2, 4])
@pytest.mark.parametrize("pen,band,spans", [
    ((4, 2, 6), 8, (0, 0, 0, 0)),
    ((9, 2, 2), 4, (0, 0, 0, 0)),
    ((4, 2, 6), 6, (0, 5, 0, 5)),
    ((4, 2, 6), 2, (3, 0, 0, 7)),
    ((3, 1, 0), 8, (0, 0, 0, 0)),
    ((0, 2, 6), 8, (0, 0, 0, 0)),
])
def test_host_wfa_chunk_matches_plain(host, pen, band, spans, lpt, shared):
    """The fill kernel's lanes and steps (wfa.cuh through hc_wfa_chunk),
    lpt lanes a thread forced, the rings in shared memory or in device
    memory, against wfa_chunk_torch chunk by chunk from the seed (u = 0)
    over uneven chunk lengths: every log row (the kernel writes the NEG
    ones too), done, score, end_k and the running pairs' rings equal;
    zero mismatch and extend penalties read the slot rl steps back."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    pairs, tb = _wfa_batch(70 + lpt, 13, 150)
    k_lo, K = wfa.band_plan(tb.query_len.numpy(), tb.db_len.numpy(), band,
                            spans)
    fp = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties(*pen), spans)
    fk = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties(*pen), spans)
    _assert_chunks_equal(host, fk, fp, _CHUNK_STEPS, lpt, shared)
    assert bool(fk.done.all())


def _run_pairs(seed):
    """Pairs of at most 256 bp whose match runs pass a word and a warp's
    span (128 codes): identical pairs, one mismatch after 130-250 bp, one
    side a prefix of the other (a run stopped by n1 or n2 mid-word), runs
    ending at every offset of a word."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(12):
        ref = rng.choice(alpha, int(rng.integers(200, 257)))
        mut = ref.copy()
        if i % 3 == 0:
            p = int(rng.integers(130, len(ref)))
            mut[p] = alpha[(np.flatnonzero(alpha == mut[p])[0] + 1) % 4]
        elif i % 3 == 1:
            mut = mut[: len(mut) - 1 - i]
        pairs.append((mut.tobytes(), ref.tobytes()) if i % 2 else
                     (ref.tobytes(), mut.tobytes()))
    for n in range(1, 9):
        pairs.append((b"ACGTTGCA"[:n] + b"T", b"ACGTTGCA"[:n] + b"G"))
    return pairs


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("spans", [(0, 0, 0, 0), (4, 4, 6, 6)])
def test_host_wfa_chunk_long_and_stopped_runs(host, spans, shared):
    """Runs longer than a word and than a warp's span, runs cut by n1 or
    n2 mid-word, in the seed and in later steps: equal to the plain fill."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    pairs = _run_pairs(5)
    tb = to_device(pack_batch(pairs, batch_size=24), "cpu")
    k_lo, K = wfa.band_plan(tb.query_len.numpy(), tb.db_len.numpy(), 8,
                            spans)
    fp = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties(), spans)
    fk = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties(), spans)
    _assert_chunks_equal(host, fk, fp, _CHUNK_STEPS, 1, shared)
    assert bool(fk.done.all())


@pytest.mark.parametrize("shared", [True, False])
def test_host_wfa_chunk_codes_outside_acgt(host, shared):
    """Codes outside ACGT (0, 7, 15, 200, 255) compare as plain equality
    once packed to bytes, as the plain fill compares them."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    rng = np.random.default_rng(6)
    codes = np.array([0, 7, 15, 200, 255, 1, 2], np.int32)
    B, L = 8, 120
    s1 = rng.choice(codes, (B, L)).astype(np.int32)
    s2 = s1.copy()
    s2[:, ::17] = rng.choice(codes, s2[:, ::17].shape)
    n1 = rng.integers(60, L + 1, B).astype(np.int32)
    n2 = rng.integers(60, L + 1, B).astype(np.int32)
    tb = [torch.from_numpy(a) for a in (s1, s2, n1, n2)]
    k_lo, K = wfa.band_plan(n1, n2, 8, (0, 0, 0, 0))
    fp = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
    fk = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
    _assert_chunks_equal(host, fk, fp, _CHUNK_STEPS, 1, shared)
    assert bool(fk.done.all())


@pytest.mark.parametrize("sms", [1, 16, 132, 4096])
def test_host_wfa_chunk_spare_ctas_write_the_neg_rows(host, sms):
    """Pairs that converged before a launch have their NEG rows split over
    the spare CTAs that a batch far below the SMs gets (none at 1 SM, up to
    one a row-plane at 4096), over short launches that pairs converge
    between: every row written (the log starts as poison) and equal to the
    plain fill."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    pairs, tb = _wfa_batch(83, 6, 90)
    k_lo, K = wfa.band_plan(tb.query_len.numpy(), tb.db_len.numpy(), 8,
                            (0, 0, 0, 0))
    fp = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
    fk = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
    steps = ((0, 1), (1, 1), (2, 3), (5, 2), (7, 1), (8, 30), (38, 7),
             (45, 300))
    _assert_chunks_equal(host, fk, fp, steps, 1, None, sms)
    assert bool(fk.done.all())


def test_host_wfa_chunk_past_1024_lanes(host):
    """A band of more than 1024 lanes takes two lanes a thread by default
    (fill_lanes_per_thread), and four and eight forced: equal to the plain
    fill."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    pairs, tb = _wfa_batch(80, 5, 120)
    k_lo, K = wfa.band_plan(tb.query_len.numpy(), tb.db_len.numpy(), 560,
                            (0, 0, 0, 0))
    assert K > 1024 and wfa.fill_lanes_per_thread(K) == 2
    fp = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
    want = wfa.wfa_chunk_torch(fp, 0, 1)
    want = torch.cat([want, wfa.wfa_chunk_torch(fp, 1, 300)])
    for lpt, shared in ((2, True), (4, True), (8, True), (2, False),
                        (8, False)):
        fk = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
        got = torch.cat([_host_wfa_chunk(host, fk, 0, 1, lpt, shared),
                         _host_wfa_chunk(host, fk, 1, 300, lpt, shared)])
        assert torch.equal(got, want)
        assert torch.equal(fk.score, fp.score)
        assert torch.equal(fk.end_k, fp.end_k)


def test_host_wfa_chunk_past_the_shared_budget(host):
    """A band whose rings pass the shared-memory budget (K 3328 at the
    default penalties' 6 ring rows): the kernel's rule routes it to the
    rings in device memory, whose schedule equals the plain fill; the
    shared route refuses that shape."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    pairs, tb = _wfa_batch(82, 5, 120)
    k_lo, K = wfa.band_plan(tb.query_len.numpy(), tb.db_len.numpy(), 1600,
                            (0, 0, 0, 0))
    L1, L2 = tb.query.shape[1], tb.db.shape[1]
    R = wfa.ring_rows(WfaPenalties())
    assert K > 3200 and not host.hc_wfa_ring_in_shared(L1, L2, K, R)
    assert host.hc_wfa_ring_in_shared(L1, L2, 1152, R)
    fp = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
    fk = wfa.wfa_fill_state(*tb, k_lo, K, WfaPenalties())
    lpt = wfa.fill_lanes_per_thread(K)
    assert _host_wfa_chunk(host, fk, 0, 1, lpt, True, rc_only=True) == -1
    _assert_chunks_equal(host, fk, fp, ((0, 1), (1, 300)), lpt)


def test_host_wfa_chunk_refuses_bad_shapes(host):
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    _pairs_, tb = _wfa_batch(81, 3, 40)
    f = wfa.wfa_fill_state(*tb, -64, 128, WfaPenalties())
    R = f.ring_m.shape[0]
    hist = torch.zeros((1, 3, 8, 128), dtype=torch.int16)
    base = [t.data_ptr() for t in (f.seq1, f.seq2, f.n1v, f.n2v, f.codes,
                                   f.ring_m, f.ring_i, f.ring_d, f.done,
                                   f.score, f.end_k, hist)]
    ok = [8, f.seq1.shape[1], f.seq2.shape[1], 128, R, -64, 0, 1, 2, 2, 4, 3,
          0, 0, 0, 0, 1, 132, 1]
    assert host.hc_wfa_chunk(*base, *ok) == 0
    for i, bad in ((16, 0), (9, R), (11, 0), (3, 2048), (3, 96 + 16),
                   (17, 0), (18, 2), (8, 0)):
        args = list(ok)
        args[i] = bad
        assert host.hc_wfa_chunk(*base, *args) == -1, (i, bad)


def _host_wfa_walk(host, hist, seeds, k_lo, g, pen, W):
    B = seeds.s0.shape[0]
    S, _, Bh, K = hist.shape
    packed = torch.zeros((B, W), dtype=torch.uint32)
    n_ops = torch.empty(B, dtype=torch.int32)
    ok = torch.empty(B, dtype=torch.int32)
    rc = host.hc_wfa_walk(hist.contiguous().data_ptr(), S, Bh, K, k_lo, g,
                          *(t.data_ptr() for t in seeds), B, pen.mismatch,
                          pen.gap_open, pen.gap_extend, W, packed.data_ptr(),
                          n_ops.data_ptr(), ok.data_ptr(), 132)
    assert rc == 0
    return packed, n_ops, ok != 0


@pytest.mark.parametrize("pen,band,s_max", [
    ((4, 2, 6), 8, 16384), ((9, 2, 2), 4, 16384), ((1, 5, 1), 2, 16384),
    ((4, 2, 6), 2, 8), ((0, 2, 6), 8, 16384),
])
def test_host_wfa_walk_matches_plain(host, pen, band, s_max):
    """The walk kernel's per-pair state machine (wfa.cuh::wfa_walk_pair
    through hc_wfa_walk) against wfa_walk_torch on ragged batches: packed
    codes, op counts and ok flags equal (pairs that did not converge, and
    walks a zero mismatch penalty leaves unfinished, not ok and all 0);
    every ok walk decodes to the host walker's strings."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    pairs, tb = _wfa_batch(90 + band, 13, 200)
    pairs += [(b"A" * 150, b"T" * 150)]
    tb = to_device(pack_batch(pairs, batch_size=24), "cpu")
    p = WfaPenalties(*pen)
    res = wfa.wfa_textbook_batch(*tb, penalties=p, band=band, s_max=s_max)
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    seeds = wfa.walk_seeds(res, s1s, s2s, "cpu")
    W = wfa.walk_width(int(seeds.budget.max()))
    hist = res.device_hist()
    want = wfa.wfa_walk_torch(hist, seeds, res.k_lo, res.stride, p, W)
    got = _host_wfa_walk(host, hist, seeds, res.k_lo, res.stride, p, W)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    alns = walk.decode_packed_alignments(got[0].numpy(), s1s, s2s)
    for b in range(len(pairs)):
        if got[2][b]:
            assert alns[b] == wfa.wfa_traceback_host(res, b, *pairs[b],
                                                     p)[1:]
    if pen[0]:
        assert torch.equal(got[2], torch.from_numpy(
            res.converged[: len(pairs)]))


def _gapped_wfa_pairs(seed, n=10):
    """Pairs of at most 256 bp, each mutant carrying a 40-60 bp insertion
    or deletion (its walk leaves a staged window of 64 lanes) and a few
    substitutions."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(n):
        ref = rng.choice(alpha, int(rng.integers(150, 197)))
        mut = ref.copy()
        for _ in range(3):
            mut[rng.integers(len(mut))] = rng.choice(alpha)
        g = int(rng.integers(40, 61))
        p = int(rng.integers(20, len(mut) - g - 20))
        mut = (np.concatenate([mut[:p], mut[p + g:]]) if i % 2 else
               np.concatenate([mut[:p], rng.choice(alpha, g), mut[p:]]))
        pairs.append((mut.tobytes(), ref.tobytes()))
    return pairs


@pytest.mark.parametrize("pen", [(4, 2, 6), (1, 5, 1), (9, 2, 2),
                                 (20, 10, 1)])
def test_host_wfa_walk_long_gaps(host, pen):
    """Walks across 40-60 bp gaps over many staged batches, M runs
    crossing word boundaries, and (20/10/1: a mismatch 20 rows back) reads
    below the staged batches, loaded from the log: the host build of the
    staged schedule equals the plain walk, and every walk decodes to the
    host walker's strings."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    pairs = _gapped_wfa_pairs(96)
    tb = to_device(pack_batch(pairs, batch_size=16), "cpu")
    p = WfaPenalties(*pen)
    res = wfa.wfa_textbook_batch(*tb, penalties=p, band=64)
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    seeds = wfa.walk_seeds(res, s1s, s2s, "cpu")
    W = wfa.walk_width(int(seeds.budget.max()))
    hist = res.device_hist()
    assert hist.shape[0] > 3 * 8  # more rows than the ring of batches
    want = wfa.wfa_walk_torch(hist, seeds, res.k_lo, res.stride, p, W)
    got = _host_wfa_walk(host, hist, seeds, res.k_lo, res.stride, p, W)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2].all())
    alns = walk.decode_packed_alignments(got[0].numpy(), s1s, s2s)
    for b in range(len(pairs)):
        assert alns[b] == wfa.wfa_traceback_host(res, b, *pairs[b], p)[1:]


@pytest.mark.parametrize("batch", ["ragged", "gapped"])
def test_host_wfa_walk_budget_and_bad_seeds(host, batch):
    """Budgets one op short (not ok, codes 0), cut inside an M run and on a
    word boundary, and walks seeded off their pairs' ends, off the lattice
    (an odd score at stride 2), past the log's rows, off the band or at a
    negative offset: the host build and the plain walk alike, on ragged
    pairs and on pairs with 40-60 bp gaps and long runs."""
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.ops import wfa

    if batch == "ragged":
        pairs, tb = _wfa_batch(95, 6, 80)
        band = 8
    else:
        pairs = _gapped_wfa_pairs(97, n=6) + _run_pairs(7)[:6]
        tb = to_device(pack_batch(pairs, batch_size=16), "cpu")
        band = 64
    p = WfaPenalties()
    res = wfa.wfa_textbook_batch(*tb, penalties=p, band=band)
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    seeds = wfa.walk_seeds(res, s1s, s2s, "cpu")
    W = wfa.walk_width(int(seeds.budget.max()))
    hist = res.device_hist()
    full = wfa.wfa_walk_torch(hist, seeds, res.k_lo, res.stride, p, W)
    assert bool(full[2].all())
    n = full[1]
    S, K = hist.shape[0], hist.shape[3]
    t0 = seeds.t0.clone()
    t0[::2] += 1
    k0 = seeds.k0.clone()
    k0[1::2] -= 3
    far = torch.where(torch.arange(len(pairs)) % 2 == 0, res.k_lo - 3,
                      res.k_lo + K + 2).to(torch.int32)
    cases = (seeds._replace(budget=n - 1), seeds._replace(t0=t0),
             seeds._replace(k0=k0), seeds._replace(budget=n - 7),
             seeds._replace(budget=n - 1 - (n - 1) % 16),
             seeds._replace(s0=seeds.s0 + 1),
             seeds._replace(s0=torch.full_like(seeds.s0, 2 * S + 4)),
             seeds._replace(k0=far), seeds._replace(t0=-seeds.t0))
    for i, sd in enumerate(cases):
        want = wfa.wfa_walk_torch(hist, sd, res.k_lo, res.stride, p, W)
        got = _host_wfa_walk(host, hist, sd, res.k_lo, res.stride, p, W)
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        assert not got[0][~got[2]].any(), i
        if i == 0:
            assert not bool(want[2].any()) and not bool(want[0].any())

"""int16 stream state of the port (ops.nw_affine_stream and
ops.nw_affine_stream_modes with state_dtype int16, and the int16 instances
of the fill kernels through csrc/host_check.cpp) against the JAX package's
int16 lax fills, against the port's int32 fills, and against the plain
versions: exact, the results are integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequencealigning_tpu.config import ScoringScheme as JaxScheme
from sequencealigning_tpu.ops import nw_affine_stream as jax_stream
from sequencealigning_tpu.ops import nw_affine_stream_modes as jax_smodes
from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import ScoringScheme
from sequencealigning_tpu_torch.device import to_device
from sequencealigning_tpu_torch.io.encode import pack_batch, trim_for_stream
from sequencealigning_tpu_torch.ops import nw_affine_modes as modes
from sequencealigning_tpu_torch.ops import nw_affine_stream as port
from sequencealigning_tpu_torch.ops import nw_affine_stream_modes as pmodes
from sequencealigning_tpu_torch.ops.traceback import traceback_stream_batch
from sequencealigning_tpu_torch.ops.traceback_device import (
    assemble_modes_alignments,
    modes_walk_device,
)

I16, I32 = torch.int16, torch.int32
_DIRS = {None: 0, "fast4": 1, "full": 2}
WILD = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)


@pytest.fixture(scope="module")
def host():
    if csrc.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/host_check.cpp")
    return csrc.host_check()


def _pairs(seed, n, lo=1, hi=60, alphabet=b"ACGTN", related=True):
    """n random pairs, every third db a mutated copy of its query."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        s2 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        if related and i % 3 == 1:
            s2 = s1.copy()
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        out.append((s1.tobytes(), s2.tobytes()))
    return out


def _wide(pairs):
    """pairs plus one whose db is 256 bp, so the rows take 384 lanes."""
    return pairs + [(b"ACGT" * 10, b"ACGTTGCA" * 32)]


def _inputs(pairs, np_slots, trim=True):
    batch = pack_batch(pairs, batch_size=-(-len(pairs) // 8) * 8)
    if trim:
        batch = trim_for_stream(batch)
    return port.stream_inputs(*to_device(batch, "cpu"), np_slots=np_slots)


def _jax_scheme(s):
    return JaxScheme(match_=s.match_, mismatch=s.mismatch,
                     gap_open=s.gap_open, gap_extend=s.gap_extend)


def _jnp(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


def _same_finals(f16, f32):
    """int16 finals against int32's: each pair's score and every finite
    corner value equal.  A -inf corner value (a plane no path reaches, as
    I at (x, 1) in compat) is each state's own sentinel plus gap steps, so
    it is only required to stay below every finite one."""
    f16, f32 = np.asarray(f16), np.asarray(f32)
    np.testing.assert_array_equal(f16.max(axis=1), f32.max(axis=1))
    finite = f32 > -32768
    np.testing.assert_array_equal(f16[finite], f32[finite])
    assert (f16[~finite] < f32.max(axis=1)[:, None].repeat(3, 1)[~finite]
            ).all()


def _view(results):
    """Walk results by value (an error by its type and message)."""
    return [(type(r).__name__, str(r)) if isinstance(r, Exception) else r
            for r in results]


# ---------------------------------------------------------------------------
# The plain int16 fills against the JAX package's int16 lax fills
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("dirs_mode", [None, "fast4", "full"])
@pytest.mark.parametrize("compat", [True, False])
def test_plain_i16_fill_matches_lax(compat, dirs_mode, wildcard):
    """Global fill, int16 state: finals and the whole dirs tensor equal
    gotoh_fill_stream_lax's with state_dtype int16."""
    scheme = WILD if wildcard else ScoringScheme()
    plan, ins = _inputs(_pairs(11 + compat, 21), 3)
    assert port.stream_i16_neg(scheme, plan) is not None
    (fm, fi, fd), dirs_j = jax_stream.gotoh_fill_stream_lax(
        *_jnp(*ins), jax_stream.StreamPlan(*plan), _jax_scheme(scheme),
        compat, wildcard, dirs_mode, state_dtype=jnp.int16,
    )
    finals, dirs = port.gotoh_fill_stream_torch(
        *ins, plan, scheme, compat, wildcard, dirs_mode, state_dtype=I16)
    want = np.stack([np.asarray(a).T.reshape(-1) for a in (fm, fi, fd)],
                    axis=1)
    assert finals.dtype == torch.int32
    np.testing.assert_array_equal(finals.numpy(), want)
    if dirs_mode is None:
        assert dirs is None and dirs_j is None
    else:
        np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))


@pytest.mark.parametrize("with_dirs", [False, True])
@pytest.mark.parametrize("mode", ["semi", "local"])
def test_plain_i16_modes_matches_lax(mode, with_dirs):
    """Semi-global and local fills, int16 state: bv, bd and the dirs equal
    gotoh_fill_stream_modes_lax's with state_dtype int16."""
    plan, ins = _inputs(_pairs(23 + len(mode), 19, hi=70), 2, trim=False)
    (bv_j, bd_j), dirs_j = jax_smodes.gotoh_fill_stream_modes_lax(
        *_jnp(*ins), jax_stream.StreamPlan(*plan), JaxScheme(), True, mode,
        with_dirs, state_dtype=jnp.int16,
    )
    (bv, bd), dirs = pmodes.gotoh_fill_stream_modes_torch(
        *ins, plan, ScoringScheme(), True, mode, with_dirs, state_dtype=I16)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(bv_j))
    np.testing.assert_array_equal(bd.numpy(), np.asarray(bd_j))
    if with_dirs:
        np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))


@pytest.mark.parametrize("dirs_mode", ["fast4", "full"])
def test_plain_i16_fill_with_query_longer_than_lanes(dirs_mode):
    """S > P (the boundary lane p passes the lane width), int16 state."""
    rng = np.random.default_rng(8)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = [(rng.choice(alpha, int(rng.integers(150, 230))).tobytes(),
              rng.choice(alpha, int(rng.integers(5, 40))).tobytes())
             for _ in range(12)]
    plan, ins = _inputs(pairs, 2)
    assert plan.s > plan.p
    (fm, fi, fd), dirs_j = jax_stream.gotoh_fill_stream_lax(
        *_jnp(*ins), jax_stream.StreamPlan(*plan), JaxScheme(), False,
        False, dirs_mode, state_dtype=jnp.int16,
    )
    finals, dirs = port.gotoh_fill_stream_torch(
        *ins, plan, ScoringScheme(), False, False, dirs_mode, state_dtype=I16)
    want = np.stack([np.asarray(a).T.reshape(-1) for a in (fm, fi, fd)],
                    axis=1)
    np.testing.assert_array_equal(finals.numpy(), want)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))


# ---------------------------------------------------------------------------
# int16 against int32: finals and walked alignments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compat", [True, False])
def test_i16_finals_and_walks_equal_i32(compat):
    """The int16 batch's finals equal int32's on its pairs (_same_finals;
    the empty padding pairs are left out), and so do the co-optimal and
    first-path walks of its dirs."""
    pairs = _pairs(41 + compat, 20, hi=80, alphabet=b"ACGT")
    tb = to_device(trim_for_stream(pack_batch(pairs, batch_size=24)), "cpu")
    s1s, s2s = [p[0] for p in pairs], [p[1] for p in pairs]
    for with_dirs in (True, "fast4"):
        r32, r16 = (port.nw_affine_stream_batch(
            *tb, compat=compat, with_dirs=with_dirs, state_dtype=st)
            for st in ("i32", "i16"))
        n = len(pairs)
        _same_finals(r16.finals[:n], r32.finals[:n])
        w32, w16 = (traceback_stream_batch(
            r.dirs.numpy(), r.finals, s1s, s2s, r.plan, compat=compat,
            dirs_mode="fast4" if with_dirs == "fast4" else "full")
            for r in (r32, r16))
        assert _view(w16) == _view(w32)


@pytest.mark.parametrize("mode", ["semi", "local"])
def test_i16_modes_walks_equal_i32(mode):
    """The int16 modes fill's end cells and walked alignments equal
    int32's."""
    pairs = _pairs(53 + len(mode), 32, lo=5, hi=60)
    tb = to_device(pack_batch(pairs, batch_size=32), "cpu")
    got = {}
    for st in ("i32", "i16"):
        res = pmodes.nw_affine_stream_modes_batch(*tb, mode, state_dtype=st)
        bs = np.arange(len(pairs))
        rowp = bs // res.plan.np_slots
        offs = (bs % res.plan.np_slots) * res.plan.s
        walked = modes_walk_device(
            res.dirs, res.best_x, res.best_y, rowp, offs,
            [p[0] for p in pairs], [p[1] for p in pairs], mode == "local",
            res.plan.l1 + res.plan.l2)
        got[st] = (res.best.tolist(), res.best_x.tolist(),
                   res.best_y.tolist(), assemble_modes_alignments(
                       pairs, walked, res.best, res.best_x, res.best_y,
                       mode == "local"))
    assert got["i16"] == got["i32"]


# ---------------------------------------------------------------------------
# Ports of the JAX package's int16 tests (tests/test_nw_stream.py)
# ---------------------------------------------------------------------------


def test_i16_deep_negative_range():
    """Pure-mismatch pairs drive real cells deep below a naive sentinel;
    the certified sentinel and the floor clamp keep the finals exact."""
    n, L = 8, 256
    tb = to_device(pack_batch([(b"A" * L, b"T" * L)] * n, batch_size=n),
                   "cpu")
    r32, r16 = (port.nw_affine_stream_batch(
        *tb, with_dirs=False, np_slots=1, state_dtype=st)
        for st in ("i32", "i16"))
    np.testing.assert_array_equal(r16.finals, r32.finals)
    assert int(r32.finals[0][0]) == -4 * L


def test_i16_gate_rejects_overflow():
    """A scheme x shape outside the certification raises ValueError naming
    int16, in the batch entries and in the fills; "auto" takes int32."""
    big = ScoringScheme(match_=5, mismatch=-400, gap_open=-800,
                        gap_extend=-600)
    plan = port.plan_stream(16, 60, 60)
    assert port.stream_i16_neg(big, plan) is None
    assert jax_stream.stream_i16_neg(
        _jax_scheme(big), jax_stream.StreamPlan(*plan)) is None
    tb = to_device(pack_batch(_pairs(7, 16, hi=14), batch_size=16), "cpu")
    with pytest.raises(ValueError, match="int16"):
        port.nw_affine_stream_batch(*tb, scheme=big, with_dirs=False,
                                    state_dtype="i16")
    with pytest.raises(ValueError, match="int16"):
        pmodes.nw_affine_stream_modes_batch(*tb, "local", scheme=big,
                                            state_dtype="i16")
    plan, ins = port.stream_inputs(*tb)
    for fn in (port.gotoh_fill_stream_torch, port.gotoh_fill_stream_cuda):
        with pytest.raises(ValueError, match="int16"):
            fn(*ins, plan, big, True, False, None, state_dtype=I16)
    with pytest.raises(ValueError, match="int16"):
        pmodes.gotoh_fill_stream_modes_torch(*ins, plan, big, False, "semi",
                                             True, state_dtype=I16)
    r_auto = port.nw_affine_stream_batch(*tb, scheme=big, with_dirs=False,
                                         state_dtype="auto")
    r32 = port.nw_affine_stream_batch(*tb, scheme=big, with_dirs=False)
    np.testing.assert_array_equal(r_auto.finals, r32.finals)


def test_i16_auto_resolution_matches_jax():
    """"auto" resolves to int16 exactly when the scheme x shape certifies,
    as the JAX package's resolve_stream_state does off the TPU; "i32",
    None and "i16" resolve unconditionally; dtypes pass; others raise."""
    big = ScoringScheme(match_=5, mismatch=-400, gap_open=-800,
                        gap_extend=-600)
    jdt = {jnp.int16: I16, jnp.int32: I32}
    for n, l1, l2 in ((16, 60, 60), (4096, 2046, 2046), (1024, 5115, 5115),
                      (64, 8000, 8000), (64, 2700, 2700), (64, 2800, 2800)):
        for s in (ScoringScheme(), big, WILD):
            plan = port.plan_stream(n, l1, l2)
            jplan = jax_stream.StreamPlan(*plan)
            for req in ("i32", "i16", "auto", None):
                want = jax_stream.resolve_stream_state(req, _jax_scheme(s),
                                                       jplan)
                assert port.resolve_stream_state(req, s, plan) == \
                    jdt[want], (n, l1, s, req)
    plan = port.plan_stream(16, 60, 60)
    assert port.resolve_stream_state(I16, big, plan) == I16
    with pytest.raises(ValueError, match="stream state"):
        port.resolve_stream_state("i8", ScoringScheme(), plan)
    with pytest.raises(ValueError, match="stream state"):
        port.check_stream_state("int16")


def test_i16_headline_shape_certified_at_every_depth():
    """The main path's headline shape, 4096 x 2046 bp under the default
    scheme, certifies at every pipeline depth 1-8 with sentinel -24632;
    1024 x 5115 bp and 64 x 8000 bp do not."""
    for np_slots in range(1, 9):
        plan = port.plan_stream(4096, 2046, 2046, np_slots=np_slots)
        assert port.stream_i16_neg(ScoringScheme(), plan) == -24632
    for n, l in ((1024, 5115), (64, 8000)):
        assert port.stream_i16_neg(ScoringScheme(),
                                   port.plan_stream(n, l, l)) is None


def test_i16_certification_boundary():
    """Schemes with large per-char costs reach the int16 limit at tiny
    lengths: the JAX package's four (two certified near each bound, one
    past the chain bound, one past the growth bound) and random ones.
    Whatever the gate certifies equals int32 (_same_finals, and the fast4
    dirs' first-path walks); what it refuses raises ValueError naming
    int16."""
    rng = np.random.default_rng(83)
    hi = 24
    pairs = _pairs(83, 12, lo=2, hi=hi, alphabet=b"ACGT", related=False)
    pairs += [(b"A" * hi, b"T" * hi), (b"A" * hi, b"C"), (b"G", b"T" * hi)]
    tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cpu")
    plan, _ = port.stream_inputs(*tb, np_slots=2)
    s1s, s2s = [p[0] for p in pairs], [p[1] for p in pairs]
    schemes = [
        ScoringScheme(match_=5, mismatch=-110, gap_open=-8, gap_extend=-6),
        ScoringScheme(match_=80, mismatch=-4, gap_open=-8, gap_extend=-6),
        ScoringScheme(match_=5, mismatch=-300, gap_open=-200,
                      gap_extend=-250),
        ScoringScheme(match_=600, mismatch=-4, gap_open=-8, gap_extend=-6),
    ]
    assert [port.stream_i16_neg(s, plan) is None for s in schemes] == \
        [False, False, True, True]
    schemes += [ScoringScheme(match_=int(rng.integers(1, 400)),
                              mismatch=-int(rng.integers(1, 800)),
                              gap_open=-int(rng.integers(0, 900)),
                              gap_extend=-int(rng.integers(1, 700)))
                for _ in range(16)]
    seen = refused = 0
    for sch in schemes:
        if port.stream_i16_neg(sch, plan) is None:
            refused += 1
            with pytest.raises(ValueError, match="int16"):
                port.nw_affine_stream_batch(*tb, scheme=sch, with_dirs=False,
                                            np_slots=2, state_dtype="i16")
            continue
        seen += 1
        r32, r16 = (port.nw_affine_stream_batch(
            *tb, scheme=sch, with_dirs="fast4", np_slots=2, state_dtype=st)
            for st in ("i32", "i16"))
        _same_finals(r16.finals, r32.finals)
        w32, w16 = (traceback_stream_batch(
            r.dirs.numpy(), r.finals, s1s, s2s, r.plan, dirs_mode="fast4")
            for r in (r32, r16))
        assert _view(w16) == _view(w32), sch
    assert seen >= 2 and refused >= 2


# ---------------------------------------------------------------------------
# The int16 kernel instances' arithmetic and schedule (host build)
# ---------------------------------------------------------------------------


def _host_fill16(host, plan, ins, scheme, compat, wildcard, dirs_mode,
                 cta_lanes=0, lpt=0, chunk=0, slots=0, wrap=0):
    """hc_stream_fill_i16: (finals, dirs), the dirs poisoned beforehand."""
    R, P, NP = plan.n_rows, plan.p, plan.np_slots
    finals = torch.zeros((R * NP, 3), dtype=torch.int32)
    upack = 8 if dirs_mode == "fast4" else 4
    dirs = torch.full((plan.t_total // upack, R, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    rc = host.hc_stream_fill_i16(
        *(t.data_ptr() for t in ins), finals.data_ptr(), dirs.data_ptr(),
        status.data_ptr(), R, plan.t_total, P, plan.s, NP, scheme.match_,
        scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        _DIRS[dirs_mode], int(compat), int(wildcard), cta_lanes, lpt, chunk,
        slots, wrap, port.stream_i16_neg(scheme, plan),
    )
    assert rc == 0
    return finals, dirs


def _host_modes16(host, plan, ins, scheme, local, wildcard, with_dirs,
                  cta_lanes=0, lpt=0, chunk=0, slots=0):
    R, P, NP = plan.n_rows, plan.p, plan.np_slots
    out = torch.empty((2, NP, R, P), dtype=torch.int32)
    out[0].fill_(modes.NEGBIG)
    out[1].zero_()
    dirs = torch.full((plan.t_total // 4, R, P), 0x5a5a5a5a,
                      dtype=torch.uint32)
    status = torch.zeros(1, dtype=torch.int32)
    rc = host.hc_stream_modes_fill_i16(
        *(t.data_ptr() for t in ins), out.data_ptr(), dirs.data_ptr(),
        status.data_ptr(), R, plan.t_total, P, plan.s, NP, scheme.match_,
        scheme.mismatch, scheme.gap_open, scheme.gap_extend,
        2 if with_dirs else 0, int(local), int(wildcard), cta_lanes, lpt,
        chunk, slots, 0, port.stream_i16_neg(scheme, plan),
    )
    assert rc == 0
    return out[0], out[1], dirs


def _scheme(rng):
    """A random scheme (certified at the tests' shapes)."""
    return ScoringScheme(match_=int(rng.integers(1, 12)),
                         mismatch=-int(rng.integers(1, 12)),
                         gap_open=-int(rng.integers(0, 15)),
                         gap_extend=-int(rng.integers(1, 10)))


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("dirs_mode", [None, "fast4", "full"])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("lpt", [2, 4, 8, 16])
def test_host_i16_fill_matches_plain(host, lpt, compat, dirs_mode, wildcard):
    """hc_stream_fill_i16 (the int16 instances' cells in the kernel's
    warp-ring schedule) equals the plain int16 fill bit for bit, finals
    and the whole dirs tensor, over a random certified scheme, 2-16 lanes
    a thread and 2-4 slots a row on 384 lanes (several warps)."""
    rng = np.random.default_rng(lpt * 7 + compat * 3 + len(str(dirs_mode)))
    scheme = _scheme(rng)
    plan, ins = _inputs(_wide(_pairs(101 + lpt, 20, hi=250)), 2 + lpt % 3)
    assert plan.p == 384 and port.stream_i16_neg(scheme, plan) is not None
    got = _host_fill16(host, plan, ins, scheme, compat, wildcard, dirs_mode,
                       lpt=lpt, chunk=5 + lpt)
    want = port.gotoh_fill_stream_torch(*ins, plan, scheme, compat, wildcard,
                                        dirs_mode, state_dtype=I16)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    if dirs_mode:
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("with_dirs", [False, True])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("lpt", [2, 4, 8, 16])
def test_host_i16_modes_match_plain(host, lpt, local, with_dirs):
    """hc_stream_modes_fill_i16 equals the plain int16 modes fill: argmax
    planes and dirs, random certified schemes, 2-16 lanes a thread."""
    rng = np.random.default_rng(lpt * 5 + local)
    scheme = _scheme(rng)
    plan, ins = _inputs(_wide(_pairs(131 + lpt, 20, hi=240)), 2,
                        trim=False)
    assert plan.p == 384
    got = _host_modes16(host, plan, ins, scheme, local, lpt == 4, with_dirs,
                        lpt=lpt, chunk=3 + lpt)
    (bv, bd), dirs = pmodes.gotoh_fill_stream_modes_torch(
        *ins, plan, scheme, lpt == 4, "local" if local else "semi",
        with_dirs, state_dtype=I16)
    np.testing.assert_array_equal(got[0].numpy(), bv.numpy())
    np.testing.assert_array_equal(got[1].numpy(), bd.numpy())
    if with_dirs:
        np.testing.assert_array_equal(got[2].numpy(), dirs.numpy())


@pytest.mark.parametrize("kind", ["fast4", "full", "none", "semi", "local"])
@pytest.mark.parametrize("cta_lanes,lpt", [(128, 2), (128, 4), (256, 8)])
def test_host_i16_split_rows_match_plain(host, kind, cta_lanes, lpt):
    """Rows split over 2-4 forced CTAs (the cluster instances' geometry:
    the last warp of a CTA feeding the next CTA's ring, lane 0's words
    finished by the last CTA), int16 state, equal the plain fill."""
    scheme = ScoringScheme()
    plan, ins = _inputs(_wide(_pairs(151 + lpt, 15, lo=100, hi=250)), 2,
                        trim=kind not in ("semi", "local"))
    assert -(-plan.p // cta_lanes) >= 2
    if kind in ("semi", "local"):
        got = _host_modes16(host, plan, ins, scheme, kind == "local", False,
                            True, cta_lanes=cta_lanes, lpt=lpt)
        (bv, bd), dirs = pmodes.gotoh_fill_stream_modes_torch(
            *ins, plan, scheme, False, kind, True, state_dtype=I16)
        for g, w in zip(got, (bv, bd, dirs)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        return
    dm = None if kind == "none" else kind
    got = _host_fill16(host, plan, ins, scheme, True, False, dm,
                       cta_lanes=cta_lanes, lpt=lpt)
    want = port.gotoh_fill_stream_torch(*ins, plan, scheme, True, False, dm,
                                        state_dtype=I16)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    if dm:
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def _h2(lo, hi):
    return (lo.astype(np.int64) & 0xffff) | ((hi.astype(np.int64) & 0xffff)
                                             << 16)


def test_host_h2_dpx_per_half(host):
    """The packed helpers' host forms (stream_cell16.cuh) per half against
    scalar maxima: add-max, add-max with relu, max3, max, the not-equal
    flag, the left-neighbour shift and the add, on int16 values whose
    sums stay inside int16."""
    rng = np.random.default_rng(5)
    n = 4096
    v = [rng.integers(-16000, 16000, size=(2, n)) for _ in range(3)]
    v[1][:, :64] = v[0][:, :64]  # equal halves for the not-equal flag
    a, b, c = (np.ascontiguousarray(_h2(x[0], x[1]), np.uint32) for x in v)
    out = np.zeros(7 * n, np.uint32)
    host.hc_h2_dpx(a.ctypes.data, b.ctypes.data, c.ctypes.data,
                   out.ctypes.data, n)
    out = out.reshape(7, n)

    def half(w, h):
        return ((w.astype(np.int64) >> (16 * h)) & 0xffff).astype(
            np.uint16).view(np.int16).astype(np.int64)

    for h in (0, 1):
        x, y, z = v[0][h], v[1][h], v[2][h]
        np.testing.assert_array_equal(half(out[0], h), np.maximum(x + y, z))
        np.testing.assert_array_equal(half(out[1], h),
                                      np.maximum(np.maximum(x + y, z), 0))
        np.testing.assert_array_equal(half(out[2], h),
                                      np.maximum(np.maximum(x, y), z))
        np.testing.assert_array_equal(half(out[3], h), np.maximum(x, y))
        np.testing.assert_array_equal(half(out[4], h), x != y)
        np.testing.assert_array_equal(half(out[6], h), x + y)
    # h2_left: (a's high lane, b's low lane).
    np.testing.assert_array_equal(half(out[5], 0), v[0][1])
    np.testing.assert_array_equal(half(out[5], 1), v[1][0])


def test_cuda_wrappers_refuse_cpu_tensors_i16():
    """The int16 instances' wrappers take CUDA tensors only, and do not
    count a refused call."""
    tb = to_device(pack_batch(_pairs(3, 8), batch_size=8), "cpu")
    plan, ins = port.stream_inputs(*tb)
    before = (port.gotoh_fill_stream_cuda.launches_i16,
              pmodes.gotoh_fill_stream_modes_cuda.launches_i16)
    with pytest.raises(ValueError, match="CUDA"):
        port.gotoh_fill_stream_cuda(*ins, plan, ScoringScheme(), True, False,
                                    "fast4", state_dtype=I16)
    with pytest.raises(ValueError, match="CUDA"):
        pmodes.gotoh_fill_stream_modes_cuda(*ins, plan, ScoringScheme(),
                                            False, "local", True,
                                            state_dtype=I16)
    assert (port.gotoh_fill_stream_cuda.launches_i16,
            pmodes.gotoh_fill_stream_modes_cuda.launches_i16) == before


# ---------------------------------------------------------------------------
# The word-at-a-time flags and codes (stream_cell16.cuh) against the
# per-lane definitions of ring_cell
# ---------------------------------------------------------------------------


def _s16(w, h):
    """Half h of uint32 words as int16 values (int64)."""
    return ((np.asarray(w, np.int64) >> (16 * h)) & 0xffff).astype(
        np.uint16).view(np.int16).astype(np.int64)


def _u16(w, h):
    return (np.asarray(w, np.int64) >> (16 * h)) & 0xffff


def _edge_words(rng, n, neg):
    """n words of int16 pairs: a third from the edges (INT16_MIN, the
    sentinel and the sentinel minus its dip, 0, +-1, INT16_MAX, values
    and their sign-flipped twins), so equal halves, ties of a maximum with
    its operands and halves that differ only in the sign bit abound; the
    rest uniform."""
    edges = np.array([-32768, -32767, neg, neg - 1, neg - 12, neg - 64, -1,
                      0, 1, 5, 12345, 12345 - 32768, 32767, 32766, 0x7ff,
                      0x7ff - 32768], np.int64)
    v = rng.integers(-32768, 32768, size=(2, n))
    pick = rng.random((2, n)) < 0.67
    v[pick] = rng.choice(edges, int(pick.sum()))
    return np.ascontiguousarray(_h2(v[0], v[1]), np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_h2_codes_match_per_lane(host, seed):
    """hc_h2_codes: both lanes' fast4 and full codes (at bits 12-15 /
    8-15 of each half), the D bits, the fast4 accumulator's split and the
    full codes' pushes equal
    ring_cell's per-lane definitions half by half, on seeded words rich in
    edge values (INT16_MIN, the default sentinel -24632 and below it, ties,
    equal halves, halves differing only in sign): no borrow crosses a
    half."""
    rng = np.random.default_rng(seed)
    n = 6144
    M, I, D, I1, t0, D1, m = (_edge_words(rng, n, -24632) for _ in range(7))
    # Ties of the maximum with more than one operand, and I1 == t0 / D1 ==
    # t0, in a sixth of the words each.
    k = n // 6
    I[:k] = M[:k]
    D[k:2 * k] = I[k:2 * k]
    D[2 * k:3 * k] = M[2 * k:3 * k]
    t0[3 * k:4 * k] = I1[3 * k:4 * k]
    t0[4 * k:5 * k] = D1[4 * k:5 * k]
    out = np.zeros(8 * n, np.uint32)
    host.hc_h2_codes(*(a.ctypes.data for a in (M, I, D, I1, t0, D1, m)),
                     out.ctypes.data, n)
    out = out.reshape(8, n)
    for h in (0, 1):
        vM, vI, vD, vI1, vt0, vD1, vm = (_s16(a, h)
                                         for a in (M, I, D, I1, t0, D1, m))
        H = np.maximum(np.maximum(vM, vI), vD)
        fast4 = (np.where(vM == H, 0, np.where(vI == H, 1, 2))
                 | np.where(vI1 >= vt0, 4, 0))
        np.testing.assert_array_equal(_u16(out[0], h), fast4 << 12)
        full = ((vM == H) * 1 | (vI == H) * 2 | (vD == H) * 4
                | (vI1 >= vt0) * 8 | (vt0 >= vI1) * 16 | (vm < 0) * 128)
        np.testing.assert_array_equal(_u16(out[1], h), full << 8)
        np.testing.assert_array_equal(_u16(out[2], h),
                                      ((vD1 >= vt0) * 8) << 12)
        np.testing.assert_array_equal(
            _u16(out[3], h), ((vD1 >= vt0) * 32 | (vt0 >= vD1) * 64) << 8)
        # The split words: nibble k = the top nibble of push k's half.
        word = np.zeros(n, np.int64)
        for j, a in enumerate((I, D, I1, m, D1, t0, M)):
            word |= (_u16(a, h) >> 12) << (4 * j)
        Hw = _h2(np.maximum(np.maximum(_s16(M, 0), _s16(I, 0)), _s16(D, 0)),
                 np.maximum(np.maximum(_s16(M, 1), _s16(I, 1)),
                            _s16(D, 1)))
        word |= (_u16(Hw, h) >> 12) << 28
        np.testing.assert_array_equal(out[4 + h].astype(np.int64), word)
        # push_full2: byte k = the top byte of push k's half.
        word = np.zeros(n, np.int64)
        for j, a in enumerate((I, D, I1, m)):
            word |= (_u16(a, h) >> 8) << (8 * j)
        np.testing.assert_array_equal(out[6 + h].astype(np.int64), word)


def _edge_batch():
    """Queries of 200-256 bp against dbs of 1-4 bp, plus all-mismatch
    pairs, and the steep scheme that certifies them with the least room:
    the sentinel minus its dip lies 20 above INT16_MIN, so the floored
    chains of the cells outside the pairs sit next to real cells in the
    same words."""
    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = [(rng.choice(alpha, int(rng.integers(200, 257))).tobytes(),
              rng.choice(alpha, int(rng.integers(1, 5))).tobytes())
             for _ in range(12)]
    pairs += [(b"A" * 256, b"T" * 4), (b"C" * 256, b"G")]
    scheme = ScoringScheme(match_=5, mismatch=-60, gap_open=-100,
                           gap_extend=-84)
    return pairs, scheme


def test_i16_edge_scheme_is_at_the_certification_edge():
    """The edge batch's scheme certifies with 20 to spare (the sentinel's
    dip) and one unit steeper does not."""
    pairs, scheme = _edge_batch()
    plan, _ = _inputs(pairs, 2)
    neg = port.stream_i16_neg(scheme, plan)
    dip = abs(scheme.gap_open) + abs(scheme.gap_extend) + 60
    assert neg is not None and neg - dip == -32768 + 20
    steeper = ScoringScheme(match_=5, mismatch=-60, gap_open=-100,
                            gap_extend=-85)
    assert port.stream_i16_neg(steeper, plan) is None


@pytest.mark.parametrize("lpt", [2, 8])
@pytest.mark.parametrize("kind", ["fast4", "full", "semi", "local"])
def test_host_i16_certification_edge_matches_plain_and_lax(host, kind, lpt):
    """At the certification's edge (_edge_batch) the int16 instances' host
    twin equals the int16 plain fill and the JAX package's int16 lax fill
    (finals or argmax planes, whole dirs), and the finals equal int32's."""
    pairs, scheme = _edge_batch()
    modes_kind = kind in ("semi", "local")
    plan, ins = _inputs(pairs, 2, trim=not modes_kind)
    if modes_kind:
        got = _host_modes16(host, plan, ins, scheme, kind == "local", False,
                            True, lpt=lpt)
        (bv, bd), dirs = pmodes.gotoh_fill_stream_modes_torch(
            *ins, plan, scheme, False, kind, True, state_dtype=I16)
        (bv_j, bd_j), dirs_j = jax_smodes.gotoh_fill_stream_modes_lax(
            *_jnp(*ins), jax_stream.StreamPlan(*plan), _jax_scheme(scheme),
            False, kind, True, state_dtype=jnp.int16)
        for g, w, j in zip(got, (bv, bd, dirs), (bv_j, bd_j, dirs_j)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
            np.testing.assert_array_equal(w.numpy(), np.asarray(j))
        return
    got = _host_fill16(host, plan, ins, scheme, True, False, kind, lpt=lpt)
    finals, dirs = port.gotoh_fill_stream_torch(
        *ins, plan, scheme, True, False, kind, state_dtype=I16)
    (fm, fi, fd), dirs_j = jax_stream.gotoh_fill_stream_lax(
        *_jnp(*ins), jax_stream.StreamPlan(*plan), _jax_scheme(scheme), True,
        False, kind, state_dtype=jnp.int16)
    want = np.stack([np.asarray(a).T.reshape(-1) for a in (fm, fi, fd)],
                    axis=1)
    np.testing.assert_array_equal(got[0].numpy(), finals.numpy())
    np.testing.assert_array_equal(finals.numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), dirs.numpy())
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))
    f32, _ = port.gotoh_fill_stream_torch(*ins, plan, scheme, True, False,
                                          kind)
    n = len(pairs)
    _same_finals(got[0][:n], f32[:n])


def test_sass_blocks_rank_dpx_runs_and_count_int16_words():
    """csrc/sass_spills.dpx_blocks on a listing in cuobjdump's form: the
    straight-line runs split at branches and branch targets, ranked by
    their DPX instructions (predicated ones counted), with their opcodes
    by base name and their int16 words (s16x2 adds to INT16_MIN, two a
    word)."""
    from sequencealigning_tpu_torch.csrc import sass_spills

    word = ["VIADDMNMX.S16x2 R1, R2, R3, 0x80008000, !PT",
            "VIMNMX.U16x2 R4, R5, 0x10001, PT",
            "LOP3.LUT R6, R7, R8, RZ, 0x3c, !PT",
            "@P1 VIADDMNMX.S16x2 R9, R10, R11, 0x80008000, !PT",
            "IMAD R12, R13, R14, -0x7fff8000"]
    ops = (["IMAD R1, R2, R3, RZ", "@P0 BRA 0x70"] + word * 3
           + ["BRA 0x0", "VIMNMX3.S16x2 R1, R2, R3, R4, !PT"] + word
           + ["EXIT"])
    funcs = sass_spills.functions("\n".join(
        ["        Function : k"]
        + [f"        /*{16 * i:04x}*/                   {op} ;"
           for i, op in enumerate(ops)]))
    got = sass_spills.dpx_blocks(funcs["k"], 3)
    # The branches end runs (at 0x10, 0x110), the branch target 0x70
    # starts one: the second and third words with the branch after them,
    # then the max3 and the last word, then the first word.
    assert [(b["first"], b["instructions"], b["dpx"], b["words"])
            for b in got] == [(0x70, 11, 6, 2.0), (0x120, 7, 4, 1.0),
                              (0x20, 5, 3, 1.0)]
    assert got[0]["opcodes"] == {"VIADDMNMX": 4, "VIMNMX": 2, "LOP3": 2,
                                 "IMAD": 2, "BRA": 1}

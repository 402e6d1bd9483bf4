"""Time the streamed fills (kernels #1 and #2, ``nw_affine_stream.cu``) on the
card over their warp rings' knobs -- lanes a thread (so threads a block),
chunk steps, slots a warp edge -- at the main shapes of ``chip_smoke.py``:
4096 pairs of 2046 bp, global fast4 trimmed (kernel #1) and textbook local
and semi-global with full dirs untrimmed (kernel #2):

    python -m sequencealigning_tpu_torch.csrc.stream_sweep [--out FILE]
        [--configs N] [--others] [--long] [--pipeline]
    python sequencealigning_tpu_torch/csrc/stream_sweep.py --root DIR
        [--others] [--long] [--pipeline]
    python sequencealigning_tpu_torch/csrc/stream_sweep.py [--root DIR]
        --walks N [--out FILE]
    python sequencealigning_tpu_torch/csrc/stream_sweep.py [--root DIR]
        --wfa N [--out FILE]
    python sequencealigning_tpu_torch/csrc/stream_sweep.py [--root DIR]
        --mm N [--out FILE]
    python sequencealigning_tpu_torch/csrc/stream_sweep.py [--root DIR]
        --i16 N [--out FILE]

run from the repository root; --root DIR times the package of another
checkout (e.g. a parent commit unpacked with ``git archive``) instead, at
the same shapes with its own default route only, so two versions can be
compared in one run on one card.  First it prints each instance's registers
and spills (-Xptxas -v), holds the kernels against their plain versions on
small ragged batches (2-4 slots a row, forced lanes a thread, chunks and
slots, rows split over CTAs of 128 lanes) and checks that a schedule whose
waits cannot be met raises instead of hanging (the seconds it took).  Then
one line a configuration: milliseconds (CUDA events over one launch after a
warm-up), GCUPS (true cells / ms), lane-steps a second and the share of
chip_smoke.bound() (bytes and operations of OPS_PER_CELL); the default
configuration's outputs are held against the plain version (finals or
argmax buffers and the whole dirs tensor) and every other configuration's
against the default's.  --configs N keeps the first N configurations a
shape; --others also times kernels #3, #4 and #5 (batches A and B), #6
(1, 4 and 31 pairs), #7 (score-only, and full dirs at 512 pairs), #8,
the linear fill (global, textbook and local score-only at the main shape,
global and local with bits at 512 pairs, one pair in the aligner's batch
of 8), the fast4 and modes walks (main shape) and the banded walk
(config 4, batches A and B) at their chip_smoke shapes (default routes),
each the mean of 5 launches after a warm-up, for comparing checkouts;
--pairs times only kernels #6 and #7 and the linear fill at 1, 31, 512
and 4096 pairs of the main length over their knobs (CTA width, lanes a
thread, chunk), after holding them against their plain versions on small
ragged batches under forced knobs (this checkout only); --long
times both fills on rows of 4097-8192 lanes (one CTA, 16 lanes a thread)
and past 8192 (a cluster a row), the kernels held against their plain
versions on the first rows; --pipeline times the runner's fused
first-only route (the host ms until the fill and walk are queued, and
until the walk is decoded) and stream_align with cigars over 8 batches of
the main shape.  --walks N times only the device walks -- the fast4 walk
and the local and semi-global modes walks at the main shape, the fast4
walk on one pair, the modes walks on kernel #6's per-pair layout at 1 and
31 pairs, the banded walk at config 4 and on batches B (band 128) and A
(band 512) -- each N launches timed one by one (CUDA events) after a
warm-up: the median, least and largest ms; for this checkout each walk is
also held equal to its plain version (the fast4 and modes walks with their
slow-path words and ns a step).  Run it on the parent and on the tree in
turn, in one call, to compare the walks.  --wfa N times only the WFA
wavefront fill and its walk (``ops/wfa.py``, ``csrc/wfa.cu``) at BASELINE
config 3, the indel batch at bands 64/128/256 and one and four of config
3's pairs: the fill as the call (band plan, state, chunk loop: chip_smoke's
whole fill) and as its launches queued behind a sleep (the seed, the
first chunk, a chunk after convergence), the walk alone and as
``wfa_traceback_device``'s call, then a seed and a chunk on identical,
config-3 and random pairs at 32/256/768 lanes (the extension's share),
medians of N; for this checkout each shape's fill and walk are held equal
to their plain versions, and ``csrc/wfa_stamps.cu`` (built here alone)
splits a fill step and a walk step into their parts with clock64()
stamps.  With --root DIR it runs parent (DIR) / tree / tree / parent as
four runs of this script and prints the medians side by side.  --mm N
times only the Myers-Miller row kernel (``ops/mm_align.py``,
``csrc/mm_rows.cu``) and kernel #8 (``ops/nw_banded.py``): the row
kernel's launch alone and its call at the ~6 kb and 100 kb escapes' top
nodes, every row launch of the 100 kb escape (its recursion run with the
leaves stubbed out: the launches alone back to back, and the rows calls'
host seconds), and kernel #8 at config 4 in fast4 and full, medians of N;
for this checkout the row kernel is first held against its plain version
(a top node, a level of several nodes, an unmet hand-over) and kernel #8's
routes against the plain sweep at each of the warp route's widths.  With
--root DIR it too runs parent / tree / tree / parent.  --i16 N times
only the int16 instances of kernels #1 and #2 beside their int32 twins:
global fast4 and full and textbook local and semi at 4096 pairs, 1, 4 and
31 pairs (global) and 32 and 128 (modes) of the main length, each at the
rule's lanes a thread and at 16 (global) / 8 (modes), int32 / int16 /
int16 / int32, each the mean of N launches after a warm-up, beside the
packed bound; for this checkout it first holds every int16 instance
against its plain version on ragged batches (2-16 lanes a thread, chunks
1-16, rows over CTAs of 128 lanes) and each shape's int16 outputs against
the int32 kernel's and the rule's, and prints the instances' registers
and spills.  With --root DIR, parent / tree / tree / parent.
Needs a CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

# Forced knobs (lanes_per_thread, chunk, ring_slots) timed after the
# default at each main shape.
GLOBAL_CONFIGS = ((8, 32, 2), (8, 8, 4), (8, 16, 2), (4, 16, 4),
                  (16, 16, 4))
MODES_CONFIGS = ((4, 16, 4), (4, 24, 2), (4, 8, 4), (8, 32, 2))
# --pairs: batches of the main length, and the per-pair fills' forced
# knobs (cta_lanes, lanes_per_thread, chunk) timed after the default at
# each batch size.
PAIR_BATCHES = (1, 31, 512, 4096)
PAIR_CONFIGS = {
    1: ((0, 4, 32), (384, 2, 32), (512, 2, 32), (0, 2, 16), (256, 2, 8)),
    31: ((0, 8, 32), (2176, 8, 32), (1152, 8, 32), (0, 4, 16), (384, 2, 32)),
    512: ((0, 16, 32), (1152, 8, 32), (768, 4, 32), (0, 8, 16),
          (512, 2, 32)),
    4096: ((0, 16, 32), (1152, 8, 32), (768, 4, 32), (0, 8, 16),
           (512, 2, 32)),
}
# --long: (name, kind, pairs, bp) -- rows of ~6016-6144 lanes (one CTA of
# 16 lanes a thread) and of ~10112-10240 lanes (three CTAs of 8 lanes a
# thread a row, the rings crossing CTAs); 40-136 rows, dirs of 22-38 GB.
LONG_SHAPES = (("#1 global fast4, 1056 x 6000 bp", "fast4", 1056, 6000),
               ("#2 local full, 528 x 6000 bp", "local", 528, 6000),
               ("#1 global fast4, 528 x 10000 bp", "fast4", 528, 10000),
               ("#2 local full, 264 x 10000 bp", "local", 264, 10000))
# --long: the rows held against the plain version.
LONG_CHECK_ROWS = 4


def _equal(a, b) -> bool:
    return all(x is None and y is None or torch.equal(
        x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def _flat(out):
    """(finals, dirs) or ((bv, bd), dirs) as one tuple of tensors."""
    head, dirs = out
    return (*head, dirs) if isinstance(head, tuple) else (head, dirs)


def _small_checks(fill, smodes, ScoringScheme, to_device, pack_batch,
                  trim_for_stream) -> int:
    """The kernels against their plain versions on small ragged batches
    under forced knobs; returns the number of runs."""
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    rng = np.random.default_rng(21)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    knobs = ({}, dict(lanes_per_thread=2, chunk=5, ring_slots=3),
             dict(lanes_per_thread=8, chunk=32, ring_slots=2),
             dict(cta_lanes=128, chunk=7),
             dict(lanes_per_thread=2, cta_lanes=128, chunk=16, ring_slots=4))
    runs = 0
    for n, np_slots, hi1, hi2 in ((40, 4, 300, 300), (24, 2, 400, 60),
                                  (24, 3, 60, 380)):
        pairs = []
        for i in range(n):
            s1 = rng.choice(alpha, int(rng.integers(1, hi1 + 1)))
            s2 = rng.choice(alpha, int(rng.integers(1, hi2 + 1)))
            if i % 3 == 1:
                s2 = np.resize(s1, len(s2))
            pairs.append((s1.tobytes(), s2.tobytes()))
        batch = pack_batch(pairs, batch_size=n)
        for trim in (True, False):
            tb = to_device(trim_for_stream(batch) if trim else batch, "cuda")
            plan, ins = fill.stream_inputs(*tb, np_slots=np_slots)
            cases = []
            if trim:
                for compat, dirs, wc in ((True, "fast4", False),
                                         (True, "full", True),
                                         (False, "fast4", True),
                                         (False, None, False)):
                    a = (plan, wild if wc else ScoringScheme(), compat, wc,
                         dirs)
                    cases.append((fill.gotoh_fill_stream_cuda,
                                  fill.gotoh_fill_stream_torch, a))
            else:
                for mode, wc, dirs in (("local", False, True),
                                       ("semi", True, True),
                                       ("local", True, False)):
                    a = (plan, wild if wc else ScoringScheme(), wc, mode,
                         dirs)
                    cases.append((smodes.gotoh_fill_stream_modes_cuda,
                                  smodes.gotoh_fill_stream_modes_torch, a))
            for kernel, plain, a in cases:
                want = _flat(plain(*ins, *a))
                for kw in knobs:
                    ring = {k: v for k, v in kw.items() if k != "cta_lanes"}
                    with fill.forced_ring(**ring):
                        got = _flat(kernel(*ins, *a,
                                           cta_lanes=kw.get("cta_lanes", 0)))
                    fill.check_stream_stalls(wait=True)
                    assert _equal(got, want), (n, trim, a[1:], kw)
                    runs += 1
    return runs


def stall_check(fill, ScoringScheme, to_device, pack_batch) -> float:
    """A wrap ring of one word under chunks of 32 steps (four words a
    chunk) on a row of several warps cannot be met: the wrapper must raise,
    not hang.  Returns the seconds it took."""
    pairs = [(b"ACGT" * 20, b"ACGTT" * 60)] * 8
    tb = to_device(pack_batch(pairs, batch_size=8), "cuda")
    plan, ins = fill.stream_inputs(*tb, np_slots=2)
    t0 = time.perf_counter()
    raised = None
    try:
        with fill.forced_ring(lanes_per_thread=2, chunk=32, wrap_words=1):
            fill.gotoh_fill_stream_cuda(*ins, plan, ScoringScheme(), True,
                                        False, "fast4")
        fill.check_stream_stalls(wait=True)
    except RuntimeError as e:
        raised = str(e)
    secs = time.perf_counter() - t0
    assert raised is not None and "spin limit" in raised, raised
    # The card is still usable: the same fill with the default rings.
    fill.gotoh_fill_stream_cuda(*ins, plan, ScoringScheme(), True, False,
                                "fast4")
    fill.check_stream_stalls(wait=True)
    return secs


def _check_stalls(fill):
    """check_stream_stalls(wait=True), where the checkout has it (the
    parent's fills read their status at the launch, or have none)."""
    check = getattr(fill, "check_stream_stalls", None)
    if check is not None:
        check(wait=True)
    torch.cuda.synchronize()


def _long(chip_smoke, fill, smodes, ScoringScheme, to_device, pack_batch,
          trim_for_stream, baseline, _ms):
    """--long: [(name, ms, plan)] of the default route, the first
    LONG_CHECK_ROWS rows held against the plain version (not on a
    baseline)."""
    rows = []
    for name, kind, n, length in LONG_SHAPES:
        pairs = chip_smoke.make_pairs(np.random.default_rng(length), n,
                                      length)
        batch = pack_batch(pairs, batch_size=n)
        tb = to_device(trim_for_stream(batch) if kind == "fast4" else batch,
                       "cuda")
        plan, ins = fill.stream_inputs(*tb)
        if kind == "fast4":
            a = (plan, ScoringScheme(), True, False, "fast4")
            kernel, plain = (fill.gotoh_fill_stream_cuda,
                             fill.gotoh_fill_stream_torch)
        else:
            a = (plan, ScoringScheme(), False, kind, True)
            kernel, plain = (smodes.gotoh_fill_stream_modes_cuda,
                             smodes.gotoh_fill_stream_modes_torch)
        ms, got = _ms(lambda: kernel(*ins, *a))
        _check_stalls(fill)
        del got
        if not baseline:
            k = LONG_CHECK_ROWS
            sub = (ins[0][:k].contiguous(), ins[1][:k].contiguous(),
                   ins[2][:, :k].contiguous(), ins[3][:, :k].contiguous())
            a_sub = (plan._replace(n_rows=k),) + a[1:]
            got = _flat(kernel(*sub, *a_sub))
            _check_stalls(fill)
            want = _flat(plain(*sub, *a_sub))
            torch.cuda.synchronize()
            assert _equal(got, want), (name, "!= plain")
            del got, want, sub
        rows.append((name, ms, plan))
        del tb, ins
        torch.cuda.empty_cache()
    return rows


def _pipeline(chip_smoke, par, pack_batch, trim_for_stream, n_batches=8):
    """--pipeline at the main shape, default route: the runner's fused
    first-only route three times -- host ms until fill_walk_from_stream_args
    returns (the fill and walk queued) and until the walk is decoded -- and
    stream_align with cigars over n_batches batches, twice.  Returns
    (queued ms, done ms, pairs/s), each a list."""
    pairs = chip_smoke.make_pairs(np.random.default_rng(0),
                                  chip_smoke.N_MAIN, chip_smoke.LEN_MAIN)
    n = len(pairs)
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    runner = par.DataParallelRunner(np_slots=8)
    b = trim_for_stream(pack_batch(pairs, batch_size=n))
    queued, done = [], []
    for _ in range(3):
        args, plan, bp, has_n = runner._stream_args(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finals, handles = runner.fill_walk_from_stream_args(
            args, plan, bp, has_n, s1, s2)
        queued.append((time.perf_counter() - t0) * 1e3)
        out = runner.device_walk_fast4_finish(handles, finals.cpu().numpy(),
                                              s1, s2)
        done.append((time.perf_counter() - t0) * 1e3)
        assert all(not isinstance(r, Exception) for r in out)
        del finals, handles, out, args
        torch.cuda.empty_cache()

    def stream_input():
        for k in range(n_batches):
            r = (k * 512) % n
            yield from pairs[r:] + pairs[:r]

    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = par.stream_align(stream_input(), runner, batch_size=n,
                               cigars=True, on_alignments=lambda i, r: None)
        rates.append(got / (time.perf_counter() - t0))
        assert got == n * n_batches, got
    return queued, done, rates


def _pair_dirs_ok(torch_, chip_smoke, got, want, n1s, n2s) -> bool:
    """A per-pair fill's dirs against its plain version's: equal on every
    cell 0 <= x <= n2, 0 <= y <= n1 of each pair (lane 0's D bits aside)
    and 0 on every other byte."""
    W, B, P = got.shape
    if chip_smoke.valid_cell_diff(torch_, got, want,
                                  [(b, 0) for b in range(B)], n1s, n2s,
                                  "full"):
        return False
    dev = got.device
    g = got.view(torch_.uint8).view(W, B, P, 4)
    d = (torch_.arange(W, device=dev)[:, None, None, None] * 4
         + torch_.arange(4, device=dev))
    x = torch_.arange(P, device=dev)[None, None, :, None]
    n1 = torch_.as_tensor(np.asarray(n1s), device=dev)[None, :, None, None]
    n2 = torch_.as_tensor(np.asarray(n2s), device=dev)[None, :, None, None]
    cells = (x <= n2) & (d >= x) & (d - x <= n1)
    return not bool(g.masked_select(~cells).any())


def _pair_checks(chip_smoke, nw, lin, modes, ScoringScheme, to_device,
                 pack_batch) -> int:
    """Kernel #7, the linear fill and kernel #6 against their plain
    versions on small ragged batches (up to 700 bp, empty sides, padded
    pairs) under forced knobs: finals, corners, maxima and argmax buffers
    equal, dirs equal on each pair's cells and 0 elsewhere.  Returns the
    number of runs."""
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    rng = np.random.default_rng(23)
    knobs = ({}, dict(cta_lanes=128), dict(lanes_per_thread=2, chunk=5,
                                           ring_slots=3),
             dict(lanes_per_thread=16, chunk=7),
             dict(cta_lanes=256, lanes_per_thread=8, chunk=1, ring_slots=1))
    runs = 0
    for n, hi in ((24, 300), (9, 700)):
        pairs = chip_smoke.skewed_pairs(rng, n - 3, 0, hi, 0, hi, b"ACGTN")
        pairs += [(b"", b"ACGTA" * 9), (b"GATTACA" * 11, b""), (b"AC", b"A")]
        tb = to_device(pack_batch(pairs, batch_size=n + 3), "cuda")
        l1, l2 = tb.query.shape[1], tb.db.shape[1]
        n1s, n2s = tb.query_len.cpu().numpy(), tb.db_len.cpu().numpy()
        lay = (tb.query.contiguous(),
               *nw.gotoh_layout(tb.db, tb.query_len, tb.db_len))
        a4 = lin.linear_inputs(*tb)
        mins = (tb.query.contiguous(), modes.modes_layout(tb.db),
                tb.query_len.contiguous(), tb.db_len.contiguous())
        cases = []
        for compat, wc, dirs in ((True, False, False), (True, False, True),
                                 (False, True, True)):
            a = (l1, l2, wild if wc else ScoringScheme(), compat, wc, dirs)
            cases.append(("#7", nw.gotoh_fill_cuda, nw.gotoh_fill_torch,
                          lay, a))
        for compat in (True, False):
            for local in (False, True):
                mv = lin.linear_fill_torch(
                    *a4, torch.zeros_like(a4[2]), l1, l2, ScoringScheme(),
                    compat, local, False)[1].contiguous()
                for bits in (False, True):
                    a = (l1, l2, ScoringScheme(), compat, local, bits)
                    cases.append(("linear", lin.linear_fill_cuda,
                                  lin.linear_fill_torch, (*a4, mv), a))
        for local in (False, True):
            a = (l1, l2, ScoringScheme(), True, local, True)
            cases.append(("#6", modes.modes_fill_cuda, modes.fill_modes_torch,
                          mins, a))
        for name, kernel, plain, ins, a in cases:
            want = plain(*ins, *a)
            for kw in knobs:
                ring = {k: v for k, v in kw.items() if k != "cta_lanes"}
                with nw_ring(ring):
                    got = kernel(*ins, *a, cta_lanes=kw.get("cta_lanes", 0))
                _check_stalls(sys.modules[
                    "sequencealigning_tpu_torch.ops.nw_affine_stream"])
                for g, w in zip(got[:-1], want[:-1]):
                    assert torch.equal(g, w), (name, n, a[2:], kw)
                if got[-1] is not None:
                    assert _pair_dirs_ok(torch, chip_smoke, got[-1],
                                         want[-1], n1s, n2s), (name, n,
                                                               a[2:], kw)
                runs += 1
    return runs


def nw_ring(ring):
    """forced_ring(**ring) of the checkout's streamed fills' module."""
    fill = sys.modules["sequencealigning_tpu_torch.ops.nw_affine_stream"]
    return fill.forced_ring(**ring) if ring else contextlib.nullcontext()


def _pair_sweep(chip_smoke, nw, lin, modes, ScoringScheme, to_device,
                pack_batch, _ms) -> list:
    """--pairs: kernel #7 (score-only; full dirs up to 512 pairs), the
    linear fill (global score-only; local with bits up to 512 pairs, its
    second pass) and kernel #6 (local with dirs, up to 512 pairs) at
    PAIR_BATCHES pairs of the main length, the default launch and then
    each of PAIR_CONFIGS' forced knobs, each forced run's outputs equal to
    the default's: [dict(kernel, pairs, force, ms, shape)]."""
    sch = ScoringScheme()
    rows = []
    for n in PAIR_BATCHES:
        pairs = chip_smoke.make_pairs(np.random.default_rng(4), n,
                                      chip_smoke.LEN_MAIN)
        tb = to_device(pack_batch(pairs, batch_size=n), "cuda")
        l1, l2 = tb.query.shape[1], tb.db.shape[1]
        lay = (tb.query.contiguous(),
               *nw.gotoh_layout(tb.db, tb.query_len, tb.db_len))
        a4 = lin.linear_inputs(*tb)
        zeros = torch.zeros_like(a4[2])
        small = n <= 512
        cases = [("#7 score-only", nw.gotoh_fill_cuda, lay,
                  (l1, l2, sch, True, False, False)),
                 ("linear global score-only", lin.linear_fill_cuda,
                  (*a4, zeros), (l1, l2, sch, True, False, False))]
        if small:
            mv = lin.linear_fill_cuda(*a4, zeros, l1, l2, sch, True, True,
                                      False)[1].contiguous()
            cases += [("#7 full", nw.gotoh_fill_cuda, lay,
                       (l1, l2, sch, True, False, True)),
                      ("linear local bits", lin.linear_fill_cuda, (*a4, mv),
                       (l1, l2, sch, True, True, True)),
                      ("#6 local full", modes.modes_fill_cuda,
                       (tb.query, modes.modes_layout(tb.db), tb.query_len,
                        tb.db_len), (l1, l2, sch, False, True, True))]
        for name, kernel, ins, a in cases:
            first = None
            for cfg in ((0, 0, 0),) + PAIR_CONFIGS[n]:
                cta, lpt, chunk = cfg
                ring = dict(lanes_per_thread=lpt, chunk=chunk) if lpt else {}
                with nw_ring(ring):
                    ms, got = _ms(lambda: kernel(*ins, *a, cta_lanes=cta))
                _check_stalls(sys.modules[
                    "sequencealigning_tpu_torch.ops.nw_affine_stream"])
                if first is None:
                    first = got
                else:
                    assert all(x is None and y is None or torch.equal(
                        x.view(torch.int32), y.view(torch.int32))
                        for x, y in zip(got, first)), (name, n, cfg)
                shape = dict(kernel.last_launch)
                rows.append(dict(kernel=name, pairs=n, force=cfg, ms=ms,
                                 **shape))
                print(f"pairs {name} {n} x {chip_smoke.LEN_MAIN} "
                      f"{'default' if cfg == (0, 0, 0) else cfg}: {ms:.3f} "
                      f"ms; {shape['lanes_per_thread']} lanes x "
                      f"{shape['threads']} threads x {shape['ctas']} CTAs, "
                      f"chunk {shape['chunk']}, slots {shape['ring_slots']}",
                      flush=True)
                del got
            del first
            torch.cuda.empty_cache()
        del tb, lay, a4
        torch.cuda.empty_cache()
    return rows


def _others(chip_smoke, port, ScoringScheme, to_device, pack_batch, _ms):
    """Kernels #3, #4 and #5 (batches A and B), #6 (1, 4 and 31 pairs,
    local and semi-global), #7 (score-only and full dirs), #8, every
    instance of the linear fill at the main shapes and one linear pair in
    the aligner's batch of 8, and the banded walk (config 4, and the long
    path's batches A and B) at their chip_smoke shapes (default routes):
    [(name, ms)]."""
    main = chip_smoke.make_pairs(np.random.default_rng(0),
                                 chip_smoke.N_MAIN, chip_smoke.LEN_MAIN)
    c4 = chip_smoke.make_pairs(np.random.default_rng(4), chip_smoke.N_BAND,
                               chip_smoke.LEN_BAND)
    sch = ScoringScheme()
    rows = []
    tb = to_device(pack_batch(main, batch_size=len(main)), "cuda")
    nw, lin = port["nw"], port["linear"]
    ins = (tb.query.contiguous(),
           *nw.gotoh_layout(tb.db, tb.query_len, tb.db_len))
    l1, l2 = tb.query.shape[1], tb.db.shape[1]
    a = (l1, l2, sch, True, False, False)
    rows.append(("#7 score-only 4096 x 2046",
                 _ms(lambda: nw.gotoh_fill_cuda(*ins, *a))[0]))
    nd = chip_smoke.N_GOTOH_DIRS
    sub = tuple(t[:nd].contiguous() for t in ins)
    a = (l1, l2, sch, True, False, True)
    rows.append((f"#7 full {nd} x 2046",
                 _ms(lambda: nw.gotoh_fill_cuda(*sub, *a))[0]))
    a4 = lin.linear_inputs(*tb)
    zeros = torch.zeros_like(a4[2])
    for tag, compat, local in (("global", True, False),
                               ("textbook", False, False),
                               ("local", True, True)):
        a = (*a4, zeros, l1, l2, sch, compat, local, False)
        rows.append((f"linear {tag} score-only 4096 x 2046",
                     _ms(lambda: lin.linear_fill_cuda(*a))[0]))
    nl = chip_smoke.N_LINEAR_DIRS
    sub = [t[:nl].contiguous() for t in a4]
    for tag, local in (("global", False), ("local", True)):
        mv = zeros[:nl].contiguous()
        if local:
            mv = lin.linear_fill_cuda(*sub, mv, l1, l2, sch, True, True,
                                      False)[1].contiguous()
        a = (*sub, mv, l1, l2, sch, True, local, True)
        rows.append((f"linear {tag} bits {nl} x 2046",
                     _ms(lambda: lin.linear_fill_cuda(*a))[0]))
    del tb, ins, a4, a, sub, mv
    # One pair of the nw-linear aligner, in its batch of 8.
    one = chip_smoke.make_pairs(np.random.default_rng(4), 1,
                                chip_smoke.LEN_MAIN)
    tb = to_device(pack_batch(one, batch_size=8), "cuda")
    a4 = lin.linear_inputs(*tb)
    a = (*a4, torch.zeros_like(a4[2]), tb.query.shape[1], tb.db.shape[1],
         sch, True, False, True)
    rows.append(("linear global bits 1 pair (batch of 8)",
                 _ms(lambda: lin.linear_fill_cuda(*a))[0]))
    del tb, a4, a
    modes = port["modes"]
    for n in (1, 4, 31):
        pn = chip_smoke.make_pairs(np.random.default_rng(4), n,
                                   chip_smoke.LEN_MAIN)
        tb = to_device(pack_batch(pn, batch_size=n), "cuda")
        for mode in ("local", "semi"):
            a = (tb.query, modes.modes_layout(tb.db), tb.query_len,
                 tb.db_len, tb.query.shape[1], tb.db.shape[1], sch, False,
                 mode == "local", True)
            rows.append((f"#6 {mode} {n} x 2046",
                         _ms(lambda: modes.modes_fill_cuda(*a))[0]))
    tb = to_device(pack_batch(c4, batch_size=len(c4)), "cuda")
    banded, row = port["banded"], port["row"]
    plan, ins = banded.band_inputs(*tb, chip_smoke.BAND)
    a = (plan, sch, True, True, "fast4")
    rows.append(("#3 config 4 fast4",
                 _ms(lambda: banded.banded_diag_fill_cuda(*ins, *a))[0]))
    rows.append(("banded walk config 4", _walk_ms(
        port, banded.banded_diag_fill_cuda(*ins, *a), plan, c4, _ms)))
    k_lo, ins = row.row_inputs(*tb, chip_smoke.BAND)
    a = (k_lo, sch, True, True, "fast4")
    rows.append(("#8 config 4 fast4",
                 _ms(lambda: row.banded_row_fill_cuda(*ins, *a))[0]))
    del ins
    # The long path's walks: batch B's band 128 and batch A's band 512;
    # kernels #4 and #5 at batches A and B.
    A, B = chip_smoke.long_batches()
    tiled = port["tiled"]
    for name, pairs, fn in (("#4 batch A", A, tiled.tiled_fill_cuda),
                            ("#5 batch B", B, tiled.tiled_fold_fill_cuda)):
        tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
        rows.append((name, _ms(lambda: fn(*tb, sch, True, False))[0]))
    for name, pairs, band in (("B", B, chip_smoke.BAND),
                              ("A", A, 4 * chip_smoke.BAND)):
        tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
        plan, ins = banded.band_inputs(*tb, band)
        got = banded.banded_diag_fill_cuda(*ins, plan, sch, True, False,
                                           "fast4")
        rows.append((f"banded walk batch {name} band {band}",
                     _walk_ms(port, got, plan, pairs, _ms)))
        del got, ins
    torch.cuda.empty_cache()
    return rows


def _put(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()


def _main_walk(walk, modes, kind, got, plan, batch, _ms):
    """(name, ms) of the fast4 walk (kind "fast4") or the local modes walk
    ("local") on the default route's fill at the main shape."""
    B = len(batch.query_len)
    bs = np.arange(B)
    rowp, off = _put(bs // plan.np_slots), _put((bs % plan.np_slots) * plan.s)
    t_steps = plan.l1 + plan.l2
    if kind == "fast4":
        finals, dirs = got
        seeds = [_put(batch.db_len), _put(batch.query_len),
                 _put(walk.seed_planes(finals[:B].cpu().numpy())), rowp, off]
        return ("fast4 walk 4096 x 2046", _ms(
            lambda: walk.walk_fast4_cuda(dirs, *seeds, t_steps))[0])
    bv, bd, dirs = got
    P = plan.p
    _, x, y = modes.modes_reduce(bv.transpose(0, 1).reshape(-1, P),
                                 bd.transpose(0, 1).reshape(-1, P))
    seeds = [x[:B].contiguous(), y[:B].contiguous(), rowp, off]
    return ("modes walk local 4096 x 2046", _ms(
        lambda: walk.walk_modes_cuda(dirs, *seeds, True, t_steps))[0])


def _banded_walk_args(walk, fill_out, plan, pairs):
    """(dirs, seeds, (k_lo_even, t_steps)) of the banded walk on a banded
    fill's (finals, fast4 dirs)."""
    finals, dirs = fill_out
    n1 = np.asarray([len(a) for a, _ in pairs], np.int32)
    n2 = np.asarray([len(b) for _, b in pairs], np.int32)
    seeds = [torch.from_numpy(np.ascontiguousarray(v, np.int32)).cuda()
             for v in (n2, n1, walk.seed_planes(finals.cpu().numpy()),
                       np.arange(len(pairs)))]
    return dirs, seeds, (plan.k_lo_even, int((n1 + n2).max()))


def _walk_ms(port, fill_out, plan, pairs, _ms) -> float:
    """The banded walk's ms on a banded fill's (finals, fast4 dirs)."""
    walk = port["walk"]
    dirs, seeds, a = _banded_walk_args(walk, fill_out, plan, pairs)
    return _ms(lambda: walk.walk_banded_cuda(dirs, *seeds, *a))[0]


def _launches_ms(fn, n: int, primed: bool = False) -> list:
    """ms of each of n launches of fn (CUDA events around each), after a
    warm-up; primed: behind a ~30 ms sleep on the card, so that the host
    queues every launch before the card reaches it and the events time
    the card alone (fn must not wait for the card)."""
    fn()
    torch.cuda.synchronize()
    if primed:
        torch.cuda._sleep(50_000_000)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in ev]


def gapped_pairs(rng, n: int, length: int, gap: int):
    """n (mutant, reference) pairs of `length` bp at ~1% substitutions, the
    mutant also carrying a `gap` bp insertion and a `gap` bp deletion at
    random places: walks with two long gaps."""
    pairs = []
    alpha = np.frombuffer(b"ACGT", np.uint8)
    for _ in range(n):
        ref = rng.choice(alpha, length)
        mut = ref.copy()
        for _ in range(length // 100):
            mut[rng.integers(length)] = rng.choice(alpha)
        at = int(rng.integers(1, length - 1))
        mut = np.concatenate([mut[:at], rng.choice(alpha, gap), mut[at:]])
        at = int(rng.integers(1, length - gap))
        mut = np.concatenate([mut[:at], mut[at + gap:]])
        pairs.append((mut.tobytes(), ref.tobytes()))
    return pairs


def _staged_walk_cases(chip_smoke, port, ScoringScheme, to_device,
                       pack_batch, trim_for_stream):
    """--walks' fast4 and modes walk shapes, one at a time (the fill freed
    before the next): (name, kernel(slow=None, check=True), plain());
    check=False skips the wrapper's seed check.  The main shape's fast4
    walk (trimmed streamed layout) and local and semi-global modes walks
    (streamed), the fast4 and local modes walks on the main shape with 50
    bp indels (gapped_pairs), the fast4 walk on one pair, the modes walks
    on kernel #6's per-pair layout at 1 and 31 pairs."""
    fill, smodes, walk, modes = (port["fill"], port["smodes"], port["walk"],
                                 port["modes"])
    sch = ScoringScheme()

    def call(fn, *args, slow=None, check=True):
        # Another checkout's wrappers may take no slow counter.
        if slow is None:
            return fn(*args, check_bounds=check)
        return fn(*args, check_bounds=check, slow=slow)

    def fast4(name, pairs):
        batch = pack_batch(pairs, batch_size=len(pairs))
        tb = to_device(trim_for_stream(batch), "cuda")
        plan, ins = fill.stream_inputs(*tb)
        finals, dirs = fill.gotoh_fill_stream_cuda(*ins, plan, sch, True,
                                                   False, "fast4")
        B = len(pairs)
        bs = np.arange(B)
        seeds = [_put(batch.db_len), _put(batch.query_len),
                 _put(walk.seed_planes(finals[:B].cpu().numpy())),
                 _put(bs // plan.np_slots), _put((bs % plan.np_slots) * plan.s)]
        a = (dirs, *seeds, plan.l1 + plan.l2)
        return (name, lambda slow=None, check=True: call(
                    walk.walk_fast4_cuda, *a, slow=slow, check=check),
                lambda: walk.walk_fast4_torch(*a))

    def streamed_modes(name, batch, mode):
        tb = to_device(batch, "cuda")
        plan, ins = fill.stream_inputs(*tb)
        (bv, bd), dirs = smodes.gotoh_fill_stream_modes_cuda(
            *ins, plan, sch, False, mode, True)
        B, P = len(batch.query_len), plan.p
        _, x, y = modes.modes_reduce(bv.transpose(0, 1).reshape(-1, P),
                                     bd.transpose(0, 1).reshape(-1, P))
        bs = np.arange(B)
        a = (dirs, x[:B].contiguous(), y[:B].contiguous(),
             _put(bs // plan.np_slots), _put((bs % plan.np_slots) * plan.s),
             mode == "local", plan.l1 + plan.l2)
        return modes_case(name, a)

    def modes_case(name, a):
        return (name, lambda slow=None, check=True: call(
                    walk.walk_modes_cuda, *a, slow=slow, check=check),
                lambda: walk.walk_modes_torch(*a))

    def pair_modes(name, pairs, local):
        batch = pack_batch(pairs, batch_size=len(pairs))
        tb = to_device(batch, "cuda")
        res = modes.nw_affine_modes_batch(tb.query, tb.db, tb.query_len,
                                          tb.db_len, local=local)
        x, y = np.asarray(res.best_x), np.asarray(res.best_y)
        a = (res.dirs, _put(x), _put(y), _put(np.arange(len(pairs))),
             _put(np.zeros(len(pairs))), local,
             tb.query.shape[1] + tb.db.shape[1])
        return modes_case(name, a)

    main = chip_smoke.make_pairs(np.random.default_rng(0), chip_smoke.N_MAIN,
                                 chip_smoke.LEN_MAIN)
    batch = pack_batch(main, batch_size=chip_smoke.N_MAIN)
    shape = f"{chip_smoke.N_MAIN} x {chip_smoke.LEN_MAIN}"
    yield fast4(f"fast4 walk {shape}", main)
    for mode in ("local", "semi"):
        yield streamed_modes(f"modes walk {mode} {shape}", batch, mode)
    gapped = gapped_pairs(np.random.default_rng(1), chip_smoke.N_MAIN,
                          chip_smoke.LEN_MAIN, 50)
    yield fast4(f"fast4 walk {shape} with 50 bp indels", gapped)
    yield streamed_modes(f"modes walk local {shape} with 50 bp indels",
                         pack_batch(gapped, batch_size=chip_smoke.N_MAIN),
                         "local")
    one = chip_smoke.make_pairs(np.random.default_rng(4), 1,
                                chip_smoke.LEN_MAIN)
    yield fast4("fast4 walk 1 pair", one)
    for n in (1, 31):
        pairs = chip_smoke.make_pairs(np.random.default_rng(4), n,
                                      chip_smoke.LEN_MAIN)
        for local in (True, False):
            yield pair_modes(f"modes walk {'local' if local else 'semi'} "
                             f"{n} pair{'s' if n > 1 else ''} per-pair",
                             pairs, local)


def _walks(chip_smoke, port, ScoringScheme, to_device, pack_batch,
           trim_for_stream, reps: int, check: bool) -> list:
    """--walks: [(name, [ms of each launch])] of the fast4 and modes walks
    (_staged_walk_cases; each timed as the wrapper's call, seed check
    included, and as the kernel alone) and the banded walk at config 4 and
    batches B and A; check: each held equal to its plain version, the fast4
    and modes walks with their slow-path words and ns a step of the longest
    walk."""
    walk, banded = port["walk"], port["banded"]
    sch = ScoringScheme()
    rows = []
    for name, kernel, plain in _staged_walk_cases(
            chip_smoke, port, ScoringScheme, to_device, pack_batch,
            trim_for_stream):
        rows.append((f"{name} call", _launches_ms(kernel, reps)))
        ms = _launches_ms(lambda: kernel(check=False), reps, primed=True)
        rows.append((f"{name} kernel", ms))
        if check:
            slow = torch.zeros(2, dtype=torch.int64, device="cuda")
            got = kernel(slow=slow)
            t0 = time.perf_counter()
            want = plain()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            assert all(bool(torch.equal(g, w)) for g, w in zip(got, want)), (
                f"{name} != plain")
            steps = int(got[-1].max())
            print(f"{name}: equal to its plain version ({secs:.1f} s); "
                  f"{int(slow[0])} slow-path words, {int(slow[1])} "
                  "restagings; "
                  f"{np.median(ms) * 1e6 / steps:.1f} ns a step of the "
                  f"longest walk ({steps} steps), kernel alone", flush=True)
        del kernel, plain
        torch.cuda.empty_cache()
    c4 = chip_smoke.make_pairs(np.random.default_rng(4), chip_smoke.N_BAND,
                               chip_smoke.LEN_BAND)
    A, B = chip_smoke.long_batches()
    for name, pairs, band, wild in (
            ("config 4", c4, chip_smoke.BAND, True),
            ("batch B band 128", B, chip_smoke.BAND, False),
            ("batch A band 512", A, 4 * chip_smoke.BAND, False)):
        tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
        plan, ins = banded.band_inputs(*tb, band)
        dirs, seeds, a = _banded_walk_args(
            walk, banded.banded_diag_fill_cuda(*ins, plan, sch, True, wild,
                                               "fast4"), plan, pairs)
        rows.append((f"banded walk {name}", _launches_ms(
            lambda: walk.walk_banded_cuda(dirs, *seeds, *a), reps)))
        if check:
            got = walk.walk_banded_cuda(dirs, *seeds, *a)
            t0 = time.perf_counter()
            want = walk.walk_banded_torch(dirs, *seeds, *a)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            assert all(bool(torch.equal(g, w)) for g, w in zip(got, want)), (
                f"banded walk {name} != plain")
            print(f"banded walk {name}: equal to its plain version "
                  f"({secs:.1f} s)", flush=True)
        del dirs, seeds, tb, ins
        torch.cuda.empty_cache()
    return rows


def _pairs_main(args, chip_smoke, csrc, nw, lin, modes, ScoringScheme,
                to_device, pack_batch, pkg) -> int:
    """--pairs: the per-pair instances' registers and spills, the small
    ragged checks, then the knob sweep."""
    from sequencealigning_tpu_torch.csrc.tiled_sweep import _card

    instances = csrc.pair_instances(csrc.build_log)
    for r in instances:
        print(f"instance {r['policy']}{r['args']} lpt "
              f"{r['lanes_per_thread']}: {r['registers']} registers, "
              f"{r['spill_stores']} / {r['spill_loads']} bytes spilled "
              f"(stores / loads), stack {r['stack']}", flush=True)
    t0 = time.perf_counter()
    runs = _pair_checks(chip_smoke, nw, lin, modes, ScoringScheme, to_device,
                        pack_batch)
    print(f"per-pair small ragged: {runs} runs equal their plain versions "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def mean_ms(fn):
        return chip_smoke.cuda_ms(torch, fn, 5), fn()

    rows = _pair_sweep(chip_smoke, nw, lin, modes, ScoringScheme, to_device,
                       pack_batch, mean_ms)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=_card(), package=pkg, instances=instances,
                           rows=rows), f, indent=1)
    return 0


# --wfa: the extension's isolating inputs are timed at these band widths.
WFA_EXT_LANES = (32, 256, 768)


def _wfa_shapes(chip_smoke):
    """--wfa's shapes: (name, pairs, band) -- BASELINE config 3 and the
    indel batch at its three bands as chip_smoke.py phase 23 builds them,
    then one and four of config 3's pairs (a CLI or serve request)."""
    c3 = chip_smoke.wfa_pairs(np.random.default_rng(3), chip_smoke.N_WFA,
                              chip_smoke.LEN_WFA, 0.005)
    indel = chip_smoke.wfa_pairs(np.random.default_rng(30), chip_smoke.N_WFA,
                                 chip_smoke.LEN_WFA, 0.01,
                                 chip_smoke.WFA_INDELS)
    band = chip_smoke.WFA_BAND
    yield "config 3", c3, band
    for b in (band, 2 * band, 4 * band):
        yield f"indel band {b}", indel, b
    yield "1 pair", c3[:1], band
    yield "4 pairs", c3[:4], band


def _wfa_batch(to_device, pack_batch, pairs):
    return to_device(pack_batch(pairs, batch_size=-(-len(pairs) // 8) * 8),
                     "cuda")


def _wfa_fill(wfa, tb, band, pen, k_plan=None):
    """One fill as wfa_textbook_batch runs it: (state, [(u0, n_steps)] of
    its launches, its chunks)."""
    k_lo, K = k_plan or wfa.band_plan(tb.query_len.cpu().numpy(),
                                      tb.db_len.cpu().numpy(), band,
                                      (0, 0, 0, 0))
    f = wfa.wfa_fill_state(*tb, k_lo, K, pen)
    calls = []

    def chunk(f_, u0, n):
        calls.append((u0, n))
        return wfa.wfa_chunk_cuda(f_, u0, n)

    return f, calls, wfa.fill_chunks(f, 16_384, chunk)


def _primed_groups(fn, reps: int, group: int = 10) -> list:
    """fn(record) queued reps times in groups, each group behind a ~50 ms
    sleep on the card so that the host has queued it before the card
    reaches it; record(launch) times one launch with CUDA events.  Returns
    [[ms of each recorded launch] a rep]."""
    out = []
    for g0 in range(0, reps, group):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        evs = []
        for _ in range(min(group, reps - g0)):
            rec = []

            def record(launch, rec=rec):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                launch()
                b.record()
                rec.append((a, b))

            fn(record)
            evs.append(rec)
        torch.cuda.synchronize()
        out += [[a.elapsed_time(b) for a, b in rec] for rec in evs]
    return out


def _wfa_times(chip_smoke, wfa, to_device, pack_batch, WfaPenalties,
               reps: int) -> list:
    """--wfa's rows of one checkout: for each shape the fill as the call
    (band plan, fresh state and chunk loop, CUDA events around it: what
    chip_smoke.py reports as a whole fill) and as its launches alone (the
    seed, the chunks that compute, those after convergence; the wrapper's
    log allocation included), the walk alone and wfa_traceback_device's
    call (host clock, the decode included); then the extension's isolating
    inputs.  Medians of reps."""
    pen = WfaPenalties()
    rows = []

    def row(name, ms, **kw):
        rows.append(dict(name=name, median=float(np.median(ms)),
                         least=float(min(ms)), largest=float(max(ms)), **kw))
        print(f"wfa {name}: median {np.median(ms):.4f} ms, least "
              f"{min(ms):.4f}, largest {max(ms):.4f} ({len(ms)} runs)"
              + "".join(f", {k} {v}" for k, v in kw.items()), flush=True)

    for name, pairs, band in _wfa_shapes(chip_smoke):
        tb = _wfa_batch(to_device, pack_batch, pairs)
        k_plan = wfa.band_plan(tb.query_len.cpu().numpy(),
                               tb.db_len.cpu().numpy(), band, (0, 0, 0, 0))
        f, calls, chunks = _wfa_fill(wfa, tb, band, pen, k_plan)
        g = wfa._score_stride(pen)
        steps = int(f.score.max()) // g
        ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chip_smoke.wfa_fill_run(torch, wfa, tb, band, pen)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        row(f"{name} fill call", ms, K=k_plan[1], steps=steps,
            launches=len(calls))

        def fill_launches(record):
            fs = wfa.wfa_fill_state(*tb, *k_plan, pen)
            for u0, n in calls:
                record(lambda: wfa.wfa_chunk_cuda(fs, u0, n))

        per = _primed_groups(fill_launches, reps)
        row(f"{name} fill launches", [sum(p) for p in per])
        row(f"{name} fill seed", [p[0] for p in per])
        row(f"{name} fill first chunk", [p[1] for p in per])
        if len(calls) > 2:
            row(f"{name} fill chunk after convergence", [p[-1] for p in per])
        res = wfa.WfaBatchResult(f.score.cpu().numpy(),
                                 f.done.cpu().numpy() != 0, chunks, f.k_lo, g)
        s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
        hist = res.device_hist()
        seeds = wfa.walk_seeds(res, s1s, s2s, hist.device)
        W = wfa.walk_width(int(seeds.budget.max()))
        wargs = (hist, seeds, res.k_lo, g, pen, W)
        row(f"{name} walk kernel", _launches_ms(
            lambda: wfa.wfa_walk_cuda(*wargs), reps, primed=True))
        ms = []
        for _ in range(min(reps, 20)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wfa.wfa_traceback_device(res, s1s, s2s, pen)
            ms.append((time.perf_counter() - t0) * 1e3)
        row(f"{name} walk call", ms)
        print(f"wfa {name}: {len(pairs)} pairs, K {k_plan[1]}, {steps} "
              f"lattice steps, launches {calls}", flush=True)
        del f, chunks, res, hist, tb
        torch.cuda.empty_cache()
    rng = np.random.default_rng(34)
    c3 = chip_smoke.wfa_pairs(np.random.default_rng(3), chip_smoke.N_WFA,
                              chip_smoke.LEN_WFA, 0.005)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    inputs = (("identical", [(b, b) for _, b in c3]), ("config 3", c3),
              ("random", [(rng.choice(alpha, len(a)).tobytes(), b)
                          for a, b in c3]))
    for kind, pairs in inputs:
        tb = _wfa_batch(to_device, pack_batch, pairs)
        for K in WFA_EXT_LANES:
            def seed_chunk(record, K=K):
                fs = wfa.wfa_fill_state(*tb, -(K // 2), K, pen)
                record(lambda: wfa.wfa_chunk_cuda(fs, 0, 1))
                record(lambda: wfa.wfa_chunk_cuda(fs, 1, wfa.S_CHUNK))

            per = _primed_groups(seed_chunk, reps)
            fs = wfa.wfa_fill_state(*tb, -(K // 2), K, pen)
            wfa.wfa_chunk_cuda(fs, 0, 1)
            wfa.wfa_chunk_cuda(fs, 1, wfa.S_CHUNK)
            done = fs.done[:len(pairs)]
            run = int(torch.where(done != 0, fs.score[:len(pairs)] // 2,
                                  wfa.S_CHUNK).max())
            row(f"extension {kind} K {K} seed", [p[0] for p in per])
            row(f"extension {kind} K {K} chunk", [p[1] for p in per],
                steps=run, us_a_step=round(
                    float(np.median([p[1] for p in per])) * 1e3
                    / max(run, 1), 3))
        del tb
        torch.cuda.empty_cache()
    return rows


def _wfa_checks(chip_smoke, wfa, to_device, pack_batch, WfaPenalties):
    """This checkout's fill and walk at each --wfa shape held equal to their
    plain versions (after the timings, so that no plain run sits between a
    parent's and a tree's times)."""
    pen = WfaPenalties()
    for name, pairs, band in _wfa_shapes(chip_smoke):
        tb = _wfa_batch(to_device, pack_batch, pairs)
        got = chip_smoke.wfa_fill_run(torch, wfa, tb, band, pen)
        want = chip_smoke.wfa_fill_run(torch, wfa, tb, band, pen,
                                       kernel=False)
        e = chip_smoke.wfa_fill_diff(torch, wfa, got, want)
        assert e == 0, f"wfa fill {name} != plain (err {e})"
        f, chunks = got
        g = wfa._score_stride(pen)
        res = wfa.WfaBatchResult(f.score.cpu().numpy(),
                                 f.done.cpu().numpy() != 0, chunks, f.k_lo, g)
        hist = res.device_hist()
        seeds = wfa.walk_seeds(res, [a for a, _ in pairs],
                               [b for _, b in pairs], hist.device)
        wargs = (hist, seeds, res.k_lo, g, pen,
                 wfa.walk_width(int(seeds.budget.max())))
        assert all(bool(torch.equal(a, b)) for a, b in zip(
            wfa.wfa_walk_cuda(*wargs), wfa.wfa_walk_torch(*wargs))), (
            f"wfa walk {name} != plain")
        print(f"wfa {name}: fill and walk equal to their plain versions",
              flush=True)
        del got, want, f, chunks, res, hist, tb
        torch.cuda.empty_cache()


def _stamp_lib(csrc):
    """The stamped kernels (csrc/wfa_stamps.cu), built for this sweep."""
    import ctypes

    src = os.path.join(os.path.dirname(os.path.abspath(csrc.__file__)),
                       "wfa_stamps.cu")
    lib_path = os.path.join(csrc.BUILD_DIR, "libwfa_stamps.so")
    heads = [os.path.join(os.path.dirname(src), h)
             for h in csrc._HEADERS + ("wfa.cu",)]
    if csrc.stale(lib_path, [src] + heads):
        csrc.compile_library([csrc.nvcc_path(), *csrc.ARCH_FLAGS, "-O3",
                              "-shared", "-Xcompiler", "-fPIC"], [src],
                             lib_path)
    lib = ctypes.CDLL(lib_path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.st_wfa_chunk.restype = i
    lib.st_wfa_chunk.argtypes = [vp] * 12 + [i] * 17 + [vp, vp]
    lib.st_wfa_walk.restype = i
    lib.st_wfa_walk.argtypes = [vp] + [i] * 5 + [vp] * 5 + [i] * 5 + [
        vp] * 3 + [i, vp, vp]
    return lib


def _clock_ghz() -> float:
    """The SM clock under load: a spin of 2e8 cycles (torch.cuda._sleep)
    timed with CUDA events."""
    torch.cuda._sleep(10_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(200_000_000)
    b.record()
    torch.cuda.synchronize()
    return 200_000_000 / (a.elapsed_time(b) * 1e6)


def _wfa_stamps(chip_smoke, csrc, wfa, to_device, pack_batch,
                WfaPenalties) -> list:
    """Part 0's split of this checkout's kernels (csrc/wfa_stamps.cu): the
    fill's launches and the walk at config 3 and on the indel batch at band
    64: cycles of each part a warp-step (a walk step), and a CTA's (a
    warp's) cycles."""
    lib = _stamp_lib(csrc)
    pen = WfaPenalties()
    g = wfa._score_stride(pen)
    stream = torch.cuda.current_stream().cuda_stream
    sms = wfa.sm_count(torch.device("cuda"))
    ghz = _clock_ghz()
    print(f"wfa stamps: SM clock {ghz:.3f} GHz under load", flush=True)
    out = []
    parts = ("candidate", "first word", "spans", "stores", "barrier",
             "staging", "write-back and NEG rows")
    for name, pairs, band in list(_wfa_shapes(chip_smoke))[:2]:
        tb = _wfa_batch(to_device, pack_batch, pairs)
        k_lo, K = wfa.band_plan(tb.query_len.cpu().numpy(),
                                tb.db_len.cpu().numpy(), band, (0, 0, 0, 0))
        f = wfa.wfa_fill_state(*tb, k_lo, K, pen)
        R, B, _ = f.ring_m.shape
        L1, L2 = f.seq1.shape[1], f.seq2.shape[1]
        chunks = []
        for u0, n in [(0, 1)] + [(u, wfa.S_CHUNK) for u in
                                 range(1, 16_384 // g, wfa.S_CHUNK)]:
            if bool(f.done.all()):
                break
            st = torch.zeros(11, dtype=torch.int64, device="cuda")
            hist = torch.empty((n, 3, B, K), dtype=torch.int16,
                               device="cuda")
            rc = lib.st_wfa_chunk(
                *(t.data_ptr() for t in (f.seq1, f.seq2, f.n1v, f.n2v,
                                         f.codes, f.ring_m, f.ring_i,
                                         f.ring_d, f.done, f.score, f.end_k,
                                         hist)),
                B, L1, L2, K, R, k_lo, u0, n, g, *wfa.lattice_offsets(pen),
                0, 0, 0, 0, wfa.fill_lanes_per_thread(K), st.data_ptr(),
                stream)
            assert rc == 0, rc
            chunks.append(hist)
            s = [int(v) for v in st.cpu()]
            ws = max(s[7], 1)
            split = {p: s[j] / ws for j, p in enumerate(parts[:5])}
            warps = s[7] / max(s[9], 1) * s[10]
            d = dict(shape=name, u0=u0, K=K, warp_steps=s[7],
                     cta_steps=s[9], split_cycles_a_warp_step=split,
                     staging_cycles_a_warp=s[5] / max(warps, 1),
                     tail_cycles_a_warp=s[6] / max(warps, 1),
                     cycles_a_step=s[8] / max(s[9], 1),
                     us_a_step=s[8] / max(s[9], 1) / ghz / 1e3)
            out.append(d)
            print(f"wfa stamps {name} launch u0={u0}: {s[9]} CTA-steps, "
                  f"{d['cycles_a_step']:.0f} cycles a step of a CTA, staging "
                  f"and tail included ({d['us_a_step']:.2f} us); a "
                  "warp-step: " + ", ".join(f"{p} {v:.0f}"
                                            for p, v in split.items())
                  + f" cycles; a warp's staging "
                  f"{d['staging_cycles_a_warp']:.0f}, write-back and NEG "
                  f"rows {d['tail_cycles_a_warp']:.0f}", flush=True)
        res = wfa.WfaBatchResult(f.score.cpu().numpy(),
                                 f.done.cpu().numpy() != 0, chunks, k_lo, g)
        s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
        hist = res.device_hist()
        seeds = wfa.walk_seeds(res, s1s, s2s, hist.device)
        W = wfa.walk_width(int(seeds.budget.max()))
        Bw = seeds.s0.shape[0]
        packed = torch.zeros((Bw, W), dtype=torch.uint32, device="cuda")
        n_ops = torch.empty(Bw, dtype=torch.int32, device="cuda")
        okv = torch.empty(Bw, dtype=torch.int32, device="cuda")
        st = torch.zeros(6, dtype=torch.int64, device="cuda")
        S, _, Bh, Kh = hist.shape
        rc = lib.st_wfa_walk(hist.data_ptr(), S, Bh, Kh, k_lo, g,
                             *(t.data_ptr() for t in seeds), Bw,
                             pen.mismatch, pen.gap_open, pen.gap_extend, W,
                             packed.data_ptr(), n_ops.data_ptr(),
                             okv.data_ptr(), sms, st.data_ptr(), stream)
        assert rc == 0, rc
        s = [int(v) for v in st.cpu()]
        steps = max(s[3], 1)
        d = dict(shape=name, walk=True, steps=s[3],
                 reads_cycles_a_step=s[0] / steps,
                 rest_cycles_a_step=s[1] / steps,
                 staging_cycles_a_step=s[2] / steps,
                 warp_cycles=s[4] / max(s[5], 1))
        out.append(d)
        print(f"wfa stamps {name} walk: {s[3]} steps of {s[5]} walks, a "
              f"step {d['reads_cycles_a_step']:.0f} cycles of log reads, "
              f"{d['rest_cycles_a_step']:.0f} of state machine and emit, "
              f"{d['staging_cycles_a_step']:.0f} of staging; a walk "
              f"{d['warp_cycles']:.0f} cycles "
              f"({d['warp_cycles'] / ghz / 1e3:.2f} us)", flush=True)
        del f, chunks, res, hist, tb
        torch.cuda.empty_cache()
    return out


def _wfa_main(args, here: str, root: str) -> int:
    """--wfa: one checkout's rows (with --root, parent / tree / tree /
    parent as four runs of this script, then a table side by side)."""
    if args.root and not args.wfa_one:
        import subprocess
        import tempfile

        sys.path.insert(0, here)
        from sequencealigning_tpu_torch.csrc.tiled_sweep import _card

        runs = []
        with tempfile.TemporaryDirectory() as tmp:
            for j, r in enumerate((root, here, here, root)):
                out = os.path.join(tmp, f"{j}.json")
                cmd = [sys.executable, os.path.abspath(__file__), "--wfa",
                       str(args.wfa), "--wfa-one", "--out", out]
                if r != here:
                    cmd += ["--root", r]
                rc = subprocess.run(cmd).returncode
                if rc != 0:
                    return rc
                with open(out) as fh:
                    runs.append(json.load(fh))
        names = [r["name"] for r in runs[1]["rows"]]
        print(f"wfa side by side (medians, ms; {_card()}): parent / tree / "
              "tree / parent", flush=True)
        for n in names:
            vals = []
            for run in runs:
                m = [r["median"] for r in run["rows"] if r["name"] == n]
                vals.append(f"{m[0]:.4f}" if m else "-")
            print(f"wfa {n}: " + " / ".join(vals), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(dict(card=_card(), runs=runs), fh)
        return 0
    sys.path.insert(0, root)
    import chip_smoke
    from sequencealigning_tpu_torch import csrc
    from sequencealigning_tpu_torch.config import WfaPenalties
    from sequencealigning_tpu_torch.csrc.tiled_sweep import _card
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops import wfa

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(csrc.__file__)))
    print(_card(), f"package {pkg}", flush=True)
    csrc.kernels()
    print(f"build {csrc.build_seconds:.1f} s", flush=True)
    for r in csrc.kernel_resources(csrc.build_log, "wfa_"):
        print(f"instance {r['entry']}: {r['registers']} registers, "
              f"{r['spill_stores']} / {r['spill_loads']} bytes spilled "
              f"(stores / loads), stack {r['stack']}", flush=True)
    rows = _wfa_times(chip_smoke, wfa, to_device, pack_batch, WfaPenalties,
                      args.wfa)
    stamps = []
    if root == here:
        stamps = _wfa_stamps(chip_smoke, csrc, wfa, to_device, pack_batch,
                             WfaPenalties)
        _wfa_checks(chip_smoke, wfa, to_device, pack_batch, WfaPenalties)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=_card(), package=pkg, rows=rows,
                           stamps=stamps), fh)
    return 0


def _mm_launches(lib, mm, sq, calls, reps: int):
    """A closure that queues the row kernel alone over `calls` (each a
    list of (fwd, rev, n) nodes one launch of this checkout takes: a level,
    or a node in a checkout whose kernel takes one node a launch), every
    launch with its own zeroed ctr (and, for this tree's tagged hand-over,
    bnd) allocated ahead (reps + 1 sets), and the status words to check
    afterwards."""
    s = sq.scheme
    seq = [t.data_ptr() for t in (sq.qf, sq.qr, sq.df, sq.dr)]
    # ctypes resolves a symbol on attribute access: hasattr tells which
    # entry points a checkout's build has.
    level = hasattr(lib, "sa_mm_rows_plan")
    plans = []
    for nodes in calls:
        if level:
            plan = mm.plan_level(nodes, lib)
            lanes, words = plan.lanes, plan.words
            tab = torch.from_numpy(plan.table).to("cuda")
            out_words = words[2]
        else:
            (fwd, rev, n), = nodes
            words = np.zeros(4, np.int64)
            lanes = lib.sa_mm_rows_scratch(n, fwd[1], rev[1],
                                           words.ctypes.data)
            tab, out_words = None, 4 * (n + 1)
        assert lanes > 0, lanes
        plans.append(dict(nodes=nodes, lanes=lanes, tab=tab,
                          tickets=int(words[3]),
                          ctrs=[torch.zeros(int(words[0]), dtype=torch.int32,
                                            device="cuda")
                                for _ in range(reps + 1)],
                          bnds=[torch.zeros(int(words[1]), dtype=torch.int32,
                                            device="cuda")
                                for _ in range(reps + 1 if level else 1)],
                          out=torch.empty(out_words, dtype=torch.int32,
                                          device="cuda")))

    def launch(rep: int):
        stream = torch.cuda.current_stream().cuda_stream
        for p in plans:
            ctr = p["ctrs"][rep]
            if level:
                rc = lib.sa_mm_rows(
                    *seq, p["tab"].data_ptr(), len(p["nodes"]), p["lanes"],
                    p["tickets"], p["out"].data_ptr(),
                    p["bnds"][rep].data_ptr(), ctr.data_ptr(), s.match_,
                    s.mismatch, s.gap_open, s.gap_extend, stream)
            else:
                (fwd, rev, n), = p["nodes"]
                rc = lib.sa_mm_rows(
                    *seq, p["out"].data_ptr(), p["bnds"][0].data_ptr(),
                    ctr.data_ptr(), *fwd, *rev, n, s.match_, s.mismatch,
                    s.gap_open, s.gap_extend, stream)
            assert rc == 0, rc

    def stalled() -> bool:
        return any(int(c[1]) for p in plans for c in p["ctrs"])

    return launch, stalled, plans


def _escape_calls(mm, pair, sch, runs: int):
    """An escape's recursion with its leaves stubbed out (which changes no
    node), run `runs` times: the nodes of each rows call (a level, or a
    node in a checkout that launches one a node) and each run's rows calls'
    host milliseconds."""
    level = hasattr(mm, "level_rows")
    spy_name = "level_rows" if level else "node_rows"
    real_rows, real_direct = getattr(mm, spy_name), mm._direct_ops
    calls, secs = [], []

    def spy(*a):
        t0 = time.perf_counter()
        out = real_rows(*a)
        secs.append(time.perf_counter() - t0)
        calls.append(list(a[4]) if level else [tuple(a[4:7])])
        return out

    setattr(mm, spy_name, spy)
    mm._direct_ops = lambda *a, **k: ""
    try:
        totals = []
        for _ in range(runs):
            calls.clear()
            secs.clear()
            mm.mm_align(pair[0], pair[1], sch, device="cuda")
            totals.append(sum(secs) * 1e3)
    finally:
        setattr(mm, spy_name, real_rows)
        mm._direct_ops = real_direct
    return calls, totals


def _mm_times(chip_smoke, port, reps: int) -> list:
    """--mm's rows of one checkout: the Myers-Miller row kernel at the two
    escapes' top nodes (the launch alone, CUDA events, and the call, host
    clock), all the row launches of the 100 kb escape (its recursion run
    with the leaves stubbed out, which changes no node: the launches alone
    queued back to back, and the rows calls' host seconds), and kernel #8
    at config 4 in fast4 and full (the call, CUDA events).  Medians of
    reps."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import encode_seq, pack_batch

    mm, row = port["mm"], port["row"]
    lib = port["csrc"].kernels()
    level = hasattr(mm, "level_rows")
    rows = []

    def record(name, ms, **kw):
        rows.append(dict(name=name, median=float(np.median(ms)),
                         least=float(min(ms)), largest=float(max(ms)), **kw))
        print(f"mm {name}: median {np.median(ms):.4f} ms, least "
              f"{min(ms):.4f}, largest {max(ms):.4f} ({len(ms)} runs)"
              + "".join(f", {k} {v}" for k, v in kw.items()), flush=True)

    sch = ScoringScheme()
    o = sch.gap_open
    for tag, length, seed in (("~6 kb", chip_smoke.LEN_MM_SHORT, 14),
                              ("100 kb", chip_smoke.LEN_LONG_PAIR, 16)):
        pair = chip_smoke.escape_pair(length, seed)
        q, d = (np.asarray(encode_seq(x), np.int32) for x in pair)
        sq = mm._Seqs(q, d, sch, "cuda")
        node = sq.node(0, sq.m0, 0, sq.n0, o, o)
        launch, stalled, plans = _mm_launches(lib, mm, sq, [[node]], reps)
        ms = _launches_ms_reps(launch, reps)
        assert not stalled(), "a timed launch stalled"
        record(f"top node {tag} launch", ms, lanes=plans[0]["lanes"],
               **({"warps": plans[0]["tickets"]} if level else {}))
        seq4 = (sq.qf, sq.qr, sq.df, sq.dr)
        call = ((lambda: mm.mm_rows_cuda(*seq4, [node], sch)) if level else
                (lambda: mm.mm_rows_cuda(*seq4, *node, sch)))
        call()
        host = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e3)
        record(f"top node {tag} call", host)
        if tag != "100 kb":
            continue
        calls, totals = _escape_calls(mm, pair, sch, reps + 1)
        nodes = sum(len(c) for c in calls)
        record("100 kb escape rows calls", totals[1:], launches=len(calls),
               nodes=nodes)
        launch, stalled, plans = _mm_launches(lib, mm, sq, calls, reps)
        ms = _launches_ms_reps(launch, reps)
        assert not stalled(), "a timed launch stalled"
        record("100 kb escape launches", ms, launches=len(calls),
               nodes=nodes)
        del plans
        torch.cuda.empty_cache()
    c4 = chip_smoke.make_pairs(np.random.default_rng(4), chip_smoke.N_BAND,
                               chip_smoke.LEN_BAND)
    tb = to_device(pack_batch(c4, batch_size=len(c4)), "cuda")
    k_lo, ins = row.row_inputs(*tb, chip_smoke.BAND)
    for dirs in ("fast4", "full"):
        a = (k_lo, sch, True, True, dirs)
        ms = _launches_ms(lambda: row.banded_row_fill_cuda(*ins, *a), reps)
        record(f"#8 config 4 {dirs}", ms,
               route=getattr(row.banded_row_fill_cuda, "last_launch",
                             {}).get("route", "block"))
    return rows


def _launches_ms_reps(launch, reps: int) -> list:
    """ms of each of reps runs of launch(rep) (CUDA events around each),
    after a warm-up run on set reps; queued behind a ~50 ms sleep so that
    the events time the card alone."""
    launch(reps)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for rep, (start, end) in enumerate(ev):
        start.record()
        launch(rep)
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in ev]


def _mm_checks(chip_smoke, port) -> None:
    """--mm, this checkout only: the row kernel against its plain version
    on the ~6 kb escape's top node and on chip_smoke's level of nodes, a
    level whose hand-over cannot be met (it must set the status word), and
    kernel #8's warp route at each of its widths and its block route
    forced, every mode, against the plain sweep."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import encode_seq, pack_batch

    mm, row = port["mm"], port["row"]
    lib = port["csrc"].kernels()
    sch = ScoringScheme()
    o = sch.gap_open
    t0 = time.perf_counter()
    seqs = []
    for length, seed in ((chip_smoke.LEN_MM_SHORT, 14),
                         (chip_smoke.LEN_LONG_PAIR, 16)):
        pair = chip_smoke.escape_pair(length, seed)
        q, d = (np.asarray(encode_seq(x), np.int32) for x in pair)
        seqs.append(mm._Seqs(q, d, sch, "cuda"))
    short, longs = seqs
    level = [longs.node(qa, qa + 2 * r, da, da + c, o * tb_, o * te)
             for qa, r, da, c, tb_, te in chip_smoke.MM_LEVEL]
    for sq, nodes in ((short, [short.node(0, short.m0, 0, short.n0, o, o)]),
                      (longs, level)):
        seq4 = (sq.qf, sq.qr, sq.df, sq.dr)
        got = mm.mm_rows_cuda(*seq4, nodes, sch)
        for g, node in zip(got, nodes):
            want = mm.node_rows_torch(*seq4, *node, sch).cpu()
            assert torch.equal(g, want), ("mm_rows != plain", node)
    launch, stalled, _plans = _mm_launches(lib, mm, longs, [level], 0)
    _plans[0]["ctrs"][0][0] = 2
    launch(0)
    torch.cuda.synchronize()
    assert stalled(), "an unmet hand-over set no status"
    print(f"mm_rows: the ~6 kb top node and a level of {len(level)} nodes "
          "equal the plain version; an unmet hand-over set the status word "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    runs, seen = 0, set()
    for K in chip_smoke.ROW_WARP_WIDTHS:
        pairs = chip_smoke.skewed_pairs(rng, 24, 200, 230, 200, 230,
                                        b"ACGTN")
        tb = to_device(pack_batch(pairs, batch_size=24), "cuda")
        _band, k_lo, ins = chip_smoke.row_band_of_width(row, tb, K)
        for compat in (True, False):
            for wildcard in (True, False):
                for dirs in (False, "fast4", "full"):
                    a = (k_lo, sch, compat, wildcard, dirs)
                    fp, dp = row.banded_row_fill_torch(*ins, *a)
                    for chunk in (0, 128):
                        fk, dk = row.banded_row_fill_cuda(
                            *ins, *a, chunk_lanes=chunk)
                        ll = row.banded_row_fill_cuda.last_launch
                        seen.add((ll["route"], ll["lanes_per_thread"]))
                        ok = torch.equal(fk, fp) and (not dirs or torch.equal(
                            dk.view(torch.int32), dp.view(torch.int32)))
                        assert ok, ("#8 != plain", K, a[2:], chunk)
                        runs += 1
    print(f"#8: {runs} runs (routes {sorted(seen)}) equal the plain sweep "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _mm_main(args, here: str, root: str) -> int:
    """--mm: one checkout's rows (with --root, parent / tree / tree /
    parent as four runs of this script, then a table side by side)."""
    if args.root and not args.mm_one:
        import subprocess
        import tempfile

        sys.path.insert(0, here)
        from sequencealigning_tpu_torch.csrc.tiled_sweep import _card

        runs = []
        with tempfile.TemporaryDirectory() as tmp:
            for j, r in enumerate((root, here, here, root)):
                out = os.path.join(tmp, f"{j}.json")
                cmd = [sys.executable, os.path.abspath(__file__), "--mm",
                       str(args.mm), "--mm-one", "--out", out]
                if r != here:
                    cmd += ["--root", r]
                rc = subprocess.run(cmd).returncode
                if rc != 0:
                    return rc
                with open(out) as fh:
                    runs.append(json.load(fh))
        names = [r["name"] for r in runs[1]["rows"] if "median" in r]
        print(f"mm side by side (medians, ms; {_card()}): parent / tree / "
              "tree / parent", flush=True)
        for n in names:
            vals = []
            for run in runs:
                m = [r["median"] for r in run["rows"]
                     if r["name"] == n and "median" in r]
                vals.append(f"{m[0]:.4f}" if m else "-")
            print(f"mm {n}: " + " / ".join(vals), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(dict(card=_card(), runs=runs), fh)
        return 0
    sys.path.insert(0, root)
    import chip_smoke
    from sequencealigning_tpu_torch import csrc
    from sequencealigning_tpu_torch.csrc.tiled_sweep import _card
    from sequencealigning_tpu_torch.ops import mm_align, nw_banded

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(csrc.__file__)))
    print(_card(), f"package {pkg}", flush=True)
    csrc.kernels()
    print(f"build {csrc.build_seconds:.1f} s", flush=True)
    for r in (csrc.kernel_resources(csrc.build_log, "mm_rows_kernel")
              + csrc.kernel_resources(csrc.build_log, "banded_row")):
        print(f"instance {r['entry']}: {r['registers']} registers, "
              f"{r['spill_stores']} / {r['spill_loads']} bytes spilled "
              f"(stores / loads), stack {r['stack']}", flush=True)
    port = {"csrc": csrc, "mm": mm_align, "row": nw_banded}
    if root == here:
        _mm_checks(chip_smoke, port)
    rows = _mm_times(chip_smoke, port, args.mm)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=_card(), package=pkg, rows=rows), fh)
    return 0


# --i16: the shapes timed -- (name, kind, pairs) of the main length; global
# fast4 and full trimmed, the modes full untrimmed -- and the lanes a thread
# forced on each (None: the rule's).
I16_SHAPES = (("#1 global fast4", "fast4", 4096), ("#1 global full", "full",
                                                    4096),
              ("#2 local full", "local", 4096), ("#2 semi full", "semi", 4096),
              ("#1 global fast4", "fast4", 1), ("#1 global fast4", "fast4", 4),
              ("#1 global fast4", "fast4", 31), ("#1 global full", "full", 1),
              ("#1 global full", "full", 4), ("#1 global full", "full", 31),
              ("#2 local full", "local", 32), ("#2 local full", "local", 128),
              ("#2 semi full", "semi", 32), ("#2 semi full", "semi", 128))
I16_LANES = {"fast4": (None, 16), "full": (None, 16), "local": (None, 8),
             "semi": (None, 8)}


def _i16_launcher(chip_smoke, fill, smodes, ScoringScheme, to_device,
                  pack_batch, trim_for_stream, kind, n):
    """(launch(state, lanes), ops, nbytes of the inputs, dirs bytes) for a
    --i16 shape: kernel #1 (global compat, trimmed) or #2 (textbook,
    untrimmed) with full or fast4 dirs on n pairs of the main length."""
    pairs = chip_smoke.make_pairs(np.random.default_rng(0), n,
                                  chip_smoke.LEN_MAIN)
    batch = pack_batch(pairs, batch_size=n)
    cells = int((batch.query_len.astype(np.int64)
                 * batch.db_len.astype(np.int64)).sum())
    modes = kind in ("local", "semi")
    tb = to_device(batch if modes else trim_for_stream(batch), "cuda")
    plan, ins = fill.stream_inputs(*tb)

    def launch(state, lanes):
        knobs = {} if lanes is None else dict(lanes_per_thread=lanes)
        with fill.forced_ring(**knobs):
            if modes:
                return smodes.gotoh_fill_stream_modes_cuda(
                    *ins, plan, ScoringScheme(), False, kind, True,
                    state_dtype=state)
            return fill.gotoh_fill_stream_cuda(
                *ins, plan, ScoringScheme(), True, False, kind,
                state_dtype=state)

    ops = cells * chip_smoke.OPS_PER_CELL[
        "local full" if kind == "local" else "full" if modes else kind]
    dirs = plan.t_total // (8 if kind == "fast4" else 4) * plan.n_rows * \
        plan.p * 4
    return launch, ops, chip_smoke.nbytes(*ins), dirs, plan


def _i16_checks(fill, smodes, ScoringScheme, to_device, pack_batch,
                trim_for_stream) -> int:
    """--i16, this checkout: every int16 instance against its int16 plain
    version on ragged batches (2-4 slots a row) at 2, 4, 8 and 16 lanes a
    thread and the rule's, chunks of 1, 7 and the default, and rows split
    over CTAs of 128 lanes; returns the number of runs."""
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    rng = np.random.default_rng(20)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    knobs = ({}, dict(lanes_per_thread=2, chunk=7),
             dict(lanes_per_thread=4, chunk=1, ring_slots=1),
             dict(lanes_per_thread=8, chunk=5), dict(lanes_per_thread=16),
             dict(cta_lanes=128, lanes_per_thread=4))
    I16 = torch.int16
    runs = 0
    for n, np_slots in ((40, 4), (24, 2), (31, 3)):
        pairs = []
        for i in range(n):
            s1 = rng.choice(alpha, int(rng.integers(1, 301)))
            s2 = rng.choice(alpha, int(rng.integers(1, 301)))
            if i % 3 == 1:
                s2 = np.resize(s1, len(s2))
            pairs.append((s1.tobytes(), s2.tobytes()))
        batch = pack_batch(pairs, batch_size=n)
        for trim in (True, False):
            tb = to_device(trim_for_stream(batch) if trim else batch, "cuda")
            plan, ins = fill.stream_inputs(*tb, np_slots=np_slots)
            cases = []
            if trim:
                for compat, dirs, wc in ((True, "fast4", False),
                                         (True, "full", True),
                                         (False, "fast4", True),
                                         (False, "full", False),
                                         (True, None, False)):
                    a = (plan, wild if wc else ScoringScheme(), compat, wc,
                         dirs)
                    cases.append((fill.gotoh_fill_stream_cuda,
                                  fill.gotoh_fill_stream_torch, a))
            else:
                for mode, wc, dirs in (("local", False, True),
                                       ("semi", True, True),
                                       ("local", True, False),
                                       ("semi", False, False)):
                    a = (plan, wild if wc else ScoringScheme(), wc, mode,
                         dirs)
                    cases.append((smodes.gotoh_fill_stream_modes_cuda,
                                  smodes.gotoh_fill_stream_modes_torch, a))
            for kernel, plain, a in cases:
                want = _flat(plain(*ins, *a, state_dtype=I16))
                for kw in knobs:
                    ring = {k: v for k, v in kw.items() if k != "cta_lanes"}
                    with fill.forced_ring(**ring):
                        got = _flat(kernel(*ins, *a, state_dtype=I16,
                                           cta_lanes=kw.get("cta_lanes", 0)))
                    fill.check_stream_stalls(wait=True)
                    assert _equal(got, want), (n, trim, a[1:], kw)
                    runs += 1
    return runs


def _i16_times(chip_smoke, fill, smodes, ScoringScheme, to_device,
               pack_batch, trim_for_stream, reps, check) -> list:
    """--i16: each shape of I16_SHAPES at each of its lanes a thread, the
    int16 instance and its int32 twin timed int32 / int16 / int16 / int32
    (each the mean of reps launches after a warm-up); with check, the
    int16 outputs equal the int32 kernel's at the rule's lanes (scores,
    finite finals or argmax planes) and the rule's own at forced lanes."""
    rows = []
    for name, kind, n in I16_SHAPES:
        launch, ops, in_bytes, dirs_bytes, plan = _i16_launcher(
            chip_smoke, fill, smodes, ScoringScheme, to_device, pack_batch,
            trim_for_stream, kind, n)
        first = None
        for lanes in I16_LANES[kind]:
            if check:
                got16 = _flat(launch(torch.int16, lanes))
                _check_stalls(fill)
                if first is None:
                    got32 = _flat(launch(torch.int32, lanes))
                    _check_stalls(fill)
                    if kind in ("local", "semi"):
                        ok = all(torch.equal(a, b) for a, b in
                                 zip(got16[:2], got32[:2]))
                    else:
                        a16, a32 = got16[0], got32[0]
                        finite = a32 > -32768
                        ok = bool(torch.equal(a16.max(1).values,
                                              a32.max(1).values)
                                  and torch.equal(a16[finite], a32[finite]))
                    assert ok, (name, n, "int16 != int32")
                    first = got16
                    del got32
                else:
                    assert _equal(got16, first), (name, n, lanes)
                del got16
            launch(torch.int16, lanes)
            shape16 = dict((smodes.gotoh_fill_stream_modes_cuda
                            if kind in ("local", "semi") else
                            fill.gotoh_fill_stream_cuda).last_launch)
            t32a = chip_smoke.cuda_ms(torch, lambda: launch(torch.int32,
                                                            lanes), reps)
            t16a = chip_smoke.cuda_ms(torch, lambda: launch(torch.int16,
                                                            lanes), reps)
            t16b = chip_smoke.cuda_ms(torch, lambda: launch(torch.int16,
                                                            lanes), reps)
            t32b = chip_smoke.cuda_ms(torch, lambda: launch(torch.int32,
                                                            lanes), reps)
            _check_stalls(fill)
            b16, by16 = chip_smoke.bound(in_bytes + dirs_bytes, ops / 2)
            rows.append(dict(name=name, pairs=n, lanes=lanes,
                             lanes_run=shape16["lanes_per_thread"],
                             threads=shape16["threads"],
                             i16_ms=[t16a, t16b], i32_ms=[t32a, t32b],
                             bound16_ms=b16, bound16_by=by16,
                             R=plan.n_rows, P=plan.p, T=plan.t_total))
        del first
        torch.cuda.empty_cache()
    return rows


def _i16_main(args, here: str, root: str) -> int:
    """--i16: one checkout's int16 instances beside their int32 twins (with
    --root, parent / tree / tree / parent as four runs of this script,
    then a table side by side)."""
    if args.root and not args.i16_one:
        import subprocess
        import tempfile

        sys.path.insert(0, here)
        from sequencealigning_tpu_torch.csrc.tiled_sweep import _card

        runs = []
        with tempfile.TemporaryDirectory() as tmp:
            for j, r in enumerate((root, here, here, root)):
                out = os.path.join(tmp, f"{j}.json")
                cmd = [sys.executable, os.path.abspath(__file__), "--i16",
                       str(args.i16), "--i16-one", "--out", out]
                if r != here:
                    cmd += ["--root", r]
                rc = subprocess.run(cmd).returncode
                if rc != 0:
                    return rc
                with open(out) as fh:
                    runs.append(json.load(fh))
        print(f"i16 side by side (ms, each the mean of its two turns; "
              f"{_card()}): parent / tree / tree / parent", flush=True)
        for i, row in enumerate(runs[1]["rows"]):
            cells = []
            for state in ("i16_ms", "i32_ms"):
                vals = [f"{np.mean(run['rows'][i][state]):.3f}"
                        for run in runs]
                cells.append(f"{state[:3]} " + " / ".join(vals))
            print(f"i16 {row['name']}, {row['pairs']} pairs, lanes "
                  f"{row['lanes'] or 'rule'} ({row['lanes_run']}): "
                  + "; ".join(cells)
                  + f"; packed bound {row['bound16_ms']:.3f} "
                  f"({row['bound16_by']})", flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(dict(card=_card(), runs=runs), fh)
        return 0
    sys.path.insert(0, root)
    import chip_smoke
    from sequencealigning_tpu_torch import csrc
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import (
        pack_batch,
        trim_for_stream,
    )
    from sequencealigning_tpu_torch.csrc.tiled_sweep import _card
    from sequencealigning_tpu_torch.ops import (
        nw_affine_stream as fill,
        nw_affine_stream_modes as smodes,
    )

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(csrc.__file__)))
    print(_card(), f"package {pkg}", flush=True)
    csrc.kernels()
    print(f"build {csrc.build_seconds:.1f} s", flush=True)
    instances = csrc.stream_instances(csrc.build_log)
    for r in instances:
        if not r["compat"] and r["mode"] == "global" or r["wildcard"]:
            continue
        print(f"instance {r['state']} lpt {r['lanes_per_thread']} "
              f"{r['mode']} {r['dirs']}: {r['registers']} registers, "
              f"{r['spill_stores']} / {r['spill_loads']} bytes spilled "
              f"(stores / loads)", flush=True)
    check = root == here
    if check:
        t0 = time.perf_counter()
        runs = _i16_checks(fill, smodes, ScoringScheme, to_device,
                           pack_batch, trim_for_stream)
        print(f"small ragged: {runs} int16 runs equal their plain versions "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    rows = _i16_times(chip_smoke, fill, smodes, ScoringScheme, to_device,
                      pack_batch, trim_for_stream, args.i16, check)
    for r in rows:
        i16, i32 = np.mean(r["i16_ms"]), np.mean(r["i32_ms"])
        print(f"i16 {r['name']}, {r['pairs']} pairs (R={r['R']}, "
              f"P={r['P']}, T={r['T']}), lanes {r['lanes'] or 'rule'} "
              f"({r['lanes_run']} x {r['threads']} threads): int16 "
              f"{i16:.3f} ms ({', '.join(f'{v:.3f}' for v in r['i16_ms'])})"
              f", int32 {i32:.3f} ({', '.join(f'{v:.3f}' for v in r['i32_ms'])}"
              f"); {100 * r['bound16_ms'] / i16:.1f}% of the packed bound "
              f"{r['bound16_ms']:.3f} ms ({r['bound16_by']})", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=_card(), package=pkg, instances=instances,
                           rows=rows), fh)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    ap.add_argument("--root", default=None,
                    help="checkout whose package to time (default: this one)")
    ap.add_argument("--configs", type=int, default=None,
                    help="forced configurations a shape (default: all)")
    ap.add_argument("--others", action="store_true",
                    help="also time kernels #3-#8, linear and the walks")
    ap.add_argument("--long", action="store_true",
                    help="also time rows of 4097-8192 lanes and past 8192")
    ap.add_argument("--pairs", action="store_true",
                    help="time only the per-pair fills (#6, #7, linear) "
                         "over their knobs at 1-4096 pairs")
    ap.add_argument("--walks", type=int, default=0,
                    help="time only the device walks, N launches each")
    ap.add_argument("--pipeline", action="store_true",
                    help="also time the runner's fused route and "
                         "stream_align")
    ap.add_argument("--wfa", type=int, default=0,
                    help="time only the WFA fill and walk, N runs each")
    ap.add_argument("--wfa-one", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mm", type=int, default=0,
                    help="time only the Myers-Miller row kernel and kernel "
                         "#8, N runs each")
    ap.add_argument("--mm-one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--i16", type=int, default=0,
                    help="time only the int16 instances of #1 / #2 beside "
                         "their int32 twins, N launches a turn")
    ap.add_argument("--i16-one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(args.root or here)
    if args.wfa:
        return _wfa_main(args, here, root)
    if args.mm:
        return _mm_main(args, here, root)
    if args.i16:
        return _i16_main(args, here, root)
    sys.path.insert(0, root)
    import chip_smoke
    from sequencealigning_tpu_torch import csrc
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import (
        pack_batch,
        trim_for_stream,
    )
    from sequencealigning_tpu_torch.csrc.tiled_sweep import _card, _ms
    from sequencealigning_tpu_torch.ops import (
        nw_affine,
        nw_affine_modes,
        nw_affine_stream as fill,
        nw_affine_stream_modes as smodes,
        nw_affine_tiled,
        nw_banded,
        nw_banded_diag,
        nw_linear,
        traceback_device,
    )

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(csrc.__file__)))
    if os.path.dirname(pkg) != root:
        print(f"the package came from {pkg}, not {root}: run this file as "
              "a script for --root", file=sys.stderr)
        return 1
    # Another checkout's fills may predate the warp rings: its default
    # route only.
    baseline = not hasattr(fill, "stream_launch_shape")
    print(_card(), f"package {pkg}", "(baseline: its default route only)"
          if baseline else "", flush=True)
    csrc.kernels()
    print(f"build {csrc.build_seconds:.1f} s", flush=True)
    if args.walks:
        for r in csrc.kernel_resources(csrc.build_log, "walk_"):
            print(f"instance {r['entry']}: {r['registers']} registers, "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes spilled "
                  f"(stores / loads), stack {r['stack']}", flush=True)
        port = {"fill": fill, "smodes": smodes, "modes": nw_affine_modes,
                "banded": nw_banded_diag, "walk": traceback_device}
        walks = _walks(chip_smoke, port, ScoringScheme, to_device,
                       pack_batch, trim_for_stream, args.walks, root == here)
        for name, ms in walks:
            print(f"walk {name}: median {np.median(ms):.4f} ms, least "
                  f"{min(ms):.4f}, largest {max(ms):.4f} ({len(ms)} "
                  "launches)", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(card=_card(), package=pkg, walks=walks), f)
        return 0
    if args.pairs:
        return _pairs_main(args, chip_smoke, csrc, nw_affine, nw_linear,
                           nw_affine_modes, ScoringScheme, to_device,
                           pack_batch, pkg)
    instances = []
    if not baseline:
        instances = csrc.stream_instances(csrc.build_log)
        for r in instances:
            print(f"instance lpt {r['lanes_per_thread']} {r['mode']} "
                  f"{r['dirs']} compat {int(r['compat'])} wildcard "
                  f"{int(r['wildcard'])}: {r['registers']} registers, "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes spilled "
                  f"(stores / loads), stack {r['stack']}", flush=True)
    stall_s = None
    if not baseline:
        t0 = time.perf_counter()
        runs = _small_checks(fill, smodes, ScoringScheme, to_device,
                             pack_batch, trim_for_stream)
        print(f"small ragged: {runs} runs equal their plain versions "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        stall_s = stall_check(fill, ScoringScheme, to_device, pack_batch)
        print(f"an unmet schedule (wrap 1 word, chunks of 32) "
              f"raised after {stall_s:.2f} s", flush=True)

    pairs = chip_smoke.make_pairs(np.random.default_rng(0),
                                  chip_smoke.N_MAIN, chip_smoke.LEN_MAIN)
    batch = pack_batch(pairs, batch_size=chip_smoke.N_MAIN)
    cells = int((batch.query_len.astype(np.int64)
                 * batch.db_len.astype(np.int64)).sum())
    shapes = (
        ("#1 global fast4", True, "fast4", GLOBAL_CONFIGS),
        ("#2 local full", False, "local", MODES_CONFIGS),
        ("#2 semi full", False, "semi", MODES_CONFIGS),
    )
    rows = []
    walk_rows = []
    for name, trim, kind, configs in shapes:
        tb = to_device(trim_for_stream(batch) if trim else batch, "cuda")
        plan, ins = fill.stream_inputs(*tb)
        if kind == "fast4":
            a = (plan, ScoringScheme(), True, False, "fast4")
            kernel, plain = (fill.gotoh_fill_stream_cuda,
                             fill.gotoh_fill_stream_torch)
            ops = cells * chip_smoke.OPS_PER_CELL["fast4"]
        else:
            a = (plan, ScoringScheme(), False, kind, True)
            kernel, plain = (smodes.gotoh_fill_stream_modes_cuda,
                             smodes.gotoh_fill_stream_modes_torch)
            ops = cells * chip_smoke.OPS_PER_CELL[
                "local full" if kind == "local" else "full"]
        lane_steps = plan.n_rows * plan.t_total * plan.p
        todo = [{}]
        if not baseline:
            todo += [dict(lanes_per_thread=l, chunk=c, ring_slots=s)
                     for l, c, s in configs[:args.configs]]
        first = None
        for kw in todo:
            with (fill.forced_ring(**kw) if kw else contextlib.nullcontext()):
                ms, got = _ms(lambda: kernel(*ins, *a))
            _check_stalls(fill)
            got = _flat(got)
            if first is None:
                first = got
                b_ms, b_by = chip_smoke.bound(
                    chip_smoke.nbytes(*ins, *got), ops)
                if args.others and kind in ("fast4", "local"):
                    walk_rows.append(_main_walk(
                        traceback_device, nw_affine_modes, kind, got, plan,
                        batch, lambda fn: (chip_smoke.cuda_ms(torch, fn, 5),
                                           None)))
                if not baseline:
                    want = _flat(plain(*ins, *a))
                    torch.cuda.synchronize()
                    assert _equal(got, want), (name, "!= plain")
                    del want
            else:
                assert _equal(got, first), (name, kw)
            row = dict(shape=name, force=kw, ms=ms, gcups=cells / ms / 1e6,
                       lane_steps_per_s=lane_steps / ms * 1e3,
                       bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / ms, R=plan.n_rows, P=plan.p,
                       T=plan.t_total)
            line = (f"{name} (R={plan.n_rows}, P={plan.p}, "
                    f"T={plan.t_total}) {kw or 'default'}: {ms:.3f} ms, "
                    f"{cells / ms / 1e6:.1f} GCUPS, "
                    f"{lane_steps / ms / 1e6:.1f} G lane-steps/s, "
                    f"{100 * b_ms / ms:.1f}% of the bound {b_ms:.3f} ms "
                    f"({b_by})")
            if not baseline:
                shape = kernel.last_launch
                row.update(shape)
                line += (f"; {shape['lanes_per_thread']} lanes x "
                         f"{shape['threads']} threads, chunk "
                         f"{shape['chunk']}, slots {shape['ring_slots']}")
            rows.append(row)
            print(line, flush=True)
        del first, got, tb, ins
        torch.cuda.empty_cache()
    others = []
    if args.others:
        port = {"nw": nw_affine, "linear": nw_linear,
                "modes": nw_affine_modes, "banded": nw_banded_diag,
                "row": nw_banded, "walk": traceback_device,
                "tiled": nw_affine_tiled}
        # The other kernels' rows: the mean of 5 launches after a warm-up.
        def _mean_ms(fn):
            return chip_smoke.cuda_ms(torch, fn, 5), None

        others = walk_rows + _others(chip_smoke, port, ScoringScheme,
                                     to_device, pack_batch, _mean_ms)
        for name, ms in others:
            print(f"other {name}: {ms:.3f} ms", flush=True)
    long_rows = []
    if args.long:
        for name, ms, plan in _long(chip_smoke, fill, smodes, ScoringScheme,
                                    to_device, pack_batch, trim_for_stream,
                                    baseline, _ms):
            print(f"long {name} (R={plan.n_rows}, P={plan.p}, "
                  f"T={plan.t_total}): {ms:.3f} ms"
                  + ("" if baseline else ", first rows equal plain"),
                  flush=True)
            long_rows.append(dict(shape=name, ms=ms, R=plan.n_rows, P=plan.p,
                                  T=plan.t_total))
    pipeline = None
    if args.pipeline:
        from sequencealigning_tpu_torch import parallel as par

        queued, done, rates = _pipeline(chip_smoke, par, pack_batch,
                                        trim_for_stream)
        pipeline = dict(queued_ms=queued, done_ms=done, pairs_per_s=rates)
        print("pipeline: fused first-only fill+walk queued in "
              + ", ".join(f"{t:.1f}" for t in queued) + " ms, decoded in "
              + ", ".join(f"{t:.1f}" for t in done) + " ms; stream_align "
              "with cigars " + ", ".join(f"{r:.1f}" for r in rates)
              + " pairs/s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=_card(), package=pkg, baseline=baseline,
                           stall_s=stall_s, instances=instances, rows=rows,
                           others=others, long=long_rows, pipeline=pipeline),
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

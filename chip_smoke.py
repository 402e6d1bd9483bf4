#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

Drives sequencealigning_tpu_torch (never JAX, nothing of the JAX package)
in the phases below and exits non-zero at the first failure:

1. device: a CUDA card must be present; prints its nvidia-smi name and
   power limit;
2. build: compiles the CUDA kernels from csrc/ (one nvcc a source, in
   parallel, sm_90a); one line per instance of the streamed fills
   (kernels #1 and #2) and of the Myers-Miller row kernel with its
   registers and spills from -Xptxas -v;
3. fill kernel vs its plain PyTorch version on the card: ragged batches
   over compat/textbook x dirs none/fast4/full x wildcard, then the main
   path's shape (4096 pairs x 2046 bp, fast4) with its rows in one block
   and split over a 4-CTA cluster (forced 512-lane CTAs): finals equal,
   direction codes equal on every cell of every real pair; a warp-ring
   schedule that cannot be met (a wrap ring of one word) must raise, not
   hang, and the next launch must equal its plain version;
4. walk kernel vs its plain version and vs the native host walker at the
   main shape, then on one pair's own streamed fill vs its plain version
   (each with ms, ns a step of the longest walk and slow-path words);
5. main path: GotohAligner(first_only) on cuda through align_batch (the
   data-parallel runner's fill+walk) over 4096 x 2046 bp pairs at ~1%
   divergence; every pair aligned, no host re-walk, both kernels launched,
   sampled scores equal the oracle; then one more align_batch under
   torch.profiler (the card's busy share) and one under cProfile (host
   stages);
6. textbook modes fills on ragged batches: the per-pair kernel (up to 31
   pairs at up to 2046 bp, skewed both ways, semi/local x wildcard) and the
   streamed kernel (2-4 slots a row) vs their plain versions: argmax
   buffers, end cells and direction bytes equal; the modes walk kernel on
   the per-pair kernel's dirs at 1 and 31 pairs of 2046 bp, local and
   semi-global, vs its plain walk (ms, ns a step, slow-path words);
7. the main shape (4096 x 2046 bp) in local, then semi-global mode: the
   streamed modes kernel vs its plain version (argmax buffers, end cells,
   direction bytes), then the modes walk kernel on its dirs vs the plain
   walk and vs the host walker on sampled pairs; one line with kernels #1
   and #2's times beside their bounds and their instances' registers;
8. modes main path: GotohAligner textbook local, then semi-global, on cuda
   through align_batch over the 4096 x 2046 bp pairs; every pair aligned,
   the streamed fill and the walk launched, every alignment rescored under
   affine scoring (semi with free end gaps) equal to its score; one more
   local align_batch under torch.profiler and cProfile;
9. CLI (first-only, co-optimal, textbook local and semi-global: the
   per-pair modes kernel's path, -a banded, a-star with no -a, nw-linear
   and nw-linear -m local) and serve (first-only, textbook local, banded)
   on the golden corpus with --device cuda;
10. banded fill kernel (one tiled route: each pair's band in strips of
   lanes x blocks of iterations, handed out over the card by a ticket) vs
   its plain version on small ragged and skewed batches over
   compat/textbook x wildcard x dirs and the std model, and bands of
   1400-4200 in the tile rule's strips and in forced strips of 64 lanes x
   blocks of 8 iterations; a schedule that cannot be met (tickets
   reversed, one CTA) must raise, not hang; then at BASELINE config 4's
   shape (1024 pairs x 5115 bp, band 128; one tile a pair), fast4 and
   full: finals and the whole dirs tensor, also forced into 2 strips of
   128 lanes and 4 of 64 lanes in blocks of 8 iterations;
11. banded walk kernel vs its plain version on the 1024 pairs (packed ops,
   end cells, op counts) and vs the host walker on sampled pairs;
12. banded main path: BandedAligner first-only over the 1024 x 5115 bp
   pairs (alignments/s, peak memory) and the default full-dirs path over
   64 of them; every alignment consumes its sequences and rescores to its
   score;
13. past 8192 lanes: the global fast4, local and semi-global streamed fills
   and the per-pair modes fill at a ~8.3 kb db vs their plain versions,
   split into 3 CTAs of 4096 lanes and into 2 of 8192 (16 lanes a thread,
   as rows past 32768 lanes take), then one global first-only pair of
   ~49 kb through GotohAligner whose alignment rescores to its score;
14. the tiled fills (kernels #4 and #5: a pair's strips pipelined over the
   card's CTAs) vs their plain versions on small ragged batches (1-16 pairs
   up to ~3 kb, forced narrow strips, compat/textbook, wildcard, empty
   sides), then their finals on 8 (resp. 2) pairs of 40 kb vs the streamed
   global fill's (kernel #1, dirs off, itself held against its plain
   version there); the handoff stress (strips of 128 lanes, chunks of 8
   rows, 64 ragged pairs of 1-6 kb) vs the plain fill; the residency
   overflow (512 pairs of 4-8 kb, more strips than resident CTAs) vs kernel
   #7's score-only fill; the banded fill at ~8.6k lanes (300 bp queries
   against ~17 kb dbs; the tile rule's strips) vs its plain version;
15. the long-pair path: GotohAligner on cuda, first-only and co-optimal,
   over batch A (8 pairs of 100 kb, one with a 300 bp insertion and a 300
   bp deletion: kernel #4, band doubling to 512) and batch B (2 pairs, one
   whose db lacks 20 kb: kernel #5, the banded fill at L = 10,240), both
   kernels' finals there held against a plain row sweep
   (gotoh_finals_rows_torch), then 5 more launches of each, every one
   equal to the first (the race check), with their CTAs a pair, strips,
   GCUPS, share of the bound and SMs used (batch A on at least 100 SMs,
   each of batch B's pairs on more than 8); the banded fill at batch B's
   band 128 held against its plain version (finals and the whole dirs
   tensor, graph-replayed; that check's seconds), 5 more launches each
   equal to the first, its tiles, GCUPS, share of the bound and each
   pair's SMs (at least 32), and each of batch A's band rounds (128, 256,
   512) timed on its own; every pair aligned, consuming
   its sequences and rescoring to the tiled exact score, the rounds each
   pair took recorded; then the Myers-Miller row kernel (both sweeps of a
   node a launch) against its plain version, every column, at widths
   whose lane rule picks 4, 8 and 16 lanes a thread as the 100 kb escape
   does: a ~6 kb escape's top node, a 50 kb node (3000 rows a sweep), a
   wide node (8000 rows a sweep x 100 kb), a tall one (6000 rows a sweep,
   its column-0 chain below NEG_INF) and random schemes at widths in each
   range; a launch whose hand-over cannot be met sets its status word;
   the launch alone timed at the ~6 kb and 100 kb escapes' top nodes;
   then those two pairs, each escaping the (lowered) band cap, are
   aligned by Myers-Miller on the card through GotohAligner, rescoring to
   the tiled exact score, their seconds split into the node rows,
   _direct_ops and the rest;
16. kernel #7 (the per-pair global fill) at the main shape, score-only in
   the runner's layout, against its plain version and the streamed
   kernel's finals; with full dirs on 512 of the pairs (the direction
   bytes of every valid cell), the host walker on its dirs against the
   co-optimal path on 8 of them;
17. the data-parallel runner at the main shape: scores with the stream
   and the plain kernel (kernel #7's path) equal; the fused first-only
   route of phase 5 equal to the direct route (streamed fill, then walk);
   the fused local and semi-global routes equal to GotohAligner's
   _modes_batch; stream_align over 8 batches of 4096 pairs with cigars
   equal to align_batch's (pairs/s; the card's busy share under
   torch.profiler over 4), and a run failing in batch 3's drain resumed
   from its checkpoint, re-delivering batches 3-7 only;
18. the banded fill past 131072 lanes at bands 131200 and 300000 on 4
   pairs of 1-2 kb (more tiles a block than resident CTAs: the residency
   overflow): finals and the whole dirs
   tensor against the plain version, scores against kernel #4's exact
   scores (the band covers the matrix); then BandedAligner first-only at
   band 131200 on the card;
19. kernel #8 (the banded row sweep) vs its plain version on ragged and
   skewed batches (128-lane chunks, bands past one block's 2048 lanes and
   past the shared memory) and at config 4 in fast4 and full; vs kernel
   #3 there (finals; full bytes on the band's interior diagonals); then
   nw_banded_batch with the native fast4 and the host full row-layout
   walkers on 16 sampled pairs, each alignment rescoring to its finals;
20. the linear fill vs its plain version on ragged batches, at 4096 x 2046
   bp score-only (global, textbook, local) and 512 x 2046 bp with path
   bits (global, local); LinearNWAligner on cuda over the 512 pairs
   (alignments/s, one pair against the oracle) and 16 small pairs global
   and local against the oracle;
21. AStarAligner over 4096 x 1023 bp pairs (alignments/s); 4 sampled pairs
   equal the oracle's result;
22. the plain versions' graph replay vs the same step loops run eagerly on
   the card: the banded fill and the row sweep at config 4, equal results,
   both times;
23. textbook WFA: the wavefront fill kernel vs its plain version on ragged
   batches (1-67 pairs up to 3 kb skewed both ways, empty sides, identical
   pairs; 4/2/6 and 9/2/2; global and spans 5 and (3, 0, 0, 7); a band of
   4 and bands past 1024 lanes, lanes a thread forced) -- score,
   converged, end diagonal and every log row up to the deepest score --
   then at BASELINE config 3 (128 x 10230 bp, 0.5% substitutions, band
   64) and on an indel batch (the same shape, 1% substitutions and 3
   indels of 1-50 bp a pair) at bands 64, 128 and 256, timed a fill and a
   launch beside the bound; the walk kernel vs its plain walk (packed
   codes, op counts, ok flags) and, on sampled pairs, the host walker;
   WfaAligner on cuda at config 3 with --wfa-engine auto, banded, native
   and wavefront (every alignment consumes its sequences and rescores to
   its penalty, the four engines' scores equal, alignments/s); the compat
   route on 8 x 1 kb against oracle_wfa; the golden wfa and wfa-textbook
   CLI outputs (also with --wfa-engine wavefront), -m semi-global
   --textbook --wfa-spans 5, and serve -a wfa;
24. int16 stream state (kernels #1 and #2's int16 instances,
   csrc/nw_affine_stream_i16.cu: two lanes a 32-bit word): every instance
   against its int16 plain version on ragged batches (global compat and
   textbook x dirs none/fast4/full x wildcard, semi-global and local x
   dirs x wildcard, lanes a thread forced to 2/4/16 and the default, odd
   and one-step chunks) and split over a 4-CTA cluster; at the main
   shape the fast4 fill against its plain version (all 4096 pairs), the
   full, local and semi-global fills against theirs on the first
   N_I16_PLAIN pairs (the plain loops' time), and all four against the
   int32 kernels at full size -- scores and every finite final, the
   modes' argmax buffers, and the walks (the fast4 and modes walk kernels
   on both dirs; the co-optimal host walk of sampled pairs for full);
   each timed int32, int16, int16, int32 beside its bound (the packed
   rule: a 16x2 instruction counts as two of OPS_PER_CELL's operations);
   GotohAligner first-only and textbook local and the runner's scores
   with stream_state "i16" through the int16 kernels (launch counts; the
   int32 kernels never launched there), equal to the int32 runs; the
   golden CLI with --stream-state i16 and with --traceback host, and
   --profile writing a trace with CUDA kernel events;
25. sequence parallelism (runs after 15): the shard fill
   (sa_tiled_shard_fill, kernel #4's strips over each shard's segments,
   one launch a shard, all at once) against its plain version on ragged
   batches of 8 pairs (queries up to 200 bp, dbs up to 3 kb, empty
   sides) on 1, 2, 4 and 8 shards of one card at tile_lanes 128 and 256,
   compat / textbook x wildcard; seqpar_fill on one 200 kb x 200 kb pair
   (~1% substitutions) over 4 shards of one card (13 rounds, 49
   segments), its finals against kernel #4's, then 5 more launches each
   equal (timed beside #4's time on the pair and the bound);
   seqpar_align on batch A's pair 0, scoring kernel #4's score with an
   alignment that consumes both sequences and rescores to it; a schedule
   that cannot be met (2 shards of one CTA, one of them not
   segment-major) must raise, and the next launch equal its plain
   version; with several cards, the 200 kb pair over distinct cards too
   (else a line says that route was not run);
26. sequence parallelism across processes (runs after 25): this script
   re-invoked as SEQPAR_RANKS ranks of a torch.distributed Gloo group
   (--seqpar-rank), each driving SEQPAR_RANK_SHARDS shards of the one
   card, the columns between ranks relayed through pinned host buffers
   (parallel/relay.py): the shard fill on two ragged batches equal to the
   plain twin across the same ranks and shards; seqpar_fill on the 200 kb
   pair equal to kernel #4's finals and to the one-process seqpar_fill
   over the same 4 shards on every rank, then N_RANK_RACE more calls each
   equal (the launches' CUDA-event ms, the relay's messages, the spread of
   the ranks' launch times); seqpar_align on batch A's pair 0 scoring
   kernel #4's score with an alignment that consumes both sequences and
   rescores to it; rank 0 withholding its columns must make both ranks
   raise, rank 1 naming the shards and rank 0, within SEQPAR_WITHHOLD_S +
   40 s.  A rank that exits non-zero fails the run.  The two ranks'
   kernels time-slice the one card (no MPS): their times are a
   correctness run, not a speed across hosts;
27. the soak (runs last; sequencealigning_tpu_torch.soak, the port of
   benchmarks/soak.py): SOAK_ROUNDS rounds of 16 random pairs of up to
   SOAK_LEN bp at a fixed seed and one more round with the cross leg (1-64
   pairs of up to SOAK_LONG_LEN bp: kernel #1's finals equal #7's, #4's
   and seqpar_fill's), every kernel of the port against the scalar
   oracles or another engine at random schemes, compat and lengths: legs,
   checks, mismatches (none allowed), each kernel's launches (every one
   launched) and seconds; then the dry run (sequencealigning_tpu_torch.
   dryrun, the port of __graft_entry__.dryrun_multichip) over make_mesh()
   and over DRYRUN_SHARDS shards of cuda:0.

Every phase prints its wall seconds; the summary is on a line before the
card's, and in chip_smoke.json's phase_s.

Launch counts are read per path: every kernel's count is set to 0 just
before a path runs and read just after; comparisons with plain versions
are not counted.  The second-to-last line is a JSON object with, for each
kernel, its launches (in total and by path), its largest error against
the plain version, its kernel and plain times with the shape they were
taken at (kernel #3 also at each shape of its paths, with its tiles), its
bound (the least time the card could take: the larger of
its bytes over 3.35 TB/s and its integer operations over 16.75 Tops/s)
and library_ms (null: no single PyTorch call computes these functions);
the last line is {"ok": true, "device": {...}}.  --out DIR writes the
compiler log, the measurements and the profile tables there.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN, LEN_MAIN = 4096, 2046
# BASELINE config 4 (benchmarks/configs_bench.py: config4_banded): 1024
# pairs of 5115 bp at 1% substitutions from seed 4, band 128.
N_BAND, LEN_BAND, BAND = 1024, 5115, 128
# The default (full-dirs, host-walked) banded path's pairs.
N_BAND_FULL = 64
# Kernel #8's warp route: the band widths its 4, 8, 12 and 16 lanes-a-
# thread instances take.
ROW_WARP_WIDTHS = (128, 256, 384, 512)
# The ceiling phase: a db past 8192 lanes, and one pair near the 49152-lane
# limit of the streamed fill.
LEN_CEIL_DB, LEN_LONG = 8300, 49150
# The long-pair path: batch A, N_LONG pairs of LEN_LONG_PAIR bp (seed 10),
# pair 0 with a LONG_INDEL bp insertion at 30 kb and deletion at 70 kb;
# batch B, pair 0 of A and a pair whose db lacks LONG_DROP bp in its
# middle.  The tiled fills' full-width check: pairs of LEN_TILE_CHECK bp.
N_LONG, LEN_LONG_PAIR, LONG_INDEL, LONG_DROP = 8, 100_000, 300, 20_000
LEN_TILE_CHECK = 40_000
# The Myers-Miller escapes: a LEN_MM_SHORT bp pair and one of batch A's
# length (LEN_LONG_PAIR), each with an MM_EXCURSION bp insertion at a third
# of its length and a deletion as long 2 kb on, on an aligner whose band
# cap is BAND.  The row kernel against its plain version, one launch a
# level of nodes (16 lanes a thread): the short escape's top node; a node of
# MM_MID_ROWS rows a sweep over MM_MID_COLS columns, a level-1 node's
# width; a wide node of MM_WIDE_ROWS rows a sweep over the long pair's
# whole db (some 200 strips a sweep, every row handed over); a tall,
# narrow node (MM_TALL_ROWS rows a sweep over MM_TALL_COLS columns, its
# column-0 chain below NEG_INF); MM_SCHEMES random schemes on nodes of
# MM_SCHEME_ROWS rows over the long pair, their widths in turn in the
# ranges of MM_SCHEME_WIDTHS; a level of several nodes (MM_LEVEL) in one
# launch; and a level of MM_WIDE_LEVEL nodes of MM_WIDE_LEVEL_ROWS rows a
# sweep across the whole db, whose strips outnumber the grid's warps (some
# strips start only when others have finished).
LEN_MM_SHORT, MM_EXCURSION = 6000, 500
MM_MID_ROWS, MM_MID_COLS = 3000, 50_000
MM_WIDE_ROWS, MM_TALL_ROWS, MM_TALL_COLS = 8000, 6000, 300
MM_SCHEMES, MM_SCHEME_ROWS = 3, 600
# A level of nodes of different widths and heights over the long pair:
# (query start, rows a sweep, db start, columns - 1, whether the top and
# the bottom boundary open a gap).
MM_LEVEL = ((0, 150, 0, 1500, 1, 1), (400, 40, 2000, 33_000, 1, 0),
            (900, 200, 40_000, 130, 0, 1), (1500, 120, 50_000, 8000, 0, 0),
            (2000, 10, 60_000, 100, 1, 1), (2100, 300, 61_000, 20_000, 1, 0))
MM_WIDE_LEVEL, MM_WIDE_LEVEL_ROWS = 3, 100
MM_SCHEME_WIDTHS = ((1, 25_000), (35_000, 55_000), (70_000, LEN_LONG_PAIR))
# The tiled fills' small ragged batches (bp at most): kernel #4's 16 pairs,
# kernel #5's 1-4 (the plain versions' cost grows with the length).
LEN_TILE_SMALL, LEN_FOLD_SMALL = 700, 1000
# Their handoff stress: N_HANDOFF pairs of 1..LEN_HANDOFF bp in strips of
# HANDOFF_LANES lanes handing over every HANDOFF_ROWS rows; the residency
# overflow: N_OVERFLOW pairs of LEN_OVERFLOW bp (more strips than the card
# holds CTAs); the race check: N_RACE more launches at batches A and B.
N_HANDOFF, LEN_HANDOFF, HANDOFF_LANES, HANDOFF_ROWS = 64, 6000, 128, 8
N_OVERFLOW, LEN_OVERFLOW = 512, (4000, 8000)
N_RACE = 5
# Sequence parallelism: one pair of SEQPAR_LEN bp a side (the README's
# durable 200 kb x 200 kb shape) at ~1% substitutions (seed 25) over
# SEQPAR_SHARDS shards of one card at tile_lanes SEQPAR_TILE (13 rounds, 49
# segments); the kernel against its plain version on ragged batches of 8
# pairs, queries up to SEQPAR_RAGGED_Q bp against dbs up to
# SEQPAR_RAGGED_DB bp.
SEQPAR_LEN, SEQPAR_SHARDS, SEQPAR_TILE = 200_000, 4, 4096
SEQPAR_RAGGED_Q, SEQPAR_RAGGED_DB = 200, 3000
# Sequence parallelism across processes (phase 26): SEQPAR_RANKS processes
# of SEQPAR_RANK_SHARDS shards each on the one card, over a Gloo group;
# the 200 kb pair N_RANK_RACE more times; the withheld relay's waits bounded
# by SEQPAR_WITHHOLD_S; the ranks given SEQPAR_RANKS_TIMEOUT_S in all.
SEQPAR_RANKS, SEQPAR_RANK_SHARDS, N_RANK_RACE = 2, 2, 2
SEQPAR_WITHHOLD_S, SEQPAR_RANKS_TIMEOUT_S = 20.0, 300
# Kernel #7 with full dirs: the first N_GOTOH_DIRS pairs of the main shape;
# its host walker against the co-optimal path on N_GOTOH_WALK of them.
N_GOTOH_DIRS, N_GOTOH_WALK = 512, 8
# stream_align over N_STREAM batches of the main shape, the checkpoint run
# failing in batch STREAM_CRASH's drain, the profiled run over
# N_STREAM_PROFILE batches.
N_STREAM, STREAM_CRASH, N_STREAM_PROFILE = 8, 3, 4
# The banded fill past a cluster's 131072 lanes: N_WIDE pairs of
# LEN_WIDE_LO..LEN_WIDE_HI bp at WIDE_BANDS (bands covering the matrix).
N_WIDE, LEN_WIDE_LO, LEN_WIDE_HI = 4, 1000, 2000
WIDE_BANDS = (131_200, 300_000)
# The linear fill with path bits and LinearNWAligner: the first
# N_LINEAR_DIRS pairs of the main shape.
N_LINEAR_DIRS = 512
# AStarAligner: N_ASTAR pairs of LEN_ASTAR bp (BASELINE config 1's length).
N_ASTAR, LEN_ASTAR = 4096, 1023
# Textbook WFA: BASELINE config 3 (benchmarks/configs_bench.py:
# config3_wfa), N_WFA pairs of LEN_WFA bp at 0.5% substitutions from seed
# 3, penalties 4/2/6, band WFA_BAND; the indel batch, the same shape at 1%
# substitutions with WFA_INDELS insertions or deletions of 1-50 bp a pair
# (seed 30), filled at the wavefront engine's doubled bands too; the
# compat route on N_WFA_COMPAT pairs of LEN_WFA_COMPAT bp.
N_WFA, LEN_WFA, WFA_BAND, WFA_INDELS = 128, 10_230, 64, 3
N_WFA_COMPAT, LEN_WFA_COMPAT = 8, 1000
# int16 stream state: the full, local and semi-global fills against their
# plain versions on the first N_I16_PLAIN pairs of the main shape (the
# plain loops over all 4096 pairs take ~10 s each); the textbook local
# aligner with stream_state "i16" over N_I16_LOCAL of them.
N_I16_PLAIN, N_I16_LOCAL = 512, 1024
# The int16 state's certification edge: the longest pair the default scheme
# certifies (ops.nw_affine_stream.stream_i16_neg bounds the plan's padded
# lengths at 2722; stream_inputs pads to 128 lanes, so 2688 bp is the
# longest pair that certifies), N_I16_EDGE of them, and
# a steep scheme that certifies 200-256 bp queries against 1-4 bp dbs with
# 20 to spare (the sentinel minus its dip): the floored chains of the cells
# outside the pairs then sit beside real cells in the same words.
N_I16_EDGE, LEN_I16_EDGE = 2, 2688
I16_STEEP = (5, -60, -100, -84)
# The compat check's step cap (config.wfa_max_steps): the reference's WFA
# converges on none of these pairs (its len-1 convergence quirk), and the
# Python oracle takes ~12 s a pair to reach the default 20000 steps.
WFA_COMPAT_STEPS = 1000
# Phase 27: the soak's rounds at SOAK_LEN bp (seed SOAK_SEED), then one
# round with the cross leg at SOAK_LONG_LEN bp (seed SOAK_SEED + 1), sized
# to stay within 90 s; the dry run over make_mesh() and over
# DRYRUN_SHARDS shards of cuda:0.
SOAK_ROUNDS, SOAK_SEED, SOAK_LEN, SOAK_LONG_LEN = 8, 27, 600, 12_000
DRYRUN_SHARDS = 4
# The card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, and INT32
# operations/s = the 67 TFLOP/s fp32 rate / 4 (64 INT32 lanes a SM against
# 128 fp32 lanes, no fused multiply-add doubling).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 67e12 / 4
# The least integer operations the function needs per interior DP cell
# (fills; banded: per band cell) or per walk step, whatever the kernel adds
# for its layout (boundary selects, edge masks, lane windows, register
# moves are not counted).  A cell: the recurrence 10 (substitution compare,
# select and add 3; the gap open M + o 1, shared by the cell's two
# neighbours; I and D a maximum and an add each 4; H two maxima 2); the
# direction code, a compare and an OR a bit (fast4: the 2-bit H argmax 4
# plus the I and D extend bits 4 = 8; full: 7 bits 14, local's LSTART 2
# more); its packing into the word, a shift and an OR 2.  Local adds the
# clamp at 0 (1) and the running argmax (compare, two selects 3); the
# semi-global argmax reads only the last row and column (0 a cell).  A walk
# step: locate the code 4, extract it 2, next plane 2, move 2, emit the op
# 2 = 12; modes + the stop test 2; banded + the band's lane index 4.
OPS_PER_CELL = {
    "fast4": 10 + 8 + 2,                  # 20: global, banded
    "full": 10 + 14 + 2,                  # 26: banded, semi-global
    "local full": 10 + 1 + 3 + 16 + 2,    # 32
    "walk_fast4": 12, "walk_modes": 14, "walk_banded": 16,
    "score": 10,                          # the tiled fills: no code
    # The linear cell: substitution 3, the two gap candidates with the
    # neighbour's gap flag 4, the maximum of three 2, the gap flag 3 = 12;
    # textbook score-only needs no gap flag (two plain adds 2: 7); local
    # adds the clamp 1 and the running maximum 2; the path bits 3 ORs and
    # their packing 2, local's cleared bits 1 and ISMAX 3.
    "linear score": 12, "linear textbook score": 3 + 2 + 2,
    "linear local score": 15,
    "linear bits": 12 + 3 + 2, "linear local bits": 15 + 3 + 2 + 1 + 3,
    # A WFA lattice step of one diagonal: I a maximum, the NEG test and
    # the ok() bounds (t >= 0, t <= n2, y = t + k, y >= 0, y <= n1) 7; D
    # the same and its +1 8; M the +1 with its NEG test, a maximum of three
    # and ok() 9; the end test 2 = 26.  A character of the extension: two
    # bounds, the code compare and the advance 4.  A walk step: three log
    # reads (lane, row, lattice and band tests) 12, the maximum of three 2,
    # the mismatch / I / D tests 3, the next state 3 = 20; an op emitted 2.
    "wfa step": 26, "wfa extend": 4, "wfa walk step": 20, "wfa walk op": 2,
    # A Myers-Miller row cell (the standard model): substitution 3; the gap
    # open from H, CC + o 1; DD's maximum and add 2; B's maximum 1; the
    # in-row chain's input B + o + e 1, its add and maximum 2; CC's maximum
    # 1 = 11.
    "mm rows": 11,
}
KERNELS = {
    # name: (module key, wrapper, source, TPU kernel replaced[, the
    # wrapper's launch counter, "launches" when absent])
    "nw_affine_stream_fill": (
        "fill", "gotoh_fill_stream_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine_stream.cu",
        "sequencealigning_tpu/ops/nw_affine_stream.py:429"),
    "walk_fast4": (
        "walk", "walk_fast4_cuda",
        "sequencealigning_tpu_torch/csrc/traceback_device.cu",
        "sequencealigning_tpu/ops/traceback_device.py:146"),
    "nw_affine_modes_fill": (
        "modes", "modes_fill_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine_modes.cu",
        "sequencealigning_tpu/ops/nw_affine_modes.py:134"),
    "nw_affine_stream_modes_fill": (
        "smodes", "gotoh_fill_stream_modes_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine_stream.cu",
        "sequencealigning_tpu/ops/nw_affine_stream_modes.py:182"),
    "nw_affine_stream_fill_i16": (
        "fill", "gotoh_fill_stream_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine_stream_i16.cu",
        "sequencealigning_tpu/ops/nw_affine_stream.py:429", "launches_i16"),
    "nw_affine_stream_modes_fill_i16": (
        "smodes", "gotoh_fill_stream_modes_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine_stream_i16.cu",
        "sequencealigning_tpu/ops/nw_affine_stream_modes.py:182",
        "launches_i16"),
    "walk_modes": (
        "walk", "walk_modes_cuda",
        "sequencealigning_tpu_torch/csrc/traceback_device.cu",
        "sequencealigning_tpu/ops/traceback_device.py:541"),
    "nw_banded_diag_fill": (
        "banded", "banded_diag_fill_cuda",
        "sequencealigning_tpu_torch/csrc/nw_banded_diag.cu",
        "sequencealigning_tpu/ops/nw_banded_diag.py:350"),
    "walk_banded": (
        "walk", "walk_banded_cuda",
        "sequencealigning_tpu_torch/csrc/traceback_device.cu",
        "sequencealigning_tpu/ops/traceback_device.py:181"),
    "nw_affine_tiled_fill": (
        "tiled", "tiled_fill_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine_tiled.cu",
        "sequencealigning_tpu/ops/nw_affine_tiled.py:161"),
    "nw_affine_tiled_fold_fill": (
        "tiled", "tiled_fold_fill_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine_tiled.cu",
        "sequencealigning_tpu/ops/nw_affine_tiled.py:563"),
    "nw_affine_fill": (
        "nw", "gotoh_fill_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine.cu",
        "sequencealigning_tpu/ops/nw_affine.py:223"),
    "nw_banded_fill": (
        "row", "banded_row_fill_cuda",
        "sequencealigning_tpu_torch/csrc/nw_banded.cu",
        "sequencealigning_tpu/ops/nw_banded.py:311"),
    "nw_linear_fill": (
        "linear", "linear_fill_cuda",
        "sequencealigning_tpu_torch/csrc/nw_linear.cu",
        "sequencealigning_tpu/ops/nw_linear.py:56"),
    "wfa_fill": (
        "wfa", "wfa_chunk_cuda",
        "sequencealigning_tpu_torch/csrc/wfa.cu",
        "sequencealigning_tpu/ops/wfa.py:343"),
    "wfa_walk": (
        "wfa", "wfa_walk_cuda",
        "sequencealigning_tpu_torch/csrc/wfa.cu",
        "sequencealigning_tpu/ops/wfa.py:692"),
    "mm_rows": (
        "mm", "mm_rows_cuda",
        "sequencealigning_tpu_torch/csrc/mm_rows.cu",
        "sequencealigning_tpu/ops/mm_align.py:64"),
    "seqpar_shard": (
        "tiled", "tiled_shard_fill_cuda",
        "sequencealigning_tpu_torch/csrc/nw_affine_tiled.cu",
        "sequencealigning_tpu/parallel/seqpar.py:57"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def _wrapper(port, name):
    key, fn = KERNELS[name][:2]
    return getattr(port[key], fn)


def _counter(name):
    """The wrapper attribute that counts the kernel's launches."""
    spec = KERNELS[name]
    return spec[4] if len(spec) > 4 else "launches"


@contextlib.contextmanager
def path_launches(port, by_path, path):
    """Run a main path with every kernel's launch count set to 0 just
    before it; just after, add the counts it read to by_path[kernel][path]
    (kernels it did not launch are left out)."""
    for name in KERNELS:
        setattr(_wrapper(port, name), _counter(name), 0)
    yield
    for name in KERNELS:
        n = getattr(_wrapper(port, name), _counter(name))
        if n:
            by_path.setdefault(name, {})[path] = \
                by_path.get(name, {}).get(path, 0) + n


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the least time the card could take for the
    bytes (each input read once, each output written once) and the integer
    operations, at the card's peak rates."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / INT32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def make_pairs(rng, n, length):
    """n (mutant, reference) pairs of `length` bp at ~1% substitutions."""
    pairs = []
    for _ in range(n):
        ref = rng.choice(list(b"ACGT"), length).astype(np.uint8).tobytes()
        mut = bytearray(ref)
        for _ in range(length // 100):
            p = int(rng.integers(0, len(mut)))
            mut[p] = int(rng.choice([c for c in b"ACGT" if c != mut[p]]))
        pairs.append((bytes(mut), ref))
    return pairs


def ragged_pairs(rng, n):
    """Lengths 1-300; a quarter of the pairs carry N; half are mutants."""
    pairs = []
    for i in range(n):
        alpha = np.frombuffer(b"ACGTN" if i % 4 == 0 else b"ACGT", np.uint8)
        s1 = rng.choice(alpha, int(rng.integers(1, 301)))
        if i % 2:
            s2 = s1.copy()
            for _ in range(int(rng.integers(0, 8))):
                s2[rng.integers(len(s2))] = rng.choice(alpha)
            s2 = s2[: int(rng.integers(1, len(s2) + 1))]
        else:
            s2 = rng.choice(alpha, int(rng.integers(1, 301)))
        pairs.append((s1.tobytes(), s2.tobytes()))
    return pairs


def cuda_ms(torch, fn, repeats=3):
    """Mean milliseconds of fn() on the card (CUDA events, after one
    warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def host_ms(torch, fn):
    """Milliseconds of one fn() call ending in a device synchronise, and its
    result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def stream_coords(plan, n):
    """(row, diagonal offset) of each of n pairs in a streamed layout."""
    return [plan.pair_coords(b)[::2] for b in range(n)]


def valid_cell_diff(torch, dirs_a, dirs_b, coords, n1s, n2s, dirs_mode):
    """Max |code_a - code_b| over every cell 0 <= x <= n2, 0 <= y <= n1 of
    each real pair (at its (row, offset) in coords), the D bits at x = 0
    masked (the torus roll fills them from lane P-1 and no walker reads
    them)."""
    per_word, bits = (8, 4) if dirs_mode == "fast4" else (4, 8)
    dmask = 8 if dirs_mode == "fast4" else 32 | 64
    a32, b32 = dirs_a.view(torch.int32), dirs_b.view(torch.int32)
    dev = dirs_a.device
    worst = 0
    for b in range(len(n1s)):
        row, off = coords[b]
        x = torch.arange(int(n2s[b]) + 1, device=dev)[:, None]
        y = torch.arange(int(n1s[b]) + 1, device=dev)[None, :]
        d = (off + x + y).reshape(-1)
        xx = x.expand(-1, y.shape[1]).reshape(-1)
        shift = (d % per_word) * bits
        mask = (1 << bits) - 1
        ca = (a32[d // per_word, row, xx] >> shift) & mask
        cb = (b32[d // per_word, row, xx] >> shift) & mask
        keep = torch.where(xx == 0, mask & ~dmask, mask)
        diff = ((ca & keep) - (cb & keep)).abs().max()
        worst = max(worst, int(diff))
    return worst


def outside_zero(torch, dirs, n1s, n2s):
    """Whether every byte of a per-pair fill's (W, B, P) dirs outside each
    pair's cells 0 <= x <= n2, 0 <= y <= n1 is 0."""
    W, B, P = dirs.shape
    dev = dirs.device
    d = torch.arange(W, device=dev)[:, None, None] * 4 + torch.arange(
        4, device=dev)
    x = torch.arange(P, device=dev)[None, :, None]
    for b in range(B):
        g = dirs[:, b, :].contiguous().view(torch.uint8).view(W, P, 4)
        valid = (x <= int(n2s[b])) & (d >= x) & (d - x <= int(n1s[b]))
        if bool(g.masked_select(~valid).any()):
            return False
    return True


def pair_dirs_diff(torch, got, want, n1s, n2s):
    """A per-pair fill's dirs (kernels #6 and #7, the linear fill) against
    the plain version's: the largest difference on the pairs' cells
    (valid_cell_diff), or 1 where a byte outside them is not 0 (the plain
    versions write their codes there; no walker reads them)."""
    err = valid_cell_diff(torch, got, want, [(b, 0) for b in range(len(n1s))],
                          n1s, n2s, "full")
    return max(err, 0 if outside_zero(torch, got, n1s, n2s) else 1)


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    lines = smi.stdout.strip().splitlines()
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return lines[0].strip()


def phase_build(csrc, out_dir):
    t0 = time.perf_counter()
    csrc.kernels()
    secs = time.perf_counter() - t0
    regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                       csrc.build_log)]
    spills = re.findall(r"[1-9]\d* bytes spill stores", csrc.build_log)
    log(f"[2 build] kernels built in {secs:.1f} s "
        f"(nvcc {csrc.build_seconds:.1f} s); {len(regs)} kernels, at most "
        f"{max(regs, default=0)} registers a thread; {len(spills)} spill")
    # The streamed fills' instances (kernels #1 and #2): registers and
    # spills from -Xptxas -v, one line each.
    inst = csrc.stream_instances(csrc.build_log)
    check(len(inst) > 0 or not csrc.build_log,
          "no streamed-fill instance in the build log")
    for r in inst:
        log(f"[2 build] stream instance {r['state']}, "
            f"{r['lanes_per_thread']} lanes a "
            f"thread, {r['mode']}, dirs {r['dirs']}, compat "
            f"{int(r['compat'])}, wildcard {int(r['wildcard'])}: "
            f"{r['registers']} registers, spill stores {r['spill_stores']} "
            f"B, loads {r['spill_loads']} B, stack {r['stack']} B")
    for r in (csrc.kernel_resources(csrc.build_log, "mm_rows_kernel")
              + csrc.kernel_resources(csrc.build_log,
                                      "banded_row_warp_kernel")):
        log(f"[2 build] {r['entry']}: {r['registers']} registers, spill "
            f"stores {r['spill_stores']} B, loads {r['spill_loads']} B")
    if out_dir:
        with open(os.path.join(out_dir, "nvcc_build.log"), "w") as f:
            f.write(csrc.build_log)
    return secs, inst


def phase_fill(torch, port):
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import (
        pack_batch,
        trim_for_stream,
    )

    fill = port["fill"]
    rng = np.random.default_rng(2)
    pairs = ragged_pairs(rng, 40)
    batch = trim_for_stream(pack_batch(pairs, batch_size=40))
    tb = to_device(batch, "cuda")
    plan, ins = fill.stream_inputs(*tb)
    n1s = batch.query_len[:40]
    n2s = batch.db_len[:40]
    whole_equal = True
    for compat in (True, False):
        for dirs_mode in (None, "fast4", "full"):
            for wildcard in (False, True):
                args = (plan, ScoringScheme(), compat, wildcard, dirs_mode)
                fk, dk = fill.gotoh_fill_stream_cuda(*ins, *args)
                fp, dp = fill.gotoh_fill_stream_torch(*ins, *args)
                torch.cuda.synchronize()
                err = int((fk - fp).abs().max())
                if dirs_mode:
                    err = max(err, valid_cell_diff(
                        torch, dk, dp, stream_coords(plan, 40), n1s, n2s,
                        dirs_mode))
                    whole_equal &= bool(torch.equal(dk.view(torch.int32),
                                                    dp.view(torch.int32)))
                check(err == 0, f"fill kernel != plain (compat={compat}, "
                      f"dirs={dirs_mode}, wildcard={wildcard}): err {err}")
    log(f"[3 fill] ragged: 12 configurations equal on finals and valid "
        f"cells (P={plan.p}, S={plan.s}, T={plan.t_total}); whole dirs "
        f"tensors equal: {whole_equal}")
    out = {"ragged_whole_dirs_equal": whole_equal}

    pairs = make_pairs(np.random.default_rng(0), N_MAIN, LEN_MAIN)
    batch = trim_for_stream(pack_batch(pairs, batch_size=N_MAIN))
    tb = to_device(batch, "cuda")
    plan, ins = fill.stream_inputs(*tb)
    args = (plan, ScoringScheme(), True, False, "fast4")
    ms = cuda_ms(torch, lambda: fill.gotoh_fill_stream_cuda(*ins, *args))
    fk, dk = fill.gotoh_fill_stream_cuda(*ins, *args)
    fill.check_stream_stalls(wait=True)
    launch = dict(fill.gotoh_fill_stream_cuda.last_launch)
    plain_ms, (fp, dp) = host_ms(
        torch, lambda: fill.gotoh_fill_stream_torch(*ins, *args))

    def diff(f, d):
        e = int((f - fp).abs().max())
        whole = bool(torch.equal(d.view(torch.int32), dp.view(torch.int32)))
        if not whole:
            e = max(e, valid_cell_diff(
                torch, d, dp, stream_coords(plan, N_MAIN), batch.query_len,
                batch.db_len, "fast4"))
        return e, whole

    err, whole = diff(fk, dk)
    check(err == 0, f"fill kernel != plain at the main shape: err {err}")
    # The same rows split over a 4-CTA cluster (forced 512-lane CTAs).
    split_lanes = 512
    n_ctas = port["csrc"].kernels().sa_fill_ctas(plan.p, split_lanes)
    split_ms = cuda_ms(torch, lambda: fill.gotoh_fill_stream_cuda(
        *ins, *args, cta_lanes=split_lanes))
    fs, ds = fill.gotoh_fill_stream_cuda(*ins, *args, cta_lanes=split_lanes)
    split_err, split_whole = diff(fs, ds)
    del dp, ds
    check(split_err == 0, f"{n_ctas}-CTA split fill != plain at the main "
          f"shape: err {split_err}")
    cells = int((batch.query_len.astype(np.int64)
                 * batch.db_len.astype(np.int64)).sum())
    b_ms, b_by = bound(nbytes(*ins, fk, dk),
                       cells * OPS_PER_CELL["fast4"])
    log(f"[3 fill] {N_MAIN} x {LEN_MAIN} bp fast4 (R={plan.n_rows}, "
        f"P={plan.p}, T={plan.t_total}): kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, {cells / ms / 1e6:.2f} GCUPS, bound "
        f"{b_ms:.3f} ms ({b_by}); equal (whole dirs tensor equal: {whole}); "
        f"split over {n_ctas} CTAs of {split_lanes} lanes: {split_ms:.3f} ms,"
        f" equal (whole dirs: {split_whole})")
    out.update(fill_ms=ms, fill_plain_ms=plain_ms, fill_err=err,
               fill_gcups=cells / ms / 1e6, main_whole_dirs_equal=whole,
               fill_bound_ms=b_ms, fill_bound_by=b_by,
               fill_split4_ms=split_ms, fill_split4_err=split_err,
               fill_split4_whole_dirs_equal=split_whole,
               fill_launch=launch)
    out.update(stream_stall_check(torch, port))
    return out, (fk, dk, plan, pairs)


def stream_stall_check(torch, port):
    """The streamed fills' warp rings: a wrap ring of one word under chunks
    of 32 steps (four words a chunk) on a row of several warps can never
    be met, and must raise, not hang; the same fill with the default rings
    then runs and equals its plain version.  The seconds it took."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    fill = port["fill"]
    tb = to_device(pack_batch([(b"ACGT" * 20, b"ACGTT" * 60)] * 8,
                              batch_size=8), "cuda")
    plan, ins = fill.stream_inputs(*tb, np_slots=2)
    a = (plan, ScoringScheme(), True, False, "fast4")
    t0 = time.perf_counter()
    raised = None
    try:
        with fill.forced_ring(lanes_per_thread=2, chunk=32, wrap_words=1):
            fill.gotoh_fill_stream_cuda(*ins, *a)
        fill.check_stream_stalls(wait=True)
    except RuntimeError as e:
        raised = str(e)
    secs = time.perf_counter() - t0
    check(raised is not None and "spin limit" in raised,
          f"an impossible warp-ring schedule did not raise: {raised}")
    got = fill.gotoh_fill_stream_cuda(*ins, *a)
    fill.check_stream_stalls(wait=True)
    want = fill.gotoh_fill_stream_torch(*ins, *a)
    torch.cuda.synchronize()
    check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
              for g, w in zip(got, want)),
          "the streamed fill after a stalled launch != plain")
    warps = fill.stream_launch_shape(port["csrc"].kernels(), plan.p, 0,
                                     False, 2)["threads"] // 32
    log(f"[3 fill] an impossible warp-ring schedule (wrap ring of 1 word, "
        f"chunks of 32 steps, {warps} warps) raised after "
        f"{secs:.2f} s: {raised}; the next launch equals its plain version")
    return {"fill_stall_s": secs}


def walk_bound(name, got, seeds):
    """Bound of a walk: one 4-byte dirs word read a step, the seeds read
    and the outputs written once; OPS_PER_CELL[name] operations a step."""
    n_ops = int(got[-1].sum())
    return bound(4 * n_ops + nbytes(*seeds, *got),
                 n_ops * OPS_PER_CELL[name])


def walk_diff(torch, got, want):
    """The largest difference between two walks' outputs."""
    return max(int((g.view(torch.int32).long()
                    - w.view(torch.int32).long()).abs().max())
               for g, w in zip(got, want))


def staged_walk(torch, kernel, plain, name, seeds, repeats=5):
    """A fast4 or modes walk kernel (kernel(slow=None)) against its plain
    version on the same seeds, then timed (the mean of `repeats` launches)
    beside its bound: ms, plain_ms, bound_ms, bound_by, err, the words its
    slow path read, its ring's restagings, the longest walk's steps and ns
    a step of it."""
    slow = torch.zeros(2, dtype=torch.int64, device="cuda")
    got = kernel(slow=slow)
    plain_ms, want = host_ms(torch, plain)
    err = walk_diff(torch, got, want)
    ms = cuda_ms(torch, kernel, repeats)
    steps = int(got[-1].max())
    b_ms, b_by = walk_bound(name, got, seeds)
    return got, dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     err=err, slow_reads=int(slow[0]),
                     restagings=int(slow[1]), steps=steps,
                     ns_per_step=ms * 1e6 / max(steps, 1))


def phase_walk(torch, port, state):
    from sequencealigning_tpu_torch import native
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import (
        pack_batch,
        trim_for_stream,
    )

    walk = port["walk"]
    finals, dirs, plan, pairs = state
    B = len(pairs)
    n1s = np.asarray([len(a) for a, _ in pairs], np.int32)
    n2s = np.asarray([len(b) for _, b in pairs], np.int32)
    fin = finals[:B].cpu().numpy()
    bs = np.arange(B)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    seeds = [put(n2s), put(n1s), put(walk.seed_planes(fin)),
             put(bs // plan.np_slots), put((bs % plan.np_slots) * plan.s)]
    a = (dirs, *seeds, plan.l1 + plan.l2)
    got, main = staged_walk(
        torch, lambda slow=None: walk.walk_fast4_cuda(*a, slow=slow),
        lambda: walk.walk_fast4_torch(*a), "walk_fast4", seeds, 3)
    err = main["err"]
    check(err == 0, f"walk kernel != plain: err {err}")
    ops = walk.decode_packed_ops(got[2].cpu().numpy(), n1s, n2s)
    host = native.fast4_first_path_batch_native(
        dirs.cpu().numpy(), fin, bs // plan.np_slots,
        (bs % plan.np_slots) * plan.s, n1s, n2s,
    )
    check(host is not None, "native host walker unavailable")
    bad = sum(o is None or o != h for o, h in zip(ops, host))
    check(bad == 0, f"walk kernel != native host walker on {bad} pairs")
    log(f"[4 walk] {B} pairs: kernel {main['ms']:.3f} ms "
        f"({main['ns_per_step']:.1f} ns a step of the longest walk, "
        f"{main['steps']} steps; "
        f"{main['slow_reads']} slow-path words, {main['restagings']} "
        f"restagings), plain "
        f"{main['plain_ms']:.1f} ms, bound {main['bound_ms']:.4f} ms "
        f"({main['bound_by']}); equal to the plain walk and to the native "
        "host walker")
    # One pair (a CLI or --serve request's walk), its own streamed fill.
    fill = port["fill"]
    one = make_pairs(np.random.default_rng(4), 1, LEN_MAIN)
    b1 = pack_batch(one, batch_size=1)
    plan1, ins1 = fill.stream_inputs(*to_device(trim_for_stream(b1), "cuda"))
    fin1, dirs1 = fill.gotoh_fill_stream_cuda(*ins1, plan1, ScoringScheme(),
                                              True, False, "fast4")
    s1 = [put(b1.db_len), put(b1.query_len),
          put(walk.seed_planes(fin1[:1].cpu().numpy())), put([0]), put([0])]
    a1 = (dirs1, *s1, plan1.l1 + plan1.l2)
    _, one_pair = staged_walk(
        torch, lambda slow=None: walk.walk_fast4_cuda(*a1, slow=slow),
        lambda: walk.walk_fast4_torch(*a1), "walk_fast4", s1)
    check(one_pair["err"] == 0,
          f"walk kernel != plain on one pair: err {one_pair['err']}")
    log(f"[4 walk] 1 pair: kernel {one_pair['ms']:.3f} ms "
        f"({one_pair['ns_per_step']:.1f} ns a step, {one_pair['steps']} "
        f"steps; {one_pair['slow_reads']} slow-path words, "
        f"{one_pair['restagings']} restagings), plain "
        f"{one_pair['plain_ms']:.1f} ms; equal to the plain walk")
    return {"walk_ms": main["ms"], "walk_plain_ms": main["plain_ms"],
            "walk_err": err, "walk_bound_ms": main["bound_ms"],
            "walk_bound_by": main["bound_by"],
            "walk_ns_per_step": main["ns_per_step"],
            "walk_slow": main["slow_reads"],
            "walk_restagings": main["restagings"],
            "walk_one_pair": one_pair}


def phase_main(torch, port, pairs, by_path):
    from sequencealigning_tpu_torch.config import AlignConfig, Algo
    from sequencealigning_tpu_torch.io.fasta import Record
    from sequencealigning_tpu_torch.ops import oracle_gotoh

    recs = [(Record(seq=a, name=b">q%d" % i), Record(seq=b, name=b">d%d" % i))
            for i, (a, b) in enumerate(pairs)]
    aligner = port["models"].GotohAligner(
        AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True), "cuda"
    )
    torch.cuda.reset_peak_memory_stats()
    path = "global first-only"
    with path_launches(port, by_path, path):
        t0 = time.perf_counter()
        res = aligner.align_batch(recs)
        secs = time.perf_counter() - t0
    launches = {k: v[path] for k, v in by_path.items() if path in v}
    peak = torch.cuda.max_memory_allocated()
    check(len(res) == len(pairs), "missing results")
    errors = [r.error for r in res if not r.ok]
    check(not errors, f"{len(errors)} pairs failed: {errors[:3]}")
    check(aligner.host_fallbacks == 0,
          f"{aligner.host_fallbacks} pairs re-walked on the host")
    for name in ("nw_affine_stream_fill", "walk_fast4"):
        check(launches.get(name, 0) > 0,
              f"the main path never launched {name}")
    for r, (a, b) in zip(res, pairs):
        check(r.aligned_query.replace("-", "").encode() == a
              and r.aligned_db.replace("-", "").encode() == b,
              f"alignment of {r.query_name} does not consume its sequences")
    for i in np.random.default_rng(1).choice(len(pairs), 4, replace=False):
        want = oracle_gotoh.gotoh_score(*pairs[i])
        check(res[i].score == want,
              f"pair {i}: score {res[i].score} != oracle {want}")
    log(f"[5 main] {len(pairs)} x {LEN_MAIN} bp first-only on cuda: "
        f"{secs:.3f} s, {len(pairs) / secs:.1f} alignments/s, peak "
        f"{peak / 2**30:.2f} GiB; launches {launches}; 4 sampled scores equal "
        "the oracle")
    return {"main_s": secs, "alignments_per_s": len(pairs) / secs,
            "peak_gib": peak / 2 ** 30}, (aligner, recs, res)


# Host stages of align_batch reported by the profile (cumulative seconds):
# the global first-only path and the textbook modes path.
STAGES = ("pack_batch", "trim_for_stream", "_stream_args_host",
          "_put_stream_args", "fill_walk_from_stream_args",
          "gotoh_fill_stream_cuda", "walk_fast4_cuda",
          "device_walk_fast4_finish", "decode_packed_alignments",
          "walk_decode_batch_native", "fill_derived", "align_batch")
MODES_STAGES = ("pack_batch", "to_device", "stream_inputs",
                "gotoh_fill_stream_modes_cuda", "modes_reduce",
                "modes_walk_device", "walk_modes_cuda",
                "decode_packed_alignments", "assemble_modes_alignments",
                "fill_derived", "align_batch")


def phase_profile(torch, aligner, recs, out_dir, name="global",
                  stages_of=STAGES, tag="[5 profile]"):
    """Where align_batch's time goes: one call under torch.profiler (the
    card's busy time) and one under cProfile (host stages); the tables go
    to out_dir when one is given, named after the path."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        aligner.align_batch(recs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    host = cProfile.Profile()
    host.enable()
    aligner.align_batch(recs)
    host.disable()
    stats = pstats.Stats(host)
    if out_dir:
        with open(os.path.join(out_dir, f"profile_device_{name}.txt"),
                  "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=30))
        with open(os.path.join(out_dir, f"profile_host_{name}.txt"), "w") as f:
            pstats.Stats(host, stream=f).sort_stats(
                "cumulative").print_stats(40)
    stages = {}
    for (_file, _line, fn), (_cc, _nc, _tt, ct, _callers) in stats.stats.items():
        if fn in stages_of:
            stages[fn] = max(stages.get(fn, 0.0), ct)
    log(f"{tag} {name} align_batch {wall_ms:.1f} ms under torch.profiler, "
        f"card busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); host "
        "stages (cProfile, s): " + ", ".join(
            f"{k} {stages[k]:.3f}" for k in stages_of if k in stages))
    return {f"{name}_profile_wall_ms": wall_ms,
            f"{name}_profile_busy_ms": busy_ms,
            f"{name}_host_stages_s": stages}


def skewed_pairs(rng, n, lo1, hi1, lo2, hi2, alphabet=b"ACGT"):
    """n random pairs with lengths lo1..hi1 and lo2..hi2; every third db a
    mutated slice of its query (a local hit)."""
    alpha = np.frombuffer(alphabet, np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo1, hi1 + 1)))
        s2 = rng.choice(alpha, int(rng.integers(lo2, hi2 + 1)))
        if i % 3 == 0 and len(s1) > 8:
            s2 = s1[3: 3 + min(len(s2), len(s1) - 3)].copy()
            s2[rng.integers(len(s2))] = rng.choice(alpha)
        pairs.append((s1.tobytes(), s2.tobytes()))
    return pairs


def pair_cells_check(torch, modes, got, want, n1s, n2s):
    """Kernel A's (bv, bd, dirs) against the plain version's: the largest
    difference of the argmax buffers, the reduced end cells and every cell
    of each pair's matrix (valid_cell_diff); whether the whole dirs tensor
    is equal; whether every byte outside the pairs' matrices is 0."""
    bk, dk_, dirs_k = got
    bp, dp_, dirs_p = want
    err = max(int((bk - bp).abs().max()), int((dk_ - dp_).abs().max()))
    for a, b in zip(modes.modes_reduce(bk, dk_), modes.modes_reduce(bp, dp_)):
        err = max(err, int((a - b).abs().max()))
    err = max(err, valid_cell_diff(torch, dirs_k, dirs_p,
                                   [(b, 0) for b in range(len(n1s))], n1s,
                                   n2s, "full"))
    whole = bool(torch.equal(dirs_k.view(torch.int32),
                             dirs_p.view(torch.int32)))
    zero = outside_zero(torch, dirs_k, n1s, n2s)
    return err, whole, zero


def phase_modes_fill(torch, port):
    """Kernels A (per-pair) and B (streamed) against their plain versions
    on ragged batches; A at 1, 4 and 31 pairs of the main length, local and
    semi-global, against its plain version and timed beside its bounds;
    A and B timed at 32, 64 and 128 pairs (their crossover)."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    modes, smodes, fill = port["modes"], port["smodes"], port["fill"]
    rng = np.random.default_rng(3)
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    err, whole, zero, runs = 0, True, True, 0
    # Kernel A: up to 31 pairs, lengths 1-2046, skewed both ways; the
    # default split and CTAs of 256 lanes.
    L, long_lo, short_hi = LEN_MAIN, LEN_MAIN * 3 // 4, LEN_MAIN // 10
    cases = [(skewed_pairs(rng, 31, 1, L, 1, L, b"ACGTN"), w, loc)
             for w in (False, True) for loc in (False, True)]
    cases += [(skewed_pairs(rng, 24, long_lo, L, 1, short_hi), False, loc)
              for loc in (False, True)]
    cases += [(skewed_pairs(rng, 24, 1, short_hi, long_lo, L), False, loc)
              for loc in (False, True)]
    for pairs, wildcard, local in cases:
        batch = pack_batch(pairs, batch_size=len(pairs))
        tb = to_device(batch, "cuda")
        args = (tb.query, modes.modes_layout(tb.db), tb.query_len, tb.db_len,
                tb.query.shape[1], tb.db.shape[1],
                wild if wildcard else ScoringScheme(), wildcard, local, True)
        want = modes.fill_modes_torch(*args)
        for cta in (0, 256):
            got = modes.modes_fill_cuda(*args, cta_lanes=cta)
            fill.check_stream_stalls(wait=True)
            e, w, z = pair_cells_check(torch, modes, got, want,
                                       batch.query_len, batch.db_len)
            check(e == 0 and (w or z), f"modes fill kernel != plain "
                  f"(local={local}, wildcard={wildcard}, {len(pairs)} pairs, "
                  f"CTA lanes {cta}): err {e}, whole dirs equal {w}, outside "
                  f"the matrices 0 {z}")
            err, whole, zero = max(err, e), whole and w, zero and z
            runs += 1
        del got, want
    log(f"[6 modes fill] per-pair kernel: {runs} ragged runs equal on "
        f"argmax buffers, end cells and valid cells (whole dirs equal: "
        f"{whole}; every byte outside the pairs' matrices 0: {zero})")
    out = {"mfill_err": err, "mfill_whole_dirs_equal": whole,
           "mfill_outside_zero": zero}
    # At 1, 4 and 31 pairs of the main length (the largest batch it
    # serves), local and semi-global: equal to the plain version, timed;
    # at 1 and 31 the modes walk on its dirs too.
    walk = port["walk"]
    shapes, walks = {}, {}
    for n in (1, 4, 31):
        pairs = make_pairs(np.random.default_rng(4), n, LEN_MAIN)
        batch = pack_batch(pairs, batch_size=n)
        tb = to_device(batch, "cuda")
        cells = int((tb.query_len.long() * tb.db_len.long()).sum())
        for local in (True, False):
            mode = "local" if local else "semi"
            args = (tb.query, modes.modes_layout(tb.db), tb.query_len,
                    tb.db_len, tb.query.shape[1], tb.db.shape[1],
                    ScoringScheme(), False, local, True)
            plain_ms, want = host_ms(torch,
                                     lambda: modes.fill_modes_torch(*args))
            got = modes.modes_fill_cuda(*args)
            fill.check_stream_stalls(wait=True)
            e, w, z = pair_cells_check(torch, modes, got, want,
                                       batch.query_len, batch.db_len)
            check(e == 0 and (w or z), f"modes fill kernel != plain at {n} x "
                  f"{LEN_MAIN} bp {mode}: err {e}")
            del want
            ms = cuda_ms(torch, lambda: modes.modes_fill_cuda(*args), 5)
            b_ms, b_by = bound(nbytes(*args[:4], *got), cells * OPS_PER_CELL[
                "local full" if local else "full"])
            launch = dict(modes.modes_fill_cuda.last_launch)
            if n in (1, 31):
                walks[f"{n}_{mode}"] = pair_modes_walk(torch, walk, modes,
                                                       got, tb, local)
            del got
            err, whole, zero = max(err, e), whole and w, zero and z
            shapes[f"{n}_{mode}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                err=e, whole_dirs_equal=w, outside_zero=z, launch=launch)
            log(f"[6 modes fill] per-pair kernel, {n} x {LEN_MAIN} bp {mode}: "
                f"{ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS), plain "
                f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{100 * b_ms / ms:.1f}%); {launch['ctas']} CTAs a pair of "
                f"{launch['threads']} threads x {launch['lanes_per_thread']} "
                f"lanes; equal (whole dirs equal: {w}; outside the matrices "
                f"0: {z})")
        torch.cuda.empty_cache()
    out["mwalk_pairs"] = walks
    main = shapes["31_local"]
    out.update(mfill_ms=main["ms"], mfill_plain_ms=main["plain_ms"],
               mfill_bound_ms=main["bound_ms"],
               mfill_bound_by=main["bound_by"],
               mfill_semi_ms=shapes["31_semi"]["ms"],
               mfill_semi_plain_ms=shapes["31_semi"]["plain_ms"],
               mfill_semi_bound_ms=shapes["31_semi"]["bound_ms"],
               mfill_semi_err=shapes["31_semi"]["err"], mfill_shapes=shapes,
               mfill_err=err, mfill_whole_dirs_equal=whole,
               mfill_outside_zero=zero)
    # Where the streamed fill (B) overtakes the per-pair one (A): both
    # timed at 32, 64 and 128 pairs (the aligner takes B from
    # GotohAligner.modes_stream_min_pairs = 32).
    cross = {}
    for n in (32, 64, 128):
        pairs = make_pairs(np.random.default_rng(8), n, LEN_MAIN)
        tb = to_device(pack_batch(pairs, batch_size=n), "cuda")
        plan, ins = fill.stream_inputs(*tb)
        for local in (True, False):
            mode = "local" if local else "semi"
            args = (tb.query, modes.modes_layout(tb.db), tb.query_len,
                    tb.db_len, tb.query.shape[1], tb.db.shape[1],
                    ScoringScheme(), False, local, True)
            a_ms = cuda_ms(torch, lambda: modes.modes_fill_cuda(*args), 3)
            sa = (plan, ScoringScheme(), False, mode, True)
            b_ms = cuda_ms(torch, lambda: smodes.gotoh_fill_stream_modes_cuda(
                *ins, *sa), 3)
            fill.check_stream_stalls(wait=True)
            cross[f"{n}_{mode}"] = dict(per_pair_ms=a_ms, streamed_ms=b_ms)
        torch.cuda.empty_cache()
    over = {mode: next((n for n in (32, 64, 128) if cross[f"{n}_{mode}"][
        "streamed_ms"] < cross[f"{n}_{mode}"]["per_pair_ms"]), None)
        for mode in ("local", "semi")}
    log("[6 modes fill] per-pair (A) against streamed (B) fill, ms: "
        + "; ".join(f"{k} A {v['per_pair_ms']:.3f} B {v['streamed_ms']:.3f}"
                    for k, v in cross.items())
        + "; B first faster at "
        + ", ".join(f"{m} {n if n else 'none of these'} pairs"
                    for m, n in over.items()))
    out.update(mfill_crossover=dict(times=cross, streamed_faster_from=over))

    # Kernel B: ragged batches with 2-4 slots a row, skewed both ways.
    err, whole, runs = 0, True, 0
    for np_slots, (lo1, hi1, lo2, hi2) in ((4, (1, 300, 1, 300)),
                                           (2, (200, 400, 1, 60)),
                                           (3, (1, 60, 200, 400))):
        pairs = skewed_pairs(rng, 48, lo1, hi1, lo2, hi2, b"ACGTN")
        batch = pack_batch(pairs, batch_size=48)
        tb = to_device(batch, "cuda")
        plan, ins = fill.stream_inputs(*tb, np_slots=np_slots)
        for wildcard in (False, True):
            for mode in ("semi", "local"):
                args = (plan, wild if wildcard else ScoringScheme(),
                        wildcard, mode, True)
                (bk, dk_), dirs_k = smodes.gotoh_fill_stream_modes_cuda(
                    *ins, *args)
                (bp, dp_), dirs_p = smodes.gotoh_fill_stream_modes_torch(
                    *ins, *args)
                torch.cuda.synchronize()
                e = max(int((bk - bp).abs().max()),
                        int((dk_ - dp_).abs().max()))
                e = max(e, valid_cell_diff(
                    torch, dirs_k, dirs_p, stream_coords(plan, 48),
                    batch.query_len, batch.db_len, "full"))
                whole &= bool(torch.equal(dirs_k.view(torch.int32),
                                          dirs_p.view(torch.int32)))
                check(e == 0, f"stream modes kernel != plain ({mode}, "
                      f"wildcard={wildcard}, np_slots={np_slots}): err {e}")
                err, runs = max(err, e), runs + 1
    log(f"[6 modes fill] streamed kernel: {runs} ragged batches (2-4 slots "
        f"a row) equal on argmax buffers and valid cells (whole dirs equal: "
        f"{whole})")
    out.update(sfill_ragged_err=err, sfill_ragged_whole_dirs_equal=whole)
    return out


def pair_modes_walk(torch, walk, modes, got, tb, local):
    """The modes walk kernel on kernel #6's per-pair dirs (row b, offset 0)
    from each pair's end cell, against its plain version: staged_walk's
    dict.  Every walk must stop cleanly."""
    bv, bd, dirs = got
    _, x, y = modes.modes_reduce(bv, bd)
    n = len(tb.query_len)
    seeds = [x.contiguous(), y.contiguous(),
             torch.arange(n, dtype=torch.int32, device="cuda"),
             torch.zeros(n, dtype=torch.int32, device="cuda")]
    a = (dirs, *seeds, local, tb.query.shape[1] + tb.db.shape[1])
    res, st_ = staged_walk(
        torch, lambda slow=None: walk.walk_modes_cuda(*a, slow=slow),
        lambda: walk.walk_modes_torch(*a), "walk_modes", seeds)
    mode = "local" if local else "semi"
    check(st_["err"] == 0, f"modes walk kernel != plain on {n} pairs' "
          f"per-pair dirs ({mode}): err {st_['err']}")
    check(bool((res[2] == 1).all()), f"modes walk kernel ({mode}, {n} "
          "pairs): a walk did not stop cleanly")
    log(f"[6 modes fill] modes walk on the per-pair dirs, {n} x {LEN_MAIN} "
        f"bp {mode}: kernel {st_['ms']:.3f} ms ({st_['ns_per_step']:.1f} ns "
        f"a step, {st_['steps']} steps; {st_['slow_reads']} slow-path "
        f"words, {st_['restagings']} "
        f"restagings), plain "
        f"{st_['plain_ms']:.1f} ms, bound {st_['bound_ms']:.4f} ms "
        f"({st_['bound_by']}); equal to the plain walk")
    return st_


def phase_modes_full(torch, port, mode, pairs):
    """Kernel B against its plain version at the main shape in one mode
    ("local" or "semi"), then kernel C against the plain walk on B's dirs
    and against the host walker on sampled pairs.  Frees its tensors."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops.traceback import (
        local_affine_traceback_pair,
        semi_global_traceback_pair,
    )

    modes, smodes = port["modes"], port["smodes"]
    fill, walk = port["fill"], port["walk"]
    local = mode == "local"
    batch = pack_batch(pairs, batch_size=N_MAIN)
    tb = to_device(batch, "cuda")
    plan, ins = fill.stream_inputs(*tb)
    args = (plan, ScoringScheme(), False, mode, True)
    ms = cuda_ms(torch, lambda: smodes.gotoh_fill_stream_modes_cuda(*ins, *args))
    (bk, dk_), dirs = smodes.gotoh_fill_stream_modes_cuda(*ins, *args)
    fill.check_stream_stalls(wait=True)
    plain_ms, ((bp, dp_), dirs_p) = host_ms(
        torch, lambda: smodes.gotoh_fill_stream_modes_torch(*ins, *args))
    err = max(int((bk - bp).abs().max()), int((dk_ - dp_).abs().max()))
    whole = bool(torch.equal(dirs.view(torch.int32), dirs_p.view(torch.int32)))
    if not whole:
        err = max(err, valid_cell_diff(torch, dirs, dirs_p,
                                       stream_coords(plan, N_MAIN),
                                       batch.query_len, batch.db_len, "full"))
    del dirs_p, bp, dp_
    check(err == 0, f"stream modes kernel != plain at the main shape "
          f"({mode}): err {err}")
    P = plan.p
    flat = bk.transpose(0, 1).reshape(-1, P)
    best, x, y = modes.modes_reduce(flat, dk_.transpose(0, 1).reshape(-1, P))
    # torch.argmax's first-maximum rule, checked on the card.
    lanes = torch.arange(P, device=flat.device).expand_as(flat)
    first = torch.where(flat == best[:, None].to(flat.dtype), lanes, P).min(1)
    check(bool(torch.equal(first.values.to(torch.int32), x)),
          "torch.argmax did not return the first maximal lane")
    cells = int((batch.query_len.astype(np.int64)
                 * batch.db_len.astype(np.int64)).sum())
    b_ms, b_by = bound(nbytes(*ins, bk, dk_, dirs),
                       cells * OPS_PER_CELL[
                           "local full" if local else "full"])
    log(f"[7 modes full] {N_MAIN} x {LEN_MAIN} bp {mode} fill "
        f"(R={plan.n_rows}, P={plan.p}, S={plan.s}, T={plan.t_total}, dirs "
        f"{dirs.numel() * 4 / 1e9:.1f} GB): kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, {cells / ms / 1e6:.2f} GCUPS, bound "
        f"{b_ms:.3f} ms ({b_by}); equal on argmax buffers and end cells "
        f"(whole dirs tensor equal: {whole})")
    out = {f"sfill_{mode}_ms": ms, f"sfill_{mode}_plain_ms": plain_ms,
           f"sfill_{mode}_launch": dict(
               smodes.gotoh_fill_stream_modes_cuda.last_launch),
           f"sfill_{mode}_err": err, f"sfill_{mode}_gcups": cells / ms / 1e6,
           f"sfill_{mode}_whole_dirs_equal": whole,
           f"sfill_{mode}_bound_ms": b_ms, f"sfill_{mode}_bound_by": b_by}

    best, end_x, end_y = (t[:N_MAIN].cpu().numpy() for t in (best, x, y))
    del bk, dk_, flat, lanes, first, x, y
    bs = np.arange(N_MAIN)
    rowp, off = bs // plan.np_slots, (bs % plan.np_slots) * plan.s

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    seeds = [put(end_x), put(end_y), put(rowp), put(off)]
    a = (dirs, *seeds, local, plan.l1 + plan.l2)
    got, st_ = staged_walk(
        torch, lambda slow=None: walk.walk_modes_cuda(*a, slow=slow),
        lambda: walk.walk_modes_torch(*a), "walk_modes", seeds, 3)
    ms, plain_ms, err = st_["ms"], st_["plain_ms"], st_["err"]
    check(err == 0, f"modes walk kernel != plain ({mode}): err {err}")
    xf, yf, st, packed, n_ops = got
    check(bool((st == 1).all()), f"modes walk kernel ({mode}): a walk did "
          "not stop cleanly")
    n_words = -(-int(n_ops.max()) // 16)
    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    walked = walk.decode_modes_walk(
        packed[:, :n_words].cpu().numpy(), xf.cpu().numpy(),
        yf.cpu().numpy(), st.cpu().numpy(), end_x, end_y, s1s, s2s)
    check(all(w is not None for w in walked),
          f"modes walk did not decode ({mode})")
    alns = walk.assemble_modes_alignments(pairs, walked, best, end_x, end_y,
                                          local)
    sample = np.random.default_rng(5).choice(N_MAIN, 6, replace=False)
    for b in sample:
        dirs_b = dirs[:, int(rowp[b]), :].cpu().numpy()
        host_walk = (local_affine_traceback_pair if local
                     else semi_global_traceback_pair)
        a1, a2 = host_walk(dirs_b, int(end_x[b]), int(end_y[b]), *pairs[b],
                           d_offset=int(off[b]))[:2]
        check(alns[b] == (int(best[b]), [(a1, a2)]),
              f"modes walk kernel != host walker on pair {b} ({mode})")
    b_ms, b_by = st_["bound_ms"], st_["bound_by"]
    log(f"[7 modes full] {N_MAIN} pairs {mode} walk: kernel {ms:.3f} ms "
        f"({st_['ns_per_step']:.1f} ns a step of the longest walk, "
        f"{st_['steps']} steps; "
        f"{st_['slow_reads']} slow-path words, {st_['restagings']} "
        f"restagings), plain {plain_ms:.1f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); equal to the plain walk, "
        f"{len(sample)} sampled pairs equal to the host walker")
    out.update({f"mwalk_{mode}_ms": ms, f"mwalk_{mode}_plain_ms": plain_ms,
                f"mwalk_{mode}_err": err, f"mwalk_{mode}_bound_ms": b_ms,
                f"mwalk_{mode}_bound_by": b_by,
                f"mwalk_{mode}_ns_per_step": st_["ns_per_step"],
                f"mwalk_{mode}_slow": st_["slow_reads"],
                f"mwalk_{mode}_restagings": st_["restagings"]})
    del dirs, got, packed, seeds, ins, tb, a
    torch.cuda.empty_cache()
    return out


def affine_score(a1, a2, scheme, semi, compat=False):
    """Affine score of one alignment (gaps open from M only); semi drops
    the leading and trailing columns that hold a gap (free end gaps);
    compat adds the reference's extra extension on a leading gap chain
    (needleman_wunsch_affine.rs:195,207)."""
    s1 = np.frombuffer(a1.encode(), np.uint8)
    s2 = np.frombuffer(a2.encode(), np.uint8)
    gap = ord("-")
    kind = np.where(s1 == gap, 2, np.where(s2 == gap, 1, 0))
    if semi:
        pure = np.flatnonzero(kind == 0)
        if not len(pure):
            return 0
        kind = kind[pure[0]: pure[-1] + 1]
        s1, s2 = s1[pure[0]: pure[-1] + 1], s2[pure[0]: pure[-1] + 1]
    prev = np.concatenate([[0], kind[:-1]])
    m = kind == 0
    score = np.where(s1[m] == s2[m], scheme.match_, scheme.mismatch).sum()
    opens = int(((kind != 0) & (kind != prev)).sum())
    quirk = scheme.gap_extend if compat and len(kind) and kind[0] else 0
    return int(score + opens * scheme.gap_open
               + int((kind != 0).sum()) * scheme.gap_extend + quirk)


def records(pairs):
    from sequencealigning_tpu_torch.io.fasta import Record

    return [(Record(seq=a, name=b">q%d" % i), Record(seq=b, name=b">d%d" % i))
            for i, (a, b) in enumerate(pairs)]


def check_results(res, pairs, scheme, label, compat=False, semi=False,
                  consume=True):
    """Every pair aligned, consuming its sequences, and rescoring to its
    score."""
    check(len(res) == len(pairs), f"{label}: missing results")
    errors = [r.error for r in res if not r.ok]
    check(not errors, f"{label}: {len(errors)} pairs failed: {errors[:3]}")
    bad = [i for i, r in enumerate(res)
           if affine_score(r.aligned_query, r.aligned_db, scheme, semi,
                           compat) != r.score]
    check(not bad, f"{label}: {len(bad)} alignments do not rescore to their "
          f"score (first: pair {bad[:1]})")
    if consume:
        for r, (a, b) in zip(res, pairs):
            check(r.aligned_query.replace("-", "").encode() == a
                  and r.aligned_db.replace("-", "").encode() == b,
                  f"{label}: alignment of {r.query_name} does not consume "
                  "its sequences")


def phase_modes_main(torch, port, pairs, out_dir, by_path):
    """GotohAligner textbook local, then semi-global, through align_batch
    at the main shape: the streamed modes fill and the modes walk; then one
    more local align_batch under the profilers."""
    from sequencealigning_tpu_torch.config import AlignConfig, Algo, Mode

    recs = records(pairs)
    meas = {}
    for mode in (Mode.LOCAL, Mode.SEMI_GLOBAL):
        cfg = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=mode, compat=False)
        aligner = port["models"].GotohAligner(cfg, "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        path = f"textbook {mode.value}"
        with path_launches(port, by_path, path):
            t0 = time.perf_counter()
            res = aligner.align_batch(recs)
            secs = time.perf_counter() - t0
        n_fill = by_path.get("nw_affine_stream_modes_fill", {}).get(path, 0)
        n_walk = by_path.get("walk_modes", {}).get(path, 0)
        peak = torch.cuda.max_memory_allocated()
        semi = mode is Mode.SEMI_GLOBAL
        check_results(res, pairs, cfg.scoring, mode.value, semi=semi,
                      consume=semi)
        check(n_fill > 0 and n_walk > 0,
              f"{mode.value}: the main path launched the streamed modes fill "
              f"{n_fill} and the modes walk {n_walk} times")
        key = "local" if mode is Mode.LOCAL else "semi"
        meas.update({f"{key}_main_s": secs,
                     f"{key}_alignments_per_s": len(pairs) / secs,
                     f"{key}_peak_gib": peak / 2 ** 30})
        log(f"[8 modes main] {len(pairs)} x {LEN_MAIN} bp textbook "
            f"{mode.value} on cuda: {secs:.3f} s, {len(pairs) / secs:.1f} "
            f"alignments/s, peak {peak / 2**30:.2f} GiB; launches: streamed "
            f"fill {n_fill}, walk {n_walk}; every alignment rescores to its "
            "score")
        del res
        if mode is Mode.LOCAL:
            meas.update(phase_profile(torch, aligner, recs, out_dir, "local",
                                      MODES_STAGES, "[8 profile]"))
        del aligner
    return meas


GOLDEN = os.path.join(ROOT, "tests", "golden")


def run_golden(port, name, extra):
    """The port's CLI on the golden corpus with --device cuda and extra
    flags: its stdout must equal tests/golden/<name>.out's (timing lines
    normalised).  Returns its stderr."""
    spec = importlib.util.spec_from_file_location(
        "golden_regen", os.path.join(GOLDEN, "regen.py"))
    regen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(regen)
    q, d = os.path.join(GOLDEN, "queries.fa"), os.path.join(GOLDEN, "db.fa")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port["cli"].main(["-q", q, "-d", d, "--no-out", "--device",
                               "cuda"] + extra)
    with open(os.path.join(GOLDEN, f"{name}.out")) as f:
        want = f.read()
    want_out = want.split("# --- stdout ---\n", 1)[1].split(
        "# --- stderr ---\n", 1)[0]
    check(rc == 0, f"cli exit {rc} ({name} {extra})")
    check(regen.normalize(out.getvalue()) == want_out,
          f"cli stdout differs from tests/golden/{name}.out ({extra})")
    return err.getvalue()


def phase_cli(torch, port, by_path):
    """The golden CLI outputs with --device cuda, and serve.  The textbook
    modes runs (24 pairs, under the streamed engine's 32) are the per-pair
    modes kernel's path."""
    q, d = os.path.join(GOLDEN, "queries.fa"), os.path.join(GOLDEN, "db.fa")
    main = port["cli"].main

    def run_cli(name, extra):
        run_golden(port, name, extra)

    def serve(args):
        stdin = sys.stdin
        sys.stdin = io.StringIO(f"{q} {d}\n")
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = main(["--serve", "--device", "cuda"] + args)
        finally:
            sys.stdin = stdin
        lines = [json.loads(s) for s in out.getvalue().splitlines()]
        pairs = [x for x in lines if "query_name" in x]
        check(rc == 0 and len(pairs) == 24 and all(p["error"] is None
                                                   for p in pairs),
              f"serve {args} did not answer the 24 pairs")
        check(lines[-1].get("done") and lines[-1].get("pairs") == 24,
              "serve summary line missing")

    nw = ["-a", "needleman-wunsch"]
    path = "golden CLI and serve (24 pairs a run)"
    with path_launches(port, by_path, path):
        for name, extra in (("nw-first-only", nw + ["--first-only"]),
                            ("needleman-wunsch", nw),
                            ("nw-local-textbook",
                             nw + ["-m", "local", "--textbook"]),
                            ("nw-semiglobal-textbook",
                             nw + ["-m", "semi-global", "--textbook"]),
                            ("banded", ["-a", "banded"]),
                            ("a-star", []),
                            ("nw-linear", ["-a", "nw-linear"]),
                            ("nw-linear-local",
                             ["-a", "nw-linear", "-m", "local"])):
            run_cli(name, extra)
        for args in (nw + ["--first-only"], nw + ["-m", "local", "--textbook"],
                     ["-a", "banded", "--band", "64"]):
            serve(args)
    launches = {k: v[path] for k, v in by_path.items() if path in v}
    for name in ("nw_affine_modes_fill", "walk_modes",
                 "nw_banded_diag_fill", "nw_linear_fill"):
        check(launches.get(name, 0) > 0,
              f"the golden CLI path never launched {name}")
    log("[9 cli] golden nw-first-only, needleman-wunsch, nw-local-textbook, "
        "nw-semiglobal-textbook, banded, a-star (the default -a), nw-linear "
        "and nw-linear-local stdout equal on cuda; serve "
        "(first-only, textbook local, banded --band 64) answered 24 pairs "
        f"each; launches {launches}")


def phase_banded_fill(torch, port, pairs):
    """The banded fill kernel against its plain version at config 4's shape
    (fast4 and full: finals and the whole dirs tensor), then on small
    ragged and skewed batches over compat/textbook x wildcard x dirs and
    the std model."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    banded = port["banded"]
    std_scheme = ScoringScheme(match_=0, mismatch=-9, gap_open=-2,
                               gap_extend=-3)
    rng = np.random.default_rng(6)
    err, runs = 0, 0
    for band, (lo1, hi1, lo2, hi2) in ((16, (1, 300, 1, 300)),
                                       (48, (200, 400, 20, 150)),
                                       (8, (10, 120, 150, 300))):
        pairs_r = skewed_pairs(rng, 40, lo1, hi1, lo2, hi2, b"ACGTN")
        tb = to_device(pack_batch(pairs_r, batch_size=40), "cuda")
        plan, ins = banded.band_inputs(*tb, band)
        for model, compat, wildcard, dirs in (
                ("ref", True, True, "fast4"), ("ref", True, False, "full"),
                ("ref", False, True, "full"), ("ref", False, False, False),
                ("std", False, True, "fast4"), ("std", False, False, False)):
            scheme = std_scheme if model == "std" else ScoringScheme()
            a = (plan, scheme, compat, wildcard, dirs, model)
            fk, dk = banded.banded_diag_fill_cuda(*ins, *a)
            fp, dp = banded.banded_diag_fill_torch(*ins, *a)
            torch.cuda.synchronize()
            e = int((fk - fp).abs().max())
            if dirs:
                e = max(e, 0 if torch.equal(dk.view(torch.int32),
                                            dp.view(torch.int32)) else 1)
            check(e == 0, f"banded fill kernel != plain (band {band}, "
                  f"{model}, compat={compat}, wildcard={wildcard}, "
                  f"dirs={dirs}): err {e}")
            err, runs = max(err, e), runs + 1
    # Wide bands: 8 pairs cut into strips of 128-448 lanes in blocks of 32
    # iterations (the tile rule's), and forced strips of 64 lanes in blocks
    # of 8 (the last block shorter).
    shapes = []
    for band, cases in ((1400, (("ref", True, True, "fast4"),)),
                        (3000, (("ref", True, True, "fast4"),)),
                        (4200, (("ref", True, True, "fast4"),
                                ("ref", False, False, "full")))):
        pairs_r = skewed_pairs(rng, 8, 200, 700, 200, 700)
        tb = to_device(pack_batch(pairs_r, batch_size=8), "cuda")
        plan, ins = banded.band_inputs(*tb, band)
        for model, compat, wildcard, dirs in cases:
            a = (plan, ScoringScheme(), compat, wildcard, dirs, model)
            fp, dp = banded.banded_diag_fill_torch(*ins, *a)
            for kw in ({}, dict(strip_lanes=64, block_iters=8)):
                fk, dk = banded.banded_diag_fill_cuda(*ins, *a, **kw)
                e = int((fk - fp).abs().max())
                e = max(e, 0 if torch.equal(dk.view(torch.int32),
                                            dp.view(torch.int32)) else 1)
                check(e == 0, f"banded fill kernel != plain (band {band}, "
                      f"L={plan.L}, compat={compat}, dirs={dirs}, {kw}): "
                      f"err {e}")
                err, runs = max(err, e), runs + 1
                shape = banded.banded_diag_fill_cuda.last_launch
                shapes.append(f"L={plan.L}: {shape['strips']} x "
                              f"{shape['strip_lanes']} lanes, T "
                              f"{shape['block_iters']}")
    log(f"[10 banded fill] {runs} ragged/skewed configurations (bands 8-4200;"
        f" {'; '.join(shapes[::2])}; forced {shapes[1]}, ...) equal on "
        "finals and the whole dirs tensor")
    out_stall = stall_check(torch, port)

    batch = pack_batch(pairs, batch_size=len(pairs))
    tb = to_device(batch, "cuda")
    plan, ins = banded.band_inputs(*tb, BAND)
    lane_steps = len(pairs) * 2 * plan.n_need * plan.L
    band_cells = int(batch.db_len.astype(np.int64).sum()) * (
        plan.k_hi_eff - plan.k_lo + 1)
    out = {"bfill_ragged_err": err}
    for dirs in ("fast4", "full"):
        a = (plan, ScoringScheme(), True, True, dirs)
        ms = cuda_ms(torch, lambda: banded.banded_diag_fill_cuda(*ins, *a))
        fk, dk = banded.banded_diag_fill_cuda(*ins, *a)
        plain_ms, (fp, dp) = host_ms(
            torch, lambda: banded.banded_diag_fill_torch(*ins, *a))
        e = int((fk - fp).abs().max())
        whole = bool(torch.equal(dk.view(torch.int32), dp.view(torch.int32)))
        e = max(e, 0 if whole else 1)
        b_ms, b_by = bound(nbytes(*ins, fk, dk),
                           band_cells * OPS_PER_CELL[dirs])
        check(e == 0, f"banded fill kernel != plain at config 4 ({dirs})")
        shape4 = dict(banded.banded_diag_fill_cuda.last_launch)
        if dirs == "fast4":
            # The same band forced into narrow strips: 2 strips of 128
            # lanes in blocks of 32 iterations, and 4 of 64 lanes in blocks
            # of 8, against the plain dirs just computed.
            for tag, kw in (("strips128", dict(strip_lanes=128)),
                            ("strips64", dict(strip_lanes=64,
                                              block_iters=8))):
                t_ms = cuda_ms(torch, lambda: banded.banded_diag_fill_cuda(
                    *ins, *a, **kw), repeats=1)
                fs, ds = banded.banded_diag_fill_cuda(*ins, *a, **kw)
                shape = banded.banded_diag_fill_cuda.last_launch
                t_err = max(int((fs - fp).abs().max()), 0 if torch.equal(
                    ds.view(torch.int32), dp.view(torch.int32)) else 1)
                del fs, ds
                check(t_err == 0, f"banded fill in forced tiles {kw} != "
                      f"plain at config 4: err {t_err}")
                log(f"[10 banded fill] config 4's band (L={plan.L}) forced "
                    f"into {shape['strips']} strips of "
                    f"{shape['strip_lanes']} lanes x {shape['rows']} blocks "
                    f"of {shape['block_iters']} iterations "
                    f"({shape['tiles']} tiles): {t_ms:.3f} ms; finals and "
                    "the whole dirs tensor equal the plain version")
                out.update({f"bfill_{tag}_ms": t_ms,
                            f"bfill_{tag}_err": t_err})
        del fp, dp
        log(f"[10 banded fill] {len(pairs)} x {LEN_BAND} bp band {BAND} "
            f"{dirs} (L={plan.L}, k_lo_even={plan.k_lo_even}, "
            f"n_iters={plan.n_need}, dirs {dk.numel() * 4 / 1e9:.2f} GB; "
            f"{tile_line(shape4)}): "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, band "
            f"{band_cells / ms / 1e6:.2f} GCUPS, lane-step "
            f"{lane_steps / ms / 1e6:.2f} GCUPS, bound {b_ms:.3f} ms "
            f"({b_by}); finals and the whole dirs tensor equal")
        out.update({f"bfill_{dirs}_ms": ms, f"bfill_{dirs}_plain_ms": plain_ms,
                    f"bfill_{dirs}_err": e,
                    f"bfill_{dirs}_band_gcups": band_cells / ms / 1e6,
                    f"bfill_{dirs}_lane_gcups": lane_steps / ms / 1e6,
                    f"bfill_{dirs}_bound_ms": b_ms,
                    f"bfill_{dirs}_bound_by": b_by})
        if dirs == "fast4":
            state = (fk, dk, plan)
        del dk
    out.update(band_cells=band_cells, band_lane_steps=lane_steps,
               bfill_shape=shape4, **out_stall)
    return out, state


def tile_line(shape):
    """A banded launch's tiles (the wrapper's last_launch), for the log."""
    return (f"{shape['strips']} strips of {shape['strip_lanes']} lanes a "
            f"pair x {shape['rows']} blocks of {shape['block_iters']} "
            f"iterations, halo {shape['halo']}, {shape['lanes_per_thread']} "
            f"lanes a thread x {shape['threads']}, {shape['tiles']} tiles, "
            f"grid {shape['ctas']} of {shape['resident']} resident, "
            f"{shape['sms']} SMs")


def stall_check(torch, port):
    """A schedule whose waits cannot be met (the banded fill's tickets
    reversed, one CTA) must raise, not hang: the seconds it took."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    banded = port["banded"]
    lib = port["csrc"].kernels()
    real = banded.band_tiles, lib.sa_banded_resident_ctas
    tb = to_device(pack_batch([(b"ACGT" * 60, b"ACGT" * 61)]), "cuda")
    plan, ins = banded.band_inputs(*tb, 200)
    banded.band_tiles = lambda *a: real[0](*a)._replace(order=1)
    lib.sa_banded_resident_ctas = lambda *a: 1
    t0 = time.perf_counter()
    raised = None
    try:
        banded.banded_diag_fill_cuda(*ins, plan, ScoringScheme(), True, False,
                                     "fast4", strip_lanes=128, block_iters=8)
    except RuntimeError as e:
        raised = str(e)
    finally:
        banded.band_tiles = real[0]
        lib.sa_banded_resident_ctas = real[1]
    secs = time.perf_counter() - t0
    check(raised is not None and "spin limit" in raised,
          f"an impossible banded schedule did not raise: {raised}")
    log(f"[10 banded fill] an impossible schedule (tickets reversed, one CTA)"
        f" raised after {secs:.2f} s: {raised}")
    return {"bfill_stall_s": secs}


def banded_walk_slow_path(torch, port):
    """The banded walk's slow path: 40 random ragged pairs (their walks
    cross band lanes) filled at band 16 and walked with a window of one
    lane, so most reads load directly; held against the plain walk.
    Returns (slow reads, reads, err)."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    walk, banded = port["walk"], port["banded"]
    pairs = ragged_pairs(np.random.default_rng(9), 40)
    tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
    plan, ins = banded.band_inputs(*tb, 16)
    finals, dirs = banded.banded_diag_fill_cuda(
        *ins, plan, ScoringScheme(), True, True, "fast4")
    seeds = [tb.db_len, tb.query_len,
             torch.from_numpy(walk.seed_planes(finals.cpu().numpy())).to(
                 device="cuda", dtype=torch.int32),
             torch.arange(len(pairs), dtype=torch.int32, device="cuda")]
    a = (plan.k_lo_even, int((tb.query_len + tb.db_len).max()))
    slow = torch.zeros(1, dtype=torch.int64, device="cuda")
    with walk.forced_walk(window=1):
        got = walk.walk_banded_cuda(dirs, *seeds, *a, slow=slow)
    err = walk_diff(torch, got, walk.walk_banded_torch(dirs, *seeds, *a))
    check(err == 0, f"banded walk kernel with a one-lane window != plain: "
          f"err {err}")
    check(int(slow) > 0, "the banded walk's slow path was not taken")
    return int(slow), int(got[3].sum()), err


def phase_banded_walk(torch, port, pairs, state):
    """The banded walk kernel against its plain version on config 4's fast4
    dirs, and against the host walker on sampled pairs."""
    from sequencealigning_tpu_torch.ops.traceback import (
        banded_diag_fast4_traceback_pair,
    )

    walk = port["walk"]
    finals, dirs, plan = state
    B = len(pairs)
    fin = finals.cpu().numpy()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    n1s = np.asarray([len(a) for a, _ in pairs], np.int32)
    n2s = np.asarray([len(b) for _, b in pairs], np.int32)
    seeds = [put(n2s), put(n1s), put(walk.seed_planes(fin)),
             put(np.arange(B))]
    t_steps = int((n1s + n2s).max())
    a = (plan.k_lo_even, t_steps)
    ms = cuda_ms(torch, lambda: walk.walk_banded_cuda(dirs, *seeds, *a))
    slow = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = walk.walk_banded_cuda(dirs, *seeds, *a, slow=slow)
    plain_ms, want = host_ms(
        torch, lambda: walk.walk_banded_torch(dirs, *seeds, *a))
    err = walk_diff(torch, got, want)
    check(err == 0, f"banded walk kernel != plain: err {err}")
    forced_slow, forced_steps, forced_err = banded_walk_slow_path(torch,
                                                                  port)
    err = max(err, forced_err)
    steps = int(got[3].sum())
    ns_step = ms * 1e6 / int(got[3].max())
    check(bool(((got[0] == 0) & (got[1] == 0)).all()),
          "a banded walk did not reach the origin")
    alns = walk.decode_packed_alignments(
        got[2][:, : -(-int(got[3].max()) // 16)].cpu().numpy(),
        [p[0] for p in pairs], [p[1] for p in pairs])
    sample = np.random.default_rng(7).choice(B, 6, replace=False)
    for b in sample:
        _, want_aln = banded_diag_fast4_traceback_pair(
            dirs[:, int(b), :].cpu().numpy(), fin[b], *pairs[b],
            plan.k_lo_even)
        check(alns[b] == want_aln[0],
              f"banded walk kernel != host walker on pair {b}")
    b_ms, b_by = walk_bound("walk_banded", got, seeds)
    log(f"[11 banded walk] {B} pairs: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); {ns_step:.1f} ns "
        f"a step of the longest walk; {int(slow)} words read outside the "
        f"staged window (the slow path) in {steps} steps; equal to the plain "
        f"walk, {len(sample)} sampled pairs equal to the host walker; ragged "
        f"pairs at band 16 with a one-lane window: {forced_slow} slow-path "
        f"words in {forced_steps} steps, equal to the plain walk")
    return {"bwalk_ms": ms, "bwalk_plain_ms": plain_ms, "bwalk_err": err,
            "bwalk_bound_ms": b_ms, "bwalk_bound_by": b_by,
            "bwalk_ns_per_step": ns_step, "bwalk_slow": int(slow),
            "bwalk_steps": steps, "bwalk_forced_slow": forced_slow}


def phase_banded_main(torch, port, pairs, by_path):
    """BandedAligner on cuda through align_batch: first-only over config
    4's pairs, then the default full-dirs path over N_BAND_FULL of them."""
    from sequencealigning_tpu_torch.config import AlignConfig, Algo

    meas = {}
    for first_only, sub in ((True, pairs), (False, pairs[:N_BAND_FULL])):
        cfg = AlignConfig(algo=Algo.BANDED, band=BAND, first_only=first_only)
        aligner = port["models"].BandedAligner(cfg, "cuda")
        recs = records(sub)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        path = "banded first-only" if first_only else "banded co-optimal"
        with path_launches(port, by_path, path):
            t0 = time.perf_counter()
            res = aligner.align_batch(recs)
            secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v[path] for k, v in by_path.items() if path in v}
        check_results(res, sub, cfg.scoring, path, compat=True)
        want = ["nw_banded_diag_fill"] + (["walk_banded"] if first_only
                                          else [])
        for name in want:
            check(launches.get(name, 0) > 0, f"{path} never launched {name}")
        key = "banded_first_only" if first_only else "banded_full"
        meas.update({f"{key}_s": secs,
                     f"{key}_alignments_per_s": len(sub) / secs,
                     f"{key}_peak_gib": peak / 2 ** 30})
        log(f"[12 banded main] {len(sub)} x {LEN_BAND} bp {path} on cuda: "
            f"{secs:.3f} s, {len(sub) / secs:.1f} alignments/s, peak "
            f"{peak / 2**30:.2f} GiB; launches {launches}; every alignment "
            "consumes its sequences and rescores to its score")
        del res, aligner
    return meas


def phase_ceiling(torch, port, by_path):
    """Past the one-block ceiling of 8192 lanes: the streamed global (fast4)
    and modes fills and the per-pair modes fill at a ~8.3 kb db against
    their plain versions; then one ~49 kb global pair through
    GotohAligner."""
    from sequencealigning_tpu_torch.config import (
        AlignConfig,
        Algo,
        ScoringScheme,
    )
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import (
        pack_batch,
        trim_for_stream,
    )

    fill, smodes, modes = port["fill"], port["smodes"], port["modes"]
    kern = port["csrc"].kernels()
    rng = np.random.default_rng(8)
    pairs = skewed_pairs(rng, 8, 100, 400, LEN_CEIL_DB - 60, LEN_CEIL_DB,
                         b"ACGTN")
    err = {}

    def same(a, b):
        if a is None or b is None:
            return a is None and b is None
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return bool(torch.equal(a, b))

    def record(name, ok):
        err[name] = max(err.get(name, 0), 0 if ok else 1)

    # Each kernel with the automatic split (CTAs of 4096 lanes, 8 a thread)
    # and with CTAs of 8192 lanes, 16 a thread (the instances rows past
    # 32768 lanes take).
    splits = (0, 8192)
    tb = to_device(trim_for_stream(pack_batch(pairs, batch_size=8)), "cuda")
    plan, ins = fill.stream_inputs(*tb)
    ctas = kern.sa_fill_ctas(plan.p, 0)
    check(ctas > 1, f"P={plan.p} did not split ({ctas} CTAs)")
    a = (plan, ScoringScheme(), True, True, "fast4")
    fp, dp = fill.gotoh_fill_stream_torch(*ins, *a)
    for cta in splits:
        fk, dk = fill.gotoh_fill_stream_cuda(*ins, *a, cta_lanes=cta)
        record("nw_affine_stream_fill", same(fk, fp) and same(dk, dp))
    tb = to_device(pack_batch(pairs, batch_size=8), "cuda")
    plan_m, ins_m = fill.stream_inputs(*tb)
    for mode in ("local", "semi"):
        a = (plan_m, ScoringScheme(), False, mode, True)
        (bp, dp_), dp = smodes.gotoh_fill_stream_modes_torch(*ins_m, *a)
        for cta in splits:
            (bk, dk_), dk = smodes.gotoh_fill_stream_modes_cuda(
                *ins_m, *a, cta_lanes=cta)
            record("nw_affine_stream_modes_fill",
                   same(bk, bp) and same(dk_, dp_) and same(dk, dp))
    s2v = modes.modes_layout(tb.db)
    a = (tb.query, s2v, tb.query_len, tb.db_len, tb.query.shape[1],
         tb.db.shape[1], ScoringScheme(), False, True, True)
    want = modes.fill_modes_torch(*a)
    pair_ctas = []
    for cta in splits:
        got = modes.modes_fill_cuda(*a, cta_lanes=cta)
        pair_ctas.append(modes.modes_fill_cuda.last_launch["ctas"])
        e, _, zero = pair_cells_check(torch, modes, got, want,
                                      tb.query_len.cpu().numpy(),
                                      tb.db_len.cpu().numpy())
        record("nw_affine_modes_fill", e == 0 and zero)
    del dk, dp, want, got
    check(not any(err.values()), f"fills past 8192 lanes != plain: {err}")
    log(f"[13 ceiling] db ~{LEN_CEIL_DB} bp: global fast4 fill (P={plan.p}, "
        f"{ctas} CTAs), local and semi-global streamed fills "
        f"(P={plan_m.p}, {kern.sa_fill_ctas(plan_m.p, 0)} CTAs) and the "
        f"per-pair modes fill (P={s2v.shape[1]}, {pair_ctas[0]} CTAs a pair; "
        f"its matrices' cells, the other bytes 0) equal their plain "
        f"versions, and again split into "
        f"{kern.sa_fill_ctas(plan.p, 8192)} CTAs of 8192 lanes (16 a thread)")
    torch.cuda.empty_cache()

    # One long global pair: ~1% substitutions and a 3 bp deletion.
    ref = make_pairs(np.random.default_rng(9), 1, LEN_LONG)[0]
    mid = LEN_LONG // 2
    long_pair = [(ref[0][:mid] + ref[0][mid + 3:], ref[1])]
    cfg = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True)
    aligner = port["models"].GotohAligner(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    path = f"global first-only, one {LEN_LONG} bp pair"
    with path_launches(port, by_path, path):
        t0 = time.perf_counter()
        res = aligner.align_batch(records(long_pair))
        secs = time.perf_counter() - t0
    launches = {k: v[path] for k, v in by_path.items() if path in v}
    check_results(res, long_pair, cfg.scoring, path, compat=True)
    check(launches.get("nw_affine_stream_fill", 0) > 0
          and launches.get("walk_fast4", 0) > 0,
          f"{path} launched {launches}")
    p_long = -(-(LEN_LONG + 2) // 128) * 128
    log(f"[13 ceiling] {path}: P={p_long} ({kern.sa_fill_ctas(p_long, 0)} "
        f"CTAs), {secs:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, score "
        f"{res[0].score}; the alignment rescores to its score")
    return {"ceiling_err": err, "long_pair_s": secs,
            "long_pair_score": res[0].score}


def tiled_pairs(rng, n, lo, hi, alphabet=b"ACGTN"):
    """n pairs of lo..hi bp; every other db a mutated copy of its query."""
    alpha = np.frombuffer(alphabet, np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        s2 = rng.choice(alpha, int(rng.integers(lo, hi + 1)))
        if i % 2:
            s2 = np.resize(s1, len(s2)).copy()
            hits = rng.integers(len(s2), size=max(1, len(s2) // 50))
            s2[hits] = rng.choice(alpha, len(hits))
        pairs.append((s1.tobytes(), s2.tobytes()))
    return pairs


def phase_tiled(torch, port):
    """Kernels #4 and #5 against their plain versions on small ragged
    batches, then at full width against the streamed global fill's finals;
    the banded fill at ~8.6k lanes (the tile rule's strips) against its
    plain version."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import (
        pack_batch,
        trim_for_stream,
    )

    tiled, fill, banded = port["tiled"], port["fill"], port["banded"]
    kern = port["csrc"].kernels()
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    rng = np.random.default_rng(11)
    err = {"nw_affine_tiled_fill": 0, "nw_affine_tiled_fold_fill": 0}
    out = {}

    def record(name, got, want, label):
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        check(e == 0, f"{name} != plain ({label}): err {e}")
        err[name] = max(err[name], e)

    # Kernel #4: 16 ragged pairs with empty sides, compat x wildcard, at its
    # own strip width and forced 128/384-lane strips; then 5 pairs up to ~3
    # kb.  The plain fill follows the lax layout.
    small = tiled_pairs(rng, 14, 1, LEN_TILE_SMALL) + [(b"ACGTA", b""),
                                                       (b"", b"ACG")]
    tb = to_device(pack_batch(small), "cuda")
    runs = 0
    for compat in (True, False):
        for wildcard in (False, True):
            a = (wild if wildcard else ScoringScheme(), compat, wildcard)
            p_ms, want = host_ms(torch, lambda: tiled.tiled_fill_torch(
                *tb, *a, tile_lanes=256))
            for cta in (0, 128, 384):
                record("nw_affine_tiled_fill",
                       tiled.tiled_fill_cuda(*tb, *a, strip_lanes=cta), want,
                       f"compat={compat}, wildcard={wildcard}, strip={cta}")
                runs += 1
            if compat and not wildcard:
                out["tiled_plain_ms"] = p_ms
                out["tiled_small_ms"] = cuda_ms(
                    torch, lambda: tiled.tiled_fill_cuda(*tb, *a))
    tb3 = to_device(pack_batch(tiled_pairs(rng, 5, 2000, 3000, b"ACGT")),
                    "cuda")
    record("nw_affine_tiled_fill",
           tiled.tiled_fill_cuda(*tb3, ScoringScheme(), True, False),
           tiled.tiled_fill_torch(*tb3, ScoringScheme(), True, False,
                                  tile_lanes=1024), "5 pairs of 2-3 kb")
    # Kernel #5: 1-4 pairs, compat and textbook, at its own strip width and
    # forced 128-lane strips (one pair of 1.1-1.5 kb: 9-12 strips).
    for B in (1, 2, 3, 4):
        lo, hi = (1100, 1500) if B == 1 else (200, LEN_FOLD_SMALL)
        pairs = tiled_pairs(rng, B, lo, hi, b"ACGT")
        if B == 4:
            pairs[3] = (pairs[3][0], b"")
        tbf = to_device(pack_batch(pairs), "cuda")
        for compat in (True, False):
            a = (ScoringScheme(), compat, False)
            p_ms, want = host_ms(torch, lambda: tiled.tiled_fold_fill_torch(
                *tbf, *a, tile_lanes=256))
            for cta in (0, 128):
                record("nw_affine_tiled_fold_fill",
                       tiled.tiled_fold_fill_cuda(*tbf, *a, strip_lanes=cta),
                       want, f"{B} pairs, compat={compat}, strip={cta}")
                runs += 1
            if B == 2 and compat:
                out["tfold_plain_ms"] = p_ms
                out["tfold_small_ms"] = cuda_ms(
                    torch, lambda: tiled.tiled_fold_fill_cuda(*tbf, *a))
    log(f"[14 tiled] {runs} small runs equal their plain versions (16 x <= "
        f"{LEN_TILE_SMALL} bp: kernel #4 {out['tiled_small_ms']:.3f} ms, "
        f"plain {out['tiled_plain_ms']:.1f} ms; 2 x <= {LEN_FOLD_SMALL} bp: "
        f"kernel #5 {out['tfold_small_ms']:.3f} ms, plain "
        f"{out['tfold_plain_ms']:.1f} ms)")

    # Full width: 8 (resp. 2) pairs of 40 kb against kernel #1's finals
    # (dirs off), kernel #1 held against its plain version on the batch.
    pairs = make_pairs(np.random.default_rng(12), 8, LEN_TILE_CHECK)
    tbs = to_device(trim_for_stream(pack_batch(pairs, batch_size=8)), "cuda")
    plan, ins = fill.stream_inputs(*tbs)
    a = (plan, ScoringScheme(), True, False, None)
    f1 = fill.gotoh_fill_stream_cuda(*ins, *a)[0]
    s_plain_ms, (fp1, _) = host_ms(
        torch, lambda: fill.gotoh_fill_stream_torch(*ins, *a))
    torch.cuda.synchronize()
    e1 = int((f1 - fp1).abs().max())
    check(e1 == 0, f"streamed fill != plain at 8 x {LEN_TILE_CHECK} bp")
    tb = to_device(pack_batch(pairs, batch_size=8), "cuda")
    record("nw_affine_tiled_fill",
           tiled.tiled_fill_cuda(*tb, ScoringScheme(), True, False), f1[:8],
           f"8 x {LEN_TILE_CHECK} bp vs kernel #1")
    record("nw_affine_tiled_fold_fill",
           tiled.tiled_fold_fill_cuda(*(t[:2] for t in tb), ScoringScheme(),
                                      True, False), f1[:2],
           f"2 x {LEN_TILE_CHECK} bp vs kernel #1")
    log(f"[14 tiled] 8 x {LEN_TILE_CHECK} bp: kernel #4's finals and kernel "
        f"#5's (2 pairs) equal the streamed fill's (P={plan.p}, "
        f"{kern.sa_fill_ctas(plan.p, 0)} CTAs, dirs off), which equal its "
        f"plain version ({s_plain_ms / 1e3:.1f} s)")
    del ins, tbs, f1, fp1
    torch.cuda.empty_cache()
    out.update(tiled_stress(torch, port, record))

    # The banded fill's natural split: 8 pairs of 300 bp against ~17 kb.
    rng = np.random.default_rng(13)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(8):
        ref = rng.choice(alpha, int(rng.integers(16_800, 17_200)))
        pairs.append((ref[:300].tobytes(), ref.tobytes()))
    tb = to_device(pack_batch(pairs, batch_size=8), "cuda")
    plan, ins = banded.band_inputs(*tb, BAND)
    a = (plan, ScoringScheme(), True, True, "fast4")
    fk, dk = banded.banded_diag_fill_cuda(*ins, *a)
    shape = dict(banded.banded_diag_fill_cuda.last_launch)
    check(plan.L > 8192 and shape["strips"] > 1, f"L={plan.L} did not split")
    fp, dp = banded.banded_diag_fill_torch(*ins, *a)
    e3 = max(int((fk - fp).abs().max()), 0 if torch.equal(
        dk.view(torch.int32), dp.view(torch.int32)) else 1)
    check(e3 == 0, f"banded fill in {shape['strips']} strips a pair != "
          f"plain: err {e3}")
    nat_ms = cuda_ms(torch, lambda: banded.banded_diag_fill_cuda(*ins, *a))
    del dk, dp
    torch.cuda.empty_cache()
    log(f"[14 tiled] banded fill at L={plan.L} (8 x 300 bp against ~17 kb; "
        f"{tile_line(shape)}): {nat_ms:.3f} ms; finals and the whole dirs "
        "tensor equal the plain version")
    out.update(tiled_small_err=err["nw_affine_tiled_fill"],
               tfold_small_err=err["nw_affine_tiled_fold_fill"],
               bfill_natural_split_ms=nat_ms, bfill_natural_split_err=e3,
               bfill_natural_split_lanes=plan.L)
    return out


def pair_line(shape):
    """A per-pair fill's launch shape (the wrapper's last_launch), for the
    log."""
    return (f"{shape['ctas']} CTAs a pair of {shape['threads']} threads x "
            f"{shape['lanes_per_thread']} lanes, chunk {shape['chunk']}, "
            f"slots {shape['ring_slots']}")


def launch_line(shape):
    """A tiled launch's shape (the wrapper's last_launch), for the log."""
    return (f"strips of {shape['strip_lanes']} lanes "
            f"({shape['lanes_per_thread']} a thread), chunks of {shape['chunk_rows']} rows, "
            f"{shape['strips']} strips, {shape['ctas_per_pair']} CTAs a "
            f"pair, ring {shape['ring']}, grid {shape['ctas']} of "
            f"{shape['resident']} resident, {shape['sms']} SMs")


def tiled_stress(torch, port, record):
    """Kernels #4 and #5 where their CTAs hand over most: strips of
    HANDOFF_LANES lanes and chunks of HANDOFF_ROWS rows on N_HANDOFF ragged
    pairs (#4) and on 2 of them (#5) vs the plain fill; then more strips
    than resident CTAs (N_OVERFLOW pairs) vs kernel #7's score-only fill."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    tiled, nw = port["tiled"], port["nw"]
    rng = np.random.default_rng(16)
    pairs = tiled_pairs(rng, N_HANDOFF, 1, LEN_HANDOFF, b"ACGT")
    pairs[1] = (pairs[1][0][:50], pairs[1][1])  # n1 below a chunk of 128
    tb = to_device(pack_batch(pairs), "cuda")
    a = (ScoringScheme(), True, False)
    kw = dict(strip_lanes=HANDOFF_LANES, chunk_rows=HANDOFF_ROWS)
    p_ms, want = host_ms(torch, lambda: tiled.tiled_fill_torch(
        *tb, *a, tile_lanes=8192))
    record("nw_affine_tiled_fill", tiled.tiled_fill_cuda(*tb, *a, **kw),
           want, "handoff stress")
    shape4 = dict(tiled.tiled_fill_cuda.last_launch)
    two = [t[:2].contiguous() for t in tb]
    record("nw_affine_tiled_fold_fill",
           tiled.tiled_fold_fill_cuda(*two, *a, **kw), want[:2],
           "handoff stress, 2 pairs")
    shape5 = dict(tiled.tiled_fold_fill_cuda.last_launch)
    log(f"[14 tiled] handoff stress, {N_HANDOFF} pairs of 1-{LEN_HANDOFF} "
        f"bp: kernel #4 ({launch_line(shape4)}) and kernel #5 on 2 of them "
        f"({launch_line(shape5)}) equal the plain fill ({p_ms / 1e3:.1f} s)")

    lo, hi = LEN_OVERFLOW
    pairs = tiled_pairs(rng, N_OVERFLOW, lo, hi, b"ACGT")
    tb = to_device(pack_batch(pairs), "cuda")
    ms, got = host_ms(torch, lambda: tiled.tiled_fill_cuda(*tb, *a))
    shape = dict(tiled.tiled_fill_cuda.last_launch)
    check(shape["strips"] > shape["resident"],
          f"overflow: {shape['strips']} strips, {shape['resident']} "
          "resident CTAs")
    q = tb.query.to(torch.int32).contiguous()
    g7, _ = nw.gotoh_fill_cuda(q, *nw.gotoh_layout(tb.db, tb.query_len,
                                                   tb.db_len),
                               q.shape[1], tb.db.shape[1], *a, False)
    torch.cuda.synchronize()
    e = int((got.max(1).values - g7.max(1).values).abs().max())
    check(e == 0, f"overflow: kernel #4's scores != kernel #7's: err {e}")
    e_all = int((got - g7).abs().max())
    cells = sum(len(x) * len(y) for x, y in pairs)
    log(f"[14 tiled] residency overflow, {N_OVERFLOW} pairs of {lo}-{hi} bp: "
        f"kernel #4 ({launch_line(shape)}) {ms:.1f} ms host clock "
        f"({cells / ms / 1e6:.1f} GCUPS); scores equal kernel #7's "
        f"(finals: max diff {e_all})")
    return dict(tiled_handoff_plain_ms=p_ms, tiled_handoff_shape=shape4,
                tfold_handoff_shape=shape5, tiled_overflow_ms=ms,
                tiled_overflow_shape=shape, tiled_overflow_finals_err=e_all)


def long_batches():
    """Batches A and B of the long-pair path (module constants)."""
    rng = np.random.default_rng(10)
    A = make_pairs(rng, N_LONG, LEN_LONG_PAIR)
    mut, ref = A[0]
    ins = rng.choice(list(b"ACGT"), LONG_INDEL).astype(np.uint8).tobytes()
    A[0] = (mut[:30_000] + ins + mut[30_000:70_000]
            + mut[70_000 + LONG_INDEL:], ref)
    mut, ref = make_pairs(rng, 1, LEN_LONG_PAIR)[0]
    half = (LEN_LONG_PAIR - LONG_DROP) // 2
    B = [A[0], (mut, ref[:half] + ref[half + LONG_DROP:])]
    return A, B


def phase_long(torch, port, by_path):
    """The long-pair path through GotohAligner on cuda over batches A and B
    (first-only and co-optimal), kernels #4 and #5 and the split banded
    fill timed at those shapes, then the Myers-Miller escape."""
    from sequencealigning_tpu_torch.config import (
        AlignConfig,
        Algo,
        ScoringScheme,
    )
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.models import gotoh as gotoh_mod

    tiled, banded = port["tiled"], port["banded"]
    kern = port["csrc"].kernels()
    A, B = long_batches()
    meas, full = {}, {}
    # The kernels at full width (and each batch's exact scores).
    for name, pairs, fn, key in (
            ("A", A, tiled.tiled_fill_cuda, "tiled"),
            ("B", B, tiled.tiled_fold_fill_cuda, "tfold")):
        tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
        a = (*tb, ScoringScheme(), True, False)
        # One launch (phase 14 has loaded the kernel): its time, and its
        # finals as the batch's exact scores.
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        finals = fn(*a)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        full[name] = finals
        exact = finals.cpu().numpy().max(axis=1)
        cells = sum(len(x) * len(y) for x, y in pairs)
        b_ms, b_by = bound(nbytes(*tb) + 12 * len(pairs),
                           cells * OPS_PER_CELL["score"])
        shape = dict(fn.last_launch)
        meas.update({f"{key}_first_ms": ms, f"{key}_bound_ms": b_ms,
                     f"{key}_bound_by": b_by, f"{key}_cells": cells,
                     f"{key}_shape": shape, f"exact_{name}": exact})
        log(f"[15 long] batch {name} ({len(pairs)} pairs, {cells:.3g} "
            f"cells): {fn.__name__} {ms:.1f} ms ({cells / ms / 1e6:.2f} "
            f"GCUPS, {100 * b_ms / ms:.1f}% of its bound {b_ms:.3f} ms, "
            f"{b_by}); {launch_line(shape)}, a pair on "
            f"{shape['sms_per_pair']} SMs")
    # Both kernels' finals at full width against one plain row sweep over
    # batch A and batch B's second pair (B's first is A's first).
    sweep = A + B[1:]
    tb = to_device(pack_batch(sweep, batch_size=len(sweep)), "cuda")
    rows_ms, plain = host_ms(torch, lambda: tiled.gotoh_finals_rows_torch(
        *tb, ScoringScheme(), True, False))
    e4 = int((full["A"] - plain[:N_LONG]).abs().max())
    e5 = int((full["B"] - plain[[0, N_LONG]]).abs().max())
    check(e4 == 0 and e5 == 0, f"full width: kernel #4 err {e4}, kernel #5 "
          f"err {e5} against the plain row sweep")
    log(f"[15 long] batch A's finals (kernel #4) and batch B's (kernel #5) "
        f"equal the plain row sweep's ({len(sweep)} pairs, "
        f"{rows_ms / 1e3:.1f} s)")
    meas.update(tiled_full_err=e4, tfold_full_err=e5, rows_plain_ms=rows_ms)
    check(meas["tiled_shape"]["sms"] >= 100,
          f"batch A: kernel #4 ran on {meas['tiled_shape']['sms']} SMs")
    check(min(meas["tfold_shape"]["sms_per_pair"]) > 8,
          f"batch B: kernel #5's pairs ran on "
          f"{meas['tfold_shape']['sms_per_pair']} SMs")
    # The race check: N_RACE more launches of each, back to back, every one
    # equal to the first (so to the plain row sweep); their mean is the
    # kernel's time.
    for name, pairs, fn, key in (
            ("A", A, tiled.tiled_fill_cuda, "tiled"),
            ("B", B, tiled.tiled_fold_fill_cuda, "tfold")):
        tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
        times = []
        for _ in range(N_RACE):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = fn(*tb, ScoringScheme(), True, False)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            check(torch.equal(got, full[name]),
                  f"race: a launch of {fn.__name__} at batch {name} differs "
                  "from the first")
        ms = sum(times) / len(times)
        cells, b_ms = meas[f"{key}_cells"], meas[f"{key}_bound_ms"]
        meas.update({f"{key}_ms": ms, f"{key}_race_ms": times,
                     f"{key}_gcups": cells / ms / 1e6,
                     f"{key}_pct_of_bound": 100 * b_ms / ms})
        log(f"[15 long] race check: {N_RACE} more launches of "
            f"{fn.__name__} at batch {name}, each equal to the first: "
            f"{ms:.3f} ms mean ({min(times):.3f}-{max(times):.3f}), "
            f"{cells / ms / 1e6:.1f} GCUPS, {100 * b_ms / ms:.1f}% of its "
            "bound")
    del full, plain
    meas.update(long_banded_fills(torch, port, A, B))

    # The path, with the band rounds recorded by a spy on the banded fill.
    rounds = []
    real_fill = gotoh_mod.nw_banded_diag_batch

    def spy(*args, band, **kwargs):
        res = real_fill(*args, band=band, **kwargs)
        rounds.append((band, res.finals.max(axis=1)))
        return res

    gotoh_mod.nw_banded_diag_batch = spy
    try:
        for name, pairs, kernel in (("A", A, "nw_affine_tiled_fill"),
                                    ("B", B, "nw_affine_tiled_fold_fill")):
            exact = meas.pop(f"exact_{name}")
            for first_only in (True, False):
                cfg = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH,
                                  first_only=first_only)
                aligner = port["models"].GotohAligner(cfg, "cuda")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                path = (f"long pairs, batch {name}, "
                        f"{'first-only' if first_only else 'co-optimal'}")
                rounds.clear()
                with path_launches(port, by_path, path):
                    t0 = time.perf_counter()
                    res = aligner.align_batch(records(pairs))
                    secs = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                launches = {k: v[path] for k, v in by_path.items()
                            if path in v}
                check_results(res, pairs, cfg.scoring, path, compat=True)
                check([r.score for r in res] == [int(x) for x in exact],
                      f"{path}: scores != the tiled exact scores")
                for k in (kernel, "nw_banded_diag_fill", "walk_banded"):
                    check(launches.get(k, 0) > 0, f"{path} never launched {k}")
                took = [next((i + 1 for i, (_b, f) in enumerate(rounds)
                              if int(f[p]) == int(exact[p])), None)
                        for p in range(len(pairs))]
                bands = [b for b, _f in rounds]
                tag = f"long_{name}_{'first' if first_only else 'coopt'}"
                meas.update({f"{tag}_s": secs,
                             f"{tag}_alignments_per_s": len(pairs) / secs,
                             f"{tag}_peak_gib": peak / 2 ** 30,
                             f"{tag}_rounds": took, f"{tag}_bands": bands})
                log(f"[15 long] {path}: {secs:.3f} s, "
                    f"{len(pairs) / secs:.2f} alignments/s, peak "
                    f"{peak / 2**30:.2f} GiB; bands {bands}, rounds a pair "
                    f"{took}; launches {launches}; every alignment consumes "
                    "its sequences and rescores to the tiled exact score")
                del res, aligner
    finally:
        gotoh_mod.nw_banded_diag_batch = real_fill

    # The escapes: Myers-Miller on the card, its row kernel first held
    # against the plain version.
    short = escape_pair(LEN_MM_SHORT, 14)
    longp = escape_pair(LEN_LONG_PAIR, 16)
    meas.update(mm_rows_check(torch, port, short, longp))
    for tag, pair, was in (("mm_escape", short, " (PR 11, run 31: 6.132 s)"),
                           ("mm_escape_long", longp, "")):
        meas.update(mm_escape(torch, port, by_path, tag, pair, was))
    return meas


def seqpar_ragged(rng, n, alphabet):
    """n pairs of queries 1..SEQPAR_RAGGED_Q bp against dbs 1..
    SEQPAR_RAGGED_DB bp, the next-to-last with an empty db and the last
    with an empty query; every other db a mutated copy of its query."""
    alpha = np.frombuffer(alphabet, np.uint8)
    pairs = []
    for i in range(n):
        s1 = rng.choice(alpha, int(rng.integers(1, SEQPAR_RAGGED_Q + 1)))
        s2 = rng.choice(alpha, int(rng.integers(1, SEQPAR_RAGGED_DB + 1)))
        if i % 2:
            s2 = np.resize(s1, len(s2)).copy()
            hits = rng.integers(len(s2), size=max(1, len(s2) // 50))
            s2[hits] = rng.choice(alpha, len(hits))
        pairs.append((s1.tobytes(), s2.tobytes()))
    pairs[-2] = (pairs[-2][0], b"")
    pairs[-1] = (b"", pairs[-1][1])
    return pairs


def seqpar_stall_check(torch, port):
    """Two shards of one card, one CTA each, shard 0's tickets not
    segment-major (its segment 2 before its segment 0): shard 0 waits on
    segment 1, whose shard waits on segment 0 -- a schedule that cannot be
    met must raise, not hang; the next launch equals its plain version.
    The seconds it took."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    tiled = port["tiled"]
    lib = port["csrc"].kernels()
    tb = to_device(pack_batch([(b"ACGT" * 50, b"ACGTT" * 120)]), "cuda")
    mesh = ["cuda:0"] * 2
    real = tiled.shard_schedule, lib.sa_tiled_resident_ctas

    def cyclic(*a):
        items, strips, nseg = real[0](*a)
        seg0 = items[0][:, 1] == 0
        items[0] = np.concatenate([items[0][~seg0], items[0][seg0]])
        return items, strips, nseg

    tiled.shard_schedule = cyclic
    lib.sa_tiled_resident_ctas = lambda *a: 2
    t0 = time.perf_counter()
    raised = None
    try:
        tiled.tiled_shard_fill_cuda(*tb, mesh, 128, ScoringScheme(), True,
                                    False)
    except RuntimeError as e:
        raised = str(e)
    finally:
        tiled.shard_schedule, lib.sa_tiled_resident_ctas = real
    secs = time.perf_counter() - t0
    check(raised is not None and "spin limit" in raised,
          f"an impossible shard schedule did not raise: {raised}")
    got = tiled.tiled_shard_fill_cuda(*tb, mesh, 128, ScoringScheme(), True,
                                      False)
    want = tiled.shard_fill_torch(*tb, mesh, 128, 128, ScoringScheme(), True,
                                  False)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "the shard fill after a stalled launch != "
          "plain")
    log(f"[25 seqpar] an impossible schedule (2 shards, one CTA each, shard "
        f"0's segment 2 first) raised after {secs:.2f} s: {raised}; the next "
        "launch equals its plain version")
    return secs


def phase_seqpar(torch, port, by_path):
    """Sequence parallelism on the card: the shard fill against its plain
    version on ragged batches over 1-8 shards; seqpar_fill on one 200 kb x
    200 kb pair over SEQPAR_SHARDS shards of one card, its finals against
    kernel #4's, timed; seqpar_align on batch A's pair 0; a schedule that
    cannot be met; and the same pair over distinct cards where there are
    several."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    tiled = port["tiled"]
    par = port["parallel"]
    kern = tiled.tiled_shard_fill_cuda
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    rng = np.random.default_rng(25)
    meas, err = {}, 0

    # 1. The kernel against its plain version (the plain twin on the card):
    # every shard count at both tile widths, compat / textbook x wildcard.
    runs = []
    for i, (D, tl) in enumerate((d, t) for d in (1, 2, 4, 8)
                                for t in (128, 256)):
        compat, wildcard = i % 2 == 0, (i // 2) % 2 == 1
        scheme = wild if wildcard else ScoringScheme()
        pairs = seqpar_ragged(rng, 8, b"ACGTN" if wildcard else b"ACGT")
        tb = to_device(pack_batch(pairs, batch_size=8), "cuda")
        mesh = ["cuda:0"] * D
        W = tiled.seqpar_lanes(tb.db.shape[1], D, tl)
        a = (mesh, W, scheme, compat, wildcard)
        got = kern(*tb, *a)
        shape = dict(kern.last_launch)
        p_ms, want = host_ms(torch, lambda: tiled.shard_fill_torch(
            *tb, mesh, W, 128, scheme, compat, wildcard))
        e = int((got - want).abs().max())
        check(e == 0, f"shard fill != plain (D={D}, tile_lanes={tl}, "
              f"compat={compat}, wildcard={wildcard}): err {e}")
        err = max(err, e)
        runs.append(f"D={D} W={W} ({shape['segments']} segments, strips "
                    f"{shape['strips']})")
        if D == 4 and tl == 128:
            meas["seqpar_plain_ms"] = p_ms
            meas["seqpar_small_ms"] = cuda_ms(torch, lambda: kern(*tb, *a))
            fin = par.seqpar_fill(*(t.cpu().numpy() for t in tb), mesh=mesh,
                                  tile_lanes=tl, scheme=scheme, compat=compat,
                                  wildcard=wildcard)
            check(np.array_equal(fin, want.cpu().numpy()),
                  "seqpar_fill != the plain twin on the ragged batch")
    log(f"[25 seqpar] the shard fill equals its plain version on 8 ragged "
        f"batches of 8 pairs (queries <= {SEQPAR_RAGGED_Q} bp, dbs <= "
        f"{SEQPAR_RAGGED_DB} bp, empty sides): {'; '.join(runs)}; at D=4 "
        f"W=128 {meas['seqpar_small_ms']:.3f} ms, plain "
        f"{meas['seqpar_plain_ms']:.1f} ms")

    # 2-3. Full width: one 200 kb x 200 kb pair over SEQPAR_SHARDS shards of
    # one card through seqpar_fill, against kernel #4; timed.
    pair = make_pairs(np.random.default_rng(25), 1, SEQPAR_LEN)
    batch = pack_batch(pair, batch_size=8)
    mesh = ["cuda:0"] * SEQPAR_SHARDS
    path = f"seqpar_fill {SEQPAR_LEN} bp x {SEQPAR_LEN} bp, {SEQPAR_SHARDS} "\
        "shards of one card"
    with path_launches(port, by_path, path):
        call_ms, fin = host_ms(torch, lambda: par.seqpar_fill(
            batch.query, batch.db, batch.query_len, batch.db_len, mesh=mesh,
            tile_lanes=SEQPAR_TILE))
    shape = dict(kern.last_launch)
    check(by_path.get("seqpar_shard", {}).get(path) == SEQPAR_SHARDS,
          f"{path}: {by_path.get('seqpar_shard')} shard launches")
    tb = to_device(pack_batch(pair, batch_size=1), "cuda")
    a = (ScoringScheme(), True, False)
    f4 = port["tiled"].tiled_fill_cuda(*tb, *a)
    e = int(np.abs(fin[:1] - f4.cpu().numpy()).max())
    check(e == 0, f"{path}: finals {fin[0]} != kernel #4's {f4[0].tolist()}")
    err = max(err, e)
    W = tiled.seqpar_lanes(SEQPAR_LEN, SEQPAR_SHARDS, SEQPAR_TILE)
    fa = (mesh, W, *a)
    times, first = [], None
    for _ in range(N_RACE):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = kern(*tb, *fa)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        check(torch.equal(got, f4), "race: a shard fill of the 200 kb pair "
              "differs from kernel #4")
    ms = sum(times) / len(times)
    t4 = cuda_ms(torch, lambda: port["tiled"].tiled_fill_cuda(*tb, *a))
    cells = SEQPAR_LEN * SEQPAR_LEN
    b_ms, b_by = bound(nbytes(*tb) + 12, cells * OPS_PER_CELL["score"])
    meas.update(seqpar_ms=ms, seqpar_race_ms=times, seqpar_call_ms=call_ms,
                seqpar_tiled_ms=t4, seqpar_bound_ms=b_ms, seqpar_bound_by=b_by,
                seqpar_gcups=cells / ms / 1e6,
                seqpar_pct_of_bound=100 * b_ms / ms, seqpar_shape=shape)
    log(f"[25 seqpar] {path}: {shape['segments']} segments of {W} lanes "
        f"({-(-shape['segments'] // SEQPAR_SHARDS)} rounds), strips of "
        f"{shape['strip_lanes']} lanes, strips a shard {shape['strips']}, "
        f"CTAs {shape['ctas']} of {shape['resident']} resident, SMs "
        f"{shape['sms']}; finals equal kernel #4's; seqpar_fill "
        f"{call_ms:.1f} ms host clock, the launches {ms:.3f} ms mean of "
        f"{N_RACE} ({min(times):.3f}-{max(times):.3f}, each equal to #4), "
        f"{cells / ms / 1e6:.1f} GCUPS, {100 * b_ms / ms:.1f}% of its bound "
        f"{b_ms:.3f} ms ({b_by}); kernel #4 on the pair {t4:.3f} ms")
    del tb, got, f4
    torch.cuda.empty_cache()

    # 4. seqpar_align at full width on batch A's pair 0.
    A, _B = long_batches()
    s1, s2 = A[0]
    tb = to_device(pack_batch([A[0]], batch_size=1), "cuda")
    exact = int(port["tiled"].tiled_fill_cuda(*tb, *a)[0].max())
    path = f"seqpar_align batch A pair 0, {SEQPAR_SHARDS} shards of one card"
    with path_launches(port, by_path, path):
        secs, (score, a1, a2) = host_ms(torch, lambda: par.seqpar_align(
            s1, s2, mesh=mesh))
    launches = {k: v[path] for k, v in by_path.items() if path in v}
    check(score == exact, f"{path}: score {score} != kernel #4's {exact}")
    check(a1 is not None and a1.replace("-", "").encode() == s1
          and a2.replace("-", "").encode() == s2,
          f"{path}: the alignment does not consume both sequences")
    check(affine_score(a1, a2, ScoringScheme(), False, True) == score,
          f"{path}: the alignment does not rescore to {score}")
    for k in ("seqpar_shard", "nw_banded_diag_fill", "walk_banded"):
        check(launches.get(k, 0) > 0, f"{path} never launched {k}")
    meas["seqpar_align_s"] = secs / 1e3
    log(f"[25 seqpar] {path}: score {score} (= kernel #4's), the alignment "
        f"consumes both sequences and rescores to it; {secs / 1e3:.3f} s; "
        f"launches {launches}")

    # 5. A schedule that cannot be met.
    meas["seqpar_stall_s"] = seqpar_stall_check(torch, port)

    # 6. Distinct cards.
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = par.make_mesh()
        tb = to_device(pack_batch(pair, batch_size=1), "cuda")
        f4 = port["tiled"].tiled_fill_cuda(*tb, *a)
        Wc = tiled.seqpar_lanes(SEQPAR_LEN, len(cards), SEQPAR_TILE)
        ms_c = cuda_ms(torch, lambda: kern(*tb, cards, Wc, *a))
        got = kern(*tb, cards, Wc, *a)
        check(torch.equal(got, f4), "distinct cards: finals != kernel #4's")
        meas["seqpar_cards_ms"] = ms_c
        log(f"[25 seqpar] the 200 kb pair over {len(cards)} distinct cards "
            f"(peers {kern.last_launch['peers']}): finals equal kernel #4's; "
            f"{ms_c:.3f} ms")
    else:
        meas["seqpar_cards_ms"] = None
        log("[25 seqpar] the distinct-card route was not run: this machine "
            f"has {n_cards} card")
    meas["seqpar_err"] = err
    return meas


def seqpar_rank(args):
    """Phase 26's rank (this script run with --seqpar-rank R): joins a Gloo
    group of SEQPAR_RANKS processes and drives the port's sequence
    parallelism over SEQPAR_RANK_SHARDS shards of the card a rank; writes
    its results to --seqpar-out as JSON.  Every check that fails raises:
    the rank exits non-zero."""
    sys.path.insert(0, ROOT)
    import torch

    from sequencealigning_tpu_torch import parallel as par
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops import nw_affine_tiled as tiled
    from sequencealigning_tpu_torch.ops import nw_banded_diag
    from sequencealigning_tpu_torch.ops import traceback_device
    from sequencealigning_tpu_torch.parallel import relay
    from sequencealigning_tpu_torch.parallel.mesh import seqpar_group

    rank = args.seqpar_rank
    t_start = time.perf_counter()
    check(torch.cuda.is_available(), "rank: no CUDA device")
    par.multihost_init(f"localhost:{args.seqpar_port}",
                       num_processes=SEQPAR_RANKS, process_id=rank,
                       backend="gloo")
    group = seqpar_group()
    mesh = ["cuda:0"] * SEQPAR_RANK_SHARDS
    D = SEQPAR_RANKS * SEQPAR_RANK_SHARDS
    kern = tiled.tiled_shard_fill_cuda
    out = dict(rank=rank)

    def say(msg):
        log(f"[26 seqpar ranks, rank {rank}] {msg}")

    # 1. The kernel route against the plain twin on the same ranks.
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    rng = np.random.default_rng(26)
    for i, tl in enumerate((128, 256)):
        compat, wildcard = i == 0, i == 1
        scheme = wild if wildcard else ScoringScheme()
        pairs = seqpar_ragged(rng, 8, b"ACGTN" if wildcard else b"ACGT")
        batch = pack_batch(pairs, batch_size=8)
        got = par.seqpar_fill(batch.query, batch.db, batch.query_len,
                              batch.db_len, mesh=mesh, tile_lanes=tl,
                              scheme=scheme, compat=compat, wildcard=wildcard)
        shape = dict(kern.last_launch)
        W = tiled.seqpar_lanes(batch.db.shape[1], D, tl)
        want = tiled.shard_fill_torch(
            *to_device(batch, "cuda"), mesh, W, 128, scheme, compat,
            wildcard, group=group).cpu().numpy()
        check(np.array_equal(got, want), f"rank {rank}: the shard fill != "
              f"the plain twin over the ranks (tile_lanes {tl}): "
              f"{np.abs(got.astype(np.int64) - want).max()}")
        say(f"ragged batch {i} (W {W}, {shape['segments']} segments, "
            f"strips {shape['strips']}, relay {shape['relay']}): equal to "
            "the plain twin over the ranks")

    # 2. The 200 kb pair: the launch count set to 0 just before.
    pair = make_pairs(np.random.default_rng(25), 1, SEQPAR_LEN)
    batch = pack_batch(pair, batch_size=8)
    args_ = (batch.query, batch.db, batch.query_len, batch.db_len)
    kern.launches = 0
    t0 = time.perf_counter()
    fin = par.seqpar_fill(*args_, mesh=mesh, tile_lanes=SEQPAR_TILE)
    out.update(call_ms=(time.perf_counter() - t0) * 1e3,
               launches=kern.launches, finals=fin[:1].tolist(),
               shape=dict(kern.last_launch))
    calls, launch_ms = [], []
    for _ in range(N_RANK_RACE):
        t0 = time.perf_counter()
        again = par.seqpar_fill(*args_, mesh=mesh, tile_lanes=SEQPAR_TILE)
        calls.append((time.perf_counter() - t0) * 1e3)
        launch_ms.append(kern.last_launch["launch_ms"])
        check(np.array_equal(again, fin), f"rank {rank}: a repeated "
              "seqpar_fill of the 200 kb pair differs")
    out.update(race_call_ms=calls, race_launch_ms=launch_ms,
               race_relay=kern.last_launch["relay"],
               race_skew_ms=kern.last_launch["launch_skew_ms"])
    say(f"the {SEQPAR_LEN} bp pair: finals {fin[0].tolist()}, "
        f"{out['launches']} launches, the call {out['call_ms']:.1f} ms, "
        f"again {[round(c, 1) for c in calls]} ms, launches {launch_ms} "
        f"ms, relay {out['race_relay']}, launch skew "
        f"{out['race_skew_ms']:.3f} ms")

    # 3. seqpar_align on batch A's pair 0.
    A, _B = long_batches()
    s1, s2 = A[0]
    counted = (kern, nw_banded_diag.banded_diag_fill_cuda,
               traceback_device.walk_banded_cuda)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    score, a1, a2 = par.seqpar_align(s1, s2, mesh=mesh)
    secs = time.perf_counter() - t0
    check(a1 is not None and a1.replace("-", "").encode() == s1
          and a2.replace("-", "").encode() == s2,
          f"rank {rank}: seqpar_align's alignment does not consume both "
          "sequences")
    check(affine_score(a1, a2, ScoringScheme(), False, True) == score,
          f"rank {rank}: seqpar_align's alignment does not rescore to "
          f"{score}")
    out["align"] = dict(score=score, seconds=secs, launches={
        "seqpar_shard": kern.launches,
        "nw_banded_diag_fill": counted[1].launches,
        "walk_banded": counted[2].launches})
    say(f"seqpar_align on batch A's pair 0: score {score}, the alignment "
        f"consumes both sequences and rescores to it; {secs:.3f} s")

    # 4. Rank 0 withholds its columns: both ranks must raise.
    relay.RELAY_TIMEOUT_S = SEQPAR_WITHHOLD_S
    if rank == 0:
        relay.ColumnRelay._send_loop = lambda self, peer, edges: None
    small = pack_batch([(b"ACGT" * 50, b"ACGTT" * 120)], batch_size=8)
    t0 = time.perf_counter()
    raised = None
    try:
        par.seqpar_fill(small.query, small.db, small.query_len, small.db_len,
                        mesh=mesh, tile_lanes=128)
    except RuntimeError as e:
        raised = str(e)
    secs = time.perf_counter() - t0
    check(raised is not None, f"rank {rank}: a withheld relay did not "
          "raise")
    if rank == 1:
        check("from rank 0" in raised and "shard" in raised,
              f"rank 1's error does not name the shards and rank 0: "
              f"{raised}")
    out["withheld"] = dict(message=raised, seconds=secs)
    say(f"rank 0 withholding its columns: raised after {secs:.2f} s: "
        f"{raised}")
    out["seconds"] = time.perf_counter() - t_start
    with open(args.seqpar_out, "w") as f:
        json.dump(out, f)
    sys.stdout.flush()
    # A withheld relay leaves a receiver thread waiting inside Gloo: end
    # the process without tearing the group down.
    os._exit(0)


def phase_seqpar_ranks(torch, port, by_path):
    """Sequence parallelism across SEQPAR_RANKS processes on the one card:
    the expectations from this process (kernel #4 on the 200 kb pair and
    on batch A's pair 0, seqpar_fill over the same 4 shards), then the
    ranks (seqpar_rank), their results held against them."""
    import socket

    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    tiled, par = port["tiled"], port["parallel"]
    a = (ScoringScheme(), True, False)
    pair = make_pairs(np.random.default_rng(25), 1, SEQPAR_LEN)
    f4 = tiled.tiled_fill_cuda(*to_device(pack_batch(pair, batch_size=1),
                                          "cuda"), *a).cpu().numpy()
    batch = pack_batch(pair, batch_size=8)
    one = par.seqpar_fill(batch.query, batch.db, batch.query_len,
                          batch.db_len, mesh=["cuda:0"] * (
                              SEQPAR_RANKS * SEQPAR_RANK_SHARDS),
                          tile_lanes=SEQPAR_TILE)[:1]
    A, _B = long_batches()
    exact = int(tiled.tiled_fill_cuda(*to_device(
        pack_batch([A[0]], batch_size=1), "cuda"), *a)[0].max())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    res = []
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for r in range(SEQPAR_RANKS):
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seqpar-rank",
                 str(r), "--seqpar-port", str(port_no), "--seqpar-out",
                 os.path.join(tmp, f"rank{r}.json")],
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT))
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, SEQPAR_RANKS_TIMEOUT_S
                                   - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            text = f.read()
            f.close()
            for line in text.splitlines():
                if line.startswith("[26 "):
                    log(line)
            check(p.returncode == 0, f"seqpar rank {r} exited "
                  f"{p.returncode}:\n{text[-4000:]}")
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    path = f"seqpar_fill {SEQPAR_LEN} bp x {SEQPAR_LEN} bp, {SEQPAR_RANKS} "\
        f"ranks x {SEQPAR_RANK_SHARDS} shards of one card"
    apath = f"seqpar_align batch A pair 0, {SEQPAR_RANKS} ranks x "\
        f"{SEQPAR_RANK_SHARDS} shards of one card"
    err = 0
    for r, got in enumerate(res):
        e = int(np.abs(np.array(got["finals"]) - f4).max())
        err = max(err, e)
        check(e == 0, f"rank {r}: the 200 kb pair's finals {got['finals']} "
              f"!= kernel #4's {f4.tolist()}")
        check(np.array_equal(np.array(got["finals"]), one),
              f"rank {r}: finals != the one-process seqpar_fill's")
        check(got["launches"] == SEQPAR_RANK_SHARDS,
              f"rank {r}: {got['launches']} shard launches on {path}")
        check(got["align"]["score"] == exact, f"rank {r}: seqpar_align "
              f"scored {got['align']['score']}, kernel #4 {exact}")
        check(got["withheld"]["seconds"] < SEQPAR_WITHHOLD_S + 40,
              f"rank {r}: the withheld relay raised after "
              f"{got['withheld']['seconds']:.1f} s")
        for k, n in got["align"]["launches"].items():
            check(n > 0, f"rank {r}: {apath} never launched {k}")
            by_path.setdefault(k, {})[apath] = \
                by_path.get(k, {}).get(apath, 0) + n
    by_path.setdefault("seqpar_shard", {})[path] = sum(
        got["launches"] for got in res)
    launch_ms = [ms for got in res for call in got["race_launch_ms"]
                 for ms in call]
    meas = dict(
        seqpar_ranks_ms=max(launch_ms),
        seqpar_ranks_launch_ms=[got["race_launch_ms"] for got in res],
        seqpar_ranks_call_ms=[got["race_call_ms"] for got in res],
        seqpar_ranks_first_call_ms=[got["call_ms"] for got in res],
        seqpar_ranks_relay=[got["race_relay"] for got in res],
        seqpar_ranks_skew_ms=[got["race_skew_ms"] for got in res],
        seqpar_ranks_align_s=[got["align"]["seconds"] for got in res],
        seqpar_ranks_withheld_s=[got["withheld"]["seconds"] for got in res],
        seqpar_ranks_rank_s=[got["seconds"] for got in res],
        seqpar_ranks_err=err)
    log(f"[26 seqpar ranks] {path}: every rank's finals equal kernel #4's "
        f"and the one-process seqpar_fill's; the launches "
        f"{meas['seqpar_ranks_launch_ms']} ms (the ranks time-slice the "
        f"one card: a correctness run, not a speed across hosts), the "
        f"calls {meas['seqpar_ranks_call_ms']} ms, relay messages "
        f"{meas['seqpar_ranks_relay']}, launch skew "
        f"{meas['seqpar_ranks_skew_ms']} ms; seqpar_align score {exact} on "
        f"every rank; the withheld relay raised after "
        f"{meas['seqpar_ranks_withheld_s']} s; the ranks "
        f"{meas['seqpar_ranks_rank_s']} s")
    return meas


def escape_pair(length, seed):
    """A pair that escapes band BAND: `length` bp at ~1% substitutions,
    the mutant with MM_EXCURSION random bp inserted at a third of its
    length and as many deleted 2 kb on (seeds seed, seed + 1)."""
    mut, ref = make_pairs(np.random.default_rng(seed), 1, length)[0]
    ins = bytes(np.random.default_rng(seed + 1).choice(
        list(b"ACGT"), MM_EXCURSION).astype(np.uint8))
    at = length // 3
    return (mut[:at] + ins + mut[at:at + 2000]
            + mut[at + 2000 + MM_EXCURSION:], ref)


def mm_bound(nodes):
    """The row kernel's bound for a level's nodes [(fwd, rev, n)]: their
    query and db codes read and their four rows written once,
    OPS_PER_CELL["mm rows"] a cell; and the level's cells."""
    cells = sum((f[1] + r[1]) * (n + 1) for f, r, n in nodes)
    moved = sum(4 * (f[1] + r[1] + 2 * (n + 1) + 4 * (n + 1))
                for f, r, n in nodes)
    return bound(moved, cells * OPS_PER_CELL["mm rows"]) + (cells,)


def mm_scratch(torch, lib, mm, nodes, copies=1):
    """sa_mm_rows' buffers for a level, planned by sa_mm_rows_plan:
    `copies` zeroed ctr and bnd buffers (a launch each), one out, the
    planned table on the card; the lanes a thread and the tickets."""
    plan = mm.plan_level(nodes, lib)
    n_ctr, n_bnd, n_out, tickets = plan.words
    ctrs = [torch.zeros(n_ctr, dtype=torch.int32, device="cuda")
            for _ in range(copies)]
    bnds = [torch.zeros(n_bnd, dtype=torch.int32, device="cuda")
            for _ in range(copies)]
    out = torch.empty(n_out, dtype=torch.int32, device="cuda")
    tab = torch.from_numpy(plan.table).to("cuda")
    return dict(ctrs=ctrs, bnds=bnds, out=out, tab=tab, lanes=plan.lanes,
                tickets=tickets, count=len(nodes))


def mm_launch(torch, lib, sq, buf, k):
    """One sa_mm_rows launch of a planned level on the current stream, with
    the buffers' k-th ctr and bnd, past the wrapper (not counted as a
    launch of the path)."""
    s = sq.scheme
    rc = lib.sa_mm_rows(
        *(t.data_ptr() for t in (sq.qf, sq.qr, sq.df, sq.dr)),
        buf["tab"].data_ptr(), buf["count"], buf["lanes"], buf["tickets"],
        buf["out"].data_ptr(), buf["bnds"][k].data_ptr(),
        buf["ctrs"][k].data_ptr(),
        s.match_, s.mismatch, s.gap_open, s.gap_extend,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"sa_mm_rows launch failed ({rc})")


def mm_launch_ms(torch, lib, mm, sq, nodes, repeats=3):
    """Mean CUDA-event milliseconds of the sa_mm_rows launch of a level
    alone (after one warm-up launch), its buffers allocated, planned and
    zeroed before the events, a fresh ctr and bnd a launch; and the rows it
    computed, flat."""
    buf = mm_scratch(torch, lib, mm, nodes, repeats + 1)
    mm_launch(torch, lib, sq, buf, 0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(1, repeats + 1):
        mm_launch(torch, lib, sq, buf, k)
    end.record()
    torch.cuda.synchronize()
    check(all(int(c[1]) == 0 for c in buf["ctrs"]), "sa_mm_rows: a timed "
          "launch stalled")
    return start.elapsed_time(end) / repeats, buf["out"].cpu()


def mm_rows_check(torch, port, short_pair, long_pair):
    """The Myers-Miller row kernel (both sweeps of every node of a level a
    launch) against its plain version on the card, every column of every
    node's four rows, on single nodes, a level of nodes of different
    widths and heights and a level whose strips outnumber the grid's
    warps; a hand-over that cannot be met; and the launch's time at the two
    escapes' top nodes and on that wide level."""
    from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
    from sequencealigning_tpu_torch.io.encode import encode_seq

    mm = port["mm"]
    lib = port["csrc"].kernels()

    def seqs(pair, scheme=ScoringScheme()):
        q, d = (np.asarray(encode_seq(x), np.int32) for x in pair)
        return mm._Seqs(q, d, scheme, "cuda")

    o = ScoringScheme().gap_open
    short, longs = seqs(short_pair), seqs(long_pair)
    level = [longs.node(qa, qa + 2 * rows, da, da + cols, o * tb, o * te)
             for qa, rows, da, cols, tb, te in MM_LEVEL]
    wide_level = [longs.node(k * 4 * MM_WIDE_LEVEL_ROWS,
                             (k * 4 + 2) * MM_WIDE_LEVEL_ROWS, 0, longs.n0,
                             o, o)
                  for k in range(MM_WIDE_LEVEL)]
    cases = [
        ("the short escape's top node", short,
         [short.node(0, short.m0, 0, short.n0, o, o)]),
        (f"mid: {MM_MID_ROWS} rows a sweep x {MM_MID_COLS + 1} columns",
         longs, [longs.node(0, 2 * MM_MID_ROWS, 0, MM_MID_COLS, o, o)]),
        (f"wide: {MM_WIDE_ROWS} rows a sweep x {longs.n0 + 1} columns",
         longs, [longs.node(0, 2 * MM_WIDE_ROWS, 0, longs.n0, o, o)]),
        (f"tall: {MM_TALL_ROWS} rows a sweep x {MM_TALL_COLS + 1} columns",
         longs, [longs.node(1000, 1000 + 2 * MM_TALL_ROWS, 500,
                            500 + MM_TALL_COLS, o, 0)]),
        (f"a level of {len(level)} nodes, {min(n for *_x, n in level) + 1}-"
         f"{max(n for *_x, n in level) + 1} columns", longs, level),
        (f"a level of {MM_WIDE_LEVEL} nodes of {MM_WIDE_LEVEL_ROWS} rows a "
         f"sweep x {longs.n0 + 1} columns", longs, wide_level),
    ]
    rng = np.random.default_rng(18)
    for k in range(MM_SCHEMES):
        sch = ScoringScheme(match_=int(rng.integers(1, 9)),
                            mismatch=-int(rng.integers(1, 12)),
                            gap_open=-int(rng.integers(0, 13)),
                            gap_extend=-int(rng.integers(1, 8)))
        sq = seqs(long_pair, sch)
        lo, hi = MM_SCHEME_WIDTHS[k % len(MM_SCHEME_WIDTHS)]
        width = int(rng.integers(lo, min(hi, sq.n0) + 1))
        da = int(rng.integers(0, sq.n0 - width + 1))
        qa = int(rng.integers(0, sq.m0 - MM_SCHEME_ROWS))
        cases.append((f"scheme {sch.match_}/{sch.mismatch}/{sch.gap_open}/"
                      f"{sch.gap_extend}, {width + 1} columns", sq,
                      [sq.node(qa, qa + MM_SCHEME_ROWS, da, da + width,
                               sch.gap_open, 0)]))
    errs, below, first, lanes_seen, done = [], False, None, set(), []
    for name, sq, nodes in cases:
        seq4 = (sq.qf, sq.qr, sq.df, sq.dr)
        got = mm.mm_rows_cuda(*seq4, nodes, sq.scheme)
        first = got if first is None else first
        shape = dict(mm.mm_rows_cuda.last_launch)
        lanes_seen.add(shape["lanes_per_thread"])
        if nodes is wide_level:
            wide_warps = shape["warps"]
        plain_ms, want = host_ms(torch, lambda: [
            mm.node_rows_torch(*seq4, *node, sq.scheme) for node in nodes])
        err = max(int((g - w.cpu()).abs().max()) for g, w in zip(got, want))
        errs.append(err)
        check(err == 0, f"mm_rows kernel != plain on {name}: err {err}")
        low = min(int(w.min()) for w in want)
        below |= low < NEG_INF
        done.append(dict(case=name, lowest=low, plain_ms=plain_ms, **shape))
        log(f"[15 long] mm_rows on {name} ({shape['warps']} warps, "
            f"{shape['lanes_per_thread']} lanes a thread): equal to the "
            f"plain version on every column of every node, lowest value "
            f"{low}; plain {plain_ms:.1f} ms")
    check(below, "no mm_rows case fell below NEG_INF")
    check(lanes_seen == {16}, f"the mm_rows cases ran the instances "
          f"{sorted(lanes_seen)}, not 16 lanes a thread")
    # A hand-over that cannot be met (tickets from 2: the level's first
    # node's strips 0 never run) must set the status word, not hang; the
    # next launch is right again.
    buf = mm_scratch(torch, lib, mm, level)
    buf["ctrs"][0][0] = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mm_launch(torch, lib, longs, buf, 0)
    torch.cuda.synchronize()
    stall_s = time.perf_counter() - t0
    status = int(buf["ctrs"][0][1])
    check(status != 0,
          "mm_rows: a level's hand-over that cannot be met set no status")
    seq4 = (short.qf, short.qr, short.df, short.dr)
    check(torch.equal(mm.mm_rows_cuda(*seq4, cases[0][2], short.scheme)[0],
                      first[0]),
          "mm_rows: the launch after a stalled one differs")
    log(f"[15 long] mm_rows on the level of {len(level)} nodes with its "
        f"first node's strips 0 unrun set its status word ({status}) after "
        f"{stall_s:.2f} s; the next launch equals the first")
    wide_ms, _rows = mm_launch_ms(torch, lib, mm, longs, wide_level)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[15 long] mm_rows on the level of {MM_WIDE_LEVEL} nodes across "
        f"the long pair's db ({wide_warps} strips, {sms} SMs): the launch "
        f"{wide_ms:.3f} ms")
    out = {"mm_rows_errs": errs, "mm_rows_cases": done,
           "mm_rows_stall_s": stall_s, "mm_wide_level_ms": wide_ms}
    for tag, sq, plain in (("mm_top_short", short, True),
                           ("mm_top_long", longs, False)):
        nodes = [sq.node(0, sq.m0, 0, sq.n0, o, o)]
        seq4 = (sq.qf, sq.qr, sq.df, sq.dr)
        ms, rows = mm_launch_ms(torch, lib, mm, sq, nodes)
        call_ms = cuda_ms(torch, lambda: mm.mm_rows_cuda(*seq4, nodes,
                                                         sq.scheme))
        check(torch.equal(rows.view(4, -1),
                          mm.mm_rows_cuda(*seq4, nodes, sq.scheme)[0]),
              f"mm_rows at the {tag[7:]} top node: the timed launch != the "
              "wrapper's")
        shape = dict(mm.mm_rows_cuda.last_launch)
        b_ms, b_by, cells = mm_bound(nodes)
        (fwd, rev, n), = nodes
        out.update({f"{tag}_ms": ms, f"{tag}_call_ms": call_ms,
                    f"{tag}_bound_ms": b_ms, f"{tag}_bound_by": b_by,
                    f"{tag}_shape": shape})
        line = (f"[15 long] mm_rows at the {tag[7:]} escape's top node "
                f"({fwd[1]} + {rev[1]} rows x {n + 1} columns, "
                f"{shape['lanes_per_thread']} lanes a thread, "
                f"{shape['warps']} warps): the launch {ms:.3f} ms, the call "
                f"{call_ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS, "
                f"{100 * b_ms / ms:.2f}% of its bound {b_ms:.4f} ms, {b_by})")
        if plain:
            plain_ms, _ = host_ms(torch, lambda: mm.node_rows_torch(
                *seq4, *nodes[0], sq.scheme))
            out[f"{tag}_plain_ms"] = plain_ms
            line += f"; plain {plain_ms:.1f} ms"
        log(line)
    return out


def mm_escape(torch, port, by_path, tag, pair, was):
    """One escape pair through GotohAligner on cuda, its long path starting
    at 4096 lanes and stopping at band BAND: it must reach Myers-Miller on
    the card, launch the row kernel, and rescore to the tiled exact score.
    Its seconds split into the level calls (launch, kernel and copy),
    _direct_ops, the rest of mm_align, and the path before it; then each
    level's launch alone is timed on its recorded nodes."""
    from sequencealigning_tpu_torch.config import (
        AlignConfig,
        Algo,
        ScoringScheme,
    )
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import encode_seq, pack_batch
    from sequencealigning_tpu_torch.models import gotoh as gotoh_mod

    mm = port["mm"]
    cfg = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True)
    aligner = port["models"].GotohAligner(cfg, "cuda")
    aligner.long_pair_lanes = min(aligner.long_pair_lanes, 4096)
    aligner.long_pair_max_band = BAND
    tb = to_device(pack_batch([pair]), "cuda")
    exact = int(port["tiled"].tiled_fold_fill_cuda(*tb, ScoringScheme(),
                                                   True, False).max())
    spent = {"rows": [0.0, 0], "direct": [0.0, 0], "mm_align": [0.0, 0]}
    devices, levels = [], []

    def clocked(key, fn):
        def run(*a, **k):
            if key == "mm_align":
                devices.append(str(k.get("device")))
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key][0] += time.perf_counter() - t0
                spent[key][1] += 1
                if key == "rows":
                    levels.append(dict(
                        node_list=list(a[4]), call_s=time.perf_counter() - t0,
                        **mm.mm_rows_cuda.last_launch))
        return run

    real = (mm.level_rows, mm._direct_ops, gotoh_mod.mm_align)
    mm.level_rows = clocked("rows", real[0])
    mm._direct_ops = clocked("direct", real[1])
    gotoh_mod.mm_align = clocked("mm_align", real[2])
    path = ("long pairs, Myers-Miller escape"
            + (" at batch A's length" if tag == "mm_escape_long" else ""))
    try:
        with path_launches(port, by_path, path):
            t0 = time.perf_counter()
            res = aligner.align_batch(records([pair]))
            secs = time.perf_counter() - t0
    finally:
        mm.level_rows, mm._direct_ops, gotoh_mod.mm_align = real
    check(devices == ["cuda"], f"{path}: the pair did not reach Myers-Miller "
          f"on the card: {devices}")
    launches = by_path.get("mm_rows", {}).get(path, 0)
    check(launches == len(levels) > 0,
          f"{path} launched mm_rows {launches} times over {len(levels)} "
          "levels")
    check_results(res, [pair], cfg.scoring, path, compat=True)
    check(res[0].score == exact, f"{path}: score {res[0].score} != {exact}")
    rows_s, direct_s, mm_s = (spent[k][0] for k in ("rows", "direct",
                                                    "mm_align"))
    split = dict(total_s=secs, rows_s=rows_s, levels=spent["rows"][1],
                 nodes=sum(v["nodes"] for v in levels),
                 direct_ops_s=direct_s, leaves=spent["direct"][1],
                 mm_rest_s=mm_s - rows_s - direct_s, before_mm_s=secs - mm_s)
    log(f"[15 long] {path}: {len(pair[0])} x {len(pair[1])} bp in "
        f"{secs:.3f} s{was}: level rows {rows_s:.3f} s ({split['levels']} "
        f"launches with their copies, {split['nodes']} nodes), _direct_ops "
        f"{direct_s:.3f} s ({split['leaves']} leaves), the rest of mm_align "
        f"{split['mm_rest_s']:.3f} s, the path before it "
        f"{split['before_mm_s']:.3f} s; the alignment rescores to the exact "
        f"score {exact}")
    # Each level's launch alone, on the nodes it was given.
    lib = port["csrc"].kernels()
    q, d = (np.asarray(encode_seq(x), np.int32) for x in pair)
    sq = mm._Seqs(q, d, ScoringScheme(), "cuda")
    for k, lv in enumerate(levels):
        ms, _rows = mm_launch_ms(torch, lib, mm, sq, lv["node_list"])
        b_ms, b_by, cells = mm_bound(lv.pop("node_list"))
        lv.update(ms=ms, bound_ms=b_ms, bound_by=b_by, cells=cells)
        log(f"[15 long] {path}, level {k}: {lv['nodes']} nodes, "
            f"{min(lv['columns'])}-{max(lv['columns'])} columns, "
            f"{lv['lanes_per_thread']} lanes a thread, {lv['warps']} warps: "
            f"the launch {ms:.3f} ms ({100 * b_ms / ms:.1f}% of its bound "
            f"{b_ms:.4f} ms, {b_by}), the call {1e3 * lv['call_s']:.3f} ms")
    split["launches_ms"] = sum(lv["ms"] for lv in levels)
    log(f"[15 long] {path}: the {len(levels)} level launches alone "
        f"{split['launches_ms']:.3f} ms")
    return {f"{tag}_s": secs, f"{tag}_split": split, f"{tag}_levels": levels}


def long_walk(torch, port, pairs, fill_out, plan, name, band):
    """The banded walk alone on a long batch's banded fill (finals, fast4
    dirs): timed, held against its plain version, its slow-path reads
    counted."""
    walk = port["walk"]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    finals, dirs = fill_out
    n1s = np.asarray([len(a) for a, _ in pairs], np.int32)
    n2s = np.asarray([len(b) for _, b in pairs], np.int32)
    seeds = [put(n2s), put(n1s), put(walk.seed_planes(finals.cpu().numpy())),
             put(np.arange(len(pairs)))]
    a = (plan.k_lo_even, int((n1s + n2s).max()))
    ms = cuda_ms(torch, lambda: walk.walk_banded_cuda(dirs, *seeds, *a))
    slow = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = walk.walk_banded_cuda(dirs, *seeds, *a, slow=slow)
    plain_ms, want = host_ms(
        torch, lambda: walk.walk_banded_torch(dirs, *seeds, *a))
    err = walk_diff(torch, got, want)
    check(err == 0, f"banded walk kernel != plain at batch {name}: err {err}")
    check(bool(((got[0] == 0) & (got[1] == 0)).all()),
          f"a banded walk of batch {name} did not reach the origin")
    b_ms, b_by = walk_bound("walk_banded", got, seeds)
    steps = int(got[3].sum())
    longest = int(got[3].max())
    log(f"[15 long] batch {name}'s banded walk (band {band}, L={plan.L}): "
        f"{ms:.3f} ms, {ms * 1e6 / longest:.1f} ns a step of the longest "
        f"walk ({longest} steps), {int(slow)} slow-path words in {steps} "
        f"steps; plain {plain_ms:.1f} ms, equal; bound {b_ms:.4f} ms "
        f"({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=b_ms,
                bound_by=b_by, band=band, steps=steps, longest=longest,
                slow=int(slow), ns_per_step=ms * 1e6 / longest)


def long_banded_fills(torch, port, A, B):
    """Kernel #3 at the long-pair path's shapes: batch B's band 128 (the
    first round of both its paths) against the plain version (finals and
    the whole dirs tensor), then N_RACE more launches, each equal to the
    first (the race check), each pair on at least 32 SMs; then each of
    batch A's band rounds (bands 128, 256, 512) timed on its own.  The
    banded walk alone on batch B's band 128 and batch A's band 512."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    banded = port["banded"]
    meas = {}

    def timed_fill(ins, a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = banded.banded_diag_fill_cuda(*ins, *a)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), got

    tb = to_device(pack_batch(B, batch_size=len(B)), "cuda")
    plan, ins = banded.band_inputs(*tb, BAND)
    a = (plan, ScoringScheme(), True, False, "fast4")
    first_ms, first = timed_fill(ins, a)
    shape = dict(banded.banded_diag_fill_cuda.last_launch)
    t0 = time.perf_counter()
    fp, dp = banded.banded_diag_fill_torch(*ins, *a)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max(int((first[0] - fp).abs().max()), 0 if torch.equal(
        first[1].view(torch.int32), dp.view(torch.int32)) else 1)
    del fp, dp
    check(err == 0, f"batch B's banded fill != plain: err {err}")
    log(f"[15 long] batch B's band {BAND} fill (L={plan.L}, "
        f"{plan.n_need} iterations): finals and the whole dirs tensor "
        f"({first[1].numel() * 4 / 1e9:.2f} GB) equal the plain version "
        f"(graph-replayed, {plain_s:.1f} s)")
    times = []
    for _ in range(N_RACE):
        ms, got = timed_fill(ins, a)
        times.append(ms)
        check(torch.equal(got[0], first[0]) and torch.equal(
            got[1].view(torch.int32), first[1].view(torch.int32)),
            "race: a launch of the banded fill at batch B differs from the "
            "first")
        del got
    ms = sum(times) / len(times)
    band_cells = sum(len(y) for _, y in B) * (plan.k_hi_eff - plan.k_lo + 1)
    lane_steps = len(B) * 2 * plan.n_need * plan.L
    b_ms, b_by = bound(nbytes(*ins, *first), band_cells * OPS_PER_CELL["fast4"])
    meas["bwalkB"] = long_walk(torch, port, B, first, plan, "B", BAND)
    del first
    per_pair = shape["sms_per_pair"]
    check(min(per_pair) >= 32, f"batch B: the banded fill's pairs ran on "
          f"{per_pair} SMs")
    log(f"[15 long] race check: {N_RACE} more launches of the banded fill at "
        f"batch B, each equal to the first: {ms:.3f} ms mean "
        f"({min(times):.3f}-{max(times):.3f}; first {first_ms:.3f}), "
        f"{band_cells / ms / 1e6:.1f} band GCUPS, "
        f"{lane_steps / ms / 1e6:.1f} G lane-steps/s, {100 * b_ms / ms:.1f}% "
        f"of its bound {b_ms:.3f} ms ({b_by}); {tile_line(shape)}, a pair on "
        f"{per_pair} SMs")
    meas.update(bfillB_ms=ms, bfillB_first_ms=first_ms, bfillB_race_ms=times,
                bfillB_plain_ms=plain_s * 1e3, bfillB_err=err,
                bfillB_bound_ms=b_ms, bfillB_bound_by=b_by,
                bfillB_lanes=plan.L, bfillB_shape=shape,
                bfillB_gcups=band_cells / ms / 1e6,
                bfillB_pct_of_bound=100 * b_ms / ms)
    del ins
    tb = to_device(pack_batch(A, batch_size=len(A)), "cuda")
    rounds = {}
    for band in (BAND, 2 * BAND, 4 * BAND):
        plan, ins = banded.band_inputs(*tb, band)
        a = (plan, ScoringScheme(), True, False, "fast4")
        timed_fill(ins, a)
        ms, got = timed_fill(ins, a)
        shape = dict(banded.banded_diag_fill_cuda.last_launch)
        band_cells = sum(len(y) for _, y in A) * (
            plan.k_hi_eff - plan.k_lo + 1)
        b_ms, b_by = bound(nbytes(*ins, *got), band_cells
                           * OPS_PER_CELL["fast4"])
        rounds[band] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                            lanes=plan.L, shape=shape)
        log(f"[15 long] batch A's band {band} round (L={plan.L}): banded fill "
            f"{ms:.3f} ms, {band_cells / ms / 1e6:.1f} band GCUPS, bound "
            f"{b_ms:.3f} ms ({b_by}); {tile_line(shape)}")
        if band == 4 * BAND:
            meas["bwalkA"] = long_walk(torch, port, A, got, plan, "A", band)
        del got, ins
    meas["bfillA_rounds"] = rounds
    torch.cuda.empty_cache()
    return meas


def phase_gotoh_fill(torch, port, pairs, stream_finals):
    """Kernel #7 (the per-pair global fill) against its plain version on
    ragged batches (score-only and full dirs, compat and textbook with
    wildcard, split as planned and over CTAs of 128 lanes); at the main
    shape in the runner's plain layout, score-only against its plain
    version on the card and against the streamed kernel's finals; then
    with full dirs on the first N_GOTOH_DIRS pairs, the host walker on its
    dirs against the co-optimal path; score-only at 1, 4 and 31 pairs of
    the main length, timed.  Dirs are held equal on every cell of each
    pair and 0 on every other byte (pair_dirs_diff)."""
    from sequencealigning_tpu_torch.config import AlignConfig, Algo
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops.traceback import traceback_pair

    nw = port["nw"]
    t0 = time.perf_counter()
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    rng = np.random.default_rng(27)
    rerr, runs = 0, 0
    for n, hi in ((24, 300), (9, 700)):
        rp = skewed_pairs(rng, n, 0, hi, 0, hi, b"ACGTN") + [
            (b"", b"ACGTA" * 9), (b"GATTACA" * 11, b"")]
        tb = to_device(pack_batch(rp, batch_size=len(rp)), "cuda")
        ins = (tb.query.contiguous(),
               *nw.gotoh_layout(tb.db, tb.query_len, tb.db_len))
        n1s, n2s = tb.query_len.cpu().numpy(), tb.db_len.cpu().numpy()
        for compat, wc in ((True, False), (False, True)):
            for dirs in (False, True):
                a = (tb.query.shape[1], tb.db.shape[1],
                     wild if wc else ScoringScheme(), compat, wc, dirs)
                fp, dp = nw.gotoh_fill_torch(*ins, *a)
                for cta in (0, 128):
                    fk, dk = nw.gotoh_fill_cuda(*ins, *a, cta_lanes=cta)
                    e = int((fk - fp).abs().max())
                    if dirs:
                        e = max(e, pair_dirs_diff(torch, dk, dp, n1s, n2s))
                    check(e == 0, f"kernel #7 != plain ({len(rp)} pairs <= "
                          f"{hi} bp, compat={compat}, wildcard={wc}, "
                          f"dirs={dirs}, cta {cta}): err {e}")
                    rerr, runs = max(rerr, e), runs + 1
    log(f"[16 gotoh fill] {runs} ragged configurations (<= 700 bp, empty "
        "sides, split as planned and over CTAs of 128 lanes) equal on "
        "finals and on every cell's direction bytes, 0 elsewhere")

    batch = pack_batch(pairs, batch_size=len(pairs))
    tb = to_device(batch, "cuda")
    q = tb.query.contiguous()
    s2v, dsum, n2mask = nw.gotoh_layout(tb.db, tb.query_len, tb.db_len)
    L1, L2 = batch.query.shape[1], batch.db.shape[1]
    a = (L1, L2, ScoringScheme(), True, False)
    ins = (q, s2v, dsum, n2mask)
    ms = cuda_ms(torch, lambda: nw.gotoh_fill_cuda(*ins, *a, False))
    fk, _ = nw.gotoh_fill_cuda(*ins, *a, False)
    shape = dict(nw.gotoh_fill_cuda.last_launch)
    plain_ms, (fp, _) = host_ms(torch, lambda: nw.gotoh_fill_torch(
        *ins, *a, False))
    err = int((fk - fp).abs().max())
    check(err == 0, f"kernel #7 != plain at the main shape: err {err}")
    stream_err = int((fk - stream_finals).abs().max())
    check(stream_err == 0, "kernel #7's finals != the streamed kernel's at "
          f"the main shape: err {stream_err}")
    cells = int((batch.query_len.astype(np.int64)
                 * batch.db_len.astype(np.int64)).sum())
    b_ms, b_by = bound(nbytes(*ins, fk), cells * OPS_PER_CELL["score"])
    log(f"[16 gotoh fill] {len(pairs)} x {LEN_MAIN} bp score-only (P="
        f"{s2v.shape[1]}, D_total={L1 + L2 + 1}, {pair_line(shape)}): "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{cells / ms / 1e6:.2f} GCUPS, bound {b_ms:.3f} ms ({b_by}); "
        "finals equal the plain version and the streamed kernel's")
    out = {"gfill_ms": ms, "gfill_plain_ms": plain_ms,
           "gfill_err": max(err, rerr), "gfill_stream_err": stream_err,
           "gfill_bound_ms": b_ms, "gfill_bound_by": b_by,
           "gfill_gcups": cells / ms / 1e6, "gfill_launch": shape}

    n = N_GOTOH_DIRS
    sub = tuple(t[:n].contiguous() for t in ins)
    ms_d = cuda_ms(torch, lambda: nw.gotoh_fill_cuda(*sub, *a, True),
                   repeats=1)
    fkd, dkd = nw.gotoh_fill_cuda(*sub, *a, True)
    plain_d_ms, (fpd, dpd) = host_ms(torch, lambda: nw.gotoh_fill_torch(
        *sub, *a, True))
    err_d = max(int((fkd - fpd).abs().max()), pair_dirs_diff(
        torch, dkd, dpd, batch.query_len[:n], batch.db_len[:n]))
    del dpd
    check(err_d == 0, f"kernel #7 with full dirs != plain: err {err_d}")
    cells_d = int((batch.query_len[:n].astype(np.int64)
                   * batch.db_len[:n].astype(np.int64)).sum())
    bd_ms, bd_by = bound(nbytes(*sub, fkd, dkd),
                         cells_d * OPS_PER_CELL["full"])
    # The host walker on kernel #7's dirs against the co-optimal path (the
    # streamed full fill and the same walker) on sampled pairs.
    idx = np.random.default_rng(3).choice(n, N_GOTOH_WALK, replace=False)
    dirs_h = dkd.view(torch.int32)[:, torch.as_tensor(
        idx, device=dkd.device), :].cpu().numpy().view(np.uint32)
    fin_h = fkd.cpu().numpy()
    dirs_gb = dkd.numel() * 4 / 1e9
    del dkd
    aligner = port["models"].GotohAligner(
        AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH), "cuda")
    res = aligner.align_batch(records([pairs[i] for i in idx]))
    for j, i in enumerate(idx):
        score, alns = traceback_pair(dirs_h[:, j, :], fin_h[i], *pairs[i])
        check(res[j].ok and score == res[j].score
              and alns == res[j].alignments,
              f"pair {i}: host walk of kernel #7's dirs != the co-optimal "
              "path's alignments")
    log(f"[16 gotoh fill] {n} x {LEN_MAIN} bp full dirs ({dirs_gb:.2f} GB):"
        f" kernel {ms_d:.3f} ms, plain {plain_d_ms:.1f} ms, bound "
        f"{bd_ms:.3f} ms ({bd_by}); finals and the direction bytes of every "
        "valid cell equal, every other byte 0; the host walker on "
        f"{N_GOTOH_WALK} sampled pairs equals the co-optimal path")
    out.update(gfill_full_ms=ms_d, gfill_full_plain_ms=plain_d_ms,
               gfill_full_err=err_d, gfill_full_bound_ms=bd_ms,
               gfill_full_bound_by=bd_by)

    # A few pairs, as a small batch of the runner's plain route.
    small = {}
    for k in (1, 4, 31):
        pk = make_pairs(np.random.default_rng(4), k, LEN_MAIN)
        tbk = to_device(pack_batch(pk, batch_size=k), "cuda")
        ins_k = (tbk.query.contiguous(),
                 *nw.gotoh_layout(tbk.db, tbk.query_len, tbk.db_len))
        a_k = (tbk.query.shape[1], tbk.db.shape[1], ScoringScheme(), True,
               False, False)
        ms_k = cuda_ms(torch, lambda: nw.gotoh_fill_cuda(*ins_k, *a_k), 5)
        fk_k, _ = nw.gotoh_fill_cuda(*ins_k, *a_k)
        shape_k = dict(nw.gotoh_fill_cuda.last_launch)
        fp_k, _ = nw.gotoh_fill_torch(*ins_k, *a_k)
        e = int((fk_k - fp_k).abs().max())
        check(e == 0, f"kernel #7 != plain at {k} x {LEN_MAIN} bp: err {e}")
        out["gfill_err"] = max(out["gfill_err"], e)
        small[k] = ms_k
        log(f"[16 gotoh fill] {k} x {LEN_MAIN} bp score-only "
            f"({pair_line(shape_k)}): kernel {ms_k:.3f} ms (mean of 5); "
            "finals equal the plain version")
    out.update(gfill_batches_ms=small,
               gfill_phase_s=time.perf_counter() - t0)
    log(f"[16 gotoh fill] phase {time.perf_counter() - t0:.1f} s")
    return out


def _aln_view(r):
    """(score, aligned query, aligned db) of an aligner result or of a
    runner's (score, [(a1, a2)]) per-pair result."""
    if isinstance(r, tuple):
        return r[0], r[1][0][0], r[1][0][1]
    return r.score, r.aligned_query, r.aligned_db


def _busy_ms(torch, prof):
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def phase_runner(torch, port, pairs, main_res, by_path, out_dir):
    """The data-parallel runner at the main shape: scores with both kernels
    (the plain one, kernel #7, is its path), its fused first-only route
    (phase 5's align_batch) against the direct route (streamed fill, then
    walk), its fused modes route against GotohAligner._modes_batch, and
    stream_align over N_STREAM batches with cigars against phase 5's
    alignments, with a checkpoint resume."""

    from torch.profiler import ProfilerActivity, profile

    from sequencealigning_tpu_torch.config import AlignConfig, Algo, Mode
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import (
        pack_batch,
        trim_for_stream,
    )
    from sequencealigning_tpu_torch.ops.traceback_device import (
        assemble_modes_alignments,
        fast4_stream_align_device,
    )

    par = port["parallel"]
    t0 = time.perf_counter()
    n = len(pairs)
    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    want = [_aln_view(r) for r in main_res]
    runner = par.DataParallelRunner(np_slots=8)
    plain = par.DataParallelRunner(kernel="plain")
    batch = pack_batch(pairs, batch_size=n)
    s_ms, fs = host_ms(torch, lambda: runner.scores(batch))
    path = "runner scores (plain kernel)"
    with path_launches(port, by_path, path):
        p_ms, fpl = host_ms(torch, lambda: plain.scores(batch))
    check(by_path.get("nw_affine_fill", {}).get(path, 0) > 0,
          "runner.scores(kernel='plain') never launched kernel #7")
    check(torch.equal(fs, fpl), "runner scores: the stream and plain "
          "kernels disagree")
    log(f"[17 runner] scores of {n} x {LEN_MAIN} bp: stream kernel "
        f"{s_ms:.1f} ms, plain kernel (#7) {p_ms:.1f} ms (host clock, "
        "batch prep included); equal")

    # The direct route (streamed fill, then the device walk) against the
    # fused route phase 5's align_batch took, both from the packed batch to
    # the decoded strings (align_batch's result building left out), timed
    # in turns: direct, fused, fused, direct.
    def direct():
        tb = to_device(trim_for_stream(pack_batch(pairs, batch_size=n)),
                       "cuda")
        res = port["fill"].nw_affine_stream_batch(*tb, with_dirs="fast4",
                                                  np_slots=8)
        alns, scores = fast4_stream_align_device(res.dirs, res.finals, s1,
                                                 s2, res.plan)
        return [None if a is None else (int(sc),) + a
                for a, sc in zip(alns, scores)]

    def fused():
        b = trim_for_stream(pack_batch(pairs, batch_size=n))
        args, plan, bp, has_n = runner._stream_args(b)
        finals, handles = runner.fill_walk_from_stream_args(
            args, plan, bp, has_n, s1, s2)
        return [_aln_view(r) for r in runner.device_walk_fast4_finish(
            handles, finals.cpu().numpy(), s1, s2)]

    times = {"direct": [], "fused": []}
    for name in ("direct", "fused", "fused", "direct"):
        ms_, got = host_ms(torch, direct if name == "direct" else fused)
        times[name].append(ms_)
        bad = [b for b in range(n) if got[b] != want[b]]
        check(not bad, f"{name} first-only route != align_batch on "
              f"{len(bad)} pairs (first {bad[:3]})")
        del got
        torch.cuda.empty_cache()
    d_ms, f_ms = (float(np.mean(times[k])) for k in ("direct", "fused"))
    runs = {k: ", ".join(f"{t:.1f}" for t in v) for k, v in times.items()}
    log(f"[17 runner] first-only, packed batch to strings: the fused route "
        f"{f_ms:.1f} ms ({runs['fused']}), the direct route (streamed fill, "
        f"then the walk) {d_ms:.1f} ms ({runs['direct']}); both "
        f"equal align_batch's (the fused route, phase 5) on all {n} pairs")

    out = {"runner_scores_stream_ms": s_ms, "runner_scores_plain_ms": p_ms,
           "first_only_fused_ms": f_ms, "first_only_direct_ms": d_ms}
    for mode in (Mode.LOCAL, Mode.SEMI_GLOBAL):
        local = mode is Mode.LOCAL
        key = "local" if local else "semi"
        torch.cuda.empty_cache()
        ref = port["models"].GotohAligner(
            AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=mode, compat=False),
            "cuda")._modes_batch(pairs)
        torch.cuda.empty_cache()
        mr = par.DataParallelRunner(np_slots=8)
        ms_, got = host_ms(torch, lambda: _runner_modes(
            mr, batch, pairs, key, assemble_modes_alignments))
        check(all(isinstance(r, tuple) for r in got),
              f"fused {key} route: a pair failed")
        ref_v = [(r["score"], r["aligned_query"], r["aligned_db"])
                 if isinstance(r, dict) else r for r in ref]
        bad = [b for b in range(n) if _aln_view(got[b]) != ref_v[b]]
        check(not bad, f"fused {key} route != _modes_batch on {len(bad)} "
              f"pairs (first {bad[:3]})")
        log(f"[17 runner] fused {key} fill+walk: {ms_:.1f} ms, equal to "
            f"GotohAligner._modes_batch on all {n} pairs")
        out[f"runner_{key}_ms"] = ms_
        del ref, got
    torch.cuda.empty_cache()

    def stream_input(nb):
        for k in range(nb):
            r = (k * 512) % n
            yield from pairs[r:] + pairs[:r]

    def checker(seen):
        def on_alignments(i, results):
            r = (i * 512) % n
            bad = [j for j, t in enumerate(results)
                   if _aln_view(t) != want[(r + j) % n]]
            check(not bad, f"stream_align batch {i}: {len(bad)} pairs differ "
                  "from align_batch")
            seen.append(i)
        return on_alignments

    seen = []
    torch.cuda.synchronize()
    ts = time.perf_counter()
    done = par.stream_align(stream_input(N_STREAM), runner, batch_size=n,
                            cigars=True, on_alignments=checker(seen))
    secs = time.perf_counter() - ts
    check(done == N_STREAM * n and seen == list(range(N_STREAM)),
          f"stream_align aligned {done} pairs in batches {seen}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        par.stream_align(stream_input(N_STREAM_PROFILE), runner,
                         batch_size=n, cigars=True,
                         on_alignments=checker([]))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - tp) * 1e3
    busy = _busy_ms(torch, prof)
    if out_dir:
        with open(os.path.join(out_dir, "profile_device_stream.txt"),
                  "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=30))
    log(f"[17 runner] stream_align, {N_STREAM} batches of {n} x {LEN_MAIN} "
        f"bp with cigars: {secs:.3f} s, {done / secs:.1f} pairs/s, every "
        f"alignment equal to align_batch's; under torch.profiler "
        f"({N_STREAM_PROFILE} batches) {prof_ms:.1f} ms, card busy "
        f"{busy:.1f} ms ({100 * busy / prof_ms:.1f}%)")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "cursor.json")
        first = []
        on_first = checker(first)

        def crash(i, results):
            on_first(i, results)
            if i == STREAM_CRASH:
                raise RuntimeError("simulated crash")

        try:
            par.stream_align(stream_input(N_STREAM), runner, batch_size=n,
                             cigars=True, checkpoint_path=ckpt,
                             on_alignments=crash)
            check(False, "the crashing stream did not raise")
        except RuntimeError as e:
            check("simulated crash" in str(e), f"stream raised {e!r}")
        with open(ckpt) as f:
            cursor = json.load(f)["next_batch"]
        resumed = []
        done = par.stream_align(stream_input(N_STREAM), runner, batch_size=n,
                                cigars=True, checkpoint_path=ckpt,
                                on_alignments=checker(resumed))
    check(cursor == STREAM_CRASH and resumed == list(range(STREAM_CRASH,
                                                           N_STREAM))
          and done == (N_STREAM - STREAM_CRASH) * n,
          f"resume from cursor {cursor} re-delivered batches {resumed}")
    log(f"[17 runner] checkpoint: a stream failing in batch {STREAM_CRASH}'s"
        f" drain left cursor {cursor}; the resume re-delivered batches "
        f"{resumed[0]}-{resumed[-1]} only, equal to align_batch's; phase "
        f"{time.perf_counter() - t0:.1f} s")
    out.update(stream_s=secs, stream_pairs_per_s=done and N_STREAM * n / secs,
               stream_profile_ms=prof_ms, stream_busy_ms=busy,
               runner_phase_s=time.perf_counter() - t0)
    return out


def _runner_modes(runner, batch, pairs, mode, assemble):
    """The runner's fused modes route on one batch: fill, end cells and
    walk queued back to back, then the finish and the assembly."""
    from sequencealigning_tpu_torch.parallel.runner import to_host

    s1 = [p[0] for p in pairs]
    s2 = [p[1] for p in pairs]
    args, plan, _b, has_n = runner._stream_args(batch)
    best, xs, ys, handles, _dirs, plan = (
        runner.fill_walk_modes_from_stream_args(args, plan, len(pairs),
                                                has_n, mode))
    walked = runner.device_walk_modes_finish(handles, s1, s2)
    return assemble(pairs, walked, to_host(best), to_host(xs), to_host(ys),
                    mode == "local")


def band_true_cells(n1s, n2s, k_lo, k_hi):
    """Cells (x, y), 1 <= x <= n2, 1 <= y <= n1, of each pair that lie in
    the band k_lo <= y - x <= k_hi, summed."""
    total = 0
    for n1, n2 in zip(n1s, n2s):
        x = np.arange(1, int(n2) + 1, dtype=np.int64)
        lo = np.maximum(1, x + k_lo)
        hi = np.minimum(int(n1), x + k_hi)
        total += int(np.maximum(hi - lo + 1, 0).sum())
    return total


def phase_wide_band(torch, port, by_path):
    """The banded fill past 131072 lanes (the former wide route's bands, now
    more tiles a block than the card holds CTAs) at
    WIDE_BANDS on N_WIDE pairs of ~1-2 kb: finals and the whole dirs tensor
    against the plain version, scores against kernel #4's exact scores
    (the band covers the matrix); then BandedAligner first-only at the
    first band on the card, every pair aligned to its exact score."""
    from sequencealigning_tpu_torch.config import AlignConfig, Algo
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch

    banded, tiled = port["banded"], port["tiled"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    pairs = []
    for _ in range(N_WIDE):
        length = int(rng.integers(LEN_WIDE_LO, LEN_WIDE_HI + 1))
        pairs += make_pairs(rng, 1, length)
    # Lengths that differ: drop a slice from two of the dbs.
    pairs[1] = (pairs[1][0], pairs[1][1][:300] + pairs[1][1][420:])
    pairs[3] = (pairs[3][0][:-250], pairs[3][1])
    batch = pack_batch(pairs)
    tb = to_device(batch, "cuda")
    scheme = ScoringScheme()
    exact = tiled.tiled_fill_cuda(*tb, scheme, True, False)
    exact_scores = exact.max(dim=1).values.cpu().numpy()[:N_WIDE]
    out, errs = {}, []
    for band in WIDE_BANDS:
        plan, ins = banded.band_inputs(*tb, band)
        check(plan.L > 131_072, f"band {band}: L={plan.L}")
        a = (plan, scheme, True, False, "fast4")
        ms = cuda_ms(torch, lambda: banded.banded_diag_fill_cuda(*ins, *a),
                     repeats=1)
        fk, dk = banded.banded_diag_fill_cuda(*ins, *a)
        shape = dict(banded.banded_diag_fill_cuda.last_launch)
        per_row = shape["tiles"] // shape["rows"]
        check(per_row > shape["resident"], f"band {band}: {per_row} tiles a "
              f"block, {shape['resident']} resident CTAs: no overflow")
        plain_ms, (fp, dp) = host_ms(
            torch, lambda: banded.banded_diag_fill_torch(*ins, *a))
        whole = bool(torch.equal(dk.view(torch.int32), dp.view(torch.int32)))
        err = max(int((fk - fp).abs().max()), 0 if whole else 1)
        check(err == 0, f"wide banded fill != plain at band {band}")
        got = fk.max(dim=1).values.cpu().numpy()[:N_WIDE]
        check(np.array_equal(got, exact_scores),
              f"band {band}: scores {got} != kernel #4's {exact_scores}")
        cells = band_true_cells(batch.query_len[:N_WIDE],
                                batch.db_len[:N_WIDE], plan.k_lo,
                                plan.k_hi_eff)
        b_ms, b_by = bound(nbytes(*ins, fk, dk), cells * OPS_PER_CELL["fast4"])
        waves = 2 * plan.n_need
        log(f"[18 wide band] band {band} (L={plan.L} lanes, "
            f"{waves} wavefronts, {N_WIDE} pairs; {tile_line(shape)}: "
            f"{per_row} tiles a block over {shape['resident']} resident "
            f"CTAs): kernel {ms:.3f} ms "
            f"({1e3 * ms / waves:.2f} us a wavefront), plain {plain_ms:.1f}"
            f" ms, bound {b_ms:.3f} ms ({b_by}); finals and the whole dirs "
            "tensor equal the plain version, scores equal kernel #4's")
        tag = f"wide{band}"
        out.update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain_ms,
                    f"{tag}_bound_ms": b_ms, f"{tag}_bound_by": b_by,
                    f"{tag}_lanes": plan.L, f"{tag}_shape": shape,
                    f"{tag}_us_per_wavefront": 1e3 * ms / waves})
        errs.append(err)
        del fk, dk, fp, dp
        torch.cuda.empty_cache()
    band = WIDE_BANDS[0]
    cfg = AlignConfig(algo=Algo.BANDED, band=band, first_only=True)
    aligner = port["models"].BandedAligner(cfg, "cuda")
    path = "banded wide first-only"
    with path_launches(port, by_path, path):
        secs, res = host_ms(torch, lambda: aligner.align_batch(
            records(pairs)))
    check_results(res, pairs, scheme, path, compat=True)
    check([r.score for r in res] == [int(x) for x in exact_scores],
          f"{path}: scores != kernel #4's")
    check(by_path.get("nw_banded_diag_fill", {}).get(path, 0) > 0,
          f"{path} never launched the banded fill")
    log(f"[18 wide band] BandedAligner first-only at band {band} on cuda: "
        f"{secs:.1f} ms; every alignment consumes its sequences and rescores"
        f" to kernel #4's exact score; phase {time.perf_counter() - t0:.1f} s")
    out.update(wide_err=max(errs), wide_main_ms=secs,
               wide_phase_s=time.perf_counter() - t0)
    return out


def row_vs_diag_full_diff(torch, rdirs, k_lo, gdirs, k_lo_even, n1s, n2s,
                          rows=64):
    """Cells whose full bytes differ between kernel #8's row layout (rdirs,
    (X4, B, K)) and kernel #3's wavefront layout (gdirs, (Aw, B, L)), over
    every cell 0 <= x <= n2, 0 <= y <= n1 of each pair but the origin in
    the row band k_lo <= k <= k_hi = k_lo + K - 1 (on row 0 only the
    H-argmax bits: the row sweep writes no parent bits there, and no walker
    reads them).  Returns (interior, edge): the band's interior diagonals
    k_lo < k < k_hi - 1, and its edge diagonals k_lo, k_hi - 1 and k_hi,
    where the two engines' -inf values differ by design (the row sweep's I
    at k_lo is NEGBIG + o + e, the wavefront fill's NEGBIG + e; the
    wavefront fill keeps row 0's compat gap chain (in D) past k_hi, which
    reaches D at (1, k_hi) and a tie bit at (2, k_hi - 1)).  Swept `rows`
    rows at a time on the card."""
    X4, B, K = rdirs.shape
    dev = rdirs.device
    r32, g32 = rdirs.view(torch.int32), gdirs.view(torch.int32)
    n1 = torch.as_tensor(np.asarray(n1s), device=dev)[None, :, None]
    n2 = torch.as_tensor(np.asarray(n2s), device=dev)[None, :, None]
    bidx = torch.arange(B, device=dev)[None, :, None]
    k = (k_lo + torch.arange(K, device=dev))[None, None, :]
    edge = (k == k_lo) | (k >= k_lo + K - 2)
    interior = edges = 0
    for x0 in range(0, 4 * X4, rows):
        x = torch.arange(x0, min(x0 + rows, 4 * X4), device=dev)[:, None,
                                                                 None]
        y = x + k
        keep = (x <= n2) & (y >= 0) & (y <= n1) & ~((x == 0) & (y == 0))
        r = (r32[x >> 2, bidx, k - k_lo] >> (8 * (x & 3))) & 0xFF
        aidx = (x + y - 1).clamp(min=0)
        g = (g32[(aidx >> 2).clamp(max=gdirs.shape[0] - 1), bidx,
                 (k - k_lo_even) >> 1] >> (8 * (aidx & 3))) & 0xFF
        diff = (((r ^ g) & torch.where(x == 0, 7, 0xFF)) != 0) & keep
        interior += int((diff & ~edge).sum())
        edges += int((diff & edge).sum())
    return interior, edges


def row_band_of_width(row, tb, K):
    """The band that gives a batch's lane range K lanes, and its inputs."""
    diff = (tb.query_len.cpu().numpy().astype(np.int64)
            - tb.db_len.cpu().numpy().astype(np.int64))
    span = max(0, diff.max()) - min(0, diff.min()) + 1
    band = int((K - 64 - span) // 2)
    k_lo, ins = row.row_inputs(*tb, band)
    check(ins[0].shape[1] == K, f"band {band} gave {ins[0].shape[1]} lanes, "
          f"not {K}")
    return band, k_lo, ins


def phase_banded_row(torch, port, pairs, by_path):
    """Kernel #8 (the banded row sweep) against its plain version on ragged
    and skewed batches (compat/textbook x none/fast4/full x wildcard): the
    warp route at 128, 256, 384 and 512 lanes (4, 8, 12 and 16 lanes a
    thread, as the rule picks) and each of those forced onto the block
    route in 128-lane chunks; the block route past 512 lanes as the rule
    picks it (one chunk, and 128-lane chunks), past one block's 2048 lanes
    and past the shared memory; then at config 4 in fast4 and full (the
    warp route, and the block route forced for comparison) against its
    plain version and against kernel #3 (finals; full bytes cell for cell
    inside the band); then the engine's own path, nw_banded_batch and the
    row-layout walkers (native fast4, host full) on sampled pairs, each
    alignment rescoring to its finals."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops.traceback import (
        banded_fast4_traceback_batch,
        banded_traceback_pair,
    )

    row, banded = port["row"], port["banded"]
    rng = np.random.default_rng(19)
    err, runs, widths, routes = 0, 0, [], set()
    modes = [(c, w, d) for c in (True, False) for w in (True, False)
             for d in (False, "fast4", "full")]
    cases = [(f"K {K}", K, (200, 230, 200, 230), 24, modes, (0, 128))
             for K in ROW_WARP_WIDTHS]
    cases += [(16, None, (1, 300, 1, 300), 24, modes, (0, 128)),
              (48, None, (200, 400, 20, 150), 24, modes, (0, 128)),
              (1100, None, (100, 300, 100, 300), 6, modes[1:3], (0,)),
              (2300, None, (50, 200, 50, 200), 6, modes[1:3], (0,))]
    for band, K, (lo1, hi1, lo2, hi2), n, todo, chunks in cases:
        pairs_r = skewed_pairs(rng, n, lo1, hi1, lo2, hi2, b"ACGTN")
        tb = to_device(pack_batch(pairs_r, batch_size=n), "cuda")
        if K is None:
            k_lo, ins = row.row_inputs(*tb, band)
        else:
            band, k_lo, ins = row_band_of_width(row, tb, K)
        widths.append(int(ins[0].shape[1]))
        for compat, wildcard, dirs in todo:
            a = (k_lo, ScoringScheme(), compat, wildcard, dirs)
            fp, dp = row.banded_row_fill_torch(*ins, *a)
            for chunk in chunks:
                fk, dk = row.banded_row_fill_cuda(*ins, *a, chunk_lanes=chunk)
                torch.cuda.synchronize()
                launch = row.banded_row_fill_cuda.last_launch
                routes.add((launch["route"], launch["lanes_per_thread"],
                            widths[-1], chunk))
                e = int((fk - fp).abs().max())
                if dirs:
                    e = max(e, 0 if torch.equal(dk.view(torch.int32),
                                                dp.view(torch.int32)) else 1)
                check(e == 0, f"banded row kernel != plain (band {band}, "
                      f"K={ins[0].shape[1]}, {launch['route']} route, compat="
                      f"{compat}, wildcard={wildcard}, dirs={dirs}, chunk "
                      f"{chunk}): err {e}")
                err, runs = max(err, e), runs + 1
    kern = port["csrc"].kernels()
    warp = {(lpt, K) for r, lpt, K, c in routes if r == "warp"}
    check(warp == {(K // 32, K) for K in ROW_WARP_WIDTHS},
          f"the warp route ran {sorted(warp)}")
    check(all((r == "warp") == (K <= 512 and c == 0)
              for r, _l, K, c in routes), f"routes by width: {routes}")
    check(widths[-2] > 2048
          and kern.sa_banded_row_scratch_words(widths[-1]) > 0,
          f"the wide bands ({widths[-2:]} lanes) did not cross a block's "
          "2048 lanes and the shared memory")
    log(f"[19 banded row] {runs} ragged/skewed configurations (K = {widths}:"
        " the warp route at 4/8/12/16 lanes a thread, every width up to 512 "
        "lanes also forced onto the block route in 128-lane chunks; the "
        "block route by the rule past 512 lanes, in two 2048-lane chunks, "
        "its state in device memory) equal on finals and the whole dirs "
        "tensor")

    batch = pack_batch(pairs, batch_size=len(pairs))
    tb = to_device(batch, "cuda")
    k_lo, ins = row.row_inputs(*tb, BAND)
    K = int(ins[0].shape[1])
    band_cells = int(batch.db_len.astype(np.int64).sum()) * K
    out = {"rfill_ragged_err": err, "rfill_lanes": K}
    n1s = batch.query_len.astype(np.int64)
    n2s = batch.db_len.astype(np.int64)
    # The bound counts K lanes a row, as kernel #3's does; the band itself
    # needs only the diagonals of [min(0, n1-n2) - band, max(0, n1-n2) +
    # band], which the needed-diagonals bound counts.
    diags = int(max(0, (n1s - n2s).max()) - min(0, (n1s - n2s).min())
                + 2 * BAND + 1)
    need_cells = int(n2s.sum()) * diags
    for dirs in ("fast4", "full"):
        a = (k_lo, ScoringScheme(), True, True, dirs)
        # The block route forced (the parent's design, one chunk), then
        # the rule's route.
        block_ms = cuda_ms(torch, lambda: row.banded_row_fill_cuda(
            *ins, *a, chunk_lanes=K))
        ms = cuda_ms(torch, lambda: row.banded_row_fill_cuda(*ins, *a))
        fk, dk = row.banded_row_fill_cuda(*ins, *a)
        launch = dict(row.banded_row_fill_cuda.last_launch)
        plain_ms, (fp, dp) = host_ms(
            torch, lambda: row.banded_row_fill_torch(*ins, *a))
        e = int((fk - fp).abs().max())
        e = max(e, 0 if torch.equal(dk.view(torch.int32),
                                    dp.view(torch.int32)) else 1)
        del dp
        check(e == 0, f"banded row kernel != plain at config 4 ({dirs})")
        b_ms, b_by = bound(nbytes(*ins, fk, dk),
                           band_cells * OPS_PER_CELL[dirs])
        need_ms = bound(nbytes(*ins, fk, dk),
                        need_cells * OPS_PER_CELL[dirs])[0]
        # Kernel #3 at the same band: equal finals, and in full the same
        # bytes on every in-band cell.
        plan, gins = banded.band_inputs(*tb, BAND)
        fg, dg = banded.banded_diag_fill_cuda(*gins, plan, ScoringScheme(),
                                              True, True, dirs)
        cross, edge = int((fk - fg).abs().max()), 0
        if dirs == "full":
            inner, edge = row_vs_diag_full_diff(
                torch, dk, k_lo, dg, plan.k_lo_even, n1s, n2s)
            cross = max(cross, inner)
        del dg
        check(cross == 0, f"kernel #8 != kernel #3 at config 4 ({dirs}): "
              f"{cross}")
        log(f"[19 banded row] {len(pairs)} x {LEN_BAND} bp band {BAND} {dirs}"
            f" (K={K}, dirs {dk.numel() * 4 / 1e9:.2f} GB): kernel {ms:.3f} "
            f"ms on the {launch['route']} route ({launch['lanes_per_thread']}"
            f" lanes a thread), {100 * b_ms / ms:.1f}% of its bound; the "
            f"block route forced {block_ms:.3f} ms; plain {plain_ms:.1f} ms, "
            f"band {band_cells / ms / 1e6:.2f} GCUPS, bound {b_ms:.3f} ms "
            f"({b_by}; {need_ms:.3f} ms over the {diags} diagonals the band "
            f"needs); finals and the whole dirs "
            "tensor equal the plain version; finals"
            + (" and every full byte on the band's interior diagonals"
               if dirs == "full" else "") + " equal kernel #3's"
            + (f" ({edge} cells differ on its edge diagonals, by design)"
               if dirs == "full" else ""))
        out.update({f"rfill_{dirs}_ms": ms,
                    f"rfill_{dirs}_block_ms": block_ms,
                    f"rfill_{dirs}_launch": launch,
                    f"rfill_{dirs}_plain_ms": plain_ms,
                    f"rfill_{dirs}_err": e, f"rfill_{dirs}_cross_err": cross,
                    f"rfill_{dirs}_edge_cells": edge,
                    f"rfill_{dirs}_band_gcups": band_cells / ms / 1e6,
                    f"rfill_{dirs}_bound_ms": b_ms,
                    f"rfill_{dirs}_bound_by": b_by,
                    f"rfill_{dirs}_bound_needed_ms": need_ms,
                    "rfill_band_diagonals": diags})
        del dk

    # The engine's own path: nw_banded_batch on the card, then the
    # row-layout walkers on a sample of its pairs.
    sample = np.sort(np.random.default_rng(20).choice(len(pairs), 16,
                                                      replace=False))
    path = "banded row sweep (nw_banded_batch + row-layout walkers)"
    scheme = ScoringScheme()
    with path_launches(port, by_path, path):
        t0 = time.perf_counter()
        res4 = row.nw_banded_batch(*tb, band=BAND, wildcard=True,
                                   with_dirs="fast4")
        pick = torch.as_tensor(sample, device=res4.dirs.device)
        d4 = res4.dirs.view(torch.int32)[:, pick].view(torch.uint32).cpu()
        walks = banded_fast4_traceback_batch(
            d4.numpy(), res4.finals[sample], [pairs[b][0] for b in sample],
            [pairs[b][1] for b in sample], res4.k_lo)
        fast4_s = time.perf_counter() - t0
        del res4, d4
        resf = row.nw_banded_batch(*tb, band=BAND, wildcard=True,
                                   with_dirs="full")
        df = resf.dirs.view(torch.int32)[:, pick].view(torch.uint32).cpu()
        full = [banded_traceback_pair(df[:, i].numpy(), resf.finals[b],
                                      *pairs[b], resf.k_lo, max_alignments=1)
                for i, b in enumerate(sample)]
        del resf, df
    launches = by_path.get("nw_banded_fill", {}).get(path, 0)
    check(launches == 2, f"{path} launched kernel #8 {launches} times")
    for i, b in enumerate(sample):
        for name, r in (("fast4", walks[i]), ("full", full[i])):
            check(not isinstance(r, Exception), f"{name} walk failed on pair "
                  f"{b}: {r}")
            score, alns = r
            a1, a2 = alns[0]
            check(a1.replace("-", "").encode() == pairs[b][0]
                  and a2.replace("-", "").encode() == pairs[b][1]
                  and affine_score(a1, a2, scheme, False, True) == score,
                  f"the row-layout {name} walk of pair {b} does not rescore "
                  "to its finals")
    log(f"[19 banded row] {path}: {len(sample)} sampled pairs walked by the "
        f"native fast4 and the host full walkers; every alignment consumes "
        f"its sequences and rescores to its finals (fast4 fill + walks "
        f"{fast4_s:.3f} s)")
    out.update(rfill_path_fast4_s=fast4_s)
    return out


def phase_graph_replay(torch, port, pairs):
    """The plain versions' step loops replayed as CUDA graphs (as every
    other phase runs them) against the same loops run eagerly step by step
    on the card (ops.step_graph.GRAPH_STEPS = 0): the banded fill and the
    row sweep at config 4 in fast4, equal finals and dirs, both times."""
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops import step_graph

    tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
    plan, gins = port["banded"].band_inputs(*tb, BAND)
    k_lo, rins = port["row"].row_inputs(*tb, BAND)
    fills = {
        "bfill": lambda: port["banded"].banded_diag_fill_torch(
            *gins, plan, ScoringScheme(), True, True, "fast4"),
        "rfill": lambda: port["row"].banded_row_fill_torch(
            *rins, k_lo, ScoringScheme(), True, True, "fast4"),
    }
    graph_steps = step_graph.GRAPH_STEPS
    out = {}
    for key, fill in fills.items():
        graph_ms, (fg, dg) = host_ms(torch, fill)
        step_graph.GRAPH_STEPS = 0
        try:
            eager_ms, (fe, de) = host_ms(torch, fill)
        finally:
            step_graph.GRAPH_STEPS = graph_steps
        check(torch.equal(fg, fe) and torch.equal(dg.view(torch.int32),
                                                  de.view(torch.int32)),
              f"{key}: the graph-replayed plain fill != the eager one")
        del fg, dg, fe, de
        log(f"[22 graph replay] {key} plain at config 4 fast4: graphs of "
            f"{graph_steps} steps {graph_ms:.1f} ms, eager {eager_ms:.1f} ms "
            f"({eager_ms / graph_ms:.2f}x); finals and dirs equal")
        out.update({f"{key}_graph_plain_ms": graph_ms,
                    f"{key}_eager_plain_ms": eager_ms})
    return out


def phase_linear(torch, port, pairs, by_path):
    """The linear kernel against its plain version: small ragged batches
    (compat/textbook x global/local x bits, in one block and split over 2
    CTAs), then 4096 x 2046 bp score-only (global compat and textbook,
    local) and 512 x 2046 bp with bits (global, local's two passes); then
    LinearNWAligner on cuda: the 512 pairs through align_batch
    (alignments/s; one sampled pair against the linear oracle), and a small
    global and local batch whose scores equal the oracle's."""
    from sequencealigning_tpu_torch.config import AlignConfig, Algo, Mode
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops import oracle_linear

    lin = port["linear"]
    scheme = ScoringScheme()
    rng = np.random.default_rng(21)
    err, runs = 0, 0
    for n, hi in ((24, 300), (9, 700)):
        tb = to_device(pack_batch(skewed_pairs(rng, n, 1, hi, 1, hi),
                                  batch_size=n), "cuda")
        a4 = lin.linear_inputs(*tb)
        l1, l2 = tb.query.shape[1], tb.db.shape[1]
        n1s, n2s = tb.query_len.cpu().numpy(), tb.db_len.cpu().numpy()
        for compat in (True, False):
            for local in (False, True):
                mv = torch.zeros_like(a4[2])
                if local:
                    mv = lin.linear_fill_torch(*a4, mv, l1, l2, scheme,
                                               compat, True, False)[1]
                for bits in (False, True):
                    a = (*a4, mv.contiguous(), l1, l2, scheme, compat, local,
                         bits)
                    p = lin.linear_fill_torch(*a)
                    for cta in (0, 128):
                        k = lin.linear_fill_cuda(*a, cta_lanes=cta)
                        torch.cuda.synchronize()
                        e = max(int((k[0] - p[0]).abs().max()),
                                int((k[1] - p[1]).abs().max()))
                        if bits:
                            e = max(e, pair_dirs_diff(torch, k[2], p[2], n1s,
                                                      n2s))
                        check(e == 0, f"linear kernel != plain ({n} pairs <= "
                              f"{hi} bp, compat={compat}, local={local}, "
                              f"bits={bits}, cta {cta}): err {e}")
                        err, runs = max(err, e), runs + 1
    log(f"[20 linear] {runs} ragged configurations (<= 700 bp, split as "
        "planned and over CTAs of 128 lanes) equal on scores and maxima, "
        "path bits equal on every cell of each pair and 0 elsewhere")

    out = {"lfill_ragged_err": err}
    tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
    a4 = lin.linear_inputs(*tb)
    l1, l2 = tb.query.shape[1], tb.db.shape[1]
    zeros = torch.zeros_like(a4[2])
    cells = int((a4[2].long() * a4[3].long()).sum())
    for tag, compat, local in (("global", True, False),
                               ("textbook", False, False),
                               ("local", True, True)):
        a = (*a4, zeros, l1, l2, scheme, compat, local, False)
        ms = cuda_ms(torch, lambda: lin.linear_fill_cuda(*a))
        k = lin.linear_fill_cuda(*a)
        plain_ms, p = host_ms(torch, lambda: lin.linear_fill_torch(*a))
        e = max(int((k[0] - p[0]).abs().max()), int((k[1] - p[1]).abs().max()))
        check(e == 0, f"linear kernel != plain at {len(pairs)} x {LEN_MAIN} "
              f"bp ({tag})")
        ops = OPS_PER_CELL["linear local score" if local else
                           "linear score" if compat else
                           "linear textbook score"]
        b_ms, b_by = bound(nbytes(*a4, zeros, k[0], k[1]), cells * ops)
        log(f"[20 linear] {len(pairs)} x {LEN_MAIN} bp {tag} score-only: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
            f"{cells / ms / 1e6:.2f} GCUPS, bound {b_ms:.3f} ms ({b_by}); "
            "corner scores and maxima equal the plain version")
        out.update({f"lfill_{tag}_ms": ms, f"lfill_{tag}_plain_ms": plain_ms,
                    f"lfill_{tag}_err": e, f"lfill_{tag}_bound_ms": b_ms,
                    f"lfill_{tag}_bound_by": b_by})
    sub = [t[:N_LINEAR_DIRS].contiguous() for t in a4]
    zsub = zeros[:N_LINEAR_DIRS].contiguous()
    dcells = int((sub[2].long() * sub[3].long()).sum())
    corner_dirs = None
    for tag, local in (("dirs", False), ("local_dirs", True)):
        mv = zsub
        if local:
            mv = lin.linear_fill_cuda(*sub, zsub, l1, l2, scheme, True, True,
                                      False)[1].contiguous()
        a = (*sub, mv, l1, l2, scheme, True, local, True)
        ms = cuda_ms(torch, lambda: lin.linear_fill_cuda(*a))
        k = lin.linear_fill_cuda(*a)
        plain_ms, p = host_ms(torch, lambda: lin.linear_fill_torch(*a))
        e = max(int((k[0] - p[0]).abs().max()), int((k[1] - p[1]).abs().max()),
                pair_dirs_diff(torch, k[2], p[2], sub[2].cpu().numpy(),
                               sub[3].cpu().numpy()))
        check(e == 0, f"linear kernel != plain at {N_LINEAR_DIRS} x "
              f"{LEN_MAIN} bp with bits ({tag})")
        ops = OPS_PER_CELL["linear local bits" if local else "linear bits"]
        b_ms, b_by = bound(nbytes(*sub, mv, k[0], k[1], k[2]), dcells * ops)
        log(f"[20 linear] {N_LINEAR_DIRS} x {LEN_MAIN} bp {tag} (bits "
            f"{k[2].numel() * 4 / 1e9:.2f} GB): kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}); scores equal "
            "the plain version, path bits on every cell of each pair, every "
            "other byte 0")
        out.update({f"lfill_{tag}_ms": ms, f"lfill_{tag}_plain_ms": plain_ms,
                    f"lfill_{tag}_err": e, f"lfill_{tag}_bound_ms": b_ms,
                    f"lfill_{tag}_bound_by": b_by})
        if not local:
            corner_dirs = k[0].cpu().numpy()
        del k, p

    # A few pairs (the aligner pads one to a batch of 8), with bits.
    small, small_err = {}, 0
    for k in (1, 4, 31):
        pk = make_pairs(np.random.default_rng(4), k, LEN_MAIN)
        tbk = to_device(pack_batch(pk, batch_size=max(k, 8)), "cuda")
        a4k = lin.linear_inputs(*tbk)
        l1k, l2k = tbk.query.shape[1], tbk.db.shape[1]
        zk = torch.zeros_like(a4k[2])
        for tag, local in (("global", False), ("local", True)):
            mv = zk
            if local:
                mv = lin.linear_fill_cuda(*a4k, zk, l1k, l2k, scheme, True,
                                          True, False)[1].contiguous()
            a = (*a4k, mv, l1k, l2k, scheme, True, local, True)
            ms = cuda_ms(torch, lambda: lin.linear_fill_cuda(*a), 5)
            kk = lin.linear_fill_cuda(*a)
            shape = dict(lin.linear_fill_cuda.last_launch)
            pp = lin.linear_fill_torch(*a)
            e = max(int((kk[0] - pp[0]).abs().max()),
                    int((kk[1] - pp[1]).abs().max()),
                    pair_dirs_diff(torch, kk[2], pp[2],
                                   a4k[2].cpu().numpy(),
                                   a4k[3].cpu().numpy()))
            check(e == 0, f"linear kernel != plain at {k} x {LEN_MAIN} bp "
                  f"with bits ({tag}): err {e}")
            small_err = max(small_err, e)
            small[f"{k}_{tag}"] = ms
            log(f"[20 linear] {k} x {LEN_MAIN} bp {tag} with bits "
                f"(batch of {len(tbk.query_len)}, {pair_line(shape)}): "
                f"kernel {ms:.3f} ms (mean of 5); equal to the plain version")
            del kk, pp
    out.update(lfill_batches_ms=small, lfill_small_err=small_err)

    # LinearNWAligner on the card.
    cfg = AlignConfig(algo=Algo.NW_LINEAR)
    aligner = port["models"].LinearNWAligner(cfg, "cuda")
    sub_pairs = pairs[:N_LINEAR_DIRS]
    path = "nw-linear (LinearNWAligner.align_batch)"
    torch.cuda.empty_cache()
    with path_launches(port, by_path, path):
        t0 = time.perf_counter()
        res = aligner.align_batch(records(sub_pairs))
        secs = time.perf_counter() - t0
    check(all(r.ok for r in res), f"{path}: a pair failed")
    check([r.score for r in res] == [int(x) for x in corner_dirs],
          f"{path}: scores != the linear kernel's corner scores")
    for r, (a, b) in zip(res, sub_pairs):
        check(r.aligned_query.replace("-", "").encode() == a
              and r.aligned_db.replace("-", "").encode() == b,
              f"{path}: an alignment does not consume its sequences")
    # One sampled pair against the oracle (a Python loop over its 4.2 M
    # cells, so one pair only).
    pick = int(np.random.default_rng(25).integers(len(sub_pairs)))
    t0 = time.perf_counter()
    want = oracle_linear.linear_score(*sub_pairs[pick], scheme)
    oracle_s = time.perf_counter() - t0
    check(res[pick].score == want, f"{path}: pair {pick} scores "
          f"{res[pick].score}, the oracle {want}")
    del res
    check(by_path.get("nw_linear_fill", {}).get(path, 0) == 1,
          f"{path} did not launch the linear kernel once")
    # A small global and local batch against the oracle, each counted as
    # its own path.
    small = skewed_pairs(np.random.default_rng(22), 16, 20, 250, 20, 250)
    for mode in (Mode.GLOBAL, Mode.LOCAL):
        a2 = port["models"].LinearNWAligner(
            AlignConfig(algo=Algo.NW_LINEAR, mode=mode), "cuda")
        spath = (f"nw-linear -m {mode.value} (LinearNWAligner.align_batch, "
                 f"{len(small)} pairs)")
        with path_launches(port, by_path, spath):
            res = a2.align_batch(records(small))
        for r, (s1, s2) in zip(res, small):
            want = oracle_linear.linear_score(s1, s2, scheme,
                                              local=mode is Mode.LOCAL)
            check(r.ok and r.score == want, f"{spath}: score "
                  f"{r.score} != the oracle's {want}")
        check(by_path.get("nw_linear_fill", {}).get(spath, 0) > 0,
              f"{spath} never launched the linear kernel")
    log(f"[20 linear] {path}: {len(sub_pairs)} x {LEN_MAIN} bp global on "
        f"cuda in {secs:.3f} s ({len(sub_pairs) / secs:.1f} alignments/s), "
        "scores equal the kernel's, every alignment consumes its sequences, "
        f"sampled pair {pick} equals the oracle ({oracle_s:.1f} s); "
        f"{len(small)} pairs <= 250 bp global and local equal the oracle")
    out.update(linear_s=secs, linear_alignments_per_s=len(sub_pairs) / secs)
    return out


def phase_astar(torch, port, by_path):
    """AStarAligner (a host search whatever the device) over N_ASTAR pairs
    of LEN_ASTAR bp at ~1% substitutions: alignments/s; sampled pairs equal
    the oracle's result, every alignment consumes its sequences."""
    from sequencealigning_tpu_torch.config import AlignConfig, Algo
    from sequencealigning_tpu_torch.ops.oracle_astar import astar_align

    pairs = make_pairs(np.random.default_rng(23), N_ASTAR, LEN_ASTAR)
    cfg = AlignConfig(algo=Algo.A_STAR)
    aligner = port["models"].AStarAligner(cfg, "cuda")
    path = "a-star (AStarAligner.align_batch)"
    with path_launches(port, by_path, path):
        t0 = time.perf_counter()
        res = aligner.align_batch(records(pairs))
        secs = time.perf_counter() - t0
    check(all(r.ok for r in res), f"{path}: a pair failed")
    for r, (a, b) in zip(res, pairs):
        check(r.aligned_query.replace("-", "").encode() == a
              and r.aligned_db.replace("-", "").encode() == b,
              f"{path}: an alignment does not consume its sequences")
    for b in np.random.default_rng(24).choice(len(pairs), 4, replace=False):
        want = astar_align(*pairs[b], scheme=cfg.scoring)
        got = (res[b].score, res[b].aligned_query, res[b].aligned_db)
        check(got == tuple(want), f"{path}: pair {b} != the oracle's result")
    log(f"[21 a-star] {N_ASTAR} x {LEN_ASTAR} bp on the host: {secs:.3f} s, "
        f"{N_ASTAR / secs:.1f} alignments/s; 4 sampled pairs equal the "
        "oracle's score and strings")
    return {"astar_s": secs, "astar_alignments_per_s": N_ASTAR / secs}


def wfa_pairs(rng, n, length, divergence, indels=0):
    """config 3's pairs (benchmarks/configs_bench.py:_mkpairs): n
    (mutant, reference) pairs of `length` bp, length * divergence
    substitutions each; with indels, that many insertions or deletions of
    1-50 bp more in each mutant."""
    pairs = []
    for _ in range(n):
        ref = rng.choice(list(b"ACGT"), length).astype(np.uint8).tobytes()
        mut = bytearray(ref)
        for _ in range(max(1, int(length * divergence))):
            p = int(rng.integers(0, len(mut)))
            mut[p] = int(rng.choice([c for c in b"ACGT" if c != mut[p]]))
        for _ in range(indels):
            p = int(rng.integers(0, len(mut)))
            n_ = int(rng.integers(1, 51))
            if rng.integers(2):
                del mut[p: p + n_]
            else:
                mut[p:p] = rng.choice(list(b"ACGT"), n_).astype(
                    np.uint8).tobytes()
        pairs.append((bytes(mut), ref))
    return pairs


def wfa_ragged(rng, n, hi):
    """n pairs up to hi bp skewed both ways: mutants (a substitution in 50
    bp, a 1-40 bp deletion, every other one a 1-300 bp tail cut: a length
    difference up to 340 bp either way) and unrelated pairs up to 200 bp,
    with an empty side each way and an identical pair past one pair.  The
    skews stay near 300 bp so that the plain fill's lattice steps (~3 a
    base of gap) stay near a thousand."""
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(n):
        if i % 4 == 3:
            s1 = rng.choice(alpha, int(rng.integers(1, 201)))
            s2 = rng.choice(alpha, int(rng.integers(1, 201)))
        else:
            s1 = rng.choice(alpha, int(rng.integers(1, hi + 1)))
            s2 = s1.copy()
            for _ in range(len(s2) // 50 + 1):
                s2[rng.integers(len(s2))] = rng.choice(alpha)
            if len(s2) > 60:
                p = int(rng.integers(1, len(s2) - 50))
                s2 = np.concatenate([s2[:p], s2[p + int(rng.integers(1, 41)):]])
            if i % 8 == 1:
                s2 = s2[: max(0, len(s2) - int(rng.integers(1, 301)))]
        pairs.append((s1.tobytes(), s2.tobytes()) if i % 2 else
                     (s2.tobytes(), s1.tobytes()))
    extra = [(b"", b"ACGT"), (b"ACG", b""), (b"GATTACA" * 9, b"GATTACA" * 9)]
    return pairs if n == 1 else pairs + extra


def wfa_penalty(a1, a2, pen):
    """The gap-affine WFA penalty of one alignment: x a mismatch, o + e a
    gap's first column, e the others."""
    s1 = np.frombuffer(a1.encode(), np.uint8)
    s2 = np.frombuffer(a2.encode(), np.uint8)
    gap = ord("-")
    kind = np.where(s1 == gap, 2, np.where(s2 == gap, 1, 0))
    prev = np.concatenate([[0], kind[:-1]])
    m = kind == 0
    return int((s1[m] != s2[m]).sum() * pen.mismatch
               + ((kind != 0) & (kind != prev)).sum() * pen.gap_open
               + (kind != 0).sum() * pen.gap_extend)


def wfa_fill_run(torch, wfa, tb, band, pen, spans=(0, 0, 0, 0), kernel=True,
                 lpt=0, events=None):
    """One fill as wfa_textbook_batch runs it, through the kernel
    (wfa_chunk_cuda, lanes a thread forced by lpt) or the plain version
    (its run-length table built once): (state, chunks).  events: a list
    that receives a (start, end) CUDA event pair a launch."""
    k_lo, K = wfa.band_plan(tb.query_len.cpu().numpy(),
                            tb.db_len.cpu().numpy(), band, spans)
    f = wfa.wfa_fill_state(*tb, k_lo, K, pen, spans)
    if kernel:
        def chunk(f_, u0, n):
            if events is None:
                return wfa.wfa_chunk_cuda(f_, u0, n, lpt)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = wfa.wfa_chunk_cuda(f_, u0, n, lpt)
            ev[1].record()
            events.append(ev)
            return out
    else:
        runlen = wfa.build_runlen(f)

        def chunk(f_, u0, n):
            return wfa.wfa_chunk_torch(f_, u0, n, runlen)
    return f, wfa.fill_chunks(f, 16_384, chunk)


def wfa_fill_diff(torch, wfa, got, want):
    """The largest difference between two fills: score, converged and
    end_k of every pair, and every row of every chunk's log (the rows
    after a pair's convergence, and the chunks queued after the batch's,
    NEG in both)."""
    (fa, ca), (fb, cb) = got, want
    err = max(int((getattr(fa, n) - getattr(fb, n)).abs().max())
              for n in ("score", "done", "end_k"))
    ha = torch.cat(ca).to(torch.int32)
    hb = torch.cat(cb).to(torch.int32)
    if ha.shape != hb.shape:
        return max(err, 1 << 15)
    return max(err, int((ha - hb).abs().max()))


def wfa_fill_bound(torch, wfa, f, chunks):
    """(bound_ms, bound_by, lattice steps, extension chars) of one fill:
    the codes and lengths read once, the log rows each pair computed and
    its results written once; OPS_PER_CELL["wfa step"] a diagonal of each
    lattice step a pair computed, ["wfa extend"] a character its
    extensions compared (counted from the log: each M offset minus the
    candidate it was extended from)."""
    g = wfa._score_stride(f.penalties)
    x_off = wfa.lattice_offsets(f.penalties)[0]
    B = f.seq1.shape[0]
    K = f.ring_m.shape[2]
    rows = int(f.score.max()) // g + 1
    h = torch.cat(chunks)[:rows].to(torch.int32)
    M, I, D = h[:, 0], h[:, 1], h[:, 2]
    neg = wfa.NEG
    prev = torch.full_like(M, neg)
    prev[x_off:] = M[:-x_off]
    cand = torch.maximum(torch.where(prev > neg, prev + 1, neg),
                         torch.maximum(I, D))
    kv = f.k_lo + torch.arange(K, device=h.device, dtype=torch.int32)
    cand[0] = torch.clamp(-kv, min=0)
    ext = int(torch.where(M > neg, M - cand, 0).clamp(min=0).sum())
    steps = torch.where(f.done != 0, f.score // g + 1, rows)
    lane_steps = int(steps.sum()) * K
    moved = nbytes(f.seq1, f.seq2, f.n1v, f.n2v, f.score, f.done, f.end_k) \
        + lane_steps * 3 * 2
    b_ms, b_by = bound(moved, lane_steps * OPS_PER_CELL["wfa step"]
                       + ext * OPS_PER_CELL["wfa extend"])
    return b_ms, b_by, rows, ext


def wfa_walk_bound(alns, seeds):
    """(bound_ms, bound_by, steps of the longest walk, its ops) of a walk:
    three 2-byte log reads a step, the seeds read and the packed ops
    written once; OPS_PER_CELL["wfa walk step"] a step, ["wfa walk op"] an
    op.  The steps of a walk: its seed, one a mismatch, one a gap column
    and one where a gap run ends (an M state a run)."""
    steps, ops, longest = 0, 0, (0, 0)
    for a in alns:
        if a is None:
            continue
        s1 = np.frombuffer(a[0].encode(), np.uint8)
        s2 = np.frombuffer(a[1].encode(), np.uint8)
        gap = ord("-")
        kind = np.where(s1 == gap, 2, np.where(s2 == gap, 1, 0))
        prev = np.concatenate([[0], kind[:-1]])
        st = 2 + int(((kind == 0) & (s1 != s2)).sum()) + int(
            (kind != 0).sum()) + int(((kind != 0) & (kind != prev)).sum())
        steps += st
        ops += len(kind)
        longest = max(longest, (st, len(kind)))
    moved = steps * 3 * 2 + nbytes(*seeds) + ops // 4
    b_ms, b_by = bound(moved, steps * OPS_PER_CELL["wfa walk step"]
                       + ops * OPS_PER_CELL["wfa walk op"])
    return b_ms, b_by, longest


def wfa_walk_check(torch, wfa, res, pairs, pen, label, samples=8):
    """The walk kernel on a fill's log against the plain walk (packed
    codes, op counts, ok flags) and, on sampled pairs, the host walker
    (the copied native walker): (err, ms, plain_ms, bound, longest)."""
    from sequencealigning_tpu_torch.ops.traceback_device import (
        decode_packed_alignments,
    )

    s1s, s2s = [a for a, _ in pairs], [b for _, b in pairs]
    hist = res.device_hist()
    seeds = wfa.walk_seeds(res, s1s, s2s, hist.device)
    W = wfa.walk_width(int(seeds.budget.max()))
    args = (hist, seeds, res.k_lo, res.stride, pen, W)
    got = wfa.wfa_walk_cuda(*args)
    torch.cuda.synchronize()
    plain_ms, want = host_ms(torch, lambda: wfa.wfa_walk_torch(*args))
    err = max(int((got[0].view(torch.int32).long()
                   - want[0].view(torch.int32).long()).abs().max()),
              int((got[1] - want[1]).abs().max()),
              int((got[2] != want[2]).sum()))
    check(err == 0, f"{label}: walk kernel != plain walk (err {err})")
    ok = got[2].cpu().numpy()
    conv = res.converged[: len(pairs)]
    check((ok == conv).all(), f"{label}: walk ok flags != converged")
    alns = decode_packed_alignments(got[0].cpu().numpy(), s1s, s2s)
    check(all(a is not None for a, c in zip(alns, conv) if c),
          f"{label}: a walk does not consume its sequences")
    for b in np.random.default_rng(31).choice(
            len(pairs), min(samples, len(pairs)), replace=False):
        if conv[b]:
            want_b = wfa.wfa_traceback_host(res, int(b), *pairs[b], pen)
            check(alns[b] == want_b[1:],
                  f"{label}: pair {b}'s walk != the host walker's")
    ms = cuda_ms(torch, lambda: wfa.wfa_walk_cuda(*args), 5)
    b_ms, b_by, longest = wfa_walk_bound(alns, seeds)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, steps=longest[0], ops=longest[1],
                ns_per_step=ms * 1e6 / max(longest[0], 1))


def phase_wfa(torch, port, by_path):
    """Textbook WFA: the fill kernel against its plain version on ragged
    batches (its rings in shared memory, and in device memory past the
    shared-memory budget), at config 3, on the indel batch (at the
    doubled bands too) and on one and four of config 3's pairs, timed; the
    walk kernel against its plain version and the host walker; WfaAligner
    on cuda at config 3 with every engine; the compat route against the
    oracle; the golden CLI and serve."""
    from sequencealigning_tpu_torch.config import (
        AlignConfig,
        Algo,
        WfaPenalties,
    )
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops import oracle_wfa

    wfa = port["wfa"]
    meas = {}
    pen = WfaPenalties()
    out_pen = WfaPenalties(mismatch=9, gap_open=2, gap_extend=2)
    rng = np.random.default_rng(32)

    def batch(pairs):
        return to_device(pack_batch(pairs, batch_size=-(-len(pairs) // 8)
                                    * 8), "cuda")

    # 1. Ragged batches: (pairs, hi bp, penalties, band, spans, lanes a
    # thread forced).  Band 1700 takes K past the shared-memory budget: the
    # kernel keeps those rings in device memory.
    err, runs, routes = 0, 0, set()
    t_ragged = time.perf_counter()
    for n, hi, p, band, spans, lpt in (
            (64, 3000, pen, 64, (0, 0, 0, 0), 0),
            (17, 3000, out_pen, 4, (0, 0, 0, 0), 0),
            (33, 1500, pen, 16, (5, 5, 5, 5), 0),
            (9, 2000, out_pen, 8, (3, 0, 0, 7), 0),
            (12, 600, pen, 32, (0, 0, 0, 0), 4),
            (1, 3000, pen, 600, (0, 0, 0, 0), 0),
            (5, 2500, pen, 700, (0, 0, 0, 0), 4),
            (5, 2000, pen, 1700, (0, 0, 0, 0), 0)):
        pairs = wfa_ragged(rng, n, hi)
        tb = batch(pairs)
        got = wfa_fill_run(torch, wfa, tb, band, p, spans, True, lpt)
        want = wfa_fill_run(torch, wfa, tb, band, p, spans, False)
        torch.cuda.synchronize()
        e = wfa_fill_diff(torch, wfa, got, want)
        K = got[0].ring_m.shape[2]
        route = "shared" if port["csrc"].kernels().sa_wfa_ring_in_shared(
            tb.query.shape[1], tb.db.shape[1], K,
            got[0].ring_m.shape[0]) else "device"
        routes.add(route)
        check(e == 0, f"wfa fill kernel != plain ({len(pairs)} pairs <= {hi}"
              f" bp, {p}, band {band} (K {K}), spans {spans}, lpt {lpt}, "
              f"rings {route}): err {e}")
        err, runs = max(err, e), runs + 1
        if spans == (0, 0, 0, 0):
            res = wfa.WfaBatchResult(
                got[0].score.cpu().numpy(), got[0].done.cpu().numpy() != 0,
                got[1], got[0].k_lo, wfa._score_stride(p))
            w = wfa_walk_check(torch, wfa, res, pairs, p,
                               f"ragged walk ({len(pairs)} pairs)",
                               samples=min(4, len(pairs)))
            err = max(err, w["err"])
        log(f"[23 wfa] ragged {len(pairs)} pairs <= {hi} bp, {p.mismatch}/"
            f"{p.gap_open}/{p.gap_extend}, band {band} (K {K}, "
            f"{wfa.fill_lanes_per_thread(K, lpt)} lanes a thread, rings "
            f"{route}), spans {spans}: fill equal to the plain version"
            + ("; walk equal" if spans == (0, 0, 0, 0) else ""))
    check(routes == {"shared", "device"}, f"wfa fill ragged batches took "
          f"the rings' routes {sorted(routes)}, not both")
    meas["wfa_fill_ragged_err"] = err
    log(f"[23 wfa] {runs} ragged fills and their walks checked in "
        f"{time.perf_counter() - t_ragged:.1f} s")

    # 2. Config 3, the indel batch at the doubled bands, then one and four
    # of config 3's pairs (a CLI or serve request).
    c3 = wfa_pairs(np.random.default_rng(3), N_WFA, LEN_WFA, 0.005)
    indel = wfa_pairs(np.random.default_rng(30), N_WFA, LEN_WFA, 0.01,
                      WFA_INDELS)
    walk_err = []
    for tag, pairs, bands in (("c3", c3, (WFA_BAND,)),
                              ("indel", indel, (WFA_BAND, 2 * WFA_BAND,
                                                4 * WFA_BAND)),
                              ("c3_1", c3[:1], (WFA_BAND,)),
                              ("c3_4", c3[:4], (WFA_BAND,))):
        tb = batch(pairs)
        for band in bands:
            got = wfa_fill_run(torch, wfa, tb, band, pen)
            plain_ms, want = host_ms(
                torch, lambda: wfa_fill_run(torch, wfa, tb, band, pen, kernel=False))
            torch.cuda.synchronize()
            e = wfa_fill_diff(torch, wfa, got, want)
            check(e == 0, f"wfa fill kernel != plain ({tag}, band {band}): "
                  f"err {e}")
            ms = cuda_ms(torch, lambda: wfa_fill_run(torch, wfa, tb, band,
                                                     pen))
            events = []
            f, chunks = wfa_fill_run(torch, wfa, tb, band, pen,
                                     events=events)
            torch.cuda.synchronize()
            chunk_ms = [a.elapsed_time(b) for a, b in events]
            b_ms, b_by, rows, ext = wfa_fill_bound(torch, wfa, f, chunks)
            K = f.ring_m.shape[2]
            key = f"wfa_fill_{tag}" + ("" if band == WFA_BAND else
                                       f"_band{band}")
            meas.update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                         f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by,
                         f"{key}_err": e, f"{key}_chunk_ms": chunk_ms,
                         f"{key}_steps": rows, f"{key}_lanes": K,
                         f"{key}_extended": ext,
                         f"{key}_converged": int(f.done[:len(pairs)].sum())})
            log(f"[23 wfa] {tag} {len(pairs)} x {LEN_WFA} bp band {band} "
                f"(K {K}): fill {ms:.3f} ms ({len(events)} launches: "
                + ", ".join(f"{c:.3f}" for c in chunk_ms)
                + f" ms), {rows} lattice steps, {ext} characters extended, "
                f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.1f} ms; "
                f"{int(f.done[:len(pairs)].sum())} converged; equal to the "
                "plain version")
            res = wfa.WfaBatchResult(f.score.cpu().numpy(),
                                     f.done.cpu().numpy() != 0, chunks,
                                     f.k_lo, wfa._score_stride(pen))
            w = wfa_walk_check(torch, wfa, res, pairs, pen,
                               f"{tag} band {band} walk")
            walk_err.append(w["err"])
            wkey = f"wfa_walk_{tag}" + ("" if band == WFA_BAND else
                                        f"_band{band}")
            meas.update({f"{wkey}_{k}": v for k, v in w.items()})
            log(f"[23 wfa] {tag} band {band} walk: {w['ms']:.3f} ms, "
                f"{w['ns_per_step']:.1f} ns a step of the longest walk "
                f"({w['steps']} steps, {w['ops']} ops), plain "
                f"{w['plain_ms']:.1f} ms, bound {w['bound_ms']:.4f} ms "
                f"({w['bound_by']}); equal to the plain walk and, on 8 "
                "sampled pairs, the host walker")
            del got, want, f, chunks, res
            torch.cuda.empty_cache()
    meas["wfa_walk_err"] = max(walk_err)

    # 3. WfaAligner on cuda at config 3, every textbook engine.
    scores = {}
    for engine in ("auto", "banded", "native", "wavefront"):
        cfg = AlignConfig(algo=Algo.WFA, compat=False, band=WFA_BAND,
                          wfa_engine=engine)
        aligner = port["models"].WfaAligner(cfg, "cuda")
        path = f"wfa --textbook --wfa-engine {engine} (WfaAligner)"
        with path_launches(port, by_path, path):
            t0 = time.perf_counter()
            res = aligner.align_batch(records(c3))
            secs = time.perf_counter() - t0
        launches = {k: v[path] for k, v in by_path.items() if path in v}
        errors = [r.error for r in res if not r.ok]
        check(not errors, f"{path}: {len(errors)} pairs failed: "
              f"{errors[:2]}")
        for r, (a, b) in zip(res, c3):
            check(r.aligned_query.replace("-", "").encode() == a
                  and r.aligned_db.replace("-", "").encode() == b,
                  f"{path}: an alignment does not consume its sequences")
            check(wfa_penalty(r.aligned_query, r.aligned_db, pen) == r.score,
                  f"{path}: an alignment does not rescore to its penalty")
        scores[engine] = [r.score for r in res]
        want = {"banded": ["nw_banded_diag_fill", "walk_banded"],
                "wavefront": ["wfa_fill", "wfa_walk"]}.get(engine, [])
        for name in want:
            check(launches.get(name, 0) > 0, f"{path} never launched {name}")
        meas[f"wfa_{engine}_alignments_per_s"] = len(c3) / secs
        log(f"[23 wfa] {path}: {len(c3)} x {LEN_WFA} bp in {secs:.3f} s, "
            f"{len(c3) / secs:.1f} alignments/s; launches {launches}; every "
            "alignment consumes its sequences and rescores to its penalty")
        del res, aligner
    check(all(v == scores["auto"] for v in scores.values()),
          "the four WFA engines' scores differ at config 3")
    meas["wfa_c3_score_range"] = [min(scores["auto"]), max(scores["auto"])]
    cpairs = wfa_pairs(np.random.default_rng(33), N_WFA_COMPAT,
                       LEN_WFA_COMPAT, 0.005)
    ccfg = AlignConfig(algo=Algo.WFA, wfa_max_steps=WFA_COMPAT_STEPS)
    aligner = port["models"].WfaAligner(ccfg, "cuda")
    t0 = time.perf_counter()
    res = aligner.align_batch(records(cpairs))
    compat_s = time.perf_counter() - t0
    for r, (a, b) in zip(res, cpairs):
        try:
            score, ocean = oracle_wfa.wfa_align(
                a, b, penalties=ccfg.wfa_penalties,
                pruning=ccfg.wfa_pruning, max_steps=ccfg.wfa_max_steps)
            want = (score, *oracle_wfa.wfa_traceback(ocean, a, b), None)
        except Exception as e:
            want = (None, None, None, str(e))
        got = (r.score, r.aligned_query, r.aligned_db, r.error)
        check(got == want, f"wfa compat: {r.query_name} != the oracle")
    log(f"[23 wfa] the four engines' scores equal ({min(scores['auto'])}-"
        f"{max(scores['auto'])}); compat on {N_WFA_COMPAT} x "
        f"{LEN_WFA_COMPAT} bp at {WFA_COMPAT_STEPS} steps equal to "
        f"oracle_wfa ({compat_s:.3f} s, {sum(r.ok for r in res)} aligned: "
        "the golden corpus below holds the converging pairs)")

    # 4. The golden CLI on cuda, the spans route and serve.
    spec = importlib.util.spec_from_file_location(
        "golden_regen", os.path.join(ROOT, "tests", "golden", "regen.py"))
    regen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(regen)
    golden = os.path.join(ROOT, "tests", "golden")
    q, d = os.path.join(golden, "queries.fa"), os.path.join(golden, "db.fa")
    main = port["cli"].main
    path = "wfa golden CLI and serve (24 pairs a run)"

    def run_cli(extra, stdin=None):
        out, err = io.StringIO(), io.StringIO()
        old = sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = main(extra + ["--device", "cuda"])
        finally:
            sys.stdin = old
        check(rc == 0, f"cli exit {rc} ({extra})")
        return out.getvalue(), err.getvalue()

    corpus = ["-q", q, "-d", d, "--no-out", "-a", "wfa"]
    with path_launches(port, by_path, path):
        for name, extra in (("wfa", []), ("wfa-textbook", ["--textbook"]),
                            ("wfa-textbook", ["--textbook", "--wfa-engine",
                                              "wavefront"])):
            out, err = run_cli(corpus + extra)
            with open(os.path.join(golden, f"{name}.out")) as fh:
                want = fh.read()
            check(f"# exit=0\n# --- stdout ---\n{regen.normalize(out)}"
                  f"# --- stderr ---\n{regen.normalize(err)}" == want,
                  f"cli {extra} differs from tests/golden/{name}.out")
        out, _ = run_cli(corpus + ["-m", "semi-global", "--textbook",
                                   "--wfa-spans", "5"])
        check(out.count("converged with score") == 24,
              "-m semi-global --textbook --wfa-spans 5 did not align the 24 "
              "pairs")
        for extra, n_ok in ((["--textbook"], 24), ([], 10)):
            out, _ = run_cli(["--serve", "-a", "wfa"] + extra, f"{q} {d}\n")
            lines = [json.loads(s) for s in out.splitlines()]
            pairs = [x for x in lines if "query_name" in x]
            check(len(pairs) == 24 and lines[-1].get("done")
                  and sum(p["error"] is None for p in pairs) == n_ok,
                  f"serve -a wfa {extra} did not answer as the CLI")
    launches = {k: v[path] for k, v in by_path.items() if path in v}
    for name in ("wfa_fill", "wfa_walk"):
        check(launches.get(name, 0) > 0, f"{path} never launched {name}")
    log("[23 wfa] golden wfa, wfa-textbook and wfa-textbook with "
        "--wfa-engine wavefront stdout equal on cuda; semi-global "
        "--wfa-spans 5 aligned 24 pairs; serve -a wfa (compat, textbook) "
        f"answered as the CLI; launches {launches}")
    return meas


def i16_check(torch, fk, dk, fp, dp, label, dirs_mode):
    """An int16 fill kernel's finals (or argmax planes) and dirs against its
    int16 plain version's: the largest difference, failing unless every
    value and every direction word is equal."""
    err = max(int((a - b).abs().max()) for a, b in zip(fk, fp))
    if dirs_mode:
        whole = bool(torch.equal(dk.view(torch.int32), dp.view(torch.int32)))
        err = max(err, 0 if whole else 1)
    check(err == 0, f"int16 kernel != its plain version ({label}): err {err}")
    return err


def i16_timed(torch, launch):
    """int32 then int16 then int16 then int32 (CUDA events, 3 launches
    each after a warm-up): (int16 ms, int32 ms), each the mean of its
    two."""
    t32a = cuda_ms(torch, lambda: launch(torch.int32))
    t16a = cuda_ms(torch, lambda: launch(torch.int16))
    t16b = cuda_ms(torch, lambda: launch(torch.int16))
    t32b = cuda_ms(torch, lambda: launch(torch.int32))
    return (t16a + t16b) / 2, (t32a + t32b) / 2


def i16_edge_checks(torch, fill, smodes, to_device, pack_batch,
                    trim_for_stream, ScoringScheme):
    """The int16 instances at the certification's edge: N_I16_EDGE pairs
    of LEN_I16_EDGE bp under the default scheme (certified; one base
    longer is not) and the steep scheme I16_STEEP over short queries
    (certified with 20 to spare), each kind -- global fast4 and full, local
    and semi full -- against its int16 plain version (every value and
    direction word) and the int32 kernel (scores and finite finals, argmax
    planes).  Returns the errors and the cases' descriptions."""
    I16 = torch.int16
    rng = np.random.default_rng(LEN_I16_EDGE)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    steep = [(rng.choice(alpha, int(rng.integers(200, 257))).tobytes(),
              rng.choice(alpha, int(rng.integers(1, 5))).tobytes())
             for _ in range(12)]
    steep += [(b"A" * 256, b"T" * 4), (b"C" * 256, b"G")]
    cases = (("default scheme", make_pairs(rng, N_I16_EDGE, LEN_I16_EDGE),
              ScoringScheme()),
             ("steep scheme", steep, ScoringScheme(*I16_STEEP)))
    res = {"global": [], "modes": [], "cases": []}
    for label, prs, sc in cases:
        batch = pack_batch(prs, batch_size=len(prs))
        n = len(prs)
        for kind in ("fast4", "full", "local", "semi"):
            modes_kind = kind in ("local", "semi")
            tb = to_device(batch if modes_kind else trim_for_stream(batch),
                           "cuda")
            plan, ins = fill.stream_inputs(*tb, np_slots=2 if n > 2 else 1)
            neg = fill.stream_i16_neg(sc, plan)
            check(neg is not None, f"{label} is not certified for int16")
            if modes_kind:
                a = (plan, sc, False, kind, True)
                (bk, ek), dk = smodes.gotoh_fill_stream_modes_cuda(
                    *ins, *a, state_dtype=I16)
                (b32, e32), _ = smodes.gotoh_fill_stream_modes_cuda(*ins, *a)
                (bp, ep), dp = smodes.gotoh_fill_stream_modes_torch(
                    *ins, *a, state_dtype=I16)
                fill.check_stream_stalls(wait=True)
                res["modes"].append(i16_check(
                    torch, (bk, ek), dk, (bp, ep), dp,
                    f"edge {label} {kind}", True))
                check(bool(torch.equal(bk, b32) and torch.equal(ek, e32)),
                      f"int16 {kind} argmax planes != int32's ({label})")
                continue
            a = (plan, sc, True, False, kind)
            fk, dk = fill.gotoh_fill_stream_cuda(*ins, *a, state_dtype=I16)
            f32, _ = fill.gotoh_fill_stream_cuda(*ins, *a)
            fp, dp = fill.gotoh_fill_stream_torch(*ins, *a, state_dtype=I16)
            fill.check_stream_stalls(wait=True)
            res["global"].append(i16_check(torch, (fk,), dk, (fp,), dp,
                                           f"edge {label} {kind}", kind))
            a16, a32 = fk[:n], f32[:n]
            finite = a32 > -32768
            check(bool(torch.equal(a16.max(1).values, a32.max(1).values)
                       and torch.equal(a16[finite], a32[finite])),
                  f"int16 {kind} finals != int32's ({label})")
        res["cases"].append(
            f"{label}: {n} pairs, l1 {plan.l1} / l2 {plan.l2}, sentinel "
            f"{neg}")
    longer = pack_batch([(b"A" * (LEN_I16_EDGE + 1),
                          b"A" * (LEN_I16_EDGE + 1))], batch_size=1)
    check(fill.stream_i16_neg(ScoringScheme(), fill.stream_inputs(
        *to_device(longer, "cuda"))[0]) is None,
          f"a {LEN_I16_EDGE + 1} bp pair certifies for int16")
    return res


def phase_int16(torch, port, pairs, main_res, instances, by_path, out_dir):
    """Kernels #1 and #2's int16 instances (two lanes a 32-bit word):
    against their int16 plain versions and the int32 kernels, timed, and
    driven through the aligner, the runner and the CLI with the int16
    state."""
    from sequencealigning_tpu_torch.config import (
        AlignConfig,
        Algo,
        Mode,
        ScoringScheme,
    )
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import (
        pack_batch,
        trim_for_stream,
    )
    from sequencealigning_tpu_torch.ops.traceback import traceback_pair

    fill, smodes, walk, modes = (port["fill"], port["smodes"], port["walk"],
                                 port["modes"])
    I16 = torch.int16
    sc = ScoringScheme()
    out = {}
    gerrs, merrs = [], []

    # Every instance against its plain version on ragged batches.
    rpairs = ragged_pairs(np.random.default_rng(24), 40)
    gb = trim_for_stream(pack_batch(rpairs, batch_size=40))
    plan, ins = fill.stream_inputs(*to_device(gb, "cuda"))
    knobs = ({}, {"lanes_per_thread": 2, "chunk": 7},
             {"lanes_per_thread": 4, "chunk": 1, "ring_slots": 1},
             {"lanes_per_thread": 16})
    for compat in (True, False):
        for dm in (None, "fast4", "full"):
            for wc in (False, True):
                for k in knobs:
                    a = (plan, sc, compat, wc, dm)
                    with fill.forced_ring(**k):
                        fk, dk = fill.gotoh_fill_stream_cuda(
                            *ins, *a, state_dtype=I16)
                    fp, dp = fill.gotoh_fill_stream_torch(
                        *ins, *a, state_dtype=I16)
                    fill.check_stream_stalls(wait=True)
                    gerrs.append(i16_check(
                        torch, (fk,), dk, (fp,), dp,
                        f"global compat={compat} dirs={dm} wildcard={wc} "
                        f"{k}", dm))
    mb = pack_batch(rpairs, batch_size=40)
    plan, ins = fill.stream_inputs(*to_device(mb, "cuda"), np_slots=3)
    for mode in ("semi", "local"):
        for wd in (False, True):
            for wc in (False, True):
                for k in knobs:
                    a = (plan, sc, wc, mode, wd)
                    with fill.forced_ring(**k):
                        bk, dk = smodes.gotoh_fill_stream_modes_cuda(
                            *ins, *a, state_dtype=I16)
                    bp, dp = smodes.gotoh_fill_stream_modes_torch(
                        *ins, *a, state_dtype=I16)
                    fill.check_stream_stalls(wait=True)
                    merrs.append(i16_check(
                        torch, bk, dk, bp, dp,
                        f"{mode} dirs={wd} wildcard={wc} {k}", wd))
    sub = trim_for_stream(pack_batch(pairs[:256], batch_size=256))
    plan, ins = fill.stream_inputs(*to_device(sub, "cuda"))
    a = (plan, sc, True, False, "fast4")
    fk, dk = fill.gotoh_fill_stream_cuda(*ins, *a, cta_lanes=512,
                                         state_dtype=I16)
    fp, dp = fill.gotoh_fill_stream_torch(*ins, *a, state_dtype=I16)
    fill.check_stream_stalls(wait=True)
    gerrs.append(i16_check(torch, (fk,), dk, (fp,), dp, "4-CTA split",
                           "fast4"))
    edge = i16_edge_checks(torch, fill, smodes, to_device, pack_batch,
                           trim_for_stream, ScoringScheme)
    gerrs += edge["global"]
    merrs += edge["modes"]
    out["i16_edge"] = edge["cases"]
    log(f"[24 int16] certification edge: {'; '.join(edge['cases'])}: "
        "finals, argmax planes and whole dirs tensors equal to the int16 "
        "plain versions, scores and finite finals and argmax planes equal "
        "to the int32 kernels'")
    log(f"[24 int16] ragged: {len(gerrs) - 1 - len(edge['global'])} global "
        f"and {len(merrs) - len(edge['modes'])} modes "
        "fills (lanes a thread 2/4/16 and the default, chunks 1, 7 and the "
        f"default), and 256 x {LEN_MAIN} bp over 4 CTAs of 512 lanes: finals, "
        "argmax planes and whole dirs tensors equal to the int16 plain "
        "versions")
    del fk, dk, fp, dp, bk, bp

    # The main shape: each kind against its plain version and the int32
    # kernel, then timed beside its bound.
    n1s = np.asarray([len(x) for x, _ in pairs], np.int32)
    n2s = np.asarray([len(y) for _, y in pairs], np.int32)
    bs = np.arange(N_MAIN)

    def put(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.int32)).cuda()

    gbatch = trim_for_stream(pack_batch(pairs, batch_size=N_MAIN))
    gplan, gins = fill.stream_inputs(*to_device(gbatch, "cuda"))
    neg = fill.stream_i16_neg(sc, gplan)
    check(neg is not None, "the main shape is not certified for int16")
    mbatch = pack_batch(pairs, batch_size=N_MAIN)
    mplan, mins = fill.stream_inputs(*to_device(mbatch, "cuda"))
    small = pairs[:N_I16_PLAIN]
    cells = int((n1s.astype(np.int64) * n2s.astype(np.int64)).sum())
    rowp, off = bs // gplan.np_slots, (bs % gplan.np_slots) * gplan.s
    for dm in ("fast4", "full"):
        def launch(st, dm=dm):
            return fill.gotoh_fill_stream_cuda(*gins, gplan, sc, True, False,
                                               dm, state_dtype=st)
        f16, d16 = launch(I16)
        launch16 = dict(fill.gotoh_fill_stream_cuda.last_launch)
        f32, d32 = launch(torch.int32)
        fill.check_stream_stalls(wait=True)
        # Against the int32 kernel: every pair's score and every finite
        # final; the walks of both dirs.
        a16, a32 = f16[:N_MAIN], f32[:N_MAIN]
        finite = a32 > -32768
        same = bool(torch.equal(a16.max(1).values, a32.max(1).values)
                    and torch.equal(a16[finite], a32[finite]))
        check(same, f"int16 {dm} finals != int32's at the main shape")
        if dm == "fast4":
            walks = []
            for fin, dirs in ((a16, d16), (a32, d32)):
                seeds = [put(n2s), put(n1s),
                         put(walk.seed_planes(fin.cpu().numpy())),
                         put(rowp), put(off)]
                walks.append(walk.walk_fast4_cuda(
                    dirs, *seeds, gplan.l1 + gplan.l2))
            werr = walk_diff(torch, walks[0], walks[1])
            check(werr == 0, f"int16 fast4 walks != int32's: err {werr}")
            walked = f"all {N_MAIN} fast4 walks equal"
            del walks
        else:
            fh16, fh32 = a16.cpu().numpy(), a32.cpu().numpy()
            for b in np.random.default_rng(7).choice(N_MAIN, 8,
                                                     replace=False):
                r, o = int(rowp[b]), int(off[b])
                w16, w32 = (traceback_pair(
                    d[:, r, :].cpu().numpy(), fh[b], *pairs[b], compat=True,
                    max_alignments=1, d_offset=o)
                    for d, fh in ((d16, fh16), (d32, fh32)))
                check(w16 == w32, f"int16 full walk != int32's, pair {b}")
            walked = "8 sampled co-optimal host walks equal"
        del d32
        # Against the int16 plain version: fast4 on every pair, full on the
        # first N_I16_PLAIN.
        if dm == "fast4":
            plain_ms, (fp, dp) = host_ms(torch, lambda: fill.gotoh_fill_stream_torch(
                *gins, gplan, sc, True, False, dm, state_dtype=I16))
            gerrs.append(i16_check(torch, (f16,), d16, (fp,), dp,
                                   "main shape fast4", dm))
            plain_on = f"{N_MAIN} pairs"
        else:
            del d16
            sb = trim_for_stream(pack_batch(small, batch_size=N_I16_PLAIN))
            splan, sins = fill.stream_inputs(*to_device(sb, "cuda"))
            fk, dk = fill.gotoh_fill_stream_cuda(*sins, splan, sc, True,
                                                 False, dm, state_dtype=I16)
            plain_ms, (fp, dp) = host_ms(torch, lambda: fill.gotoh_fill_stream_torch(
                *sins, splan, sc, True, False, dm, state_dtype=I16))
            gerrs.append(i16_check(torch, (fk,), dk, (fp,), dp,
                                   f"{N_I16_PLAIN} pairs full", dm))
            plain_on = f"{N_I16_PLAIN} pairs"
            del fk, dk
        del fp, dp
        torch.cuda.empty_cache()
        ms, ms32 = i16_timed(torch, launch)
        nbytes_io = nbytes(*gins, f16) + gplan.t_total // (
            8 if dm == "fast4" else 4) * gplan.n_rows * gplan.p * 4
        b_ms, b_by = bound(nbytes_io, cells * OPS_PER_CELL[dm] / 2)
        reg = instance_of(instances, "i16", launch16, "global", dm, True)
        out.update({f"i16_{dm}_ms": ms, f"i16_{dm}_int32_ms": ms32,
                    f"i16_{dm}_plain_ms": plain_ms,
                    f"i16_{dm}_plain_on": plain_on,
                    f"i16_{dm}_bound_ms": b_ms, f"i16_{dm}_bound_by": b_by,
                    f"i16_{dm}_err": max(gerrs),
                    f"i16_{dm}_launch": launch16,
                    f"i16_{dm}_registers": reg})
        log(f"[24 int16] {N_MAIN} x {LEN_MAIN} bp global {dm} (sentinel "
            f"{neg}): int16 kernel {ms:.3f} ms, int32 kernel {ms32:.3f} ms "
            f"(same call), plain {plain_ms:.1f} ms on {plain_on}, bound "
            f"{b_ms:.3f} ms ({b_by}, a 16x2 instruction two operations; "
            f"{100 * b_ms / ms:.1f}%); {launch16['lanes_per_thread']} lanes "
            f"x {launch16['threads']} threads, "
            + (f"{reg['registers']} registers, {reg['spill_stores']} B "
               "spilled" if reg else "registers not in the build log")
            + f"; equal to the plain version, scores and finite finals equal"
            f" to int32's, {walked}")
        del f16, f32
        torch.cuda.empty_cache()

    mrowp, moff = bs // mplan.np_slots, (bs % mplan.np_slots) * mplan.s
    P = mplan.p
    for mode in ("local", "semi"):
        local = mode == "local"

        def launch(st, mode=mode):
            return smodes.gotoh_fill_stream_modes_cuda(
                *mins, mplan, sc, False, mode, True, state_dtype=st)
        (b16, e16), d16 = launch(I16)
        launch16 = dict(smodes.gotoh_fill_stream_modes_cuda.last_launch)
        (b32, e32), d32 = launch(torch.int32)
        fill.check_stream_stalls(wait=True)
        check(bool(torch.equal(b16, b32) and torch.equal(e16, e32)),
              f"int16 {mode} argmax planes != int32's at the main shape")
        walks = []
        for bv, bd, dirs in ((b16, e16, d16), (b32, e32, d32)):
            _, x, y = modes.modes_reduce(bv.transpose(0, 1).reshape(-1, P),
                                         bd.transpose(0, 1).reshape(-1, P))
            seeds = [x[:N_MAIN].contiguous(), y[:N_MAIN].contiguous(),
                     put(mrowp), put(moff)]
            walks.append(walk.walk_modes_cuda(dirs, *seeds, local,
                                              mplan.l1 + mplan.l2))
        werr = walk_diff(torch, walks[0], walks[1])
        check(werr == 0, f"int16 {mode} walks != int32's: err {werr}")
        del walks, d16, d32, b32, e32
        torch.cuda.empty_cache()
        sb = pack_batch(small, batch_size=N_I16_PLAIN)
        splan, sins = fill.stream_inputs(*to_device(sb, "cuda"))
        a = (splan, sc, False, mode, True)
        bk, dk = smodes.gotoh_fill_stream_modes_cuda(*sins, *a,
                                                     state_dtype=I16)
        plain_ms, (bp, dp) = host_ms(
            torch, lambda: smodes.gotoh_fill_stream_modes_torch(
                *sins, *a, state_dtype=I16))
        merrs.append(i16_check(torch, bk, dk, bp, dp,
                               f"{N_I16_PLAIN} pairs {mode}", True))
        del bk, dk, bp, dp
        torch.cuda.empty_cache()
        ms, ms32 = i16_timed(torch, launch)
        nbytes_io = nbytes(*mins, b16, e16) + (
            mplan.t_total // 4 * mplan.n_rows * mplan.p * 4)
        b_ms, b_by = bound(nbytes_io, cells * OPS_PER_CELL[
            "local full" if local else "full"] / 2)
        reg = instance_of(instances, "i16", launch16, mode, "full", False)
        out.update({f"i16_{mode}_ms": ms, f"i16_{mode}_int32_ms": ms32,
                    f"i16_{mode}_plain_ms": plain_ms,
                    f"i16_{mode}_plain_on": f"{N_I16_PLAIN} pairs",
                    f"i16_{mode}_bound_ms": b_ms,
                    f"i16_{mode}_bound_by": b_by,
                    f"i16_{mode}_err": max(merrs),
                    f"i16_{mode}_launch": launch16,
                    f"i16_{mode}_registers": reg})
        log(f"[24 int16] {N_MAIN} x {LEN_MAIN} bp {mode} full: int16 kernel "
            f"{ms:.3f} ms, int32 kernel {ms32:.3f} ms (same call), plain "
            f"{plain_ms:.1f} ms on {N_I16_PLAIN} pairs, bound {b_ms:.3f} ms "
            f"({b_by}, a 16x2 instruction two operations; "
            f"{100 * b_ms / ms:.1f}%); {launch16['lanes_per_thread']} lanes "
            f"x {launch16['threads']} threads, "
            + (f"{reg['registers']} registers, {reg['spill_stores']} B "
               "spilled" if reg else "registers not in the build log")
            + f"; equal to the plain version on {N_I16_PLAIN} pairs; argmax "
            f"planes and all {N_MAIN} walks equal to int32's")
        del b16, e16
        torch.cuda.empty_cache()
    out["i16_global_errs"], out["i16_modes_errs"] = gerrs, merrs
    del gins, mins
    torch.cuda.empty_cache()

    # The aligner, the runner and the CLI with the int16 state.
    recs = records(pairs)
    cfg = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True,
                      stream_state="i16")
    path = "int16 global first-only"
    aligner = port["models"].GotohAligner(cfg, "cuda")
    with path_launches(port, by_path, path):
        t0 = time.perf_counter()
        res = aligner.align_batch(recs)
        secs = time.perf_counter() - t0
    launches = {k: v[path] for k, v in by_path.items() if path in v}
    check(launches.get("nw_affine_stream_fill_i16", 0) > 0
          and "nw_affine_stream_fill" not in launches,
          f"{path}: launches {launches}")
    check([(r.score, r.aligned_query, r.aligned_db) for r in res]
          == [(r.score, r.aligned_query, r.aligned_db) for r in main_res],
          f"{path}: alignments != phase 5's (int32)")
    log(f"[24 int16] GotohAligner first-only stream_state i16, {N_MAIN} "
        f"pairs: {secs:.3f} s, {N_MAIN / secs:.1f} alignments/s; launches "
        f"{launches}; every alignment equal to phase 5's int32 run")
    del res, aligner
    lrecs = recs[:N_I16_LOCAL]
    got = {}
    for st in ("i16", "i32"):
        lcfg = AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=Mode.LOCAL,
                           compat=False, stream_state=st)
        lpath = f"{st} textbook local"
        with path_launches(port, by_path, lpath):
            t0 = time.perf_counter()
            res = port["models"].GotohAligner(lcfg, "cuda").align_batch(
                lrecs)
            got[st] = (time.perf_counter() - t0, [
                (r.score, r.aligned_query, r.aligned_db) for r in res])
    llaunch = {k: v["i16 textbook local"] for k, v in by_path.items()
               if "i16 textbook local" in v}
    check(llaunch.get("nw_affine_stream_modes_fill_i16", 0) > 0
          and "nw_affine_stream_modes_fill" not in llaunch,
          f"int16 textbook local: launches {llaunch}")
    check(got["i16"][1] == got["i32"][1],
          "int16 textbook local alignments != int32's")
    log(f"[24 int16] GotohAligner textbook local stream_state i16, "
        f"{N_I16_LOCAL} pairs: {got['i16'][0]:.3f} s (int32 "
        f"{got['i32'][0]:.3f} s); launches {llaunch}; alignments equal to "
        "the int32 run's")
    batch = pack_batch(pairs, batch_size=N_MAIN)
    rpath = "int16 runner scores"
    runner16 = port["parallel"].DataParallelRunner(["cuda"],
                                                   state_dtype="i16")
    with path_launches(port, by_path, rpath):
        s16 = runner16.scores(batch)
    s32 = port["parallel"].DataParallelRunner(["cuda"]).scores(batch)
    check(bool(torch.equal(s16.max(1).values, s32.max(1).values)),
          "int16 runner scores != int32's")
    rl = {k: v[rpath] for k, v in by_path.items() if rpath in v}
    check(rl.get("nw_affine_stream_fill_i16", 0) > 0
          and "nw_affine_stream_fill" not in rl, f"{rpath}: launches {rl}")
    cpath = "int16 and walk-route CLI"
    nw = ["-a", "needleman-wunsch"]
    with path_launches(port, by_path, cpath):
        for name, extra in (("needleman-wunsch", nw),
                            ("nw-first-only", nw + ["--first-only"])):
            run_golden(port, name, extra + ["--stream-state", "i16"])
        for name, extra in (("nw-first-only", nw + ["--first-only"]),
                            ("nw-local-textbook",
                             nw + ["-m", "local", "--textbook"]),
                            ("nw-semiglobal-textbook",
                             nw + ["-m", "semi-global", "--textbook"])):
            run_golden(port, name, extra + ["--traceback", "host"])
    cl = {k: v[cpath] for k, v in by_path.items() if cpath in v}
    check(cl.get("nw_affine_stream_fill_i16", 0) > 0,
          f"--stream-state i16 never launched the int16 fill: {cl}")
    with tempfile.TemporaryDirectory() as prof:
        err = run_golden(port, "nw-first-only",
                         nw + ["--first-only", "--profile", prof])
        traces = [f for f in os.listdir(prof) if f.startswith("trace_")]
        check(len(traces) >= 1 and "trace written to" in err,
              "--profile wrote no trace")
        with open(os.path.join(prof, traces[0])) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(kernels > 0, "--profile's trace holds no CUDA kernel event")
    log(f"[24 int16] runner scores with stream_state i16 equal int32's "
        f"(launches {rl}); golden CLI with --stream-state i16 "
        "(needleman-wunsch, nw-first-only) and --traceback host "
        "(nw-first-only, nw-local-textbook, nw-semiglobal-textbook) equal; "
        f"launches {cl}; --profile wrote {traces[0]} with {kernels} CUDA "
        "kernel events")
    return out


def phase_soak(torch, port, by_path):
    """Phase 27: the soak (sequencealigning_tpu_torch.soak) on the card at
    fixed seeds, every kernel launched and no mismatch; then the dry run
    (sequencealigning_tpu_torch.dryrun) over make_mesh() and over
    DRYRUN_SHARDS shards of cuda:0."""
    from sequencealigning_tpu_torch import dryrun, soak

    check(set(soak.COUNTERS) == set(KERNELS),
          f"the soak counts {sorted(set(soak.COUNTERS) ^ set(KERNELS))} "
          "unlike KERNELS")
    with path_launches(port, by_path, "soak"):
        reps = [soak.run_soak(SOAK_ROUNDS, SOAK_SEED, max_len=SOAK_LEN),
                soak.run_soak(1, SOAK_SEED + 1, max_len=SOAK_LEN,
                              long_len=SOAK_LONG_LEN)]
    for rep in reps:
        log(f"[27 soak] {rep.rounds} rounds, seed {rep.seed}, <= "
            f"{rep.max_len} bp, long_len {rep.long_len}: "
            + json.dumps(rep.summary()))
    bad = [m.line() for rep in reps for m in rep.mismatches]
    check(not bad, f"the soak found {len(bad)} mismatches: {bad[:5]}")
    launches = {k: sum(rep.launches[k] for rep in reps) for k in KERNELS}
    missing = sorted(k for k, n in launches.items() if not n)
    check(not missing, f"the soak launched no {missing}")
    meshes = ((torch.cuda.device_count(), None),
              (DRYRUN_SHARDS, ["cuda:0"] * DRYRUN_SHARDS))
    dry = []
    with path_launches(port, by_path, "dryrun"):
        for n, devices in meshes:
            t0 = time.perf_counter()
            try:
                out = dryrun.dryrun_multichip(n, devices)
            except dryrun.DryRunFailure as e:
                raise SmokeFailure(f"dryrun_multichip({n}, {devices}): {e}")
            dry.append(dict(devices=out["devices"],
                            seconds=time.perf_counter() - t0))
            log(f"[27 dryrun] {out['devices']}: runner scores, state auto, "
                "device walk, fused fill+walk, semi-global modes and "
                f"seqpar_fill checked in {dry[-1]['seconds']:.2f} s")
    log(f"[27 soak] every kernel launched: {json.dumps(launches)}; "
        f"{sum(sum(r.checks.values()) for r in reps)} checks, 0 "
        f"mismatches, {sum(r.seconds for r in reps):.1f} s")
    return {"soak": [r.summary() for r in reps], "soak_launches": launches,
            "dryrun": dry}


def instance_of(instances, state, launch, mode, dirs, compat):
    """The build log's row of the streamed-fill instance a launch ran
    (wildcard off), or None."""
    for r in instances:
        if (r["state"], r["lanes_per_thread"], r["mode"], r["dirs"],
                r["compat"], r["wildcard"]) == (
                    state, launch["lanes_per_thread"], mode, dirs, compat,
                    False):
            return r
    return None


def stream_times_line(meas, instances):
    """One line: kernels #1 and #2 at the main shape, their times beside
    their bounds, and the registers and spills of the instances that ran."""
    def regs(launch, mode, dirs, compat):
        r = instance_of(instances, "i32", launch, mode, dirs, compat)
        if r is None:
            return "registers not in the build log"
        return f"{r['registers']} registers, {r['spill_stores']} B spilled"

    parts = []
    for name, key, mode, dirs, compat in (
            ("#1 global fast4", "fill", "global", "fast4", True),
            ("#2 local full", "sfill_local", "local", "full", False),
            ("#2 semi full", "sfill_semi", "semi", "full", False)):
        launch = meas[f"{key}_launch"]
        parts.append(
            f"{name} {meas[f'{key}_ms']:.3f} ms against a bound of "
            f"{meas[f'{key}_bound_ms']:.3f} ms "
            f"({100 * meas[f'{key}_bound_ms'] / meas[f'{key}_ms']:.1f}%; "
            f"{launch['lanes_per_thread']} lanes x {launch['threads']} "
            f"threads, chunks of {launch['chunk']}, "
            f"{regs(launch, mode, dirs, compat)})")
    log("[7 modes full] streamed fills at the main shape: "
        + "; ".join(parts))


@contextlib.contextmanager
def timed(seconds, name):
    """Time one phase on the host clock: print its wall seconds and keep
    them in seconds[name]."""
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0
    log(f"[{name}] phase wall {seconds[name]:.1f} s")


def run(args):
    if not os.path.isdir(os.path.join(ROOT, "sequencealigning_tpu_torch")):
        raise SmokeFailure("sequencealigning_tpu_torch/ is not beside this "
                           "script: run it from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()
    phase_s = {}
    with timed(phase_s, "1 device"):
        card = phase_device(torch)
    from sequencealigning_tpu_torch import cli, csrc, models, parallel
    from sequencealigning_tpu_torch.ops import (
        nw_affine,
        nw_affine_modes,
        nw_affine_stream,
        nw_affine_stream_modes,
        nw_affine_tiled,
        nw_banded,
        nw_banded_diag,
        mm_align,
        nw_linear,
        traceback_device,
        wfa,
    )

    port = {"cli": cli, "csrc": csrc, "models": models, "parallel": parallel,
            "fill": nw_affine_stream, "walk": traceback_device,
            "modes": nw_affine_modes, "smodes": nw_affine_stream_modes,
            "banded": nw_banded_diag, "tiled": nw_affine_tiled,
            "nw": nw_affine, "row": nw_banded, "linear": nw_linear,
            "wfa": wfa, "mm": mm_align}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    by_path = {}
    with timed(phase_s, "2 build"):
        build_s, instances = phase_build(csrc, args.out)
    with timed(phase_s, "3 fill"):
        meas, state = phase_fill(torch, port)
    with timed(phase_s, "4 walk"):
        meas.update(phase_walk(torch, port, state))
    pairs = state[3]
    stream_finals = state[0][:N_MAIN].clone()
    del state
    torch.cuda.empty_cache()
    with timed(phase_s, "5 main"):
        main_meas, (aligner, recs, main_res) = phase_main(torch, port, pairs,
                                                          by_path)
        meas.update(main_meas)
        meas.update(phase_profile(torch, aligner, recs, args.out))
        del aligner, recs
    torch.cuda.empty_cache()
    with timed(phase_s, "16 global fill"):
        meas.update(phase_gotoh_fill(torch, port, pairs, stream_finals))
    torch.cuda.empty_cache()
    with timed(phase_s, "17 runner"):
        meas.update(phase_runner(torch, port, pairs, main_res, by_path,
                                 args.out))
    torch.cuda.empty_cache()
    with timed(phase_s, "24 int16"):
        meas.update(phase_int16(torch, port, pairs, main_res, instances,
                                by_path, args.out))
    del main_res
    torch.cuda.empty_cache()
    with timed(phase_s, "20 linear"):
        meas.update(phase_linear(torch, port, pairs, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "6 modes fill"):
        meas.update(phase_modes_fill(torch, port))
    mpairs = make_pairs(np.random.default_rng(0), N_MAIN, LEN_MAIN)
    for mode in ("local", "semi"):
        with timed(phase_s, f"7 modes {mode}"):
            meas.update(phase_modes_full(torch, port, mode, mpairs))
    stream_times_line(meas, instances)
    with timed(phase_s, "8 modes main"):
        meas.update(phase_modes_main(torch, port, mpairs, args.out, by_path))
    del mpairs
    with timed(phase_s, "9 cli"):
        phase_cli(torch, port, by_path)
    bpairs = make_pairs(np.random.default_rng(4), N_BAND, LEN_BAND)
    with timed(phase_s, "10 banded fill"):
        bmeas, state = phase_banded_fill(torch, port, bpairs)
        meas.update(bmeas)
    with timed(phase_s, "11 banded walk"):
        meas.update(phase_banded_walk(torch, port, bpairs, state))
    del state
    torch.cuda.empty_cache()
    with timed(phase_s, "12 banded main"):
        meas.update(phase_banded_main(torch, port, bpairs, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "19 banded row"):
        meas.update(phase_banded_row(torch, port, bpairs, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "22 graph replay"):
        meas.update(phase_graph_replay(torch, port, bpairs))
    del bpairs
    torch.cuda.empty_cache()
    with timed(phase_s, "13 ceiling"):
        meas.update(phase_ceiling(torch, port, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "18 wide band"):
        meas.update(phase_wide_band(torch, port, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "14 tiled"):
        meas.update(phase_tiled(torch, port))
    with timed(phase_s, "15 long"):
        meas.update(phase_long(torch, port, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "25 seqpar"):
        meas.update(phase_seqpar(torch, port, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "26 seqpar ranks"):
        meas.update(phase_seqpar_ranks(torch, port, by_path))
    with timed(phase_s, "21 a-star"):
        meas.update(phase_astar(torch, port, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "23 wfa"):
        meas.update(phase_wfa(torch, port, by_path))
    torch.cuda.empty_cache()
    with timed(phase_s, "27 soak"):
        meas.update(phase_soak(torch, port, by_path))
    total = time.perf_counter() - t_start
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}) + f"; total {total:.1f}")
    meas.update(build_s=build_s, card=card, launches=by_path,
                phase_s=phase_s, total_s=total)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(meas, f, indent=1)
    return card, kernel_entries(meas, by_path)


def banded_shapes(meas):
    """Kernel #3's times and bounds at each shape the paths give it, with
    its tiles: config 4 (fast4, full), batch B's band 128, batch A's band
    rounds, the bands past 131072 lanes."""
    def tiles(shape):
        out = {k: shape[k] for k in (
            "strip_lanes", "block_iters", "strips", "rows", "halo",
            "lanes_per_thread", "threads", "tiles", "ctas", "resident",
            "sms")}
        per_pair = shape["sms_per_pair"]
        out["sms_per_pair_min_max"] = [min(per_pair), max(per_pair)]
        return out

    band = f"{N_BAND} x {LEN_BAND} bp band {BAND}"
    out = {}
    for dirs in ("fast4", "full"):
        out[f"config4_{dirs}"] = dict(
            timed_on=f"{band} {dirs}", ms=meas[f"bfill_{dirs}_ms"],
            plain_ms=meas[f"bfill_{dirs}_plain_ms"],
            bound_ms=meas[f"bfill_{dirs}_bound_ms"],
            bound_by=meas[f"bfill_{dirs}_bound_by"],
            tiles=tiles(meas["bfill_shape"]))
    for tag in ("strips128", "strips64"):
        out[f"config4_fast4_{tag}"] = dict(ms=meas[f"bfill_{tag}_ms"])
    out["batch_B"] = dict(
        timed_on=f"batch B's band {BAND} (2 pairs, L = "
        f"{meas['bfillB_lanes']}), fast4; ms the mean of {N_RACE} launches",
        ms=meas["bfillB_ms"], first_ms=meas["bfillB_first_ms"],
        race_ms=meas["bfillB_race_ms"], plain_ms=meas["bfillB_plain_ms"],
        bound_ms=meas["bfillB_bound_ms"], bound_by=meas["bfillB_bound_by"],
        gcups=meas["bfillB_gcups"], pct_of_bound=meas["bfillB_pct_of_bound"],
        tiles=tiles(meas["bfillB_shape"]))
    for b, r in meas["bfillA_rounds"].items():
        out[f"batch_A_band_{b}"] = dict(
            timed_on=f"batch A ({N_LONG} x {LEN_LONG_PAIR} bp) band {b} "
            f"(L = {r['lanes']}), fast4", ms=r["ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], tiles=tiles(r["shape"]))
    for b in WIDE_BANDS:
        out[f"wide_{b}"] = dict(
            timed_on=f"{N_WIDE} pairs of {LEN_WIDE_LO}-{LEN_WIDE_HI} bp band "
            f"{b} (L = {meas[f'wide{b}_lanes']}), fast4",
            ms=meas[f"wide{b}_ms"], plain_ms=meas[f"wide{b}_plain_ms"],
            bound_ms=meas[f"wide{b}_bound_ms"],
            bound_by=meas[f"wide{b}_bound_by"],
            tiles=tiles(meas[f"wide{b}_shape"]))
    out["natural_split"] = dict(ms=meas["bfill_natural_split_ms"],
                                lanes=meas["bfill_natural_split_lanes"])
    out["stall_raised_after_s"] = meas["bfill_stall_s"]
    return out


def kernel_entries(meas, by_path):
    """The `kernels` line: per kernel its launches (in total and by path),
    its largest error over every comparison, its kernel and plain times
    with the shape they were taken at, its bound and library_ms (null)."""
    main = f"{N_MAIN} x {LEN_MAIN} bp"
    band = f"{N_BAND} x {LEN_BAND} bp band {BAND}"
    ceil = meas["ceiling_err"]
    errs = {
        "nw_affine_stream_fill": [meas["fill_err"], meas["fill_split4_err"],
                                  ceil["nw_affine_stream_fill"]],
        "walk_fast4": [meas["walk_err"], meas["walk_one_pair"]["err"]],
        "nw_affine_modes_fill": [meas["mfill_err"], meas["mfill_semi_err"],
                                 ceil["nw_affine_modes_fill"]],
        "nw_affine_stream_modes_fill": [meas["sfill_ragged_err"],
                                        meas["sfill_local_err"],
                                        meas["sfill_semi_err"],
                                        ceil["nw_affine_stream_modes_fill"]],
        "nw_affine_stream_fill_i16": meas["i16_global_errs"],
        "nw_affine_stream_modes_fill_i16": meas["i16_modes_errs"],
        "walk_modes": [meas["mwalk_local_err"], meas["mwalk_semi_err"]] + [
            v["err"] for v in meas["mwalk_pairs"].values()],
        "nw_banded_diag_fill": [meas["bfill_ragged_err"],
                                meas["bfill_fast4_err"],
                                meas["bfill_full_err"],
                                meas["bfill_strips128_err"],
                                meas["bfill_strips64_err"],
                                meas["bfill_natural_split_err"],
                                meas["bfillB_err"], meas["wide_err"]],
        "walk_banded": [meas["bwalk_err"], meas["bwalkA"]["err"],
                        meas["bwalkB"]["err"]],
        "nw_affine_tiled_fill": [meas["tiled_small_err"],
                                 meas["tiled_full_err"]],
        "nw_affine_tiled_fold_fill": [meas["tfold_small_err"],
                                      meas["tfold_full_err"]],
        "nw_affine_fill": [meas["gfill_err"], meas["gfill_stream_err"],
                           meas["gfill_full_err"]],
        "nw_banded_fill": [meas["rfill_ragged_err"], meas["rfill_fast4_err"],
                           meas["rfill_full_err"],
                           meas["rfill_fast4_cross_err"],
                           meas["rfill_full_cross_err"]],
        "nw_linear_fill": [meas[f"lfill_{t}_err"] for t in (
            "ragged", "global", "textbook", "local", "dirs", "local_dirs",
            "small")],
        "wfa_fill": [meas["wfa_fill_ragged_err"]] + [
            v for k, v in meas.items()
            if k.startswith("wfa_fill_") and k.endswith("_err")],
        "wfa_walk": [meas["wfa_walk_err"]],
        "mm_rows": meas["mm_rows_errs"],
        "seqpar_shard": [meas["seqpar_err"], meas["seqpar_ranks_err"]],
    }
    times = {
        "nw_affine_stream_fill": ("fill", f"{main} global fast4"),
        "walk_fast4": ("walk", f"{main} global"),
        "nw_affine_modes_fill": ("mfill", f"31 x {LEN_MAIN} bp local"),
        "nw_affine_stream_modes_fill": ("sfill_local", f"{main} local"),
        "nw_affine_stream_fill_i16": (
            "i16_fast4", f"{main} global fast4, int16 state; plain_ms on "
            f"{meas['i16_fast4_plain_on']}; bound: a 16x2 instruction "
            "counts as two of OPS_PER_CELL's operations"),
        "nw_affine_stream_modes_fill_i16": (
            "i16_local", f"{main} local, int16 state; plain_ms on "
            f"{N_I16_PLAIN} pairs; bound: a 16x2 instruction counts as two "
            "of OPS_PER_CELL's operations"),
        "walk_modes": ("mwalk_local", f"{main} local"),
        "nw_banded_diag_fill": ("bfill_fast4", f"{band} fast4"),
        "walk_banded": ("bwalk", f"{band}"),
        "nw_affine_tiled_fill": (
            "tiled", f"ms (mean of {N_RACE} launches), bound: batch A, "
            f"{N_LONG} x {LEN_LONG_PAIR} bp; "
            f"plain_ms, small_ms: 16 pairs <= {LEN_TILE_SMALL} bp; "
            f"rows_plain_ms: the plain row sweep over batch A and B's second "
            "pair"),
        "nw_affine_tiled_fold_fill": (
            "tfold", f"ms (mean of {N_RACE} launches), bound: batch B, 2 "
            f"pairs of {LEN_LONG_PAIR} bp "
            f"(db {LEN_LONG_PAIR} and {LEN_LONG_PAIR - LONG_DROP}); plain_ms, "
            f"small_ms: 2 pairs <= {LEN_FOLD_SMALL} bp; rows_plain_ms: as "
            "kernel #4's"),
        "nw_affine_fill": ("gfill", f"{main} score-only, the runner's plain "
                           "layout"),
        "nw_banded_fill": ("rfill_fast4", f"{band} fast4"),
        "nw_linear_fill": ("lfill_global", f"{main} global compat "
                           "score-only"),
        "wfa_fill": ("wfa_fill_c3", f"{N_WFA} x {LEN_WFA} bp (config 3) band "
                     f"{WFA_BAND}, penalties 4/2/6: the whole fill, the seed "
                     "and the chunks the fill loop queues"),
        "wfa_walk": ("wfa_walk_c3", f"{N_WFA} x {LEN_WFA} bp (config 3) band "
                     f"{WFA_BAND}, every pair's walk"),
        "mm_rows": ("mm_top_short", "the top node of the "
                    f"{LEN_MM_SHORT} bp escape, both sweeps, the launch "
                    "alone (its scratch allocated and zeroed before the "
                    "events)"),
        "seqpar_shard": (
            "seqpar", f"ms (mean of {N_RACE} calls of the wrapper: the "
            f"{SEQPAR_SHARDS} launches and the wrapper's copies), bound: one "
            f"{SEQPAR_LEN} x {SEQPAR_LEN} bp pair over {SEQPAR_SHARDS} "
            "shards of one card, tile_lanes 4096; plain_ms, small_ms: 8 "
            f"ragged pairs (queries <= {SEQPAR_RAGGED_Q} bp, dbs <= "
            f"{SEQPAR_RAGGED_DB} bp) over 4 shards, tile_lanes 128; "
            "tiled_ms: kernel #4 on the 200 kb pair"),
    }
    kernels = []
    for name, (_key, _fn, source, replaces, *_rest) in KERNELS.items():
        paths = by_path.get(name, {})
        check(sum(paths.values()) > 0,
              f"no main path launched the {name} kernel")
        key, shape = times[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(errs[name]),
            "ms": meas[f"{key}_ms"],
            "plain_ms": meas[f"{key}_plain_ms"],
            "bound_ms": meas[f"{key}_bound_ms"],
            "bound_by": meas[f"{key}_bound_by"],
            "library_ms": None,
            "timed_on": shape,
        }
        if name == "seqpar_shard":
            entry.update(small_ms=meas["seqpar_small_ms"],
                         call_ms=meas["seqpar_call_ms"],
                         race_ms=meas["seqpar_race_ms"],
                         tiled_ms=meas["seqpar_tiled_ms"],
                         gcups=meas["seqpar_gcups"],
                         pct_of_bound=meas["seqpar_pct_of_bound"],
                         launch=meas["seqpar_shape"],
                         align_s=meas["seqpar_align_s"],
                         stall_raised_after_s=meas["seqpar_stall_s"],
                         distinct_cards_ms=meas["seqpar_cards_ms"],
                         ranks={k[len("seqpar_ranks_"):]: v
                                for k, v in meas.items()
                                if k.startswith("seqpar_ranks_")})
        elif f"{key}_small_ms" in meas:
            entry["small_ms"] = meas[f"{key}_small_ms"]
            entry["rows_plain_ms"] = meas["rows_plain_ms"]
            entry["first_ms"] = meas[f"{key}_first_ms"]
            entry["race_ms"] = meas[f"{key}_race_ms"]
            entry["gcups"] = meas[f"{key}_gcups"]
            entry["pct_of_bound"] = meas[f"{key}_pct_of_bound"]
            entry["launch"] = meas[f"{key}_shape"]
        if name == "nw_banded_diag_fill":
            entry["shapes"] = banded_shapes(meas)
        if name.endswith("_i16"):
            entry.update(int32_ms=meas[f"{key}_int32_ms"],
                         launch=meas[f"{key}_launch"],
                         registers=meas[f"{key}_registers"])
        if name == "nw_affine_modes_fill":
            entry["semi"] = {k: meas[f"mfill_semi_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "err")}
            entry["shapes"] = meas["mfill_shapes"]
            entry["crossover"] = meas["mfill_crossover"]
            entry["whole_dirs_equal"] = meas["mfill_whole_dirs_equal"]
            entry["outside_zero"] = meas["mfill_outside_zero"]
        if name == "walk_fast4":
            entry.update(ns_per_step=meas["walk_ns_per_step"],
                         slow_reads=meas["walk_slow"],
                         restagings=meas["walk_restagings"],
                         one_pair=meas["walk_one_pair"])
        if name == "walk_modes":
            entry.update(ns_per_step=meas["mwalk_local_ns_per_step"],
                         slow_reads=meas["mwalk_local_slow"],
                         restagings=meas["mwalk_local_restagings"],
                         per_pair_dirs=meas["mwalk_pairs"])
        if name == "walk_banded":
            entry.update(ns_per_step=meas["bwalk_ns_per_step"],
                         slow_reads=meas["bwalk_slow"],
                         steps=meas["bwalk_steps"],
                         forced_window_slow_reads=meas["bwalk_forced_slow"],
                         batch_A=meas["bwalkA"], batch_B=meas["bwalkB"])
        if name == "nw_affine_fill":
            entry["full"] = {
                "ms": meas["gfill_full_ms"],
                "plain_ms": meas["gfill_full_plain_ms"],
                "bound_ms": meas["gfill_full_bound_ms"],
                "bound_by": meas["gfill_full_bound_by"],
                "max_abs_err": meas["gfill_full_err"],
                "timed_on": f"{N_GOTOH_DIRS} x {LEN_MAIN} bp full dirs"}
            entry["launch"] = meas["gfill_launch"]
            entry["batches_ms"] = {
                f"{k} x {LEN_MAIN} bp score-only": v
                for k, v in meas["gfill_batches_ms"].items()}
        if name == "nw_banded_fill":
            entry["bound_needed_ms"] = meas["rfill_fast4_bound_needed_ms"]
            entry["band_diagonals"] = meas["rfill_band_diagonals"]
        if name == "nw_linear_fill":
            for tag in ("textbook", "local", "dirs", "local_dirs"):
                entry[tag] = {k: meas[f"lfill_{tag}_{k}"] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")}
            for tag in ("dirs", "local_dirs"):
                entry[tag]["timed_on"] = f"{N_LINEAR_DIRS} x {LEN_MAIN} bp " \
                    "with path bits"
            entry["batches_ms"] = {
                f"{k.split('_')[0]} x {LEN_MAIN} bp {k.split('_')[1]} with "
                "path bits": v for k, v in meas["lfill_batches_ms"].items()}
        if name == "wfa_fill":
            entry.update(
                chunk_ms=meas["wfa_fill_c3_chunk_ms"],
                lattice_steps=meas["wfa_fill_c3_steps"],
                lanes=meas["wfa_fill_c3_lanes"],
                characters_extended=meas["wfa_fill_c3_extended"],
                indel={f"band {b}": {k: meas[f"{key}_{k}"] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "chunk_ms",
                    "steps", "lanes", "extended", "converged")}
                    for b, key in ((WFA_BAND, "wfa_fill_indel"),
                                   (2 * WFA_BAND, f"wfa_fill_indel_band"
                                    f"{2 * WFA_BAND}"),
                                   (4 * WFA_BAND, f"wfa_fill_indel_band"
                                    f"{4 * WFA_BAND}"))},
                pairs={n: {k: meas[f"wfa_fill_c3_{n}_{k}"] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "chunk_ms")}
                    for n in (1, 4)})
        if name == "wfa_walk":
            entry.update(
                ns_per_step=meas["wfa_walk_c3_ns_per_step"],
                steps=meas["wfa_walk_c3_steps"],
                indel={k: meas[f"wfa_walk_indel_{k}"] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "steps",
                    "ns_per_step")},
                pairs={n: {k: meas[f"wfa_walk_c3_{n}_{k}"] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")}
                    for n in (1, 4)},
                alignments_per_s={e: meas[f"wfa_{e}_alignments_per_s"]
                                  for e in ("auto", "banded", "native",
                                            "wavefront")})
        if name == "mm_rows":
            entry.update(
                call_ms=meas["mm_top_short_call_ms"],
                launch=meas["mm_top_short_shape"],
                top_node_long={k: meas[f"mm_top_long_{k}"] for k in (
                    "ms", "call_ms", "bound_ms", "bound_by", "shape")},
                escapes={k: meas[f"{k}_split"] for k in (
                    "mm_escape", "mm_escape_long")},
                levels_long=meas["mm_escape_long_levels"])
        for other, tag in (("_local", "_semi"), ("_fast4", "_full")):
            if key.endswith(other) and f"{key[:-len(other)]}{tag}_ms" in meas:
                alt = key[:-len(other)] + tag
                entry[tag[1:]] = {
                    "ms": meas[f"{alt}_ms"],
                    "plain_ms": meas[f"{alt}_plain_ms"],
                    "bound_ms": meas[f"{alt}_bound_ms"],
                    "max_abs_err": meas[f"{alt}_err"]}
                if name.endswith("_i16"):
                    entry[tag[1:]].update(
                        int32_ms=meas[f"{alt}_int32_ms"],
                        plain_on=meas[f"{alt}_plain_on"],
                        registers=meas[f"{alt}_registers"])
        kernels.append(entry)
    return kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the compiler log, the measurements "
                    "and the profile tables")
    ap.add_argument("--seqpar-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--seqpar-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--seqpar-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.seqpar_rank is not None:
        return seqpar_rank(args)
    try:
        card, kernels = run(args)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    import torch

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

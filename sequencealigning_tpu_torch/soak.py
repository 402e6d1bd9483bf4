"""Randomized cross-engine soak of the port's kernels against the scalar
oracles: the port of benchmarks/soak.py, plus legs for the kernels that
script never reached.

    python -m sequencealigning_tpu_torch.soak --rounds 200 --seed 1
    python -m sequencealigning_tpu_torch.soak --seed 2 --long-len 12000
    python -m sequencealigning_tpu_torch.soak --device cpu --max-len 40

Each round draws a compat flag, a scoring scheme (the default on even
rounds), 16 random ACGT pairs of 1..max_len bp a side, a narrow band (4 or
24) and two WFA penalty schemes from ``random.Random(seed)``, in
benchmarks/soak.py's order, so a seed gives that script's rounds.  The legs
that script never had draw from a second generator seeded from the seed.
On ``device`` each round checks (leg names as in the report):

* ``stream``: the streamed fill (kernel #1, fast4 dirs) against
  oracle_gotoh; ``stream-walk``: the host walker rebuilds both sequences;
  ``stream-dev-walk``: the fast4 walk (kernel on CUDA) equals the host
  walker's first path;
* ``stream-i16``: kernel #1's int16 instances where stream_i16_neg
  certifies the scheme x shape; ``stream-modes``: the streamed modes fill
  (#2; semi-global on even rounds, local on odd) ends where the per-pair
  modes fill (#6) does; ``stream-modes-i16``: #2's int16 instances too;
* ``banded-full`` / ``banded-fast4``: the banded row sweep (#8) at a band
  of max_len against the oracle; ``diag-vs-row``: the banded fill (#3)
  equals #8 at the narrow band; ``diag-wide``: #3 at max_len against the
  oracle; ``diag-walk``: the host walker on two of #3's narrow-band pairs
  rebuilds them; ``diag-dev-walk``: the banded walk (kernel on CUDA) on
  every pair rebuilds it and equals the host walker on those two;
* ``tiled`` / ``fold``: the tiled fills (#4 at 128-lane tiles; #5 on the
  first 1-4 pairs) against the oracle;
* ``wfa``: the textbook WFA fill at a band of max_len against the
  penalty-converted oracle (every pair must converge); ``wfa-auto`` /
  ``wfa-std``: WfaAligner's auto route in the coincidence regime
  (mismatch <= 2 * gap_extend) and out of it (the std model), each pair's
  penalty exact and its alignment rebuilding the pair; ``wfa-dev-tb``: the
  WFA walk (kernel on CUDA) equals the host walker;
* ``plain``: DataParallelRunner(kernel="plain") (#7) against the oracle;
* ``linear``: the linear fill, global (compat), textbook and local,
  against oracle_linear;
* ``gotoh-modes``: GotohAligner textbook semi-global and local over the 16
  pairs (#6 and the modes walk) and ``gotoh-modes-stream`` over 32 (16
  more pairs: #2): every alignment rescores to its score (the local
  segments lie in their sequences, the semi-global ones consume them) and
  the score is #6's end cell;
* ``mm``: Myers-Miller (ops.mm_align, leaves of MM_LEAF_CELLS so that
  the row kernel runs) on two pairs against the standard-model oracle;
* ``seqpar``: seqpar_fill over 1-4 shards of the device, 128- or 256-lane
  tiles, against the oracle;
* ``cross`` (long_len > 0): 1-64 pairs of up to long_len bp a side,
  kernel #1's finals equal #7's, #4's and seqpar_fill's, and the first
  pair (at most 600 bp a side) equals the oracle.

A leg that raises is a mismatch of that leg (pair -1), never a skip.  The
oracles run in a pool of worker processes when pairs are long enough for
them to dominate a round (max_len >= POOL_MIN_LEN).  Prints each mismatch
on stderr as "[soak] MISMATCH leg round=r pair=b: got=... exp=... n1=...
n2=..." and one JSON summary line on stdout; exits 1 on any mismatch.
``--device`` defaults to cuda, which raises without a GPU; on the CPU the
plain versions run and no kernel is launched.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import random
import sys
import time
import traceback
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from sequencealigning_tpu_torch.config import (
    Algo,
    AlignConfig,
    Mode,
    ScoringScheme,
    WfaPenalties,
)
from sequencealigning_tpu_torch.device import resolve_device, to_device
from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.models.gotoh import GotohAligner
from sequencealigning_tpu_torch.models.wfa import WfaAligner
from sequencealigning_tpu_torch.ops import (
    mm_align as _mm,
    nw_affine,
    nw_affine_modes,
    nw_affine_stream,
    nw_affine_stream_modes,
    nw_affine_tiled,
    nw_banded,
    nw_banded_diag,
    nw_linear,
    oracle_gotoh,
    oracle_linear,
    traceback_device,
    wfa,
)
from sequencealigning_tpu_torch.ops.mm_align import mm_align, mm_score_ops
from sequencealigning_tpu_torch.ops.nw_affine_modes import (
    modes_end_cell,
    nw_affine_modes_batch,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream import (
    nw_affine_stream_batch,
    plan_stream,
    stream_i16_neg,
)
from sequencealigning_tpu_torch.ops.nw_affine_stream_modes import (
    nw_affine_stream_modes_batch,
    stream_modes_best,
)
from sequencealigning_tpu_torch.ops.nw_affine_tiled import (
    nw_affine_tiled_batch,
    nw_affine_tiled_fold_batch,
)
from sequencealigning_tpu_torch.ops.nw_banded import nw_banded_batch
from sequencealigning_tpu_torch.ops.nw_banded_diag import (
    nw_banded_diag_batch,
    plan_band,
)
from sequencealigning_tpu_torch.ops.nw_linear import nw_linear_batch
from sequencealigning_tpu_torch.ops.traceback import (
    banded_diag_fast4_traceback_pair,
    traceback_stream_batch,
)
from sequencealigning_tpu_torch.ops.traceback_device import (
    banded_diag_align_device,
    fast4_stream_align_device,
)
from sequencealigning_tpu_torch.ops.wfa import (
    wfa_textbook_batch,
    wfa_traceback_device,
    wfa_traceback_host,
)
from sequencealigning_tpu_torch.parallel.runner import (
    DataParallelRunner,
    to_host,
)
from sequencealigning_tpu_torch.parallel.seqpar import seqpar_fill

Pair = Tuple[bytes, bytes]

# Every leg, in the order a round runs them ("cross" only with long_len).
LEGS = (
    "stream", "stream-walk", "stream-dev-walk", "stream-i16",
    "stream-modes", "stream-modes-i16", "banded-full", "banded-fast4",
    "diag-vs-row", "diag-wide", "diag-walk", "diag-dev-walk", "tiled",
    "fold", "wfa", "wfa-auto", "wfa-std", "wfa-dev-tb", "plain", "linear",
    "gotoh-modes", "gotoh-modes-stream", "mm", "seqpar", "cross",
)

# Each kernel's launch counter (its wrapper, the counter's attribute), by
# the names chip_smoke.py's KERNELS gives them.
COUNTERS = {
    "nw_affine_stream_fill": (nw_affine_stream.gotoh_fill_stream_cuda,
                              "launches"),
    "nw_affine_stream_fill_i16": (nw_affine_stream.gotoh_fill_stream_cuda,
                                  "launches_i16"),
    "walk_fast4": (traceback_device.walk_fast4_cuda, "launches"),
    "nw_affine_stream_modes_fill": (
        nw_affine_stream_modes.gotoh_fill_stream_modes_cuda, "launches"),
    "nw_affine_stream_modes_fill_i16": (
        nw_affine_stream_modes.gotoh_fill_stream_modes_cuda, "launches_i16"),
    "nw_affine_modes_fill": (nw_affine_modes.modes_fill_cuda, "launches"),
    "walk_modes": (traceback_device.walk_modes_cuda, "launches"),
    "nw_banded_diag_fill": (nw_banded_diag.banded_diag_fill_cuda,
                            "launches"),
    "walk_banded": (traceback_device.walk_banded_cuda, "launches"),
    "nw_affine_tiled_fill": (nw_affine_tiled.tiled_fill_cuda, "launches"),
    "nw_affine_tiled_fold_fill": (nw_affine_tiled.tiled_fold_fill_cuda,
                                  "launches"),
    "nw_affine_fill": (nw_affine.gotoh_fill_cuda, "launches"),
    "nw_banded_fill": (nw_banded.banded_row_fill_cuda, "launches"),
    "nw_linear_fill": (nw_linear.linear_fill_cuda, "launches"),
    "wfa_fill": (wfa.wfa_chunk_cuda, "launches"),
    "wfa_walk": (wfa.wfa_walk_cuda, "launches"),
    "mm_rows": (_mm.mm_rows_cuda, "launches"),
    "seqpar_shard": (nw_affine_tiled.tiled_shard_fill_cuda, "launches"),
}

N_PAIRS = 16
# Leaves of the Myers-Miller leg: small enough that pairs of tens of bp
# reach the score rows (the aligner's leaves are 2^20 cells).
MM_LEAF_CELLS = 1 << 10
# The cross leg's oracle pair is at most this long a side.
CROSS_ORACLE_LEN = 600
# Below this max_len the oracles run in this process: a pool's start costs
# more than they take.  From it on, in POOL_WORKERS processes (a core is
# left to this one).
POOL_MIN_LEN = 128
POOL_WORKERS = min(8, max(1, (os.cpu_count() or 2) - 1))


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, from its wrapper's counter."""
    return {name: int(getattr(fn, attr))
            for name, (fn, attr) in COUNTERS.items()}


class Round(NamedTuple):
    """One round's draws from benchmarks/soak.py's generator."""

    compat: bool
    scheme: ScoringScheme
    pairs: List[Pair]
    nb: int
    pen: WfaPenalties
    pen_oor: WfaPenalties


def _seq(rng: random.Random, n: int) -> bytes:
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def draw_round(rng: random.Random, rnd: int, max_len: int) -> Round:
    """Round rnd's draws, in benchmarks/soak.py's order: compat, the scheme
    (odd rounds), the 16 pairs (n1, n2, then their bases), the narrow band,
    the in-regime penalties (gap_extend, mismatch, gap_open), and the
    out-of-regime mismatch."""
    compat = rng.random() < 0.5
    scheme = ScoringScheme() if rnd % 2 == 0 else ScoringScheme(
        match_=rng.randint(1, 9),
        mismatch=-rng.randint(1, 12),
        gap_open=-rng.randint(0, 14),
        gap_extend=-rng.randint(1, 8),
    )
    pairs = []
    for _ in range(N_PAIRS):
        n1 = rng.randint(1, max_len)
        n2 = rng.randint(1, max_len)
        pairs.append((_seq(rng, n1), _seq(rng, n2)))
    nb = rng.choice([4, 24])
    ev = rng.randint(1, 6)
    pen = WfaPenalties(mismatch=rng.randint(1, 2 * ev),
                       gap_open=rng.randint(0, 6), gap_extend=ev)
    pen_oor = WfaPenalties(mismatch=2 * pen.gap_extend + rng.randint(1, 4),
                           gap_open=pen.gap_open, gap_extend=pen.gap_extend)
    return Round(compat, scheme, pairs, nb, pen, pen_oor)


class PortDraw(NamedTuple):
    """One round's draws for the legs benchmarks/soak.py never had."""

    extra: List[Pair]        # 16 more pairs: the streamed modes route
    shards: int              # seqpar's devices (1-4 shards of one)
    tile_lanes: int          # seqpar's tile lanes (128 or 256)
    cross: List[Pair]        # the cross leg's batch (empty: no cross leg)


def _seq_fast(rng: random.Random, n: int) -> bytes:
    return bytes(rng.choices(b"ACGT", k=n))


def draw_port(rng: random.Random, max_len: int, long_len: int) -> PortDraw:
    extra = [(_seq_fast(rng, rng.randint(1, max_len)),
              _seq_fast(rng, rng.randint(1, max_len)))
             for _ in range(N_PAIRS)]
    shards = rng.randint(1, 4)
    tile_lanes = rng.choice([128, 256])
    cross = []
    if long_len > 0:
        n = rng.randint(1, 64)
        short = min(CROSS_ORACLE_LEN, long_len)
        cross.append((_seq_fast(rng, rng.randint(1, short)),
                      _seq_fast(rng, rng.randint(1, short))))
        cross += [(_seq_fast(rng, rng.randint(1, long_len)),
                   _seq_fast(rng, rng.randint(1, long_len)))
                  for _ in range(n - 1)]
    return PortDraw(extra, shards, tile_lanes, cross)


def port_rng(seed: int) -> random.Random:
    """The second generator: the port-only legs' draws."""
    return random.Random(f"sequencealigning_tpu_torch.soak:{seed}")


@dataclasses.dataclass
class Mismatch:
    leg: str
    round: int
    pair: int
    got: object
    expected: object
    n1: Optional[int]
    n2: Optional[int]

    def line(self) -> str:
        return (f"[soak] MISMATCH {self.leg} round={self.round} "
                f"pair={self.pair}: got={self.got} exp={self.expected} "
                f"n1={self.n1} n2={self.n2}")


@dataclasses.dataclass
class SoakReport:
    """A soak's result: checks and mismatches by leg, every kernel's
    launches during the soak (COUNTERS; 0 on the CPU), the narrow-band
    walks that touched the band's outermost diagonals, and the run's wall
    seconds: in all, by leg (a leg's seconds include any wait for its
    oracles), and waiting for the oracles."""

    rounds: int
    seed: int
    max_len: int
    long_len: int
    device: str
    pairs: int = 0
    checks: Dict[str, int] = dataclasses.field(default_factory=dict)
    mismatches: List[Mismatch] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    band_walks: int = 0
    edge_walks: int = 0
    seconds: float = 0.0
    seconds_by_leg: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    oracle_wait_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def summary(self) -> dict:
        by_leg: Dict[str, int] = {}
        for m in self.mismatches:
            by_leg[m.leg] = by_leg.get(m.leg, 0) + 1
        return dict(
            ok=self.ok, device=self.device, rounds=self.rounds,
            seed=self.seed, max_len=self.max_len, long_len=self.long_len,
            pairs=self.pairs, checks=self.checks,
            mismatches=len(self.mismatches), mismatches_by_leg=by_leg,
            launches=self.launches, band_walks=self.band_walks,
            edge_walks=self.edge_walks, seconds=round(self.seconds, 3),
            seconds_by_leg={k: round(v, 3)
                            for k, v in self.seconds_by_leg.items()},
            oracle_wait_s=round(self.oracle_wait_s, 3),
        )


class _Oracle:
    """Scalar oracle calls as futures: in a pool of spawned worker
    processes, or computed at once in this process (workers 0)."""

    def __init__(self, workers: int):
        self._pool = None
        if workers > 0:
            self._pool = concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn"))

    def submit(self, fn, *args) -> concurrent.futures.Future:
        if self._pool is not None:
            return self._pool.submit(fn, *args)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args))
        except Exception as e:  # delivered where the result is read
            fut.set_exception(e)
        return fut

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)


def _consumes(aln, pair: Pair) -> bool:
    a1, a2 = aln
    return (a1.replace("-", "").encode() == pair[0]
            and a2.replace("-", "").encode() == pair[1])


def _path_diagonals(aln) -> Tuple[int, int]:
    """The least and greatest diagonal y - x (y the query position, x the
    db position) of the cells an alignment's path visits."""
    a1, a2 = aln
    x = y = lo = hi = 0
    for c1, c2 in zip(a1, a2):
        y += c1 != "-"
        x += c2 != "-"
        lo, hi = min(lo, y - x), max(hi, y - x)
    return lo, hi


def _gap_kind(c1: str, c2: str) -> int:
    """0 for an aligned column, 1 for a query character against a gap, 2
    for a db character against a gap."""
    return 1 if c2 == "-" else 2 if c1 == "-" else 0


def textbook_rescore(aln, scheme: ScoringScheme, semi: bool) -> int:
    """Textbook affine score of an alignment (each gap run pays its open).
    semi: a semi-global path starts on row 0 or column 0 and ends on the
    last row or column, so its leading run of gap columns of one kind and
    its trailing run of one kind are free (a run of the other kind beside
    it is not)."""
    a1, a2 = aln
    cols = list(zip(a1, a2))
    lo, hi = 0, len(cols)
    if semi:
        for edge, step in ((lo, 1), (hi - 1, -1)):
            kind = _gap_kind(*cols[edge]) if lo < hi else 0
            while kind and lo < hi and _gap_kind(*cols[edge]) == kind:
                lo, hi = (lo + 1, hi) if step > 0 else (lo, hi - 1)
                edge += step
    cols = cols[lo:hi]
    ops = "".join("MID"[_gap_kind(c1, c2)] for c1, c2 in cols)
    q = "".join(c1 for c1, _ in cols if c1 != "-").encode()
    d = "".join(c2 for _, c2 in cols if c2 != "-").encode()
    return mm_score_ops(ops, q, d, scheme)


class _Soak:
    def __init__(self, report: SoakReport, oracle: _Oracle,
                 dev: torch.device, max_len: int):
        self.report = report
        self.oracle = oracle
        self.dev = dev
        self.max_len = max_len

    def fail(self, leg: str, rnd: int, b: int, got, exp, pair) -> None:
        m = Mismatch(leg, rnd, b, got, exp,
                     None if pair is None else len(pair[0]),
                     None if pair is None else len(pair[1]))
        self.report.mismatches.append(m)
        print(m.line(), file=sys.stderr, flush=True)

    def check(self, leg: str, rnd: int, b: int, got, exp, pair) -> None:
        self.report.checks[leg] = self.report.checks.get(leg, 0) + 1
        if got != exp:
            self.fail(leg, rnd, b, got, exp, pair)

    def wait(self, futs) -> list:
        """The oracles' results, the time spent waiting for them kept in
        the report."""
        t0 = time.perf_counter()
        out = [f.result() for f in futs]
        self.report.oracle_wait_s += time.perf_counter() - t0
        return out

    @contextlib.contextmanager
    def leg(self, name: str, rnd: int):
        """A leg that raises is that leg's mismatch (pair -1), and the
        round goes on with the next leg.  Its wall seconds are added to
        the report's seconds_by_leg."""
        t0 = time.perf_counter()
        try:
            yield
        except Exception as e:  # a soak reports every failure and goes on
            traceback.print_exc(file=sys.stderr)
            self.report.checks[name] = self.report.checks.get(name, 0) + 1
            self.fail(name, rnd, -1, repr(e), "no exception", None)
        finally:
            by = self.report.seconds_by_leg
            by[name] = by.get(name, 0.0) + time.perf_counter() - t0

    def run_round(self, rnd: int, r: Round, p: PortDraw) -> None:
        dev, sub = self.dev, self.oracle.submit
        sch, compat, pairs = r.scheme, r.compat, r.pairs
        s1s = [a for a, _ in pairs]
        s2s = [b for _, b in pairs]
        self.report.pairs += len(pairs) + len(p.extra) + len(p.cross)
        eq = ScoringScheme(match_=0, mismatch=-r.pen.mismatch,
                           gap_open=-r.pen.gap_open,
                           gap_extend=-r.pen.gap_extend)
        eq_oor = ScoringScheme(match_=0, mismatch=-r.pen_oor.mismatch,
                               gap_open=-r.pen_oor.gap_open,
                               gap_extend=-r.pen_oor.gap_extend)
        walked = (rnd % N_PAIRS, (rnd + 7) % N_PAIRS)
        gs = oracle_gotoh.gotoh_score
        exp_f = [sub(gs, a, b, sch, compat) for a, b in pairs]
        wfa_f = [sub(gs, a, b, eq, False) for a, b in pairs]
        std_f = [sub(gs, a, b, eq_oor, False, "std") for a, b in pairs]
        lin_kinds = (("global", True, False), ("textbook", False, False),
                     ("local", compat, True))
        lin_f = {k: [sub(oracle_linear.linear_score, a, b, sch, local, c)
                     for a, b in pairs] for k, c, local in lin_kinds}
        mm_f = [sub(gs, *pairs[b], sch, False, "std") for b in walked]
        cross_f = [sub(gs, *p.cross[0], sch, compat)] if p.cross else []

        batch = pack_batch(pairs, batch_size=N_PAIRS)
        tb = to_device(batch, dev)
        exp = []

        def expected():
            if not exp:
                exp.extend(self.wait(exp_f))
            return exp

        res = host = None
        with self.leg("stream", rnd):
            res = nw_affine_stream_batch(*tb, scheme=sch, compat=compat,
                                         with_dirs="fast4", np_slots=2)
            for b in range(N_PAIRS):
                self.check("stream", rnd, b, int(res.finals[b].max()),
                           expected()[b], pairs[b])
        if res is not None:
            with self.leg("stream-walk", rnd):
                host = traceback_stream_batch(
                    res.dirs.cpu().numpy(), res.finals, s1s, s2s, res.plan,
                    compat=compat, dirs_mode="fast4")
                for b, t in enumerate(host):
                    ok = not isinstance(t, Exception) and _consumes(
                        t[1][0], pairs[b])
                    self.check("stream-walk", rnd, b,
                               "ok" if ok else repr(t), "ok", pairs[b])
            with self.leg("stream-dev-walk", rnd):
                alns, _ = fast4_stream_align_device(res.dirs, res.finals,
                                                    s1s, s2s, res.plan)
                for b in range(N_PAIRS):
                    if host is not None and not isinstance(host[b],
                                                           Exception):
                        self.check("stream-dev-walk", rnd, b, alns[b],
                                   host[b][1][0], pairs[b])
            del res
        with self.leg("stream-i16", rnd):
            plan1 = plan_stream(N_PAIRS, batch.query.shape[1],
                                batch.db.shape[1], np_slots=1)
            if stream_i16_neg(sch, plan1) is not None:
                r16 = nw_affine_stream_batch(*tb, scheme=sch, compat=compat,
                                             with_dirs=False, np_slots=1,
                                             state_dtype="i16")
                for b in range(N_PAIRS):
                    self.check("stream-i16", rnd, b,
                               int(r16.finals[b].max()), expected()[b],
                               pairs[b])

        mode = "semi" if rnd % 2 == 0 else "local"
        plain = None
        with self.leg("stream-modes", rnd):
            sres = nw_affine_stream_modes_batch(*tb, mode, scheme=sch,
                                                np_slots=2, with_dirs=False)
            plain = nw_affine_modes_batch(*tb, local=mode == "local",
                                          scheme=sch, with_dirs=False)
            for b in range(N_PAIRS):
                self.check("stream-modes", rnd, b, stream_modes_best(sres, b),
                           modes_end_cell(plain, b), pairs[b])
        plan2 = plan_stream(N_PAIRS, batch.query.shape[1], batch.db.shape[1],
                            np_slots=2)
        if plain is not None and stream_i16_neg(sch, plan2) is not None:
            with self.leg("stream-modes-i16", rnd):
                s16 = nw_affine_stream_modes_batch(
                    *tb, mode, scheme=sch, np_slots=2, with_dirs=False,
                    state_dtype="i16")
                for b in range(N_PAIRS):
                    self.check("stream-modes-i16", rnd, b,
                               stream_modes_best(s16, b),
                               modes_end_cell(plain, b), pairs[b])

        for dm in ("full", "fast4"):
            with self.leg(f"banded-{dm}", rnd):
                bres = nw_banded_batch(*tb, band=self.max_len, scheme=sch,
                                       compat=compat, with_dirs=dm)
                for b in range(N_PAIRS):
                    self.check(f"banded-{dm}", rnd, b,
                               int(bres.finals[b].max()), expected()[b],
                               pairs[b])
                del bres

        self._diag(rnd, r, tb, batch, walked)
        with self.leg("diag-wide", rnd):
            bwide = nw_banded_diag_batch(*tb, band=self.max_len, scheme=sch,
                                         compat=compat, with_dirs=False)
            for b in range(N_PAIRS):
                self.check("diag-wide", rnd, b, int(bwide.finals[b].max()),
                           expected()[b], pairs[b])

        with self.leg("tiled", rnd):
            tf = nw_affine_tiled_batch(*tb, scheme=sch, compat=compat,
                                       tile_lanes=128)
            for b in range(N_PAIRS):
                self.check("tiled", rnd, b, int(tf[b].max()), expected()[b],
                           pairs[b])
        nf = 1 + rnd % 4
        with self.leg("fold", rnd):
            ff = nw_affine_tiled_fold_batch(*(t[:nf] for t in tb),
                                            scheme=sch, compat=compat,
                                            tile_lanes=128)
            for b in range(nf):
                self.check("fold", rnd, b, int(ff[b].max()), expected()[b],
                           pairs[b])

        self._wfa(rnd, r, tb, wfa_f, std_f)

        with self.leg("plain", rnd):
            runner = DataParallelRunner([dev], scheme=sch, compat=compat,
                                        kernel="plain")
            f7 = to_host(runner.scores(batch))
            for b in range(N_PAIRS):
                self.check("plain", rnd, b, int(f7[b].max()), expected()[b],
                           pairs[b])
        with self.leg("linear", rnd):
            for kind, c, local in lin_kinds:
                lres = nw_linear_batch(*tb, scheme=sch, compat=c, local=local,
                                       with_dirs=False)
                want = self.wait(lin_f[kind])
                for b in range(N_PAIRS):
                    self.check("linear", rnd, b, (kind, int(lres.score[b])),
                               (kind, want[b]), pairs[b])

        self._gotoh_modes(rnd, sch, pairs, p.extra)

        with self.leg("mm", rnd):
            want = self.wait(mm_f)
            for k, b in enumerate(walked):
                ops = mm_align(*pairs[b], sch, device=dev,
                               leaf_cells=MM_LEAF_CELLS)
                self.check("mm", rnd, b, mm_score_ops(ops, *pairs[b], sch),
                           want[k], pairs[b])
        with self.leg("seqpar", rnd):
            sp = seqpar_fill(batch.query, batch.db, batch.query_len,
                             batch.db_len, mesh=[dev] * p.shards,
                             tile_lanes=p.tile_lanes, scheme=sch,
                             compat=compat)
            for b in range(N_PAIRS):
                self.check("seqpar", rnd, b, int(sp[b].max()), expected()[b],
                           pairs[b])
        if p.cross:
            with self.leg("cross", rnd):
                self._cross(rnd, sch, compat, p, cross_f)

    def _diag(self, rnd, r: Round, tb, batch, walked) -> None:
        sch, compat, pairs = r.scheme, r.compat, r.pairs
        bdia = None
        with self.leg("diag-vs-row", rnd):
            brow = nw_banded_batch(*tb, band=r.nb, scheme=sch, compat=compat,
                                   with_dirs=False)
            bdia = nw_banded_diag_batch(*tb, band=r.nb, scheme=sch,
                                        compat=compat, with_dirs="fast4")
            for b in range(N_PAIRS):
                self.check("diag-vs-row", rnd, b, bdia.finals[b].tolist(),
                           brow.finals[b].tolist(), pairs[b])
        if bdia is None:
            return
        plan = plan_band(batch.query_len, batch.db_len, r.nb,
                         batch.query.shape[1], batch.db.shape[1])
        host = {}
        with self.leg("diag-walk", rnd):
            ddirs = bdia.dirs.cpu().numpy()
            for b in walked:
                _score, alns = banded_diag_fast4_traceback_pair(
                    ddirs[:, b, :], bdia.finals[b], *pairs[b],
                    bdia.k_lo_even, compat=compat)
                host[b] = alns[0]
                self.check("diag-walk", rnd, b,
                           "ok" if _consumes(alns[0], pairs[b])
                           else "bad-recon", "ok", pairs[b])
                self._edge(alns[0], plan)
        with self.leg("diag-dev-walk", rnd):
            alns, _ = banded_diag_align_device(
                bdia.dirs, bdia.finals, [a for a, _ in pairs],
                [b for _, b in pairs], bdia.k_lo_even)
            for b in range(N_PAIRS):
                ok = alns[b] is not None and _consumes(alns[b], pairs[b])
                self.check("diag-dev-walk", rnd, b,
                           "ok" if ok else repr(alns[b]), "ok", pairs[b])
                if b in host:
                    self.check("diag-dev-walk", rnd, b, alns[b], host[b],
                               pairs[b])
                elif ok:
                    self._edge(alns[b], plan)

    def _edge(self, aln, plan) -> None:
        """Count a narrow-band walk, and whether its path touched the
        band's outermost diagonals (k_lo, k_hi_eff), where the two banded
        engines' full bytes differ."""
        lo, hi = _path_diagonals(aln)
        self.report.band_walks += 1
        self.report.edge_walks += lo <= plan.k_lo or hi >= plan.k_hi_eff

    def _wfa(self, rnd, r: Round, tb, wfa_f, std_f) -> None:
        pairs = r.pairs
        wres = None
        with self.leg("wfa", rnd):
            wres = wfa_textbook_batch(*tb, penalties=r.pen, band=self.max_len)
            want = self.wait(wfa_f)
            for b in range(N_PAIRS):
                got = (int(wres.score[b]) if wres.converged[b]
                       else "not converged")
                self.check("wfa", rnd, b, got, -want[b], pairs[b])
        if wres is not None:
            with self.leg("wfa-dev-tb", rnd):
                dev_alns = wfa_traceback_device(
                    wres, [a for a, _ in pairs], [b for _, b in pairs], r.pen)
                for b in range(N_PAIRS):
                    if wres.converged[b]:
                        _s, h1, h2 = wfa_traceback_host(wres, b, *pairs[b],
                                                        r.pen)
                        self.check("wfa-dev-tb", rnd, b, dev_alns[b],
                                   (h1, h2), pairs[b])
        for leg, pen, futs in (("wfa-auto", r.pen, wfa_f),
                               ("wfa-std", r.pen_oor, std_f)):
            with self.leg(leg, rnd):
                al = WfaAligner(AlignConfig(algo=Algo.WFA, compat=False,
                                            wfa_penalties=pen), self.dev)
                routed = al._align_batch_impl(pairs)
                want = self.wait(futs)
                for b, res in enumerate(routed):
                    if not isinstance(res, dict):
                        self.fail(leg, rnd, b, repr(res), -want[b], pairs[b])
                        continue
                    self.check(leg, rnd, b, ("penalty", res["score"]),
                               ("penalty", -want[b]), pairs[b])
                    if res["aligned_query"] is not None:
                        ok = _consumes((res["aligned_query"],
                                        res["aligned_db"]), pairs[b])
                        self.check(leg, rnd, b,
                                   ("walk", "ok" if ok else "bad-recon"),
                                   ("walk", "ok"), pairs[b])

    def _gotoh_modes(self, rnd, sch, pairs, extra) -> None:
        for leg, batch_pairs in (("gotoh-modes", pairs),
                                 ("gotoh-modes-stream", pairs + extra)):
            with self.leg(leg, rnd):
                tb = to_device(pack_batch(batch_pairs), self.dev)
                for mode in (Mode.SEMI_GLOBAL, Mode.LOCAL):
                    semi = mode is Mode.SEMI_GLOBAL
                    out = GotohAligner(AlignConfig(
                        algo=Algo.NEEDLEMAN_WUNSCH, mode=mode, compat=False,
                        scoring=sch), self.dev)._align_batch_impl(batch_pairs)
                    plain = nw_affine_modes_batch(*tb, local=not semi,
                                                  scheme=sch,
                                                  with_dirs=False)
                    for b, (res, pair) in enumerate(zip(out, batch_pairs)):
                        want = modes_end_cell(plain, b)[0]
                        if not isinstance(res, dict):
                            self.fail(leg, rnd, b, repr(res), want, pair)
                            continue
                        aln = (res["aligned_query"], res["aligned_db"])
                        if semi:
                            ok = _consumes(aln, pair)
                        else:
                            ok = (aln[0].replace("-", "").encode() in pair[0]
                                  and aln[1].replace("-", "").encode()
                                  in pair[1])
                        tag = mode.value
                        for what, got, exp in (
                                ("end cell", res["score"], want),
                                ("rescore", textbook_rescore(aln, sch, semi),
                                 res["score"]),
                                ("walk", "ok" if ok else "bad-recon", "ok")):
                            self.check(leg, rnd, b, (tag, what, got),
                                       (tag, what, exp), pair)

    def _cross(self, rnd, sch, compat, p: PortDraw, oracle_f) -> None:
        cb = pack_batch(p.cross)
        ctb = to_device(cb, self.dev)
        f1 = nw_affine_stream_batch(*ctb, scheme=sch, compat=compat,
                                    with_dirs=False).finals
        runner = DataParallelRunner([self.dev], scheme=sch, compat=compat,
                                    kernel="plain")
        others = (
            ("#7", to_host(runner.scores(cb))),
            ("#4", nw_affine_tiled_batch(*ctb, scheme=sch, compat=compat)),
            ("seqpar", seqpar_fill(cb.query, cb.db, cb.query_len, cb.db_len,
                                   mesh=[self.dev] * p.shards,
                                   tile_lanes=p.tile_lanes, scheme=sch,
                                   compat=compat)),
        )
        for b, pair in enumerate(p.cross):
            for name, f in others:
                self.check("cross", rnd, b, (name, f[b].tolist()),
                           (name, f1[b].tolist()), pair)
        self.check("cross", rnd, 0, ("oracle", int(f1[0].max())),
                   ("oracle", self.wait(oracle_f)[0]), p.cross[0])


def _device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run_soak(rounds: int, seed: int, max_len: int = 600,
             device="cuda", long_len: int = 0) -> SoakReport:
    """Run ``rounds`` soak rounds from ``seed`` on ``device`` (cuda by
    default: it raises without a GPU; "cpu" runs the plain versions) and
    return the report.  Mismatches are also printed on stderr as they are
    found, and each round's end.  From max_len POOL_MIN_LEN the oracles
    run in spawned processes, which import the main module: a script
    that calls run_soak keeps its entry under ``if __name__ ==
    "__main__"``."""
    dev = _device(device)
    report = SoakReport(rounds=rounds, seed=seed, max_len=max_len,
                        long_len=long_len, device=str(dev))
    rng = random.Random(seed)
    rng2 = port_rng(seed)
    before = launch_counts()
    t0 = time.perf_counter()
    oracle = _Oracle(POOL_WORKERS if max_len >= POOL_MIN_LEN else 0)
    try:
        soak = _Soak(report, oracle, dev, max_len)
        for rnd in range(rounds):
            r = draw_round(rng, rnd, max_len)
            p = draw_port(rng2, max_len, long_len)
            soak.run_round(rnd, r, p)
            print(f"[soak] round {rnd} done (compat={r.compat}, "
                  f"{len(report.mismatches)} mismatches so far)",
                  file=sys.stderr, flush=True)
    finally:
        oracle.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report.seconds = time.perf_counter() - t0
    after = launch_counts()
    report.launches = {k: after[k] - before[k] for k in after}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-len", type=int, default=600)
    ap.add_argument("--long-len", type=int, default=0,
                    help="add the cross leg: 1-64 pairs of up to this many "
                    "bp a side (0: no cross leg)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    report = run_soak(args.rounds, args.seed, max_len=args.max_len,
                      device=args.device, long_len=args.long_len)
    verdict = "PASS" if report.ok else f"{len(report.mismatches)} MISMATCHES"
    print(f"[soak] {verdict}", file=sys.stderr)
    print(json.dumps(report.summary()), flush=True)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Time the banded fill (kernel #3, ``nw_banded_diag.cu``) on the card over
its tiles -- strip widths, blocks of iterations, lanes a thread -- at the
shapes the paths give it: BASELINE config 4 (1024 pairs of 5115 bp, band
128), the long-pair path's band rounds over batch A (8 pairs of 100 kb,
bands 128-512) and batch B (2 pairs, band 128) of ``chip_smoke.py``, and
the bands past 131072 lanes of its phase 18:

    python -m sequencealigning_tpu_torch.csrc.band_sweep [--out FILE]
    python sequencealigning_tpu_torch/csrc/band_sweep.py --root DIR

run from the repository root; --root DIR times the package of another
checkout (e.g. a parent commit unpacked with ``git archive``) instead, at
the same shapes with its own default route only, so two versions can be
compared in one run on one card.  First it holds the kernel against its plain
version on small ragged batches (the tile rule's shape, and forced strips
of 128 lanes in blocks of 4 and 8 iterations; compat/textbook x wildcard x
dirs and the std model), and checks that a schedule whose waits cannot be
met raises instead of hanging (the seconds it took).  Then one line a
configuration: the kernel's milliseconds (CUDA events over one launch
after a warm-up), lane-steps a second, the tiles and the SMs a pair ran
on; every configuration's finals and dirs must equal the rule's.  Needs a
CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _equal(a, b) -> bool:
    fa, da = a
    fb, db = b
    return torch.equal(fa, fb) and (da is None or torch.equal(
        da.view(torch.int32), db.view(torch.int32)))


def _small_checks(banded, ScoringScheme, to_device, pack_batch) -> int:
    """The kernel against its plain version on small ragged and skewed
    batches; returns the number of runs."""
    std = ScoringScheme(match_=0, mismatch=-9, gap_open=-2, gap_extend=-3)
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    runs = 0
    for n, lo1, hi1, lo2, hi2, band in ((40, 1, 300, 1, 300, 16),
                                        (16, 200, 400, 20, 150, 48),
                                        (8, 200, 256, 200, 256, 8),
                                        (8, 300, 700, 300, 700, 600)):
        pairs = []
        for i in range(n):
            s1 = rng.choice(alpha, int(rng.integers(lo1, hi1 + 1)))
            s2 = rng.choice(alpha, int(rng.integers(lo2, hi2 + 1)))
            if i % 2:
                s2 = np.resize(s1, len(s2))
            pairs.append((s1.tobytes(), s2.tobytes()))
        tb = to_device(pack_batch(pairs, batch_size=n), "cuda")
        plan, ins = banded.band_inputs(*tb, band)
        for model, compat, wildcard, dirs in (
                ("ref", True, True, "fast4"), ("ref", True, False, "full"),
                ("ref", False, True, "full"), ("ref", False, False, False),
                ("std", False, True, "fast4"), ("std", False, False, False)):
            scheme = std if model == "std" else (wild if wildcard
                                                 else ScoringScheme())
            a = (plan, scheme, compat, wildcard, dirs, model)
            want = banded.banded_diag_fill_torch(*ins, *a)
            for kw in ({}, dict(strip_lanes=128, block_iters=4),
                       dict(strip_lanes=128, block_iters=8),
                       dict(strip_lanes=32, block_iters=12)):
                got = banded.banded_diag_fill_cuda(*ins, *a, **kw)
                torch.cuda.synchronize()
                assert _equal(got, want), (n, band, model, compat, wildcard,
                                           dirs, kw)
                runs += 1
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    ap.add_argument("--root", default=None,
                    help="checkout whose package to time (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(args.root or here)
    sys.path.insert(0, root)
    import chip_smoke
    from sequencealigning_tpu_torch import csrc
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.csrc.tiled_sweep import _card, _ms
    from sequencealigning_tpu_torch.ops import nw_banded_diag as banded

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(csrc.__file__)))
    if os.path.dirname(pkg) != root:
        print(f"the package came from {pkg}, not {root}: run this file as "
              "a script for --root", file=sys.stderr)
        return 1
    # Another checkout's fill may predate the tiles: its default route only.
    baseline = not hasattr(banded, "band_tiles")
    print(_card(), f"package {pkg}", "(baseline: its default route only)"
          if baseline else "", flush=True)
    csrc.kernels()
    log = csrc.build_log.splitlines()
    for i, ln in enumerate(log):
        if "banded_tile_kernel" in ln and "Compiling entry" in ln:
            print(ln.strip()[-90:])
            for nxt in log[i + 1:i + 4]:
                print("   ", nxt.strip())

    stall_s = None
    if not baseline:
        runs = _small_checks(banded, ScoringScheme, to_device, pack_batch)
        print(f"small ragged: {runs} runs equal their plain versions",
              flush=True)
        stall_s = chip_smoke.stall_check(
            torch, {"banded": banded, "csrc": csrc})["bfill_stall_s"]
    A, B = chip_smoke.long_batches()
    c4 = chip_smoke.make_pairs(np.random.default_rng(4), chip_smoke.N_BAND,
                               chip_smoke.LEN_BAND)
    rng = np.random.default_rng(12)
    wide = []
    for _ in range(chip_smoke.N_WIDE):
        n = int(rng.integers(chip_smoke.LEN_WIDE_LO,
                             chip_smoke.LEN_WIDE_HI + 1))
        wide += chip_smoke.make_pairs(rng, 1, n)
    lane_sets = {
        "config 4": (c4, [128], [{}, dict(lpt=4), dict(strip_lanes=128)]),
        "batch B": (B, [128], [
            {}, dict(strip_lanes=160, block_iters=32),
            dict(strip_lanes=192, block_iters=32), dict(block_iters=96)]),
        "batch A": (A, [128, 256, 512], [
            {}, dict(strip_lanes=128, block_iters=32),
            dict(strip_lanes=64)]),
        "wide": (wide, list(chip_smoke.WIDE_BANDS), [
            {}, dict(strip_lanes=1024)]),
    }
    rows = []
    real = getattr(banded, "band_tiles", None)
    for name, (pairs, bands, configs) in lane_sets.items():
        if baseline:
            configs = [{}]
        tb = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
        for band in bands:
            plan, ins = banded.band_inputs(*tb, band)
            a = (plan, ScoringScheme(), True, False, "fast4")
            lane_steps = len(pairs) * 2 * plan.n_need * plan.L
            first = None
            for kw in configs:
                kw = dict(kw)
                lpt = kw.pop("lpt", 0)
                if lpt:
                    def tiles_at(*t, _lpt=lpt):
                        got = real(*t)
                        window = min(t[1], got.strip_lanes + 2 * got.halo)
                        threads = -(-window // _lpt)
                        return got._replace(lanes_per_thread=_lpt,
                                            threads=-(-threads // 32) * 32)
                    banded.band_tiles = tiles_at
                try:
                    ms, got = _ms(lambda: banded.banded_diag_fill_cuda(
                        *ins, *a, **kw))
                finally:
                    if real is not None:
                        banded.band_tiles = real
                if first is None:
                    first = got
                assert _equal(got, first), (name, band, kw, lpt)
                row = dict(batch=name, band=band, lanes=plan.L,
                           n_iters=plan.n_need, force=kw, lpt=lpt, ms=ms,
                           lane_steps_per_s=lane_steps / ms * 1e3)
                line = (f"{name} band {band} (L={plan.L}, {plan.n_need} "
                        f"iterations) {kw or 'rule'}"
                        f"{' lpt ' + str(lpt) if lpt else ''}: {ms:.3f} ms, "
                        f"{lane_steps / ms / 1e6:.1f} G lane-steps/s")
                if not baseline:
                    shape = dict(banded.banded_diag_fill_cuda.last_launch)
                    row.update(shape)
                    per_pair = shape["sms_per_pair"]
                    line += (f"; {chip_smoke.tile_line(shape)} (a pair: "
                             f"{min(per_pair)}-{max(per_pair)})")
                rows.append(row)
                print(line, flush=True)
            del first, got
        del tb
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=_card(), package=pkg, baseline=baseline,
                           stall_s=stall_s, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the tiled fills (kernels #4 and #5, ``nw_affine_tiled.cu``) on the
card over strip widths, chunk rows and CTAs a pair, at the long-pair
path's batches A (8 pairs of 100 kb, kernel #4) and B (2 pairs, kernel #5)
of ``chip_smoke.py``:

    python -m sequencealigning_tpu_torch.csrc.tiled_sweep [--out FILE]

run from the repository root.  First it holds both kernels against their
plain versions on small ragged batches (default shape, and strips of 128
lanes with chunks of 8 rows), and checks that a schedule whose waits cannot
be met raises instead of hanging (the seconds it took).  Then one line a
configuration: the kernel's milliseconds (CUDA events over one launch
after a warm-up), GCUPS, CTAs a pair, ring slots, grid CTAs, SMs used;
every configuration's finals must equal the default configuration's.
Needs a CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def _ms(fn):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from sequencealigning_tpu_torch import csrc
    from sequencealigning_tpu_torch.config import ScoringScheme
    from sequencealigning_tpu_torch.device import to_device
    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.ops import nw_affine_tiled as tiled

    print(_card(), flush=True)
    csrc.kernels()
    log = csrc.build_log.splitlines()
    for i, ln in enumerate(log):
        if "strip_fill_kernel" in ln and "Compiling entry" in ln:
            print(ln.strip())
            for nxt in log[i + 1:i + 4]:
                print("   ", nxt.strip())

    # Small ragged batches against the plain versions.
    rng = np.random.default_rng(11)
    small = chip_smoke.tiled_pairs(rng, 14, 1, 3000) + [(b"ACGTA", b""),
                                                        (b"", b"ACG")]
    tb = to_device(pack_batch(small), "cuda")
    wild = ScoringScheme(match_=3, mismatch=-5, gap_open=-7, gap_extend=-2)
    runs = 0
    for compat in (True, False):
        for wildcard in (False, True):
            a = (wild if wildcard else ScoringScheme(), compat, wildcard)
            want = tiled.tiled_fill_torch(*tb, *a, tile_lanes=4096)
            for kw in ({}, dict(strip_lanes=128, chunk_rows=8),
                       dict(strip_lanes=384, chunk_rows=16)):
                got = tiled.tiled_fill_cuda(*tb, *a, **kw)
                torch.cuda.synchronize()
                e = int((got - want).abs().max())
                assert e == 0, ("#4", compat, wildcard, kw, e)
                runs += 1
            for sl in (slice(0, 2), slice(14, 16)):
                fw = tiled.tiled_fold_fill_torch(*(t[sl] for t in tb), *a,
                                                 tile_lanes=1024)
                for kw in ({}, dict(strip_lanes=128, chunk_rows=8)):
                    got = tiled.tiled_fold_fill_cuda(*(t[sl] for t in tb),
                                                     *a, **kw)
                    torch.cuda.synchronize()
                    e = int((got - fw).abs().max())
                    assert e == 0, ("#5", compat, wildcard, kw, e)
                    runs += 1
    print(f"small ragged: {runs} runs equal their plain versions",
          flush=True)

    # A schedule whose waits cannot be met (a strip before its producer,
    # one CTA) must raise, not hang.
    real = tiled.strip_schedule, tiled.strip_plan
    tiled.strip_schedule = lambda n2s, w: (lambda r: (r[0][::-1].copy(),
                                                      r[1]))(real[0](n2s, w))
    tiled.strip_plan = lambda *a: (1, 2, 1)
    t0 = time.perf_counter()
    try:
        tiled.tiled_fill_cuda(*(t[:1] for t in tb), ScoringScheme(), True,
                              False, strip_lanes=128)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        tiled.strip_schedule, tiled.strip_plan = real
    stall_s = time.perf_counter() - t0
    assert raised and "spin limit" in raised, raised
    print(f"stalled schedule raised after {stall_s:.2f} s: {raised}",
          flush=True)

    A, B = chip_smoke.long_batches()
    rows = []
    for name, pairs, fn, configs in (
            ("A", A, tiled.tiled_fill_cuda,
             [{}, dict(strip_lanes=512), dict(strip_lanes=2048),
              dict(chunk_rows=64), dict(strip_lanes=768)]),
            ("B", B, tiled.tiled_fold_fill_cuda,
             [{}, dict(strip_lanes=256), dict(strip_lanes=1024),
              dict(chunk_rows=64), dict(strip_lanes=256, chunk_rows=32)]),
            ("B", B, tiled.tiled_fill_cuda,
             [dict(strip_lanes=1024), dict(strip_lanes=512)])):
        t = to_device(pack_batch(pairs, batch_size=len(pairs)), "cuda")
        cells = sum(len(x) * len(y) for x, y in pairs)
        first = None
        for kw in configs:
            ms, got = _ms(lambda: fn(*t, ScoringScheme(), True, False, **kw))
            if first is None:
                first = got
            assert torch.equal(got, first), (name, fn.__name__, kw)
            shape = dict(fn.last_launch)
            row = dict(batch=name, kernel=fn.__name__, ms=ms,
                       gcups=cells / ms / 1e6, **shape)
            rows.append(row)
            print(f"batch {name} {fn.__name__} {kw}: {ms:.3f} ms, "
                  f"{cells / ms / 1e6:.1f} GCUPS; W {shape['strip_lanes']} "
                  f"R {shape['chunk_rows']} lpt {shape['lanes_per_thread']}"
                  f", {shape['strips']} strips, {shape['ctas_per_pair']} "
                  f"CTAs a pair, ring {shape['ring']}, grid {shape['ctas']} "
                  f"of {shape['resident']} resident, {shape['sms']} SMs "
                  f"(a pair: {shape['sms_per_pair']})", flush=True)
        del t
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=_card(), stall_s=stall_s, rows=rows), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

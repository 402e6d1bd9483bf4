#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

Drives sequencealigning_tpu_torch (never JAX) in six phases and exits
non-zero at the first failure:

1. device: a CUDA card must be present; prints its nvidia-smi name and
   power limit;
2. build: compiles the CUDA kernels from csrc/ (nvcc, sm_90a);
3. fill kernel vs its plain PyTorch version on the card: ragged batches
   over compat/textbook x dirs none/fast4/full x wildcard, then the main
   path's shape (4096 pairs x 2046 bp, fast4): finals equal, direction
   codes equal on every cell of every real pair;
4. walk kernel vs its plain version and vs the native host walker;
5. main path: GotohAligner(first_only) on cuda through align_batch over
   4096 x 2046 bp pairs at ~1% divergence; every pair aligned, no host
   re-walk, both kernels launched, sampled scores equal the oracle; then
   one more align_batch under torch.profiler (the card's busy share) and
   one under cProfile (host stages);
6. CLI (first-only and co-optimal) and serve on the golden corpus with
   --device cuda.

The second-to-last line is a JSON object with each kernel's launches in
the main path, its error against the plain version and both times; the
last line is {"ok": true, "device": {...}}.  --out DIR writes the compiler
log, the measurements and the profile tables there.
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
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN, LEN_MAIN = 4096, 2046
REPLACES = {
    "nw_affine_stream_fill": "sequencealigning_tpu/ops/nw_affine_stream.py:429",
    "walk_fast4": "sequencealigning_tpu/ops/traceback_device.py:146",
}
SOURCES = {
    "nw_affine_stream_fill": "sequencealigning_tpu_torch/csrc/nw_affine_stream.cu",
    "walk_fast4": "sequencealigning_tpu_torch/csrc/traceback_device.cu",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


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


def valid_cell_diff(torch, dirs_a, dirs_b, plan, n1s, n2s, dirs_mode):
    """Max |code_a - code_b| over every cell 0 <= x <= n2, 0 <= y <= n1 of
    each real pair, the D bits at x = 0 masked (the torus roll fills them
    from lane P-1 and no walker reads them)."""
    per_word, bits = (8, 4) if dirs_mode == "fast4" else (4, 8)
    dmask = 8 if dirs_mode == "fast4" else 32 | 64
    a32, b32 = dirs_a.view(torch.int32), dirs_b.view(torch.int32)
    dev = dirs_a.device
    worst = 0
    for b in range(len(n1s)):
        row, _slot, off = plan.pair_coords(b)
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
    if out_dir:
        with open(os.path.join(out_dir, "nvcc_build.log"), "w") as f:
            f.write(csrc.build_log)
    return secs


def phase_fill(torch, port):
    from sequencealigning_tpu.config import ScoringScheme
    from sequencealigning_tpu.io.encode import pack_batch, trim_for_stream
    from sequencealigning_tpu_torch.device import to_device

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
                        torch, dk, dp, plan, n1s, n2s, dirs_mode))
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
    plain_ms, (fp, dp) = host_ms(
        torch, lambda: fill.gotoh_fill_stream_torch(*ins, *args))
    err = int((fk - fp).abs().max())
    whole = bool(torch.equal(dk.view(torch.int32), dp.view(torch.int32)))
    if not whole:
        err = max(err, valid_cell_diff(torch, dk, dp, plan, batch.query_len,
                                       batch.db_len, "fast4"))
    del dp
    check(err == 0, f"fill kernel != plain at the main shape: err {err}")
    cells = int((batch.query_len.astype(np.int64)
                 * batch.db_len.astype(np.int64)).sum())
    log(f"[3 fill] {N_MAIN} x {LEN_MAIN} bp fast4 (R={plan.n_rows}, "
        f"P={plan.p}, T={plan.t_total}): kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, {cells / ms / 1e6:.2f} GCUPS; equal "
        f"(whole dirs tensor equal: {whole})")
    out.update(fill_ms=ms, fill_plain_ms=plain_ms, fill_err=err,
               fill_gcups=cells / ms / 1e6, main_whole_dirs_equal=whole)
    return out, (fk, dk, plan, pairs)


def phase_walk(torch, port, state):
    from sequencealigning_tpu import native

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
    t_steps = plan.l1 + plan.l2
    ms = cuda_ms(torch, lambda: walk.walk_fast4_cuda(dirs, *seeds, t_steps))
    got = walk.walk_fast4_cuda(dirs, *seeds, t_steps)
    plain_ms, want = host_ms(
        torch, lambda: walk.walk_fast4_torch(dirs, *seeds, t_steps))
    err = 0
    for g, w in zip(got, want):
        err = max(err, int((g.view(torch.int32).long()
                            - w.view(torch.int32).long()).abs().max()))
    check(err == 0, f"walk kernel != plain: err {err}")
    ops = walk.decode_packed_ops(got[2].cpu().numpy(), n1s, n2s)
    host = native.fast4_first_path_batch_native(
        dirs.cpu().numpy(), fin, bs // plan.np_slots,
        (bs % plan.np_slots) * plan.s, n1s, n2s,
    )
    check(host is not None, "native host walker unavailable")
    bad = sum(o is None or o != h for o, h in zip(ops, host))
    check(bad == 0, f"walk kernel != native host walker on {bad} pairs")
    log(f"[4 walk] {B} pairs: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
        "equal to the plain walk and to the native host walker")
    return {"walk_ms": ms, "walk_plain_ms": plain_ms, "walk_err": err}


def phase_main(torch, port, pairs):
    from sequencealigning_tpu.config import AlignConfig, Algo
    from sequencealigning_tpu.io.fasta import Record
    from sequencealigning_tpu.ops import oracle_gotoh

    fill, walk = port["fill"], port["walk"]
    recs = [(Record(seq=a, name=b">q%d" % i), Record(seq=b, name=b">d%d" % i))
            for i, (a, b) in enumerate(pairs)]
    aligner = port["models"].GotohAligner(
        AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True), "cuda"
    )
    torch.cuda.reset_peak_memory_stats()
    fill.gotoh_fill_stream_cuda.launches = 0
    walk.walk_fast4_cuda.launches = 0
    t0 = time.perf_counter()
    res = aligner.align_batch(recs)
    secs = time.perf_counter() - t0
    launches = {"nw_affine_stream_fill": fill.gotoh_fill_stream_cuda.launches,
                "walk_fast4": walk.walk_fast4_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    check(len(res) == len(pairs), "missing results")
    errors = [r.error for r in res if not r.ok]
    check(not errors, f"{len(errors)} pairs failed: {errors[:3]}")
    check(aligner.host_fallbacks == 0,
          f"{aligner.host_fallbacks} pairs re-walked on the host")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
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
    return launches, {"main_s": secs, "alignments_per_s": len(pairs) / secs,
                      "peak_gib": peak / 2 ** 30}, (aligner, recs)


# Host stages of align_batch reported by the profile (cumulative seconds).
STAGES = ("pack_batch", "trim_for_stream", "to_device", "stream_inputs",
          "gotoh_fill_stream_cuda", "fast4_stream_align_device",
          "walk_fast4_cuda", "decode_packed_alignments",
          "walk_decode_batch_native", "fill_derived", "align_batch")


def phase_profile(torch, aligner, recs, out_dir):
    """Where align_batch's time goes: one call under torch.profiler (the
    card's busy time) and one under cProfile (host stages); the tables go
    to out_dir when one is given."""
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
        with open(os.path.join(out_dir, "profile_device.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=30))
        with open(os.path.join(out_dir, "profile_host.txt"), "w") as f:
            pstats.Stats(host, stream=f).sort_stats(
                "cumulative").print_stats(40)
    stages = {}
    for (_file, _line, fn), (_cc, _nc, _tt, ct, _callers) in stats.stats.items():
        if fn in STAGES:
            stages[fn] = max(stages.get(fn, 0.0), ct)
    log(f"[5 profile] align_batch {wall_ms:.1f} ms under torch.profiler, "
        f"card busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); host "
        "stages (cProfile, s): " + ", ".join(
            f"{k} {stages[k]:.3f}" for k in STAGES if k in stages))
    return {"profile_wall_ms": wall_ms, "profile_busy_ms": busy_ms,
            "host_stages_s": stages}


def phase_cli(port):
    spec = importlib.util.spec_from_file_location(
        "golden_regen", os.path.join(ROOT, "tests", "golden", "regen.py"))
    regen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(regen)
    golden = os.path.join(ROOT, "tests", "golden")
    q, d = os.path.join(golden, "queries.fa"), os.path.join(golden, "db.fa")
    main = port["cli"].main
    for name, extra in (("nw-first-only", ["--first-only"]),
                        ("needleman-wunsch", [])):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(["-q", q, "-d", d, "--no-out", "-a", "needleman-wunsch",
                       "--device", "cuda"] + extra)
        with open(os.path.join(golden, f"{name}.out")) as f:
            want = f.read()
        want_out = want.split("# --- stdout ---\n", 1)[1].split(
            "# --- stderr ---\n", 1)[0]
        check(rc == 0, f"cli exit {rc} ({name})")
        check(regen.normalize(out.getvalue()) == want_out,
              f"cli stdout differs from tests/golden/{name}.out")
    stdin = sys.stdin
    sys.stdin = io.StringIO(f"{q} {d}\n")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(["--serve", "-a", "needleman-wunsch", "--first-only",
                       "--device", "cuda"])
    finally:
        sys.stdin = stdin
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    pairs = [x for x in lines if "query_name" in x]
    check(rc == 0 and len(pairs) == 24 and all(p["error"] is None
                                               for p in pairs),
          "serve did not answer the 24 pairs")
    check(lines[-1].get("done") and lines[-1].get("pairs") == 24,
          "serve summary line missing")
    log("[6 cli] golden nw-first-only and needleman-wunsch stdout equal on "
        "cuda; serve answered 24 pairs")


def run(args):
    if not os.path.isdir(os.path.join(ROOT, "sequencealigning_tpu_torch")):
        raise SmokeFailure("sequencealigning_tpu_torch/ is not beside this "
                           "script: run it from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    card = phase_device(torch)
    from sequencealigning_tpu_torch import cli, csrc, models
    from sequencealigning_tpu_torch.ops import nw_affine_stream, traceback_device

    port = {"cli": cli, "models": models, "fill": nw_affine_stream,
            "walk": traceback_device}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    build_s = phase_build(csrc, args.out)
    meas, state = phase_fill(torch, port)
    meas.update(phase_walk(torch, port, state))
    pairs = state[3]
    del state
    torch.cuda.empty_cache()
    launches, main_meas, (aligner, recs) = phase_main(torch, port, pairs)
    meas.update(main_meas)
    meas.update(phase_profile(torch, aligner, recs, args.out))
    del aligner, recs
    phase_cli(port)
    meas.update(build_s=build_s, card=card)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(meas, f, indent=1)
    kernels = []
    for name, ms_key in (("nw_affine_stream_fill", "fill"),
                         ("walk_fast4", "walk")):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": meas[f"{ms_key}_err"],
            "ms": meas[f"{ms_key}_ms"],
            "plain_ms": meas[f"{ms_key}_plain_ms"],
        })
    return card, kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the compiler log, the measurements "
                    "and the profile tables")
    args = ap.parse_args()
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

"""Command-line interface of the PyTorch port (port of cli.py).

    seqalign-torch -q query.fa -d db.fa [-a ALGO] [--first-only] [--band N]
                   [--textbook] [--wfa-engine E] [--wfa-spans S]
                   [--stream-state i32|i16|auto] [--traceback auto|device|host]
                   [--profile DIR] [--device cpu|cuda] [-m MODE] [-o OUT] [-v]

Same interface, stdout formats, FASTA recovery and per-pair error
isolation as the JAX package's ``seqalign``, plus ``--device`` (default
cuda; cuda with no GPU fails).  ``--serve`` reads 'QUERY.fa DB.fa' lines
from stdin and answers each with JSON lines, keeping the aligner and its
built kernels warm; the other flags apply to it too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from sequencealigning_tpu_torch.config import (
    AlignConfig,
    Algo,
    Mode,
    ScoringScheme,
    WfaPenalties,
)
from sequencealigning_tpu_torch.errors import CharError, FastaError
from sequencealigning_tpu_torch.io.fasta import parse_fasta
from sequencealigning_tpu_torch.utils.pprint import bars
from sequencealigning_tpu_torch.models import get_aligner
from sequencealigning_tpu_torch.utils.profiling import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="seqalign-torch",
        description="Pairwise sequence alignment, PyTorch + CUDA port of "
        "sequencealigning_tpu",
    )
    p.add_argument("-q", "--query-file", help="Path to query FASTA")
    p.add_argument("-d", "--db-file", help="Path to db FASTA")
    p.add_argument(
        "-o", "--out-path", default="./results",
        help="Structured JSONL output path (default ./results)",
    )
    p.add_argument("-v", "--verbose", action="store_true", default=False)
    p.add_argument(
        "-m", "--mode", default="global",
        choices=[m.value for m in Mode],
    )
    p.add_argument(
        "-a", "--algo", default="a-star",
        choices=[a.value for a in Algo],
    )
    p.add_argument(
        "--textbook", action="store_true",
        help="Textbook semantics instead of reference-quirk compat",
    )
    p.add_argument("--no-out", action="store_true", help="Skip JSONL output")
    p.add_argument(
        "--first-only", action="store_true",
        help="One optimal alignment per pair (fast4 fill + device walk) "
        "instead of the reference's co-optimal enumeration",
    )
    p.add_argument(
        "--bucket", action="store_true",
        help="Length-bucket pairs within a window to reduce padding",
    )
    p.add_argument(
        "--debug", action="store_true",
        help="Validate fill results against closed-form score bounds",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="Write a torch.profiler trace (CPU and CUDA activity, Chrome "
        "format) of the run to DIR",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cpu", "cuda"],
        help="cuda runs the CUDA kernels, cpu their plain PyTorch versions",
    )
    p.add_argument("--band", type=int, default=128, help="Band half-width")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--match", type=int, default=5)
    p.add_argument("--mismatch", type=int, default=-4)
    p.add_argument("--gap-open", type=int, default=-8)
    p.add_argument("--gap-extend", type=int, default=-6)
    p.add_argument("--wfa-mismatch", type=int, default=4)
    p.add_argument("--wfa-gap-open", type=int, default=2)
    p.add_argument("--wfa-gap-extend", type=int, default=6)
    p.add_argument(
        "--wfa-engine", default="auto",
        choices=["auto", "banded", "native", "wavefront"],
        help="Textbook-WFA engine: the banded Gotoh fill, the exact "
        "threaded native host engine, or the wavefront engine (the CUDA "
        "fill and walk kernels on --device cuda); auto: native for "
        "low-divergence pairs, banded for the rest",
    )
    p.add_argument(
        "--wfa-spans", default=None, metavar="L1,L2,T1,T2",
        help="Bounded ends-free WFA spans for '-a wfa --textbook -m "
        "semi-global' or '-m local': the most FREE leading/trailing skips "
        "of query (L1/T1) and db (L2/T2).  One integer applies to all "
        "four.  Required for semi-global/local textbook WFA (the unbounded "
        "forms are degenerate under min-penalty scoring: the empty "
        "alignment always wins at 0)",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="Serve mode: read 'QUERY.fa DB.fa' lines from stdin, emit "
        "one JSON result line per pair + a summary line per request",
    )
    p.add_argument(
        "--traceback", default="auto", choices=["auto", "device", "host"],
        help="First-path, modes and long-pair walk route: device walks the "
        "direction words on the fill's device (the walk kernels on cuda) "
        "and fetches 2-bit op codes, host fetches the direction words and "
        "walks them on the host; auto = device on cuda; alignments are "
        "bit-identical either way",
    )
    p.add_argument(
        "--stream-state", default="i32", choices=["i32", "i16", "auto"],
        help="Streamed fills' score state: i16 holds two lanes a 32-bit "
        "word in the CUDA kernels where the scheme x shape certifies "
        "(about 2.7 kb pairs under the default scheme) and fails "
        "otherwise; auto takes i16 exactly when certified",
    )
    return p


def _parse_spans(v):
    """--wfa-spans: 'N' (all four) or 'L1,L2,T1,T2' -> tuple, None if
    unset."""
    if v is None:
        return None
    usage = SystemExit(
        "--wfa-spans takes one or four non-negative integers "
        "(L1,L2,T1,T2)"
    )
    try:
        parts = [int(x) for x in str(v).split(",")]
    except ValueError:
        raise usage from None
    if len(parts) == 1:
        parts = parts * 4
    if len(parts) != 4 or any(p < 0 for p in parts):
        raise usage
    return tuple(parts)


def _load(path: str, label: str):
    """Reference parse semantics: FastaError aborts, CharError warns and
    continues with the cleaned records."""
    try:
        return parse_fasta(path)
    except CharError as e:
        print(
            f"Invalid character {e.chars!r} detected in {label} fasta; "
            "continuing by ignoring it",
            file=sys.stderr,
        )
        return e.res
    except FastaError as e:
        print(f"{label} fasta could not be opened: {e}", file=sys.stderr)
        print("aborting", file=sys.stderr)
        return None


def _print_result(res, algo: Algo, verbose: bool) -> None:
    """Per-algorithm stdout format, following the reference's shapes;
    errors go to stderr."""
    if res.error is not None:
        print(
            f"An error occured during alignment of {res.query_name} and "
            f"{res.db_name}\n{res.error}",
            file=sys.stderr,
        )
        return
    if algo is Algo.A_STAR:
        # align.rs:41-47
        print(
            f"Alignment for db {res.db_name} and query {res.query_name} "
            f"with score {res.score} found"
        )
        print(res.aligned_db)
        print(bars(res.aligned_query, res.aligned_db))
        print(res.aligned_query)
    elif algo is Algo.WFA:
        # wfa.rs:36-39
        print(f"converged with score {res.score}: ")
        print(res.aligned_query)
        print(bars(res.aligned_query, res.aligned_db) + res.aligned_db)
    elif algo is Algo.NW_LINEAR:
        # needleman_wunsch.rs:196-201, 155-178
        print(
            f"Alignment between sequences {res.query_name} and "
            f"{res.db_name} found"
        )
        for a1, a2 in res.alignments or []:
            print(f"\nHit: \nseq1: {a1}\n      {bars(a1, a2)}\nseq2: {a2}\n")
    else:
        # needleman_wunsch_affine.rs:283-286, 390-411; banded's timing line
        # shows only with -v
        for a1, a2 in res.alignments or [(res.aligned_query, res.aligned_db)]:
            print("alignment found")
            print(f"\nseq1: {a1}\n      {bars(a1, a2)}\nseq2: {a2}")
        if verbose or algo is Algo.NEEDLEMAN_WUNSCH:
            print(f"{res.elapsed_s * 1e3:.3f}ms")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not args.serve:
        if args.query_file is None or args.db_file is None:
            build_parser().error(
                "the following arguments are required: -q/--query-file, "
                "-d/--db-file (or use --serve)"
            )
        db = _load(args.db_file, "DB")
        if db is None:
            return 1
        query = _load(args.query_file, "Query")
        if query is None:
            return 1

    config = AlignConfig(
        algo=Algo(args.algo),
        mode=Mode(args.mode),
        scoring=ScoringScheme(
            match_=args.match,
            mismatch=args.mismatch,
            gap_open=args.gap_open,
            gap_extend=args.gap_extend,
        ),
        wfa_penalties=WfaPenalties(
            mismatch=args.wfa_mismatch,
            gap_open=args.wfa_gap_open,
            gap_extend=args.wfa_gap_extend,
        ),
        compat=not args.textbook,
        verbose=args.verbose,
        band=args.band,
        wfa_engine=args.wfa_engine,
        wfa_spans=_parse_spans(args.wfa_spans),
        batch_size=args.batch_size,
        bucket=args.bucket,
        first_only=args.first_only,
        traceback=args.traceback,
        stream_state=args.stream_state,
        debug=args.debug,
        profile_dir=args.profile,
    )
    aligner = get_aligner(config, args.device)

    if args.serve:
        with trace(args.profile):
            return _serve(args, aligner)

    out_file = None
    if not args.no_out:
        out_path = Path(args.out_path)
        if out_path.parent != Path(""):
            out_path.parent.mkdir(parents=True, exist_ok=True)
        out_file = open(out_path, "w")

    t0 = time.perf_counter()
    n = n_err = 0
    try:
        with trace(args.profile):
            for res in aligner.align_all_pairs(query, db, args.batch_size):
                _print_result(res, config.algo, args.verbose)
                if out_file is not None:
                    out_file.write(json.dumps(res.to_json()) + "\n")
                n += 1
                n_err += 0 if res.ok else 1
    finally:
        if out_file is not None:
            out_file.close()
    if args.verbose:
        print(
            f"aligned {n} pairs ({n_err} errors) in "
            f"{time.perf_counter() - t0:.3f}s",
            file=sys.stderr,
        )
    return 0


def _serve(args, aligner) -> int:
    """Serve loop: one request per stdin line ("QUERY.fa DB.fa"; '#'
    comments skipped), one JSON line per pair result and one summary line
    per request on stdout.  A request's errors are reported as JSON and
    never stop the server."""
    n_req = 0
    for line in sys.stdin:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2:
            print(
                json.dumps(
                    {"error": f"expected 'QUERY.fa DB.fa', got {line!r}"}
                ),
                flush=True,
            )
            continue
        qpath, dpath = parts
        t0 = time.perf_counter()
        query = _load(qpath, "Query")
        dbr = _load(dpath, "DB")
        if query is None or dbr is None:
            print(
                json.dumps(
                    {"request": n_req, "error": "fasta could not be opened"}
                ),
                flush=True,
            )
            n_req += 1
            continue
        n = n_err = 0
        try:
            for res in aligner.align_all_pairs(query, dbr, args.batch_size):
                print(json.dumps(res.to_json()), flush=False)
                n += 1
                n_err += 0 if res.ok else 1
        except Exception as e:  # isolation: a request must not kill the server
            print(json.dumps({"request": n_req, "error": repr(e)}))
        print(
            json.dumps(
                {
                    "request": n_req,
                    "done": True,
                    "pairs": n,
                    "errors": n_err,
                    "elapsed_s": round(time.perf_counter() - t0, 6),
                }
            ),
            flush=True,
        )
        n_req += 1
    return 0


def console_main() -> int:
    """Entry point for the ``seqalign-torch`` script: exit quietly on
    SIGPIPE, while main() itself keeps raising for in-process callers."""
    try:
        return main()
    except BrokenPipeError:
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 141


if __name__ == "__main__":
    sys.exit(console_main())

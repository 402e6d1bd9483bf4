"""Streaming alignment pipeline for very large pair sets: the port of
parallel/streaming.py.

BASELINE config 5: a million read pairs streamed data-parallel.  The host
pipeline keeps the devices fed: a kernel launch returns before the device
finishes, so queueing the next batch while the previous one runs gives
double-buffering, and a bounded in-flight window applies backpressure.
Each process streams its own shard of the input; the score merge is the
runner's gather.

A batch-cursor checkpoint (the index of the next batch to deliver)
supports resume for long runs.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from sequencealigning_tpu_torch.io.encode import (
    PairBatch,
    WireBatch,
    pack_batch,
)
from sequencealigning_tpu_torch.ops.traceback_device import (
    assemble_modes_alignments,
)
from sequencealigning_tpu_torch.parallel.mesh import process_count
from sequencealigning_tpu_torch.parallel.runner import (
    DataParallelRunner,
    to_host,
)

# Seconds a pipeline thread waits on a full queue before it looks again
# whether the stream has stopped.
_POLL = 0.1


def stream_align(
    pairs: Iterable[Tuple[bytes, bytes]],
    runner: Optional[DataParallelRunner] = None,
    batch_size: int = 256,
    max_in_flight: int = 2,
    checkpoint_path: Optional[str] = None,
    on_result: Optional[Callable[[int, np.ndarray], None]] = None,
    cigars: bool = False,
    on_alignments: Optional[Callable[[int, list], None]] = None,
    first_batch_index: int = 0,
    mode: str = "global",
) -> int:
    """Stream pairs through the runner.  Returns the number of pairs
    aligned (this process's).

    ``pairs`` is an iterable of (query, db) byte tuples (chunked and packed
    here) or of pre-packed PairBatch / WireBatch objects (io.encode.
    pack_arrays / pack_wire; scores only, since the cigar traceback needs
    the raw byte sequences).

    on_result(batch_index, scores) is called per completed batch (scores:
    (B, 3) finals, or (B,) best scores in the textbook modes).  Callbacks
    fire on the pipeline's single DRAIN worker thread, in batch order.  If
    checkpoint_path is given, completed-batch indices are persisted and
    already-completed batches are skipped on resume (at-least-once
    delivery: the batch in flight when a run is interrupted is
    re-delivered, so callbacks must be idempotent).  A checkpoint written
    under another ``mode`` or ``cigars`` is refused.

    first_batch_index declares that ``pairs`` already starts at that batch
    index (the reader seeks past completed input instead of regenerating
    it; batch i of the stream is numbered first_batch_index + i for the
    callbacks and the checkpoint cursor).

    With cigars=True each batch also runs the fast4 direction fill and its
    walk; on_alignments(batch_index, results) receives per-pair (score,
    [(aligned_query, aligned_db)]) tuples or AlignmentError instances.  On
    the device route the walk is queued behind its own fill and only its
    op codes are fetched at drain time; with several processes each
    process's on_alignments receives ITS OWN pairs in local order, while
    on_result keeps the globally gathered scores.

    ``mode``: "global" (default; fast4) or the textbook modes "semi" /
    "local" (the streamed modes fill and the modes walk).

    A failed drain (a callback's or a fetch's error) stops the stream: no
    batch is dispatched after the drain worker has recorded it, and the
    error is raised on the calling thread.
    """
    if mode not in ("global", "semi", "local"):
        raise ValueError(f"unknown mode {mode!r}")
    runner = runner or DataParallelRunner()
    mp = process_count() > 1
    start_batch = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            ckpt = json.load(f)
        start_batch = ckpt.get("next_batch", 0)
        # A checkpoint written under other alignment semantics must not be
        # continued: the one output stream would mix them at the resume
        # point.  (Checkpoints without the fields resume as before.)
        for field, now in (("mode", mode), ("cigars", cigars)):
            then = ckpt.get(field, now)
            if then != now:
                raise ValueError(
                    f"checkpoint {checkpoint_path!r} was written by a "
                    f"run with {field}={then!r}; resuming with "
                    f"{field}={now!r} would mix alignment semantics in "
                    "one output stream (delete the checkpoint to start "
                    "over)"
                )

    n_done = [0]  # drained-pair count (owned by the drain worker)

    def _drain(entry):
        idx, scores, n_slice, n_count, extra = entry
        scores = to_host(scores)  # waits for the batch's device work
        n_done[0] += n_count
        if on_result is not None:
            on_result(idx, scores[:n_slice])
        if extra is not None and on_alignments is not None:
            on_alignments(idx, _alignments(runner, scores, extra, mp))
        if checkpoint_path:
            tmp = checkpoint_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"next_batch": idx + 1, "mode": mode, "cigars": cigars},
                    f,
                )
            os.replace(tmp, checkpoint_path)

    def _batches():
        """Yield (index, PairBatch/WireBatch or None, pair bytes or None);
        byte pairs are packed by prep() after the resume skip, so a resumed
        run does not re-pack completed batches."""
        it = iter(pairs)
        first = next(it, None)
        if first is None:
            return
        chained = itertools.chain([first], it)
        if isinstance(first, (PairBatch, WireBatch)):
            for i, b in enumerate(chained, start=first_batch_index):
                yield i, b, None
            return
        for i, bp in enumerate(_chunks(chained, batch_size),
                               start=first_batch_index):
            yield i, None, bp

    # Four stages: [prep thread: pack + host work] -> [put thread: host to
    # device copies] -> [this thread: dispatch only] -> [drain thread:
    # result fetch + decode + callbacks].  Bounded queues keep the
    # backpressure of max_in_flight.
    stream_kernel = runner.kernel == "stream"
    depth = max(1, max_in_flight)
    q_prep: "queue.Queue" = queue.Queue(maxsize=depth)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def offer(qu, item) -> bool:
        """Put item on a bounded queue unless the stream stops first."""
        while not stop.is_set():
            try:
                qu.put(item, timeout=_POLL)
                return True
            except queue.Full:
                continue
        return False

    def prep():
        try:
            for i, batch, batch_pairs in _batches():
                if i < start_batch:
                    continue
                if batch is None:
                    batch = pack_batch(batch_pairs, batch_size=batch_size)
                n_valid = int(batch.valid.sum())
                if stream_kernel:
                    host_args, plan, B, has_n = runner._stream_args_host(
                        batch)
                    item = ("host", i, host_args, plan, B, has_n, n_valid,
                            batch_pairs)
                else:
                    item = ("batch", i, batch, n_valid, batch_pairs)
                if not offer(q_prep, item):
                    return
            offer(q_prep, ("done",))
        except BaseException as e:  # propagate downstream
            offer(q_prep, ("error", e))

    def put():
        while not stop.is_set():
            try:
                item = q_prep.get(timeout=_POLL)
            except queue.Empty:
                continue
            if item[0] == "host":
                _, i, host_args, plan, B, has_n, n_valid, batch_pairs = item
                try:
                    args = runner._put_stream_args(host_args, has_n)
                except BaseException as e:
                    offer(q, ("error", e))
                    return
                item = ("args", i, args, plan, B, has_n, n_valid, batch_pairs)
            if not offer(q, item) or item[0] in ("done", "error"):
                return

    # The drain worker fetches, decodes and calls back off the main thread,
    # so batch k+1's dispatch never waits behind batch k's fetch.  The
    # in-flight budget (undrained batches alive at once) is EXACTLY
    # max_in_flight: each entry pins its batch's device buffers (the fast4
    # dirs are GBs at production shapes); the semaphore is acquired before
    # each dispatch and released only when the entry is fully drained.
    q_drain: "queue.Queue" = queue.Queue()
    drain_err: List[BaseException] = []
    in_flight_sem = threading.Semaphore(depth)

    def drain_worker():
        while True:
            entry = q_drain.get()
            if entry is None:
                return
            try:
                if not drain_err:
                    _drain(entry)
            except BaseException as e:  # surfaced on the main thread
                drain_err.append(e)
            finally:
                del entry  # release the batch's device buffers
                in_flight_sem.release()

    def check_drain():
        if drain_err:
            raise drain_err[0]

    threads = [threading.Thread(target=prep, daemon=True),
               threading.Thread(target=put, daemon=True)]
    drain_t = threading.Thread(target=drain_worker, daemon=True)
    for t in threads + [drain_t]:
        t.start()

    def _stream_loop():
        while True:
            item = q.get()
            kind = item[0]
            if kind == "done":
                break
            if kind == "error":
                raise item[1]
            # A failed drain stops the stream before the next dispatch:
            # checked before waiting for a slot, and again after the wait
            # (the slot may have been freed by the drain that failed).
            check_drain()
            in_flight_sem.acquire()
            try:
                check_drain()
            except BaseException:
                in_flight_sem.release()
                raise
            batch = args = plan = B = has_n = None
            if kind == "args":
                _, i, args, plan, B, has_n, n_valid, batch_pairs = item
            else:
                _, i, batch, n_valid, batch_pairs = item
            if batch_pairs is None and cigars:
                raise ValueError(
                    "cigars=True requires byte pairs (the traceback needs "
                    "the raw sequences); stream (query, db) tuples instead "
                    "of PairBatch objects"
                )
            if mode != "global" and args is None:
                args, plan, B, has_n = runner._stream_args(batch)
            q_drain.put(_dispatch(runner, i, args, plan, B, has_n, batch,
                                  n_valid, batch_pairs, cigars, mode, mp))

    try:
        _stream_loop()
    finally:
        stop.set()
        # Always release the drain worker.
        q_drain.put(None)
        drain_t.join()
        for t in threads:
            t.join()
    check_drain()
    return n_done[0]


def _dispatch(runner, i, args, plan, B, has_n, batch, n_valid, batch_pairs,
              cigars, mode, mp):
    """Queue one batch's device work; returns its drain entry (index,
    scores, n_slice, n_count, extra)."""
    if not cigars:
        if mode != "global":
            scores = runner.fill_modes_from_stream_args(
                args, plan, B, has_n, mode, with_dirs=False)[0]
        elif args is not None:
            scores = runner.scores_from_stream_args(args, plan, B, has_n)
        else:
            scores = runner.scores(batch)
        # With several processes on_result sees the GLOBAL gathered scores
        # (B covers every process's rows); n_pairs counts this process's.
        n_slice = B if (args is not None and mp) else n_valid
        return i, scores, n_slice, n_valid, None
    seqs1 = [p[0] for p in batch_pairs]
    seqs2 = [p[1] for p in batch_pairs]
    n = len(batch_pairs)
    if args is None:
        if mp:
            raise NotImplementedError(
                "multi-process cigars streaming requires the stream-args "
                "route (kernel='stream')"
            )
        finals, dirs, plan = runner.fill_with_dirs(batch)
        return i, finals, n, n, ("dirs", dirs, plan, seqs1, seqs2)
    n_out = B if mp else n
    device = runner.walk_on_device() or mp
    if mode != "global":
        if device:
            best, xs, ys, handles, dirs, plan = (
                runner.fill_walk_modes_from_stream_args(
                    args, plan, n_out, has_n, mode))
        else:
            best, xs, ys, dirs, plan = runner.fill_modes_from_stream_args(
                args, plan, n_out, has_n, mode)
            handles = None
        extra = ("modes", handles, seqs1, seqs2, xs, ys, dirs, plan, mode)
        return i, best, n_out, n, extra
    if device:
        finals, handles = runner.fill_walk_from_stream_args(
            args, plan, n_out, has_n, seqs1, seqs2)
        return i, finals, n_out, n, ("device", handles, seqs1, seqs2)
    finals, dirs, plan = runner.fill_with_dirs_from_stream_args(
        args, plan, n, has_n)
    return i, finals, n, n, ("dirs", dirs, plan, seqs1, seqs2)


def _alignments(runner, scores, extra, mp):
    """Finish a batch's walk at drain time: per-pair results."""
    kind = extra[0]
    if kind == "device":
        _, handles, seqs1, seqs2 = extra
        return runner.device_walk_fast4_finish(handles, scores, seqs1, seqs2)
    if kind == "dirs":
        _, dirs, plan, seqs1, seqs2 = extra
        walk = (runner.device_walk_fast4 if runner.walk_on_device()
                else runner.host_walk_fast4)
        return walk(dirs, plan, scores, seqs1, seqs2)
    _, handles, seqs1, seqs2, xs, ys, dirs, plan, mode = extra
    walked = (runner.device_walk_modes_finish(handles, seqs1, seqs2)
              if handles is not None else None)
    xs, ys = to_host(xs), to_host(ys)
    sc = scores[:, 0] if scores.ndim > 1 else scores
    if mp:
        # This process's view of the replicated best / end-cell vectors.
        loc = runner.mp_local_slice(plan)
        nb = len(seqs1)
        xs, ys, sc = xs[loc][:nb], ys[loc][:nb], sc[loc][:nb]
    # The host walkers take a pair whose device walk failed on the CPU, and
    # every pair on the host route; a kernel's failed walk stays the pair's
    # AlignmentError (ROADMAP.md §3).
    fetch = None
    if walked is None or not dirs[0].is_cuda:
        def fetch(b):
            return runner.dirs_fetch(dirs, plan, b)
    return assemble_modes_alignments(
        list(zip(seqs1, seqs2)), walked, sc, xs, ys, mode == "local", fetch)


def _chunks(pairs: Iterable[Tuple[bytes, bytes]], n: int):
    buf: List[Tuple[bytes, bytes]] = []
    for p in pairs:
        buf.append(p)
        if len(buf) >= n:
            yield buf
            buf = []
    if buf:
        yield buf

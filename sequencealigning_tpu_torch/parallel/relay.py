"""The seqpar column relay: boundary columns between ranks through host
buffers, and the finals' sum over the ranks.

Sequence parallelism over several processes (parallel/seqpar.py under an
initialised ``torch.distributed`` group) deals one pair's segments to every
rank's devices.  Where segment k - 1 and segment k sit on two ranks, the
column between them crosses the processes:

* the producer's launch writes it into an *outbox* in its rank's host
  memory, publishing the rows in place at the buffer's head as it goes;
* the consumer's launch reads it from an *inbox* in its own rank's host
  memory, waiting on the inbox's count as on any boundary buffer;
* the relay moves the rows between the two: one sender thread a consumer
  rank polls its outboxes' counts and sends each run of at least
  BLOCK_ROWS newly published rows (or a column's last rows) as one
  message; one receiver thread a producer rank writes each message's rows
  into the inbox, the rows first and the count last.

Both buffers keep the shard fill's layout (ops.nw_affine_tiled.SHARD_HEAD
int32, [0] the rows in place, then the column's 2 * nrow int32).  On CUDA
they are pinned host tensors: under unified addressing their data_ptr() is
a device address, so the kernel's table takes them as it takes a peer
card's buffer, and its system-scope acquire loads and release stores
order the rows against the count.  On the host the count is stored with
release order after the rows and loaded with acquire order before them
(native.relay_store_release / relay_load_acquire), so a fill on another
thread, or the card reading over the bus, that sees a count also sees the
rows it covers.

Messages from one rank to another go in order on one tag, each
MSG_HEAD + 2 * BLOCK_ROWS int32: a data message (pair, segment, first row,
rows), then END once every column is sent, or ABORT when the sender's own
fill failed.  Every wait on the network is bounded by RELAY_TIMEOUT_S; a
peer that sends nothing leaves a receiver to time out (Gloo then closes
the connection, so the peer's next call on the group fails too).
"""

from __future__ import annotations

import datetime
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sequencealigning_tpu_torch import native
from sequencealigning_tpu_torch.ops.nw_affine_tiled import SHARD_HEAD as _HEAD

# Rows a message carries at most: a run of newly published rows is sent
# once it reaches this (or the column's end).  The same on every rank: it
# sizes the messages.
BLOCK_ROWS = 4096
# Seconds a send or a receive may wait on its peer.
RELAY_TIMEOUT_S = 120.0
# Seconds a sender sleeps when no outbox moved.
POLL_S = 2e-4

MSG_HEAD = 8
DATA, END, ABORT = 1, 2, 3


@dataclass
class RelayEdge:
    """One column crossing ranks: pair b's column entering segment k,
    produced by global shard src and consumed by global shard dst; peer the
    other side's rank; buf this side's host buffer (int32, _HEAD + 2 *
    nrow)."""
    b: int
    k: int
    src: int
    dst: int
    peer: int
    buf: torch.Tensor

    def name(self) -> str:
        return (f"pair {self.b} segment {self.k} (shard {self.src} -> shard "
                f"{self.dst})")


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=RELAY_TIMEOUT_S)


class ColumnRelay:
    """Relays the columns of inbox and outbox (RelayEdge lists) over group
    while this rank's launches run: start(), then finish(ok) once they
    have ended.  rows[b]: the rows of pair b's column (n1 + 1); tag: this
    call's message tag, the same on every rank.  errors: what went wrong,
    one line each; sent / received: messages."""

    def __init__(self, group, inbox: Sequence[RelayEdge],
                 outbox: Sequence[RelayEdge], rows, tag: int):
        self.group = group
        self.rows = [int(r) for r in rows]
        self.tag = tag
        self.block = BLOCK_ROWS
        self.errors: List[str] = []
        self.sent = self.received = 0
        self._stop = threading.Event()
        self._lib = native.get_lib()
        self._senders = [
            threading.Thread(target=self._send_loop, args=(p, es),
                             daemon=True)
            for p, es in _by_peer(outbox)]
        self._receivers = [
            threading.Thread(target=self._recv_loop, args=(p, es),
                             daemon=True)
            for p, es in _by_peer(inbox)]

    def start(self) -> None:
        for t in self._senders + self._receivers:
            t.start()

    def finish(self, ok: bool) -> None:
        """ok: every launch of this rank ended with its columns complete --
        the senders flush what is left and send END, and the receivers
        end on their peers' END.  Otherwise the senders send ABORT and the
        receivers are left to their peers (they end on END or ABORT, or
        time out)."""
        if not ok:
            self._stop.set()
        for t in self._senders:
            t.join()
        if ok:
            for t in self._receivers:
                t.join()

    def _peer(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)

    def _send(self, peer: int, msg: torch.Tensor) -> None:
        dist.isend(msg, self._peer(peer), group=self.group,
                   tag=self.tag).wait(_timeout())
        self.sent += 1

    def _send_loop(self, peer: int, edges: List[RelayEdge]) -> None:
        msg = torch.zeros(MSG_HEAD + 2 * self.block, dtype=torch.int32)
        m = msg.numpy()
        done = [0] * len(edges)
        left = set(range(len(edges)))
        try:
            while left and not self._stop.is_set():
                moved = False
                for i in sorted(left):
                    e = edges[i]
                    total = self.rows[e.b]
                    have = min(self._lib.relay_load_acquire(e.buf.data_ptr()),
                               total)
                    src = e.buf.numpy()
                    while (have - done[i] >= self.block
                           or (have == total and done[i] < total)):
                        n = min(self.block, have - done[i])
                        m[:5] = (DATA, e.b, e.k, done[i], n)
                        m[MSG_HEAD:MSG_HEAD + 2 * n] = \
                            src[_HEAD + 2 * done[i]:_HEAD + 2 * (done[i] + n)]
                        self._send(peer, msg)
                        done[i] += n
                        moved = True
                    if done[i] == total:
                        left.discard(i)
                if not moved and left:
                    time.sleep(POLL_S)
            m[:5] = (ABORT if left else END, 0, 0, 0, 0)
            self._send(peer, msg)
        except Exception as err:  # noqa: BLE001 -- the thread's end, kept
            unsent = ", ".join(edges[i].name() for i in sorted(left))
            self.errors.append(f"sending to rank {peer} ({unsent or 'END'}): "
                               f"{err}")

    def _recv_loop(self, peer: int, edges: List[RelayEdge]) -> None:
        want = {(e.b, e.k): e for e in edges}
        got = {key: 0 for key in want}
        msg = torch.zeros(MSG_HEAD + 2 * self.block, dtype=torch.int32)
        m = msg.numpy()

        def short():
            return [e.name() for key, e in want.items()
                    if got[key] < self.rows[e.b]]

        try:
            while True:
                dist.irecv(msg, self._peer(peer), group=self.group,
                           tag=self.tag).wait(_timeout())
                self.received += 1
                kind, b, k, row0, n = (int(x) for x in m[:5])
                if kind != DATA:
                    if short():
                        self.errors.append(
                            f"rank {peer} {'ended' if kind == END else 'aborted'}"
                            f" with columns unsent: {', '.join(short())}")
                    return
                e = want.get((b, k))
                if e is None or row0 != got[b, k] or \
                        row0 + n > self.rows[b]:
                    self.errors.append(f"rank {peer} sent rows {row0}.."
                                       f"{row0 + n} of pair {b} segment {k}, "
                                       "out of order")
                    return
                dst = e.buf.numpy()
                dst[_HEAD + 2 * row0:_HEAD + 2 * (row0 + n)] = \
                    m[MSG_HEAD:MSG_HEAD + 2 * n]
                self._lib.relay_store_release(e.buf.data_ptr(), row0 + n)
                got[b, k] = row0 + n
        except Exception as err:  # noqa: BLE001 -- the thread's end, kept
            self.errors.append(
                f"no message from rank {peer} within {RELAY_TIMEOUT_S:g} s "
                f"(columns waiting: {', '.join(short())}): {err}")


def _by_peer(edges: Sequence[RelayEdge]):
    peers = {}
    for e in edges:
        peers.setdefault(e.peer, []).append(e)
    return sorted(peers.items())


def send_column(col: torch.Tensor, peer: int, group, tag: int) -> None:
    """The plain twin's hand-over: one column (any int32 tensor) to rank
    peer of group, bounded by RELAY_TIMEOUT_S."""
    _wait(dist.isend(col.cpu().contiguous(),
                     dist.get_global_rank(group, peer), group=group,
                     tag=tag), f"sent a column to rank {peer}")


def recv_column(shape, peer: int, group, tag: int, what: str
                ) -> torch.Tensor:
    """The plain twin's receipt of send_column's column (int32 of shape,
    on the host); raises naming ``what`` when rank peer sends nothing
    within RELAY_TIMEOUT_S."""
    buf = torch.empty(shape, dtype=torch.int32)
    _wait(dist.irecv(buf, dist.get_global_rank(group, peer), group=group,
                     tag=tag), f"waited for {what} from rank {peer}")
    return buf


def _wait(work, what: str) -> None:
    """Waits for a send or receive of the plain twin; past RELAY_TIMEOUT_S
    (Gloo then closes the connection) the cached seqpar group is dropped
    and this raises, naming what the rank was doing."""
    from sequencealigning_tpu_torch.parallel.mesh import drop_seqpar_group

    try:
        work.wait(_timeout())
    except RuntimeError as err:
        drop_seqpar_group()
        raise RuntimeError(f"seqpar: rank {dist.get_rank()} {what} for "
                           f"{RELAY_TIMEOUT_S:g} s: {err}") from err


def exchange_finals(finals: np.ndarray, failure: Optional[str], group,
                    stamp_ns: int = 0):
    """The finals' sum over group (each rank's (B, 3) int64 finals hold
    the corners of its own segments, zeros elsewhere: the JAX package's
    psum), with each rank's failure flag and stamp: (sum, stamps).  Every
    rank joins it, failed or not, so a failure raises on every rank: the
    failed ones with their own message, the others naming them.  After a
    failure the cached seqpar group is dropped."""
    from sequencealigning_tpu_torch.parallel.mesh import drop_seqpar_group

    mine = torch.from_numpy(np.concatenate([
        np.array([failure is not None, stamp_ns], np.int64),
        np.asarray(finals, np.int64).ravel()]))
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    try:
        dist.all_gather(out, mine, group=group)
    except RuntimeError as err:
        drop_seqpar_group()
        raise RuntimeError(failure or f"seqpar: the finals' exchange failed: "
                           f"{err}") from err
    failed = [r for r, t in enumerate(out) if int(t[0])]
    if failed:
        drop_seqpar_group()
        raise RuntimeError(failure or f"seqpar: rank(s) {failed} failed; "
                           "no finals")
    total = sum(t[2:] for t in out).numpy().reshape(np.shape(finals))
    return total, [int(t[1]) for t in out]


# Tags of the calls made so far: every rank makes the same calls in the
# same order, so the n-th call's messages carry the same tag everywhere.
_calls = 0


def next_tag() -> int:
    global _calls
    _calls += 1
    return _calls % (1 << 24)

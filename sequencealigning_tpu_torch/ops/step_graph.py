"""Step loops of the plain versions, replayed as CUDA graphs on the card.

A plain version steps a Python loop of a few dozen small torch ops a step.
On the card each op is a launch, so the loop's time is the host's, not the
device's.  A loop body written against a step counter held in a 0-d device
tensor, with its state updated in place, can instead be captured once for
GRAPH_STEPS consecutive steps (torch.cuda.CUDAGraph) and replayed, the counter
advanced inside the graph: the same ops on the same cells, launched by the
driver a graph at a time.  On CPU tensors the body runs eagerly step by
step, so the CPU tests run the very body the card replays.

A body must read its step only through the counter (index_select, masks,
arithmetic with 0-d tensors), keep no Python state between steps, update
its state only in place, and never synchronise with the host.
"""

from __future__ import annotations

import torch

# Steps a graph holds; 0 runs every step eagerly on the card as well.
GRAPH_STEPS = 32


def run_steps(body, counter: torch.Tensor, n: int, done=None,
              every: int = 0) -> None:
    """Run body() n times, adding 1 to counter (a 0-d integer tensor) after
    each.  On CUDA, n >= 2 * GRAPH_STEPS: the first GRAPH_STEPS steps run
    eagerly on a side stream (the warm-up a capture needs), the next are
    captured as one graph of GRAPH_STEPS steps and replayed, the remainder
    runs eagerly.  done: None, or a function returning a 0-d bool tensor,
    read on the host before each `every` steps (a multiple of GRAPH_STEPS):
    the loop stops once it holds, the graph captured once for all."""
    if n <= 0:
        return
    block = every if done is not None and every else n
    graph = None
    t = 0
    while t < n:
        if done is not None and bool(done()):
            break
        k = min(block, n - t)
        graph = _steps(body, counter, k, graph)
        t += k
    del graph


def _steps(body, counter: torch.Tensor, k: int, graph):
    """k steps of run_steps, replaying `graph` (None: captured here where
    k allows); returns the graph."""
    unroll = GRAPH_STEPS
    if graph is None and (counter.device.type != "cuda" or not unroll
                          or k < 2 * unroll):
        for _ in range(k):
            body()
            counter.add_(1)
        return None
    if graph is None:
        main = torch.cuda.current_stream(counter.device)
        side = torch.cuda.Stream(counter.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(unroll):
                body()
                counter.add_(1)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(unroll):
                body()
                counter.add_(1)
        k -= unroll
    reps, rest = divmod(k, unroll)
    for _ in range(reps):
        graph.replay()
    for _ in range(rest):
        body()
        counter.add_(1)
    return graph


def to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same 32 bits as int32."""
    return (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)


class CounterPacker:
    """ops.nw_affine.DirsPacker for a step held in a 0-d device tensor: the
    code of step t lands in bits (32 / per) * (t % per) of word t // per of
    dirs.  Each add stores its word, so the last, partial word needs no
    flush (zeros above its codes, as DirsPacker.flush leaves them)."""

    def __init__(self, dirs: torch.Tensor, per: int):
        self.dirs = dirs
        self.words = dirs.view(torch.int32)
        self.per = per
        self.bits = 32 // per
        self.acc = torch.zeros(dirs.shape[1:], dtype=torch.int64,
                               device=dirs.device)

    def add(self, t: torch.Tensor, code: torch.Tensor) -> None:
        u = t % self.per
        word = code.to(torch.int64) << (self.bits * u)
        self.acc.copy_(torch.where(u == 0, word, self.acc | word))
        self.words.index_copy_(0, (t // self.per).view(1),
                               to_i32(self.acc)[None])

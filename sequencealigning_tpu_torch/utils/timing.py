"""Observability: GCUPS counters, pairs/s, and the scaling-efficiency
harness (the port's copy of sequencealigning_tpu/utils/timing.py).

The reference's only instrumentation is ad-hoc wall-clock prints
(src/align.rs:38-40, src/needleman_wunsch_affine.rs:431); this module is the
framework-level replacement: structured counters plus a harness that
measures data-parallel scaling efficiency across mesh sizes (the BASELINE
config-5 metric).

Timing: always measure to a host read of the result
(parallel.runner.to_host), which waits for the fills behind it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np

from sequencealigning_tpu_torch.parallel.runner import to_host


@dataclasses.dataclass
class FillStats:
    """One fill measurement."""

    pairs: int
    cells: int  # true n1*n2 cells credited
    seconds: float

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9

    @property
    def pairs_per_s(self) -> float:
        return self.pairs / self.seconds

    def to_json(self) -> dict:
        return {
            "pairs": self.pairs,
            "cells": self.cells,
            "seconds": self.seconds,
            "gcups": self.gcups,
            "pairs_per_s": self.pairs_per_s,
        }


def time_to_host(fn: Callable[[], object], n_iter: int = 3) -> float:
    """Best-of-n wall time of fn(), forcing a host read of its result (a
    tensor, per-device blocks or an array)."""
    to_host(fn())  # warmup / build
    best = float("inf")
    for _ in range(n_iter):
        t0 = time.perf_counter()
        to_host(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def measure_fill(runner, batch, n_iter: int = 3) -> FillStats:
    """Measure a DataParallelRunner.scores call on a PairBatch."""
    cells = int(
        (
            np.asarray(batch.query_len, np.int64)
            * np.asarray(batch.db_len, np.int64)
        ).sum()
    )
    seconds = time_to_host(lambda: runner.scores(batch), n_iter)
    return FillStats(
        pairs=int(batch.valid.sum()), cells=cells, seconds=seconds
    )


def scaling_efficiency(
    make_runner: Callable[[int], "object"],
    batch_for: Callable[[int], "object"],
    device_counts: List[int],
    n_iter: int = 3,
) -> Dict[int, dict]:
    """Weak-scaling harness: for each device count n, run a proportionally
    sized batch and report pairs/s + efficiency vs. the smallest mesh.

    make_runner(n) -> runner over an n-device mesh;
    batch_for(n)   -> the workload for n devices (weak scaling: n x base).
    """
    results: Dict[int, dict] = {}
    base_rate = None
    base_n = None
    for n in device_counts:
        stats = measure_fill(make_runner(n), batch_for(n), n_iter)
        if base_rate is None:
            base_rate, base_n = stats.pairs_per_s, n
        ideal = base_rate * n / base_n
        results[n] = {
            **stats.to_json(),
            "efficiency": stats.pairs_per_s / ideal if ideal else 0.0,
        }
    return results

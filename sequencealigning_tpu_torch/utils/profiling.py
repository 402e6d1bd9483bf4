"""Profiling hooks: torch.profiler traces and simple phase timers, the
port's copy of sequencealigning_tpu/utils/profiling.py.

Usage:
    with trace("/tmp/trace"):          # Chrome trace of host and card
        runner.scores(batch)

    with phase_timer() as t:
        ...
    t.report()                          # per-phase wall seconds to stderr
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace of the CPU activity and, where there is a
    card, the CUDA activity, written into logdir as a Chrome trace
    (trace_<pid>_<ns>.json; viewable in chrome://tracing or Perfetto).
    No-op if logdir is falsy."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(logdir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}", file=sys.stderr)


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (
                self.phases.get(name, 0.0) + time.perf_counter() - t0
            )

    def report(self, file=sys.stderr) -> None:
        for name, s in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            print(f"[profile] {name}: {s:.3f}s", file=file)


@contextlib.contextmanager
def phase_timer() -> Iterator[PhaseTimer]:
    t = PhaseTimer()
    yield t

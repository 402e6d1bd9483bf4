"""Configuration dataclasses: scoring schemes, modes, algorithms.
(The port's copy of sequencealigning_tpu/config.py.)

The reference hardcodes one compile-time scoring constant per algorithm file
with *inconsistent sign conventions* (maximize +5/-4/-8/-6 in src/align.rs:9-17
and src/needleman_wunsch_affine.rs:15-20 vs. minimized penalties 4/2/6 in
src/wfa.rs:17-21).  Here scoring is data: one dataclass per convention, with
the reference's constants as defaults, all CLI-settable.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Mode(enum.Enum):
    """Alignment mode (reference: src/parse.rs:44-50)."""

    GLOBAL = "global"
    LOCAL = "local"
    SEMI_GLOBAL = "semi-global"


class Algo(enum.Enum):
    """Algorithm selector (reference: src/parse.rs:36-42), plus this
    framework's additions: the linear-gap NW recurrence that exists in the
    reference only as dead code (src/needleman_wunsch.rs, commented out of
    src/main.rs:4), and a banded affine variant (fixed-shape masked band, the
    TPU-native analog of A*'s pruning)."""

    A_STAR = "a-star"
    NEEDLEMAN_WUNSCH = "needleman-wunsch"
    WFA = "wfa"
    NW_LINEAR = "nw-linear"
    BANDED = "banded"


@dataclasses.dataclass(frozen=True)
class ScoringScheme:
    """Maximizing match/mismatch/gap-affine scheme.

    Defaults are the reference's constants shared by the A* and both NW
    aligners (src/align.rs:9-17, src/needleman_wunsch_affine.rs:15-20,
    src/needleman_wunsch.rs:181-186).  A gap of length L costs
    ``gap_open + L * gap_extend`` (both negative when maximizing).
    """

    match_: int = 5
    mismatch: int = -4
    gap_open: int = -8
    gap_extend: int = -6
    # A* weighted-heuristic inflation factor (src/align.rs:14).
    epsilon: float = 1.5
    # Karlin-Altschul constants, reserved-but-unused in the reference
    # (src/align.rs:15-16); carried for E-value reporting.
    lambda_: float = 0.039
    k: float = 0.11


@dataclasses.dataclass(frozen=True)
class WfaPenalties:
    """Minimizing WFA penalty scheme (reference: src/wfa.rs:17-21).

    Note the reference's unusual choice ``gap_open < gap_extend`` (2 < 6) is
    preserved as the default.  Match cost is implicitly 0 (classic WFA).
    """

    mismatch: int = 4
    gap_open: int = 2
    gap_extend: int = 6


@dataclasses.dataclass(frozen=True)
class WfaPruning:
    """WFA adaptive-pruning knobs (reference: src/wfa.rs:14-15)."""

    min_length: int = 5
    max_diff: int = 20


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """One config object for a whole run: algorithm, mode, scoring, batching,
    band/pruning parameters, and mesh shape.  This is the framework-level
    replacement for the reference's scattered per-file consts + clap Args
    (src/parse.rs:10-50)."""

    algo: Algo = Algo.A_STAR
    mode: Mode = Mode.GLOBAL
    scoring: ScoringScheme = dataclasses.field(default_factory=ScoringScheme)
    wfa_penalties: WfaPenalties = dataclasses.field(default_factory=WfaPenalties)
    wfa_pruning: WfaPruning = dataclasses.field(default_factory=WfaPruning)
    # Reference-compat mode: reproduce the Rust binary's exact outputs,
    # including its quirks (boundary `open + (i+1)*ext` gap chains
    # needleman_wunsch_affine.rs:195,207; WFA convergence at len-1 offsets
    # wfa.rs:189; score reported as wavefront-vector length wfa.rs:31-36).
    # False = textbook semantics.
    compat: bool = True
    verbose: bool = False
    # Banded variant: half-width of the fixed masked band around the main
    # diagonal (cells with |i - j - (n2-n1)/2-ish skew| > band are pruned).
    band: int = 128
    # Compat-WFA step bound: the reference's score loop can provably run
    # forever (greedy extension overshoots the len-1 convergence cell,
    # wfa.rs:127-139 vs :189); instead of hanging like the Rust binary, a
    # pair exceeding this raises AlignmentError and is isolated.
    wfa_max_steps: int = 20_000
    # Textbook-WFA engine choice.  "auto" routes low-divergence pairs to
    # the exact threaded native host engine (penalty-capped) and the rest
    # to the banded Gotoh Pallas kernel under the penalty-converted
    # scheme -- in its reference model inside the coincidence regime
    # (mismatch <= 2*gap_extend, PARITY.md; measured ~7x the wavefront
    # engine at 128 x 10 kb), or the any-state-open "std" variant
    # (ops.nw_banded_diag model="std") outside it, so EVERY penalty
    # scheme gets the TPU banded path.  "banded" / "native" /
    # "wavefront" force a specific engine.
    wfa_engine: str = "auto"
    # Bounded ends-free WFA spans (lead1, lead2, trail1, trail2): with
    # textbook WFA in semi-global mode, up to leadN/trailN chars of
    # seq1/seq2 may be skipped free at the start/end (WFA2-lib-style).
    # None = unset; required for semi-global textbook WFA because
    # UNBOUNDED both-sides ends-free is degenerate under min-penalty
    # scoring (the empty alignment costs 0 -- PARITY.md modes matrix).
    wfa_spans: Optional[Tuple[int, int, int, int]] = None
    # Batch runner knobs.
    batch_size: int = 64
    # Length-bucket pairs within a 4-batch window before batching (reduces
    # padding on heterogeneous workloads; output order is preserved).
    bucket: bool = False
    # Gotoh global mode: emit one optimal alignment per pair from the 4-bit
    # fast4 direction layout (half the dirs memory, threaded native walker)
    # instead of the reference's full co-optimal enumeration.
    first_only: bool = False
    # Walk route of the first-path, modes and long-pair tracebacks
    # (ops.traceback_device.use_device_walk): "auto" walks on the device
    # when the fill ran on the card (the walk kernels fetch 2-bit op codes
    # instead of the 0.5-1 byte/cell dirs tensor), "host" always fetches the
    # dirs and walks them on the host (the host walkers, the native
    # decoder), "device" walks on the fill's device whatever it is (the
    # plain walks on the CPU).  Alignments are bit-identical on every route.
    traceback: str = "auto"
    # Streamed fills' score state (ops.nw_affine_stream.
    # resolve_stream_state): "i32"; "i16" (two lanes a 32-bit word in the
    # CUDA kernels; the fill raises if the closed-form range certification
    # stream_i16_neg refuses the scheme x shape); or "auto" (i16 exactly
    # when certified).  Finals and alignments are bit-identical either way.
    stream_state: str = "i32"
    # Device mesh: (data,) axis sizes; None = all local devices on one axis.
    mesh_shape: tuple = ()
    # Debug guards: validate kernel results against closed-form score
    # bounds + sentinel-underflow checks (utils.guards); the SPMD analog of
    # the reference's Rust type-system safety net (SURVEY.md §5).
    debug: bool = False
    # torch.profiler trace directory (utils.profiling.trace); None = off.
    profile_dir: "str | None" = None


# Nucleotide encoding used across the framework: one-hot-in-4-bits so that
# "match" is a single AND (a & b != 0) and the reference's N-matches-anything
# rule (src/align.rs:298-304) falls out for free.  PAD=0 matches nothing.
ENCODE = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
DECODE = {1: "A", 2: "C", 4: "G", 8: "T", 15: "N", 0: "-"}
PAD = 0

# The reference's i16::MIN "minus infinity" sentinel
# (needleman_wunsch_affine.rs:174).  Kept exactly for bit-parity in compat
# mode; safe in i32 arithmetic (cannot underflow when a handful of gap
# penalties are added).
NEG_INF = -32768

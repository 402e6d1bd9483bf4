"""The port's --stream-state, --traceback and --profile flags (the JAX
CLI's last three) on the CPU: each reproduces the golden outputs of the
routes it reaches byte for byte, --serve takes them too, and --profile
writes a trace without touching stdout.  Plus the aligners' walk routes
(config.traceback) against the JAX aligners on every route they steer."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

from sequencealigning_tpu.models.banded import BandedAligner as JaxBanded
from sequencealigning_tpu.models.gotoh import GotohAligner as JaxGotoh
from sequencealigning_tpu.models.wfa import WfaAligner as JaxWfa
from sequencealigning_tpu_torch.cli import build_parser, main
from sequencealigning_tpu_torch.config import AlignConfig, Algo, Mode
from sequencealigning_tpu_torch.models import (
    BandedAligner,
    GotohAligner,
    WfaAligner,
)
from sequencealigning_tpu_torch.ops.traceback_device import use_device_walk
from tests.golden.regen import normalize
from tests.test_torch_golden_cli import CORPUS, HERE
from tests.test_torch_models import _jax, _modes_records, _records, _view

ROUTES = {
    "needleman-wunsch": ["-a", "needleman-wunsch"],
    "nw-first-only": ["-a", "needleman-wunsch", "--first-only"],
    "nw-local-textbook": ["-a", "needleman-wunsch", "-m", "local",
                          "--textbook"],
    "nw-semiglobal-textbook": ["-a", "needleman-wunsch", "-m",
                               "semi-global", "--textbook"],
    "banded": ["-a", "banded"],
    "wfa-textbook": ["-a", "wfa", "--textbook"],
}


def _run(args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


def _golden(name, args):
    rc, out, err = _run(CORPUS + ["--no-out", "--device", "cpu"] + args)
    got = (f"# exit={rc}\n# --- stdout ---\n{normalize(out)}"
           f"# --- stderr ---\n{normalize(err)}")
    with open(os.path.join(HERE, f"{name}.out")) as f:
        assert got == f.read()
    return out


@pytest.mark.parametrize("flags", [
    ["--stream-state", "auto"], ["--traceback", "host"],
    ["--traceback", "device"], ["--traceback", "auto"],
    ["--stream-state", "i16", "--traceback", "host"],
])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_flags_reproduce_golden(name, flags):
    """Every walk route and score state gives the golden bytes."""
    _golden(name, ROUTES[name] + flags)


def test_flags_reach_the_config():
    """The flags' defaults are the JAX CLI's, and main() hands them to
    AlignConfig (the aligner's config carries them)."""
    args = build_parser().parse_args(["-q", "q.fa", "-d", "d.fa"])
    assert (args.stream_state, args.traceback, args.profile) == \
        ("i32", "auto", None)
    seen = {}
    import sequencealigning_tpu_torch.cli as cli

    real = cli.get_aligner

    def spy(config, device):
        seen["config"] = config
        return real(config, device)

    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "get_aligner", spy)
    try:
        _run(CORPUS + ["--no-out", "--device", "cpu", "-a",
                       "needleman-wunsch", "--stream-state", "i16",
                       "--traceback", "host", "--profile", ""])
    finally:
        mp.undo()
    c = seen["config"]
    assert (c.stream_state, c.traceback, c.profile_dir) == ("i16", "host", "")


def test_profile_writes_a_trace_and_keeps_stdout(tmp_path):
    """--profile DIR writes a Chrome trace of the run into DIR; stdout is
    the golden output byte for byte, the trace's path goes to stderr."""
    d = tmp_path / "prof"
    rc, out, err = _run(CORPUS + ["--no-out", "--device", "cpu", "-a",
                                  "needleman-wunsch", "--first-only",
                                  "--profile", str(d)])
    assert rc == 0
    with open(os.path.join(HERE, "nw-first-only.out")) as f:
        golden = f.read()
    want = golden.split("# --- stdout ---\n")[1].split("# --- stderr ---")[0]
    assert normalize(out) == want
    traces = list(d.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert f"[profile] trace written to {traces[0]}" in err


def test_serve_takes_the_flags(monkeypatch, tmp_path):
    """--serve with --stream-state i16 --traceback host --profile DIR
    answers the corpus as the golden first-only output, and writes a
    trace."""
    q, d = CORPUS[1], CORPUS[3]
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{q} {d}\n"))
    prof = tmp_path / "p"
    rc, out, _ = _run(["--serve", "-a", "needleman-wunsch", "--first-only",
                       "--device", "cpu", "--stream-state", "i16",
                       "--traceback", "host", "--profile", str(prof)])
    assert rc == 0
    lines = [json.loads(s) for s in out.splitlines()]
    pairs = [x for x in lines if "query_name" in x]
    assert len(pairs) == 24 and all(p["error"] is None for p in pairs)
    with open(os.path.join(HERE, "nw-first-only.out")) as f:
        golden = f.read()
    for p in pairs:
        assert f"seq1: {p['aligned_query']}\n" in golden
    assert len(list(prof.glob("trace_*.json"))) == 1


def test_use_device_walk_routes():
    """"device" and "host" force; "auto" is the device walk where the
    aligner's device or the dirs tensor is on the card; others raise."""
    import torch

    for route, dev, want in (("device", "cpu", True), ("host", "cuda", False),
                             ("auto", "cpu", False), ("auto", "cuda", True)):
        cfg = AlignConfig(traceback=route)
        assert use_device_walk(cfg, torch.device(dev)) is want

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    dirs = torch.zeros(1).as_subclass(OnCard)
    assert use_device_walk(AlignConfig(), torch.device("cpu"), dirs)
    with pytest.raises(ValueError, match="traceback"):
        use_device_walk(AlignConfig(traceback="tpu"), torch.device("cpu"))


def _routes_equal(cls, jax_cls, config, recs, monkeypatch=None):
    got = {}
    for route in ("auto", "device", "host"):
        cfg = dataclasses.replace(config, traceback=route)
        aligner = cls(cfg, "cpu")
        got[route] = _view(aligner.align_batch(recs))
        assert getattr(aligner, "host_fallbacks", 0) == 0
    want = _view(jax_cls(_jax(config)).align_batch(recs))
    assert got["auto"] == got["device"] == got["host"] == want


@pytest.mark.parametrize("compat", [True, False])
def test_global_first_only_routes(compat):
    _routes_equal(GotohAligner, JaxGotoh,
                  AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True,
                              compat=compat), _records(61 + compat, n=12))


@pytest.mark.parametrize("n", [8, 40])  # per-pair / streamed modes fill
@pytest.mark.parametrize("mode", [Mode.LOCAL, Mode.SEMI_GLOBAL])
def test_modes_routes(mode, n):
    _routes_equal(GotohAligner, JaxGotoh,
                  AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, mode=mode,
                              compat=False, stream_state="auto"),
                  _modes_records(71 + n, n))


def test_banded_routes():
    _routes_equal(BandedAligner, JaxBanded,
                  AlignConfig(algo=Algo.BANDED, first_only=True, band=32),
                  _records(81, n=10))


def test_long_pair_routes(monkeypatch):
    """The long-pair path's banded walks (long_pair_lanes lowered so that
    pairs of up to 120 bp take it)."""
    for cls in (GotohAligner, JaxGotoh):
        monkeypatch.setattr(cls, "long_pair_lanes", 64)
    _routes_equal(GotohAligner, JaxGotoh,
                  AlignConfig(algo=Algo.NEEDLEMAN_WUNSCH, first_only=True),
                  _records(91, n=5, hi=120))


def test_wfa_banded_engine_routes():
    """The WFA banded engine's certified walks."""
    rng = np.random.default_rng(3)
    from sequencealigning_tpu_torch.io.fasta import Record

    recs = []
    for i in range(6):
        s1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), 80)
        s2 = s1.copy()
        s2[rng.integers(80, size=3)] = ord("A")
        recs.append((Record(seq=s1.tobytes(), name=b">q%d" % i),
                     Record(seq=np.delete(s2, 40).tobytes(),
                            name=b">d%d" % i)))
    _routes_equal(WfaAligner, JaxWfa,
                  AlignConfig(algo=Algo.WFA, compat=False,
                              wfa_engine="banded", band=16), recs)

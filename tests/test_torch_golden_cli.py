"""The PyTorch port's CLI on the CPU must byte-match the golden fixtures
of the JAX CLI (timing lines normalized), and its serve mode must answer
requests as the JAX one does."""

import contextlib
import io
import json
import os

import pytest

from tests.golden.regen import normalize
from sequencealigning_tpu_torch.cli import main

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CORPUS = ["-q", os.path.join(HERE, "queries.fa"),
          "-d", os.path.join(HERE, "db.fa")]


def _run(args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("name,args", [
    ("needleman-wunsch", ["-a", "needleman-wunsch"]),
    ("nw-first-only", ["-a", "needleman-wunsch", "--first-only"]),
    ("nw-local-compat", ["-a", "needleman-wunsch", "-m", "local"]),
    ("nw-local-textbook",
     ["-a", "needleman-wunsch", "-m", "local", "--textbook"]),
    ("nw-semiglobal-textbook",
     ["-a", "needleman-wunsch", "-m", "semi-global", "--textbook"]),
    ("banded", ["-a", "banded"]),
    ("a-star", []),
    ("nw-linear", ["-a", "nw-linear"]),
    ("nw-linear-local", ["-a", "nw-linear", "-m", "local"]),
])
def test_port_cli_matches_golden(name, args):
    rc, out, err = _run(CORPUS + ["--no-out", "--device", "cpu"] + args)
    got = (f"# exit={rc}\n# --- stdout ---\n{normalize(out)}"
           f"# --- stderr ---\n{normalize(err)}")
    with open(os.path.join(HERE, f"{name}.out")) as f:
        assert got == f.read()


def test_port_serve_answers_requests(monkeypatch):
    q, d = CORPUS[1], CORPUS[3]
    monkeypatch.setattr(
        "sys.stdin", io.StringIO(f"# comment\n{q} {d}\nbad line here\n")
    )
    rc, out, _ = _run(["--serve", "-a", "needleman-wunsch", "--first-only",
                       "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(s) for s in out.splitlines()]
    pairs = [x for x in lines if "query_name" in x]
    assert len(pairs) == 24 and all(p["error"] is None for p in pairs)
    assert lines[24]["done"] and lines[24]["pairs"] == 24
    assert "error" in lines[25]


def test_port_serve_textbook_local(monkeypatch):
    """--serve -m local --textbook answers the corpus with the same scores
    and alignments as the one-shot CLI's golden output."""
    q, d = CORPUS[1], CORPUS[3]
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{q} {d}\n"))
    rc, out, _ = _run(["--serve", "-a", "needleman-wunsch", "-m", "local",
                       "--textbook", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(s) for s in out.splitlines()]
    pairs = [x for x in lines if "query_name" in x]
    assert len(pairs) == 24 and all(p["error"] is None for p in pairs)
    assert all(p["mode"] == "local" for p in pairs)
    with open(os.path.join(HERE, "nw-local-textbook.out")) as f:
        golden = f.read()
    for p in pairs:
        assert f"seq1: {p['aligned_query']}\n" in golden
    assert lines[24]["done"] and lines[24]["pairs"] == 24


def test_port_cli_default_algo_is_a_star():
    """No -a runs a-star, the reference binary's default: the same output
    as -a a-star (tests/golden/a-star.out)."""
    base = CORPUS + ["--no-out", "--device", "cpu"]
    assert _run(base) == _run(base + ["-a", "a-star"])


def test_port_cli_unported_algo_exits_2():
    rc, out, err = _run(CORPUS + ["--no-out", "--device", "cpu", "-a", "wfa"])
    assert rc == 2 and out == "" and "not ported yet" in err


def test_port_cli_banded_band_flag(monkeypatch):
    """--band is accepted and reaches the aligner's config; the corpus pairs
    are short, so a band of 64 prints the golden banded output."""
    import sequencealigning_tpu_torch.cli as cli_mod

    seen = []
    real = cli_mod.get_aligner

    def spy(config, device):
        seen.append(config.band)
        return real(config, device)

    monkeypatch.setattr(cli_mod, "get_aligner", spy)
    with open(os.path.join(HERE, "banded.out")) as f:
        golden = f.read()
    rc, out, err = _run(CORPUS + ["--no-out", "--device", "cpu", "-a",
                                  "banded", "--band", "64"])
    assert (f"# exit={rc}\n# --- stdout ---\n{normalize(out)}"
            f"# --- stderr ---\n{normalize(err)}") == golden
    _run(CORPUS + ["--no-out", "--device", "cpu", "-a", "banded"])
    assert seen == [64, 128]


def test_port_serve_banded(monkeypatch):
    """--serve -a banded answers the corpus with the golden alignments."""
    q, d = CORPUS[1], CORPUS[3]
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{q} {d}\n"))
    rc, out, _ = _run(["--serve", "-a", "banded", "--band", "32",
                       "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(s) for s in out.splitlines()]
    pairs = [x for x in lines if "query_name" in x]
    assert len(pairs) == 24 and all(p["error"] is None for p in pairs)
    with open(os.path.join(HERE, "banded.out")) as f:
        golden = f.read()
    for p in pairs:
        assert f"seq1: {p['aligned_query']}\n" in golden
    assert lines[24]["done"] and lines[24]["pairs"] == 24

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
    ("wfa", ["-a", "wfa"]),
    ("wfa-textbook", ["-a", "wfa", "--textbook"]),
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
    """The JAX CLI's last flags are ported: --stream-state i16 reproduces
    the golden outputs byte for byte (the streamed global fill, co-optimal
    and first-only, with int16 state); an unknown state still exits 2 with
    nothing on stdout."""
    for name, args in (("needleman-wunsch", ["-a", "needleman-wunsch"]),
                       ("nw-first-only",
                        ["-a", "needleman-wunsch", "--first-only"])):
        rc, out, err = _run(CORPUS + ["--no-out", "--device", "cpu",
                                      "--stream-state", "i16"] + args)
        got = (f"# exit={rc}\n# --- stdout ---\n{normalize(out)}"
               f"# --- stderr ---\n{normalize(err)}")
        with open(os.path.join(HERE, f"{name}.out")) as f:
            assert got == f.read(), name
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        with pytest.raises(SystemExit) as e:
            main(CORPUS + ["--no-out", "--device", "cpu", "-a", "wfa",
                           "--stream-state", "i8"])
    assert e.value.code == 2 and out.getvalue() == ""
    assert "--stream-state" in err.getvalue()


@pytest.mark.parametrize("args", [
    ["--textbook", "--wfa-engine", "wavefront"],
    ["--textbook", "--wfa-engine", "native"],
])
def test_port_cli_wfa_engines_print_the_textbook_golden(args):
    """The wavefront and native engines print wfa-textbook.out too (the
    auto route's native leg answers the corpus; the wavefront engine's
    walk has the same tie order)."""
    rc, out, err = _run(CORPUS + ["--no-out", "--device", "cpu", "-a", "wfa"]
                        + args)
    with open(os.path.join(HERE, "wfa-textbook.out")) as f:
        assert (f"# exit={rc}\n# --- stdout ---\n{normalize(out)}"
                f"# --- stderr ---\n{normalize(err)}") == f.read()


def test_port_cli_wfa_spans_and_penalties_reach_the_aligner(monkeypatch):
    """--wfa-spans (one or four integers), --wfa-engine and the WFA
    penalties reach the aligner's config; a malformed spans value exits."""
    import sequencealigning_tpu_torch.cli as cli_mod

    seen = []
    real = cli_mod.get_aligner

    def spy(config, device):
        seen.append((config.wfa_spans, config.wfa_engine,
                     (config.wfa_penalties.mismatch,
                      config.wfa_penalties.gap_open,
                      config.wfa_penalties.gap_extend)))
        return real(config, device)

    monkeypatch.setattr(cli_mod, "get_aligner", spy)
    base = CORPUS + ["--no-out", "--device", "cpu", "-a", "wfa",
                     "--textbook", "-m", "semi-global"]
    rc, out, _ = _run(base + ["--wfa-spans", "5"])
    assert rc == 0 and out.count("converged with score") == 24
    rc, _, _ = _run(base + ["--wfa-spans", "3,0,0,7", "--wfa-engine",
                            "wavefront", "--wfa-mismatch", "9",
                            "--wfa-gap-open", "1", "--wfa-gap-extend", "2"])
    assert rc == 0
    assert seen == [((5, 5, 5, 5), "auto", (4, 2, 6)),
                    ((3, 0, 0, 7), "wavefront", (9, 1, 2))]
    for bad in ("1,2", "-1", "a"):
        with pytest.raises(SystemExit, match="--wfa-spans"):
            _run(base + ["--wfa-spans", bad])


def test_port_serve_wfa(monkeypatch):
    """--serve -a wfa answers the corpus as the one-shot CLI: the golden
    scores and alignments, compat and textbook."""
    q, d = CORPUS[1], CORPUS[3]
    for name, extra in (("wfa", []), ("wfa-textbook", ["--textbook"])):
        monkeypatch.setattr("sys.stdin", io.StringIO(f"{q} {d}\n"))
        rc, out, _ = _run(["--serve", "-a", "wfa", "--device", "cpu"]
                          + extra)
        assert rc == 0
        lines = [json.loads(s) for s in out.splitlines()]
        pairs = [x for x in lines if "query_name" in x]
        assert len(pairs) == 24 and lines[24]["done"]
        with open(os.path.join(HERE, f"{name}.out")) as f:
            golden = f.read()
        ok = [p for p in pairs if p["error"] is None]
        assert lines[24]["errors"] == 24 - len(ok)
        for p in ok:
            assert (f"converged with score {p['score']}: \n"
                    f"{p['aligned_query']}\n") in golden
        assert golden.count("converged with score") == len(ok)


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

"""The PyTorch port never imports JAX nor the JAX package (not even its
host modules, which load no JAX), and asks for devices explicitly."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sequencealigning_tpu_torch")
# An import of the JAX package or any of its submodules.
_JAX_PKG_IMPORT = re.compile(
    r"^\s*(from\s+sequencealigning_tpu(\.\S+)?\s+import|"
    r"import\s+sequencealigning_tpu(\.|\s|$|,))", re.M)


def _modules():
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    return sorted(m for m in mods if not m.endswith("__main__"))


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tests", "torch_seqpar_mp_worker.py")


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter, importing every module of the port and
    chip_smoke (as a module) leaves no jax, jax.*, sequencealigning_tpu or
    sequencealigning_tpu.* in sys.modules."""
    mods = _modules()
    for m in ("cli", "config", "errors", "io.encode", "io.fasta", "native",
              "ops.nw_affine", "ops.nw_affine_modes", "ops.nw_banded_diag",
              "ops.nw_affine_tiled", "ops.mm_align",
              "ops.nw_affine_stream_modes", "ops.traceback",
              "ops.traceback_device", "ops.oracle_gotoh", "models.banded",
              "ops.nw_banded", "ops.nw_linear", "ops.oracle_linear",
              "ops.oracle_astar", "ops.step_graph", "models.linear",
              "models.astar", "ops.wfa", "ops.oracle_wfa", "models.wfa",
              "parallel", "parallel.mesh", "parallel.runner",
              "parallel.streaming", "parallel.relay", "parallel.seqpar",
              "utils.cigar", "utils.guards", "utils.pprint", "utils.stats",
              "utils.timing", "soak", "dryrun"):
        assert f"sequencealigning_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "print(sorted(k for k in sys.modules if k in ('jax', "
        "'sequencealigning_tpu') or k.startswith(('jax.', "
        "'sequencealigning_tpu.'))))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_no_port_source_imports_jax():
    """No source of the port, nor chip_smoke.py, nor the seqpar test
    worker, imports jax or the JAX package (any submodule, at any
    indentation)."""
    for path in _sources():
        with open(path) as fh:
            src = fh.read()
        assert "import jax" not in src, path
        assert "from jax" not in src, path
        assert not _JAX_PKG_IMPORT.search(src), (
            path, _JAX_PKG_IMPORT.search(src).group(0))


def test_jax_package_import_pattern():
    for line in ("from sequencealigning_tpu.config import X",
                 "    from sequencealigning_tpu import native",
                 "import sequencealigning_tpu.ops.traceback as tb",
                 "import sequencealigning_tpu"):
        assert _JAX_PKG_IMPORT.search(line), line
    for line in ("from sequencealigning_tpu_torch.config import X",
                 "import sequencealigning_tpu_torch",
                 "# the port of sequencealigning_tpu.ops"):
        assert not _JAX_PKG_IMPORT.search(line), line


def test_cuda_device_is_never_replaced_by_cpu():
    from sequencealigning_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_runner_devices_are_never_replaced_by_cpu():
    """The runner's default devices are every CUDA device; with none it
    raises instead of running on the CPU.  The CPU is named explicitly."""
    from sequencealigning_tpu_torch.parallel import make_mesh

    assert make_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh(["meta"])

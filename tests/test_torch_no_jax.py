"""The PyTorch port never imports JAX, and asks for devices explicitly."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sequencealigning_tpu_torch")


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


def test_importing_every_port_module_loads_no_jax():
    mods = _modules()
    for m in ("cli", "ops.nw_affine", "ops.nw_affine_modes",
              "ops.nw_affine_stream_modes", "ops.traceback_device"):
        assert f"sequencealigning_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.')))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_no_port_source_imports_jax():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                assert "import jax" not in src, f
                assert "from jax" not in src, f


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

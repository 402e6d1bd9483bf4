"""The port's public API against the JAX package's, name for name.

The JAX sources are read with ``ast`` (no JAX is imported).  For every
module of sequencealigning_tpu, each public def, class and constant defined
there, and each entry of its ``__all__``, must exist in the port's module at
the same relative path, unless the exemptions below name it with the port's
counterpart.  For every public function the two share, a call that the JAX
signature accepts must either bind the same values to the same parameter
names in the port or raise TypeError: never bind silently to another
parameter.  Names a JAX module only imports are not its API (except through
``__all__``).
"""

import ast
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "sequencealigning_tpu")
PORT = "sequencealigning_tpu_torch"

# JAX-only names by design: (module, name) -> (reason, the port's
# counterpart as (module, name), or None where there is none).
NAME_EXEMPT = {
    ("ops/nw_affine.py", "gotoh_fill_pallas"):
        ("the Pallas kernel's entry point",
         ("ops/nw_affine.py", "gotoh_fill_cuda")),
    ("ops/nw_affine_modes.py", "modes_fill_pallas"):
        ("the Pallas kernel's entry point",
         ("ops/nw_affine_modes.py", "modes_fill_cuda")),
    ("ops/nw_affine_stream.py", "gotoh_fill_stream_pallas"):
        ("the Pallas kernel's entry point",
         ("ops/nw_affine_stream.py", "gotoh_fill_stream_cuda")),
    ("ops/nw_affine_stream.py", "gotoh_fill_stream_lax"):
        ("the lax twin of the Pallas kernel",
         ("ops/nw_affine_stream.py", "gotoh_fill_stream_torch")),
    ("ops/nw_affine_stream.py", "stream_i16_supported"):
        ("a Mosaic capability probe",
         ("ops/nw_affine_stream.py", "stream_i16_neg")),
    ("ops/nw_affine_stream.py", "stream_finals"):
        ("assembles the TPU's parity-packed lane blocks",
         ("ops/nw_affine_stream.py", "gotoh_fill_stream")),
    ("ops/nw_affine_stream_modes.py", "gotoh_fill_stream_modes_pallas"):
        ("the Pallas kernel's entry point",
         ("ops/nw_affine_stream_modes.py", "gotoh_fill_stream_modes_cuda")),
    ("ops/nw_affine_stream_modes.py", "gotoh_fill_stream_modes_lax"):
        ("the lax twin of the Pallas kernel",
         ("ops/nw_affine_stream_modes.py", "gotoh_fill_stream_modes_torch")),
    ("ops/nw_affine_stream_modes.py", "stream_modes_lanes"):
        ("assembles the TPU's parity-packed lane blocks",
         ("ops/nw_affine_stream_modes.py", "gotoh_fill_stream_modes")),
    ("ops/nw_banded.py", "banded_fill_pallas"):
        ("the Pallas kernel's entry point",
         ("ops/nw_banded.py", "banded_row_fill_cuda")),
    ("ops/nw_banded_diag.py", "banded_diag_fill_pallas"):
        ("the Pallas kernel's entry point",
         ("ops/nw_banded_diag.py", "banded_diag_fill_cuda")),
    ("ops/traceback_device.py", "RLE_CAP"):
        ("the RLE drain: the port's walks emit 2-bit op codes", None),
    ("ops/traceback_device.py", "rle_pack_ops"):
        ("the RLE drain: the port's walks emit 2-bit op codes", None),
    ("ops/traceback_device.py", "rle_expand_packed"):
        ("the RLE drain: the port's walks emit 2-bit op codes", None),
}
# JAX-only modules: module -> (reason, the port's counterpart).
MODULE_EXEMPT = {
    "utils/compilecache.py":
        ("XLA's compilation cache; the kernels' build cache stands in",
         ("csrc/__init__.py", "BUILD_DIR")),
}
# JAX signatures the port does not follow: (module, name) -> (reason, the
# port's counterpart).
SIGNATURE_EXEMPT = {
    ("parallel/mesh.py", "make_mesh"):
        ("a port mesh is a device list, not a jax.sharding.Mesh shape",
         ("parallel/mesh.py", "make_mesh")),
}
EXEMPT = (
    [("name",) + k for k in NAME_EXEMPT]
    + [("module", m, None) for m in MODULE_EXEMPT]
    + [("signature",) + k for k in SIGNATURE_EXEMPT]
)


def _jax_modules():
    out = []
    for root, _dirs, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_ROOT)
                           .replace(os.sep, "/"))
    return sorted(out)


_TREES = {}


def _tree(rel):
    if rel not in _TREES:
        with open(os.path.join(JAX_ROOT, rel)) as fh:
            _TREES[rel] = ast.parse(fh.read())
    return _TREES[rel]


def _bound_names(targets):
    """The names an assignment binds (not those inside a subscript)."""
    for t in targets:
        if isinstance(t, ast.Name):
            yield t.id
        elif isinstance(t, (ast.Tuple, ast.List)):
            yield from _bound_names(t.elts)
        elif isinstance(t, ast.Starred):
            yield from _bound_names([t.value])


def _public(rel):
    """The module's public API: its top-level defs, classes and assigned
    names that do not start with "_", and the entries of its __all__."""
    names = set()
    for node in _tree(rel).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            for n in _bound_names(targets):
                if n == "__all__":
                    names.update(ast.literal_eval(node.value))
                else:
                    names.add(n)
    return sorted(n for n in names
                  if not n.startswith("_") or n == "__version__")


def _functions():
    return [(rel, node.name) for rel in _jax_modules()
            for node in _tree(rel).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not node.name.startswith("_")]


def _port_module(rel):
    mod = rel[: -len(".py")].replace("/", ".")
    if mod == "__init__":
        return importlib.import_module(PORT)
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return importlib.import_module(f"{PORT}.{mod}")


def _port_has_module(rel):
    path = os.path.join(REPO, PORT, rel)
    return os.path.exists(path)


def _jax_node(rel, name):
    for node in _tree(rel).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name == name:
            return node
    raise KeyError(name)


def _jax_params(node):
    """(positional params [(name, default source)], keyword-only names,
    has *args, has **kwargs) of a JAX def."""
    a = node.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    return ([(p.arg, d) for p, d in zip(pos, defaults)],
            [(p.arg, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)],
            a.vararg is not None, a.kwarg is not None)


def _binding_faults(rel, name):
    """Where a call the JAX signature accepts would bind differently in the
    port without a TypeError, or where a shared parameter's default
    differs; [] when the port follows the rule."""
    jpos, jkw, j_var, _j_varkw = _jax_params(_jax_node(rel, name))
    fn = getattr(_port_module(rel), name)
    params = list(inspect.signature(fn).parameters.values())
    kinds = inspect.Parameter
    ppos = [p for p in params
            if p.kind in (kinds.POSITIONAL_ONLY, kinds.POSITIONAL_OR_KEYWORD)]
    p_var = any(p.kind == kinds.VAR_POSITIONAL for p in params)
    p_varkw = any(p.kind == kinds.VAR_KEYWORD for p in params)
    by_name = {p.name: p for p in params
               if p.kind not in (kinds.VAR_POSITIONAL, kinds.VAR_KEYWORD)}
    faults = []
    for i, (jname, _d) in enumerate(jpos):
        if i < len(ppos):
            if ppos[i].name != jname:
                faults.append(f"positional {i}: JAX {jname!r}, port "
                              f"{ppos[i].name!r}")
        elif p_var and not j_var:
            faults.append(f"positional {i} ({jname!r}) lands in the port's "
                          "*args")
    for jname, jdefault in jpos + jkw:
        p = by_name.get(jname)
        if p is None:
            if p_varkw:
                faults.append(f"{jname!r} lands in the port's **kwargs")
            continue
        if jdefault is None:
            continue
        if p.default is inspect.Parameter.empty:
            faults.append(f"{jname!r} has a default in JAX, none in the "
                          "port")
            continue
        try:
            want = ast.literal_eval(jdefault)
        except ValueError:  # a call or a JAX object: compared by value
            continue       # in the equality tests
        if p.default != want or type(p.default) is not type(want):
            faults.append(f"{jname!r} defaults to {p.default!r}, JAX "
                          f"{want!r}")
    return faults


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_names_exist_in_the_port(rel):
    """Each public name of the JAX module exists in the port's module at
    the same relative path, or is exempt with a counterpart."""
    if rel in MODULE_EXEMPT:
        assert not _port_has_module(rel), f"stale module exemption {rel}"
        return
    assert _port_has_module(rel), f"the port has no {rel}"
    port = _port_module(rel)
    missing = [n for n in _public(rel)
               if not hasattr(port, n) and (rel, n) not in NAME_EXEMPT]
    assert not missing, f"{rel}: the port lacks {missing}"


@pytest.mark.parametrize(
    "rel,name", [f for f in _functions()
                 if f not in NAME_EXEMPT and f not in SIGNATURE_EXEMPT
                 and f[0] not in MODULE_EXEMPT],
    ids=lambda v: v)
def test_shared_function_binds_like_jax(rel, name):
    """A call the JAX signature accepts binds the same values to the same
    names in the port, or raises TypeError; shared parameters keep JAX's
    literal defaults."""
    assert not _binding_faults(rel, name), _binding_faults(rel, name)


@pytest.mark.parametrize("entry", EXEMPT, ids=lambda e: "::".join(
    x for x in e if x))
def test_exemption_is_live_and_has_its_counterpart(entry):
    """Each exemption still applies (the port does not have the name, the
    module, or the JAX signature) and its counterpart exists in the
    port."""
    kind, rel, name = entry
    if kind == "name":
        assert name in _public(rel), f"{rel} no longer defines {name}"
        assert not hasattr(_port_module(rel), name), \
            f"stale exemption: the port now has {rel}::{name}"
        _reason, counterpart = NAME_EXEMPT[(rel, name)]
    elif kind == "module":
        assert os.path.exists(os.path.join(JAX_ROOT, rel))
        assert not _port_has_module(rel), f"stale exemption: the port has {rel}"
        _reason, counterpart = MODULE_EXEMPT[rel]
    else:
        assert _binding_faults(rel, name), \
            f"stale exemption: {rel}::{name} now binds like JAX"
        _reason, counterpart = SIGNATURE_EXEMPT[(rel, name)]
    if counterpart is not None:
        c_rel, c_name = counterpart
        assert hasattr(_port_module(c_rel), c_name), counterpart


def test_exemptions_are_the_tpu_only_names():
    """The exemptions are the TPU-only names and no other: the Pallas and
    lax entry points, the Mosaic probe, the parity-block assemblers, the
    RLE drain, the XLA compilation cache and the mesh's signature."""
    assert len(NAME_EXEMPT) == 14
    assert sorted(n for _r, n in NAME_EXEMPT) == sorted([
        "gotoh_fill_pallas", "modes_fill_pallas", "gotoh_fill_stream_pallas",
        "gotoh_fill_stream_lax", "stream_i16_supported", "stream_finals",
        "gotoh_fill_stream_modes_pallas", "gotoh_fill_stream_modes_lax",
        "stream_modes_lanes", "banded_fill_pallas", "banded_diag_fill_pallas",
        "RLE_CAP", "rle_pack_ops", "rle_expand_packed"])
    assert list(MODULE_EXEMPT) == ["utils/compilecache.py"]
    assert list(SIGNATURE_EXEMPT) == [("parallel/mesh.py", "make_mesh")]


def test_the_rule_catches_a_shifted_parameter(monkeypatch):
    """The binding rule flags a port function whose parameter moved into a
    dropped JAX parameter's position, and passes it once keyword-only."""
    from sequencealigning_tpu_torch.ops import traceback_device

    def shifted(dirs, finals, seqs1, seqs2, k_lo_even, pair_idx=None,
                std=False):
        return None

    def keyword_only(dirs, finals, seqs1, seqs2, k_lo_even, *,
                     pair_idx=None, std=False):
        return None

    rel, name = "ops/traceback_device.py", "banded_diag_align_device"
    monkeypatch.setattr(traceback_device, name, shifted)
    assert _binding_faults(rel, name) == [
        "positional 5: JAX 'unroll', port 'pair_idx'",
        "positional 6: JAX 'pair_idx', port 'std'"]
    monkeypatch.setattr(traceback_device, name, keyword_only)
    assert _binding_faults(rel, name) == []

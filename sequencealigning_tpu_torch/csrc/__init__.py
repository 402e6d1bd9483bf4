"""Build-at-first-use loader for the port's CUDA kernels.

The kernels (``*.cu`` here, with their per-cell arithmetic in ``*.cuh``)
have a plain C interface.  On first use they are compiled with ``nvcc``, one
process a source started together, and linked into one shared library
under ``build/sequencealigning_tpu_torch/`` at the repository root, rebuilt
whenever a source is newer than the library, and loaded with ``ctypes``.
``host_check()`` builds ``host_check.cpp`` -- the kernels' loops run
serially through the same ``*.cuh`` functions -- with the host C++
compiler, so the arithmetic can be tested without a GPU.

Nothing is compiled when this module is imported.  A build that fails
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "sequencealigning_tpu_torch"
)
_CUDA_SOURCES = ("nw_affine.cu", "nw_affine_stream.cu",
                 "nw_affine_stream_i16.cu", "nw_affine_modes.cu",
                 "nw_banded_diag.cu", "nw_affine_tiled.cu", "nw_banded.cu",
                 "nw_banded_warp.cu", "nw_linear.cu", "traceback_device.cu",
                 "wfa.cu", "mm_rows.cu")
_HEADERS = ("nw_affine_stream.cuh", "pair_sweep.cuh", "cluster_split.cuh",
            "stream_ring.cuh", "stream_ring_kernel.cuh", "stream_cell16.cuh",
            "nw_banded_diag.cuh", "nw_affine_tiled.cuh", "nw_banded.cuh",
            "nw_linear.cuh", "traceback_device.cuh", "wfa.cuh", "mm_rows.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17")
NVCC_FLAGS = ARCH_FLAGS + (
    "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_VP = ctypes.c_void_p
_INT = ctypes.c_int

_kernels: Optional[ctypes.CDLL] = None
_host: Optional[ctypes.CDLL] = None
# Seconds the last kernel build took (0.0 when the library was up to date)
# and the compiler's output (register and spill counts from -Xptxas -v).
build_seconds = 0.0
build_log = ""


def _paths(names: Sequence[str]):
    return [os.path.join(_HERE, n) for n in names]


def stale(lib: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(lib):
        return True
    t = os.path.getmtime(lib)
    return any(os.path.getmtime(s) > t for s in sources)


def compile_library(cmd_head: Sequence[str], sources: Sequence[str],
                    lib: str) -> str:
    """Compile into a temporary file beside ``lib`` and rename it into
    place, so concurrent builds never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [*cmd_head, "-o", tmp, *sources],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(lib)} failed "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``.  Raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_kernels(srcs: Sequence[str], lib: str) -> str:
    """One nvcc process a source, all started together, then one link into
    ``lib``.  Returns the compilers' output (register and spill counts from
    -Xptxas -v); raises if a step fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", o, s],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(srcs, objs)
        ]
        logs = []
        failed = []
        try:
            for s, p in zip(srcs, procs):
                out, _ = p.communicate(timeout=900)
                logs.append(out)
                if p.returncode != 0:
                    failed.append(
                        f"{os.path.basename(s)} (exit {p.returncode})")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError("building the CUDA kernels failed: "
                               + ", ".join(failed) + "\n" + "".join(logs))
        logs.append(compile_library([nvcc, *ARCH_FLAGS, "-shared"], objs, lib))
    return "".join(logs)


def kernels() -> ctypes.CDLL:
    """Load the CUDA kernel library, building it first if it is missing or
    older than a source."""
    global _kernels, build_seconds, build_log
    if _kernels is not None:
        return _kernels
    lib_path = os.path.join(BUILD_DIR, "libsa_kernels.so")
    srcs = _paths(_CUDA_SOURCES)
    if stale(lib_path, srcs + _paths(_HEADERS)):
        t0 = time.perf_counter()
        build_log = _build_kernels(srcs, lib_path)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    lib.sa_fill_ctas.restype = _INT
    lib.sa_fill_ctas.argtypes = [_INT, _INT]
    lib.sa_stream_plan.restype = _INT
    lib.sa_stream_plan.argtypes = [_INT] * 7 + [_VP]
    lib.sa_stream_fill.restype = _INT
    lib.sa_stream_fill.argtypes = [_VP] * 7 + [_INT] * 17 + [_VP]
    lib.sa_stream_modes_fill.restype = _INT
    lib.sa_stream_modes_fill.argtypes = [_VP] * 7 + [_INT] * 17 + [_VP]
    for name in ("sa_stream_fill_i16", "sa_stream_modes_fill_i16"):
        getattr(lib, name).restype = _INT
        getattr(lib, name).argtypes = [_VP] * 7 + [_INT] * 18 + [_VP]
    lib.sa_pair_plan.restype = _INT
    lib.sa_pair_plan.argtypes = [_INT] * 6 + [_VP]
    lib.sa_modes_fill.restype = _INT
    lib.sa_modes_fill.argtypes = [_VP] * 6 + [_INT] * 12 + [_VP] + [
        _INT] * 3 + [_VP]
    lib.sa_gotoh_fill.restype = _INT
    lib.sa_gotoh_fill.argtypes = [_VP] * 6 + [_INT] * 12 + [_VP] + [
        _INT] * 3 + [_VP]
    lib.sa_sm_count.restype = _INT
    lib.sa_sm_count.argtypes = []
    lib.sa_banded_resident_ctas.restype = _INT
    lib.sa_banded_resident_ctas.argtypes = [_INT] * 5
    lib.sa_banded_fill.restype = _INT
    lib.sa_banded_fill.argtypes = [_VP] * 10 + [_INT] * 20 + [_VP]
    lib.sa_banded_row_threads.restype = _INT
    lib.sa_banded_row_threads.argtypes = [_INT, _INT]
    lib.sa_banded_row_warp_lanes.restype = _INT
    lib.sa_banded_row_warp_lanes.argtypes = [_INT, _INT]
    lib.sa_banded_row_scratch_words.restype = ctypes.c_long
    lib.sa_banded_row_scratch_words.argtypes = [_INT]
    lib.sa_banded_row_fill.restype = _INT
    lib.sa_banded_row_fill.argtypes = [_VP] * 8 + [_INT] * 13 + [_VP]
    lib.sa_linear_fill.restype = _INT
    lib.sa_linear_fill.argtypes = [_VP] * 8 + [_INT] * 12 + [_VP] + [
        _INT] * 3 + [_VP]
    lib.sa_tiled_resident_ctas.restype = _INT
    lib.sa_tiled_resident_ctas.argtypes = [_INT] * 4
    lib.sa_tiled_fill.restype = _INT
    lib.sa_tiled_fill.argtypes = [_VP] * 8 + [_INT] * 15 + [_VP]
    lib.sa_tiled_fold_fill.restype = _INT
    lib.sa_tiled_fold_fill.argtypes = [_VP] * 8 + [_INT] * 15 + [_VP]
    lib.sa_tiled_shard_fill.restype = _INT
    lib.sa_tiled_shard_fill.argtypes = [_VP] * 9 + [_INT] * 16 + [_VP]
    lib.sa_enable_peer.restype = _INT
    lib.sa_enable_peer.argtypes = [_INT, _INT]
    lib.sa_walk_fast4.restype = _INT
    lib.sa_walk_fast4.argtypes = [_VP] + [_INT] * 3 + [_VP] * 5 + [
        _INT, _INT] + [_VP] * 6
    lib.sa_walk_modes.restype = _INT
    lib.sa_walk_modes.argtypes = [_VP] + [_INT] * 3 + [_VP] * 4 + [
        _INT] * 3 + [_VP] * 7
    lib.sa_walk_banded.restype = _INT
    lib.sa_walk_banded.argtypes = [_VP] + [_INT] * 3 + [_VP] * 4 + [
        _INT] * 4 + [_VP] * 4 + [_INT] + [_VP] * 2
    lib.sa_wfa_chunk.restype = _INT
    lib.sa_wfa_chunk.argtypes = [_VP] * 12 + [_INT] * 18 + [_VP]
    lib.sa_wfa_ring_in_shared.restype = _INT
    lib.sa_wfa_ring_in_shared.argtypes = [_INT] * 4
    lib.sa_wfa_walk.restype = _INT
    lib.sa_wfa_walk.argtypes = [_VP] + [_INT] * 5 + [_VP] * 5 + [
        _INT] * 5 + [_VP] * 3 + [_INT, _VP]
    lib.sa_mm_table_cols.restype = None
    lib.sa_mm_table_cols.argtypes = [_VP]
    lib.sa_mm_rows_plan.restype = _INT
    lib.sa_mm_rows_plan.argtypes = [_VP, _INT, _VP]
    lib.sa_mm_rows.restype = _INT
    lib.sa_mm_rows.argtypes = [_VP] * 5 + [_INT] * 3 + [_VP] * 3 + [
        _INT] * 4 + [_VP]
    _kernels = lib
    return lib


def kernel_resources(log: str, name: str) -> list:
    """Each entry function whose (mangled) name contains ``name`` in a
    build's -Xptxas -v output, in order: dicts of entry, registers,
    stack, spill_stores and spill_loads (bytes)."""
    out, entry, frame = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, frame = (m.group(1) if name in m.group(1) else None), None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = [int(g) for g in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stack, stores, loads = frame or (0, 0, 0)
            out.append(dict(entry=entry, registers=int(m.group(1)),
                            stack=stack, spill_stores=stores,
                            spill_loads=loads))
            entry = None
    return out


def stream_instances(log: str) -> list:
    """kernel_resources of the streamed fills' instances -- int32 state
    (nw_affine_stream.cu::stream_ring_kernel<LPT, DIRS, MODE, COMPAT,
    WILDCARD>) and int16 state (nw_affine_stream_i16.cu::
    stream_ring16_kernel, the same arguments) -- each with its state
    ("i32" or "i16") and template arguments decoded."""
    rows = []
    for name, state in (("stream_ring_kernel", "i32"),
                        ("stream_ring16_kernel", "i16")):
        for r in kernel_resources(log, name):
            m = re.search(name + r"ILi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELb([01])ELb([01])E", r["entry"])
            if m:
                lpt, dirs, mode, compat, wild = (int(g) for g in m.groups())
                r.update(state=state, lanes_per_thread=lpt,
                         dirs=("none", "fast4", "full")[dirs],
                         mode=("global", "semi", "local")[mode],
                         compat=bool(compat), wildcard=bool(wild))
                rows.append(r)
    return rows


def pair_instances(log: str) -> list:
    """kernel_resources of the per-pair fills' instances
    (pair_sweep.cuh::pair_sweep_kernel<Pol, LPT>), each with its cell
    policy -- GotohCells<DIRS, MODE, COMPAT, WILDCARD> (kernels #6 and #7)
    or LinearCells<DIRS, COMPAT, LOCAL> (the linear fill) -- its template
    arguments and its lanes a thread decoded."""
    rows = []
    for r in kernel_resources(log, "pair_sweep_kernel"):
        m = re.search(r"(GotohCells|LinearCells)I((?:L[ib]\d+E)+)E+Li(\d+)E",
                      r["entry"])
        if m:
            r.update(policy=m.group(1),
                     args=[int(v) for v in re.findall(r"L[ib](\d+)E",
                                                      m.group(2))],
                     lanes_per_thread=int(m.group(3)))
            rows.append(r)
    return rows


def launch_error(name: str, rc: int, nctas: int = 1) -> RuntimeError:
    """The error a wrapper raises for a kernel entry's non-zero return."""
    if rc == -3:
        return RuntimeError(f"{name}: the card cannot schedule a cluster of "
                            f"{nctas} CTAs")
    return RuntimeError(f"{name} launch failed (error {rc})")


def host_compiler() -> Optional[str]:
    """The host C++ compiler, or None."""
    for cxx in ("c++", "g++", "clang++"):
        path = shutil.which(cxx)
        if path:
            return path
    return None


def host_check() -> ctypes.CDLL:
    """Load the serial host build of the kernels' loops (host_check.cpp),
    building it with the host C++ compiler if needed."""
    global _host
    if _host is not None:
        return _host
    cxx = host_compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler for host_check.cpp")
    lib_path = os.path.join(BUILD_DIR, "libsa_host_check.so")
    srcs = _paths(("host_check.cpp",))
    if stale(lib_path, srcs + _paths(_HEADERS)):
        compile_library([cxx, *HOST_FLAGS], srcs, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.hc_fill_ctas.restype = _INT
    lib.hc_fill_ctas.argtypes = [_INT, _INT]
    lib.hc_stream_plan.restype = _INT
    lib.hc_stream_plan.argtypes = [_INT] * 7 + [_VP]
    lib.hc_stream_fill.restype = _INT
    lib.hc_stream_fill.argtypes = [_VP] * 7 + [_INT] * 17
    lib.hc_stream_modes_fill.restype = _INT
    lib.hc_stream_modes_fill.argtypes = [_VP] * 7 + [_INT] * 17
    for name in ("hc_stream_fill_i16", "hc_stream_modes_fill_i16"):
        getattr(lib, name).restype = _INT
        getattr(lib, name).argtypes = [_VP] * 7 + [_INT] * 18
    lib.hc_h2_dpx.restype = None
    lib.hc_h2_dpx.argtypes = [_VP] * 4 + [_INT]
    lib.hc_h2_codes.restype = None
    lib.hc_h2_codes.argtypes = [_VP] * 8 + [_INT]
    lib.hc_pair_plan.restype = _INT
    lib.hc_pair_plan.argtypes = [_INT] * 6 + [_VP]
    lib.hc_modes_fill.restype = _INT
    lib.hc_modes_fill.argtypes = [_VP] * 6 + [_INT] * 12 + [_VP] + [
        _INT] * 3
    lib.hc_gotoh_fill.restype = _INT
    lib.hc_gotoh_fill.argtypes = [_VP] * 6 + [_INT] * 12 + [_VP] + [
        _INT] * 3
    lib.hc_banded_fill.restype = _INT
    lib.hc_banded_fill.argtypes = [_VP] * 10 + [_INT] * 17
    lib.hc_banded_row_warp_lanes.restype = _INT
    lib.hc_banded_row_warp_lanes.argtypes = [_INT, _INT]
    lib.hc_banded_row_fill.restype = _INT
    lib.hc_banded_row_fill.argtypes = [_VP] * 7 + [_INT] * 13
    lib.hc_linear_fill.restype = _INT
    lib.hc_linear_fill.argtypes = [_VP] * 8 + [_INT] * 12 + [_VP] + [
        _INT] * 3
    lib.hc_tiled_fill.restype = _INT
    lib.hc_tiled_fill.argtypes = [_VP] * 8 + [_INT] * 14
    lib.hc_tiled_shard_fill.restype = _INT
    lib.hc_tiled_shard_fill.argtypes = [_VP] * 9 + [_INT] * 15
    lib.hc_tile_dpx.restype = None
    lib.hc_tile_dpx.argtypes = [_VP] * 4 + [_INT]
    lib.hc_walk_fast4.restype = _INT
    lib.hc_walk_fast4.argtypes = [_VP] + [_INT] * 3 + [_VP] * 5 + [
        _INT, _INT] + [_VP] * 5
    lib.hc_walk_modes.restype = _INT
    lib.hc_walk_modes.argtypes = [_VP] + [_INT] * 3 + [_VP] * 4 + [
        _INT] * 3 + [_VP] * 6
    lib.hc_walk_banded.restype = _INT
    lib.hc_walk_banded.argtypes = [_VP] + [_INT] * 3 + [_VP] * 4 + [
        _INT] * 4 + [_VP] * 4 + [_INT] + [_VP]
    lib.hc_wfa_chunk.restype = _INT
    lib.hc_wfa_chunk.argtypes = [_VP] * 12 + [_INT] * 19
    lib.hc_wfa_ring_in_shared.restype = _INT
    lib.hc_wfa_ring_in_shared.argtypes = [_INT] * 4
    lib.hc_wfa_walk.restype = _INT
    lib.hc_wfa_walk.argtypes = [_VP] + [_INT] * 5 + [_VP] * 5 + [
        _INT] * 5 + [_VP] * 3 + [_INT]
    lib.hc_mm_table_cols.restype = None
    lib.hc_mm_table_cols.argtypes = [_VP]
    lib.hc_mm_rows_plan.restype = _INT
    lib.hc_mm_rows_plan.argtypes = [_VP, _INT, _INT, _VP]
    lib.hc_mm_rows.restype = _INT
    lib.hc_mm_rows.argtypes = [_VP] * 5 + [_INT] * 3 + [_VP] * 3 + [_INT] * 4
    _host = lib
    return lib

"""Time the kernel library's build two ways on a machine with nvcc:

    python -m sequencealigning_tpu_torch.csrc.build_timing [--rounds N]

serial: one ``nvcc -shared`` command over every source (nvcc compiles them
one after another); parallel: ``_build_kernels``, one ``nvcc -c`` a source
started together, then one link.  The rounds alternate serial, parallel,
each into a fresh library beside the real one (which is not touched).
Prints one JSON object with the seconds of each build.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from sequencealigning_tpu_torch import csrc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    srcs = csrc._paths(csrc._CUDA_SOURCES)
    nvcc = csrc.nvcc_path()
    serial_cmd = [nvcc, *csrc.NVCC_FLAGS, "-shared"]
    serial_cmd.remove("-c")
    lib = os.path.join(csrc.BUILD_DIR, "libsa_kernels_timing.so")
    out = {"serial_s": [], "parallel_s": [], "sources": len(srcs)}
    try:
        for _ in range(args.rounds):
            for key in ("serial_s", "parallel_s"):
                t0 = time.perf_counter()
                if key == "serial_s":
                    csrc.compile_library(serial_cmd, srcs, lib)
                else:
                    csrc._build_kernels(srcs, lib)
                out[key].append(round(time.perf_counter() - t0, 2))
    finally:
        if os.path.exists(lib):
            os.unlink(lib)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

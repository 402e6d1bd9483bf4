"""One process of a two-process run of the port's data-parallel runner on
the CPU (driven by tests/test_torch_multiprocess.py): torch.distributed
with the Gloo backend (parallel.mesh.multihost_init), four CPU shards a
process, each process streaming its own half of the pairs.

Usage: python tests/torch_mp_worker.py <process_id> <num_processes> <port>
Prints "SCORES <json>" and "STREAM <json>" on process 0 and "CIGARS<p>
<json>" and "MODES<p> <json>" on every process p.
"""

import json
import os
import random
import sys


def _pairs():
    rng = random.Random(21)
    return [
        (bytes(rng.choice(b"ACGT") for _ in range(rng.randint(3, 24))),
         bytes(rng.choice(b"ACGT") for _ in range(rng.randint(3, 24))))
        for _ in range(32)
    ]


def _strings(results):
    out = []
    for t in results:
        assert isinstance(t, tuple), t
        out.append([t[0], t[1][0][0], t[1][0][1]])
    return out


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch.distributed as dist

    from sequencealigning_tpu_torch.io.encode import pack_batch
    from sequencealigning_tpu_torch.parallel import (
        DataParallelRunner,
        multihost_init,
        stream_align,
    )
    from sequencealigning_tpu_torch.parallel.runner import to_host

    multihost_init(f"localhost:{port}", num_processes=nproc, process_id=pid)
    multihost_init(f"localhost:{port}", num_processes=nproc, process_id=pid)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc
    pairs = _pairs()
    per = len(pairs) // nproc
    local = pairs[pid * per:(pid + 1) * per]  # this process's input shard
    runner = DataParallelRunner(["cpu"] * 4, np_slots=2,
                                traceback="device")
    assert runner.n_devices == 4 * nproc

    def extract(global_scores, n_per):
        # Pair j of process p lives at global row p * bp_local + j.
        bp_local = global_scores.shape[0] // nproc
        return np.concatenate([global_scores[p * bp_local:p * bp_local
                                             + n_per] for p in range(nproc)])

    scores = extract(to_host(runner.scores(pack_batch(local))), per)
    got = {}
    n = stream_align(local, runner=runner, batch_size=per // 2,
                     on_result=lambda i, s: got.__setitem__(i, s))
    assert n == per, n
    half = per // 2
    blocks = [extract(got[i], half) for i in sorted(got)]
    stream = np.concatenate([
        np.concatenate([b[p * half:(p + 1) * half] for b in blocks])
        for p in range(nproc)])
    for tag, mode in (("CIGARS", "global"), ("MODES", "semi")):
        alns = {}
        n = stream_align(local, runner=runner, batch_size=half, cigars=True,
                         mode=mode,
                         on_alignments=lambda i, t: alns.__setitem__(i, t))
        assert n == per, n
        cig = [x for i in sorted(alns) for x in _strings(alns[i])]
        print(f"{tag}{pid} " + json.dumps(cig), flush=True)
    if pid == 0:
        print("SCORES " + json.dumps(scores.max(axis=1).tolist()), flush=True)
        print("STREAM " + json.dumps(stream.max(axis=1).tolist()), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

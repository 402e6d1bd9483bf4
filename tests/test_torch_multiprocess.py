"""The port's runner and stream_align across two real processes on the CPU
(torch.distributed, Gloo; tests/torch_mp_worker.py), modelled on
tests/test_multiprocess.py: the gathered scores, the streamed scores and
the cigars streams (global and semi-global; each process decodes its own
pairs) must be byte-equal to one process over the same 32 pairs on the same
eight shards."""

import json
import os
import subprocess
import sys

from sequencealigning_tpu_torch.io.encode import pack_batch
from sequencealigning_tpu_torch.parallel import (
    DataParallelRunner,
    stream_align,
)
from sequencealigning_tpu_torch.parallel.runner import to_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_mp_worker import _pairs, _strings  # noqa: E402


def _one_process():
    runner = DataParallelRunner(["cpu"] * 8, np_slots=2, traceback="device")
    pairs = _pairs()
    scores = to_host(runner.scores(pack_batch(pairs))).max(axis=1).tolist()
    want = {"SCORES": scores, "STREAM": scores}
    for tag, mode in (("CIGARS", "global"), ("MODES", "semi")):
        alns = {}
        stream_align(pairs, runner=runner, batch_size=8, cigars=True,
                     mode=mode,
                     on_alignments=lambda i, t: alns.__setitem__(i, t))
        want[tag] = [x for i in sorted(alns) for x in _strings(alns[i])]
    return want


def test_two_process_scores_and_streams_equal_one_process():
    port = 20000 + os.getpid() % 20000
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(p), "2", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         cwd=REPO, text=True)
        for p in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out, err, rc in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err}"
    got = {}
    for out, _err, _rc in outs:
        for line in out.splitlines():
            tag, _, payload = line.partition(" ")
            got[tag] = json.loads(payload)
    want = _one_process()
    assert got["SCORES"] == want["SCORES"]
    assert got["STREAM"] == want["STREAM"]
    for tag in ("CIGARS", "MODES"):
        assert got[tag + "0"] + got[tag + "1"] == want[tag], tag

"""Per-cell direction bits shared by the fills and the walkers (the
constants of sequencealigning_tpu/ops/dirbits.py).

One byte per DP cell in the "full" layout.  For cell (x, y) (x = db index,
y = query index):

* HM/HI/HD: which plane(s) achieve H(x,y) = max(M,I,D)(x,y) -- the
  M-parent set of the successor diagonal cell
  (needleman_wunsch_affine.rs:120-153).
* IEXT/IOPEN: I(x,y) came from I(x,y-1)+e / M(x,y-1)+o+e (:108-119).
* DEXT/DOPEN: D(x,y) came from D(x-1,y)+e / M(x-1,y)+o+e (:96-107).
"""

HM = 1
HI = 2
HD = 4
IEXT = 8
IOPEN = 16
DEXT = 32
DOPEN = 64
# Local (Smith-Waterman-affine) mode only: M(x,y) restarted from 0 here --
# the traceback stop condition.
LSTART = 128


def pack_bytes_to_words(bytes_, d_total: int):
    """Pack a (D, B, P) uint8 per-diagonal byte stack into (ceil(D/4), B, P)
    uint32 words, little-endian in d -- the layout every fill emits and
    ops.traceback._byte reads.  Takes a tensor (or an array), returns a
    tensor on its device."""
    import torch

    bytes_ = torch.as_tensor(bytes_)
    d4 = -(-d_total // 4)
    pad = d4 * 4 - d_total
    bytes_ = torch.nn.functional.pad(bytes_, (0, 0, 0, 0, 0, pad))
    w = bytes_.reshape(d4, 4, bytes_.shape[1], bytes_.shape[2]).to(
        torch.int64)
    words = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
    words = words - ((words >> 31) & 1) * (1 << 32)
    return words.to(torch.int32).view(torch.uint32)

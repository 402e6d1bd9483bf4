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

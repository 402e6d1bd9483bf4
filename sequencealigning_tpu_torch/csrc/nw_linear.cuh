// Per-cell arithmetic of the linear-gap NW fill (nw_linear.cu), shared
// with the serial host build (host_check.cpp).
//
// It is ops/nw_linear.py::_linear_fill_lax's diagonal step written for one
// lane x of diagonal d (cell (x, y = d - x)): one score plane and a gap
// flag.  DOWN consumes the query (same lane, d-1), RIGHT the db (lane x-1,
// d-1), DIAG both (lane x-1, d-2).  Compat adds e or o by the NEIGHBOUR's
// gap flag (the reference's gap state, needleman_wunsch.rs) and starts from
// its double-initialised origin 2*o; local clamps at 0 and clears the path
// bits there.  Lanes 0 and d are the boundaries.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

constexpr int32_t kLinNegBig = -(1 << 30);  // nw_linear's NEGBIG
// Path bits (ops/nw_linear.py: LDOWN, LRIGHT, LDIAG, LISMAX).
constexpr int32_t kLDown = 1, kLRight = 2, kLDiag = 4, kLIsMax = 8;

// One lane's rolling state: its score one and two diagonals back, its gap
// flag, the query code flowing along the lanes, its db code, and the
// running maximum of its valid cells.
struct LinCell {
  int32_t S2, S1, G1, s1d, s2v, best;
};

SA_HD LinCell lin_init() {
  LinCell c;
  c.S2 = c.S1 = c.best = kLinNegBig;
  c.G1 = 0;
  c.s1d = c.s2v = 0;
  return c;
}

// One cell of diagonal d at lane x.  lS2, lS1, lG1, ls1d: lane x-1's state
// before the step (lane 0 ignores them: it is a boundary and takes the
// query code qc).  valid: the cell lies in the pair's matrix on or before
// its corner diagonal; maxv: the pair's maximum from pass 1 (local).
// Updates c and returns the path bits (0 when DIRS is false).
template <bool COMPAT, bool LOCAL, bool DIRS>
SA_HD int32_t linear_cell(LinCell& c, int32_t lS2, int32_t lS1, int32_t lG1,
                          int32_t ls1d, bool at0, bool atd, int32_t d,
                          int32_t qc, bool valid, int32_t maxv,
                          const Scheme& s) {
  const int32_t o = s.gap_open, e = s.gap_extend;
  const int32_t s1d = at0 ? qc : ls1d;
  const int32_t diag = lS2 + (s1d == c.s2v ? s.match : s.mismatch);
  int32_t down, right;
  if (COMPAT) {
    down = c.S1 + (c.G1 ? e : o);
    right = lS1 + (lG1 ? e : o);
  } else {
    down = c.S1 + e;
    right = lS1 + e;
  }
  const int32_t mx = imax(diag, imax(down, right));
  int32_t gap = (mx == down || mx == right) ? 1 : 0;
  int32_t sn = LOCAL ? (mx < 0 ? 0 : mx) : mx;
  const bool bound = at0 || atd;
  if (bound) {
    if (LOCAL) {
      sn = 0;
      gap = 0;
    } else if (COMPAT) {
      sn = d == 0 ? 2 * o : d * e + o;
      gap = 1;
    } else {
      sn = d == 0 ? 0 : d * e;
      gap = 1;
    }
  }
  if (valid) c.best = imax(c.best, sn);
  int32_t b = 0;
  if (DIRS) {
    const bool ismax = LOCAL && valid && sn == maxv;
    if (bound) {
      if (LOCAL) {
        b = ismax ? kLIsMax : 0;
      } else {
        b = d == 0 ? (kLRight | kLDown) : (at0 ? kLDown : kLRight);
      }
    } else {
      b = (mx == down ? kLDown : 0) | (mx == right ? kLRight : 0) |
          (mx == diag ? kLDiag : 0);
      if (LOCAL) {
        if (mx < 0) b = 0;
        if (ismax) b |= kLIsMax;
      }
    }
  }
  c.S2 = c.S1;
  c.S1 = sn;
  c.G1 = gap;
  c.s1d = s1d;
  return b;
}

// The lax twin's validity of cell (x, d - x) of a pair with lengths (n1,
// n2): inside the matrix and on or before the corner diagonal n1 + n2.
SA_HD bool linear_valid(int32_t x, int32_t d, int32_t n1, int32_t n2) {
  return x <= n2 && x >= d - n1 && x <= d && d <= n1 + n2;
}

}  // namespace sa

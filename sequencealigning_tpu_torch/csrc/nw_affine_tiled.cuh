// Per-cell arithmetic of the tiled score-only Gotoh fill, shared by the CUDA
// kernels (nw_affine_tiled.cu) and the serial host build (host_check.cpp).
//
// It is ops/nw_affine_tiled.py::_tile_step written for one lane: the tile
// holds cells x = x0 + lane of the db axis, step g holds y = g - lane; the
// merged-roll Gotoh recurrence of _stream_step inside the tile, lane 0 fed
// by the carried boundary column (M, D, H at x0 - 1) instead of a left
// neighbour, and the y = 0 chain written where lane == g.  The boundary
// column of tile 0 is the x = 0 column in closed form (_boundary0); every
// later tile's is the previous tile's last lane, emitted row by row.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

// The x = 0 boundary column at row y (_boundary0): M, D and H.  Compat
// keeps the chain o + (y+1)e in D, textbook o + y*e in I (D stays -inf, H
// sees it); y < 0 (the row before the first) is -inf everywhere.
SA_HD void tile_boundary0(int32_t y, bool compat, const Scheme& s,
                          int32_t& M, int32_t& D, int32_t& H) {
  if (y < 0) {
    M = D = H = kNegInf;
    return;
  }
  if (y == 0) {
    M = 0;
    D = kNegInf;
    H = 0;
    return;
  }
  M = kNegInf;
  D = compat ? s.gap_open + (y + 1) * s.gap_extend : kNegInf;
  H = compat ? D : s.gap_open + y * s.gap_extend;
}

// What the tile's lane 0 reads at the step holding row y: the query code
// y - 1 (0 outside 1 <= y <= L1, as the zero-padded query), and the carried
// boundary column's H(y - 1) and max(M(y) + o, D(y)) -- the values a left
// neighbour would hand over.  tile 0 takes the closed form; a later tile
// reads the column (bM, bD, bH: rows 0..n1 of the previous tile's last lane)
// and -inf past row n1 (those cells never reach the corner).  q: the pair's
// query codes.
SA_HD void tile_stage_row(int tile, int32_t y, int32_t n1, int L1,
                          const int32_t* q, const int32_t* bM,
                          const int32_t* bD, const int32_t* bH, bool compat,
                          const Scheme& s, int32_t& qc, int32_t& hb,
                          int32_t& od) {
  qc = y >= 1 && y <= L1 ? q[y - 1] : 0;
  int32_t mb, db;
  if (tile == 0) {
    int32_t m_, d_;
    tile_boundary0(y - 1, compat, s, m_, d_, hb);
    tile_boundary0(y, compat, s, mb, db, d_);
  } else {
    hb = y >= 1 && y - 1 <= n1 ? bH[y - 1] : kNegInf;
    mb = y >= 0 && y <= n1 ? bM[y] : kNegInf;
    db = y >= 0 && y <= n1 ? bD[y] : kNegInf;
  }
  od = imax(mb + s.gap_open, db);
}

// One cell of a tile step.  t0 = M1 + o of this lane before the step; lH2,
// ldsel, ls1d: the left neighbour's H2, max(M1 + o, D1) and query code
// before the step (for the tile's lane 0, the staged boundary row: H(y-1),
// max(M(y) + o, D(y)), query code y - 1).  atg: this lane holds cell
// (xg, 0), whose x-chain boundary (compat in I with one extra extension,
// textbook in D) overrides the recurrence.  c.s2v is the lane's db code.
template <bool COMPAT, bool WILDCARD>
SA_HD void tile_cell(Cell& c, int32_t t0, int32_t lH2, int32_t ldsel,
                     int32_t ls1d, bool atg, int32_t xg, const Scheme& s) {
  const bool eq = WILDCARD ? (ls1d & c.s2v) != 0 : ls1d == c.s2v;
  int32_t M = lH2 + (eq ? s.match : s.mismatch);
  int32_t I = imax(t0, c.I1) + s.gap_extend;
  int32_t D = ldsel + s.gap_extend;
  if (atg) {
    M = kNegInf;
    I = COMPAT ? s.gap_open + (xg + 1) * s.gap_extend : kNegInf;
    D = COMPAT ? kNegInf : s.gap_open + xg * s.gap_extend;
  }
  const int32_t H = imax(M, imax(I, D));
  c.H2 = c.H1;
  c.H1 = H;
  c.M1 = M;
  c.I1 = I;
  c.D1 = D;
  c.s1d = ls1d;
}

}  // namespace sa

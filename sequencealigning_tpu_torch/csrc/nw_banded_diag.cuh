// Per-cell arithmetic of the anti-diagonal banded fill, shared by the CUDA
// kernel (nw_banded_diag.cu) and the serial host build (host_check.cpp).
//
// It is ops/nw_banded_diag.py::_diag_step (boundary variant) written for one
// lane l of wavefront a with parity PAR: lane l holds diagonal
// k = k_lo_even + 2l + PAR, cell x = q - l, y = a - x with
// q = (a - PAR) / 2 - he.  On an odd wavefront (PAR 1) D and the query window
// s1w read lane l+1 of wavefront a-1; on an even one (PAR 0) I and the db
// window s2w read lane l-1; the edge lane (l = L-1, resp. l = 0) takes NEGBIG
// and the entering character instead.  STD opens gaps from H = max(M, I, D)
// (the standard gap-affine model) instead of M.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

// One lane's state: M/I/D and H of wavefront a-1, H of a-2, and the two
// character windows.
struct BandCell {
  int32_t M1, I1, D1, H1, H2, s1w, s2w;
};

// The wavefront-0 state of lane l: the origin (0, 0) at lane -he holds
// M = H = 0, every other value NEGBIG (_init_state).
SA_HD BandCell band_init(int32_t lane, int32_t he, int32_t s1w0,
                         int32_t s2w0) {
  BandCell c;
  c.M1 = c.H1 = lane == -he ? 0 : kNegBig;
  c.I1 = c.D1 = c.H2 = kNegBig;
  c.s1w = s1w0;
  c.s2w = s2w0;
  return c;
}

// What a lane hands its neighbour before a step: the gap-open source plus o.
template <bool STD>
SA_HD int32_t band_open(const BandCell& c, const Scheme& s) {
  return (STD ? c.H1 : c.M1) + s.gap_open;
}

// Lane l's pre-step neighbour values for a step of parity PAR: the
// neighbour's band_open, its gap plane (I1 for PAR 0, D1 for PAR 1) and its
// moving window (s2w for PAR 0, s1w for PAR 1).
template <int PAR>
SA_HD int32_t band_gap_src(const BandCell& c) {
  return PAR == 0 ? c.I1 : c.D1;
}
template <int PAR>
SA_HD int32_t band_char_src(const BandCell& c) {
  return PAR == 0 ? c.s2w : c.s1w;
}

// One cell.  nb_open / nb_gap / nb_char: the neighbour lane's pre-step
// values (l-1 for PAR 0, l+1 for PAR 1); edge: this lane is l = 0 (PAR 0)
// or l = L-1 (PAR 1), whose neighbour is outside the band; enter: the
// entering character; lane_ok: the lane is inside the effective band
// (l <= the parity's lane limit).  Updates c to wavefront a and returns the
// direction code (fast4 nibble or full 7-bit byte; 0 for kDirsNone).
template <int PAR, int DIRS, bool WILDCARD, bool STD>
SA_HD int32_t band_cell(BandCell& c, int32_t nb_open, int32_t nb_gap,
                        int32_t nb_char, bool edge, int32_t enter,
                        int32_t xv, int32_t yv, bool lane_ok, int32_t n1,
                        int32_t n2, bool compat, const Scheme& s) {
  const int32_t o = s.gap_open, e = s.gap_extend;
  const int32_t own_open = band_open<STD>(c, s);
  if (PAR == 1) {
    c.s1w = edge ? enter : nb_char;
  } else {
    c.s2w = edge ? enter : nb_char;
  }
  const bool eq = WILDCARD ? (c.s1w & c.s2w) != 0 : c.s1w == c.s2w;
  int32_t M = c.H2 + (eq ? s.match : s.mismatch);
  int32_t I_src, M_src_i, D_src, M_src_d;
  if (PAR == 0) {
    I_src = edge ? kNegBig : nb_gap;
    M_src_i = edge ? kNegBig : nb_open;
    D_src = c.D1;
    M_src_d = own_open;
  } else {
    I_src = c.I1;
    M_src_i = own_open;
    D_src = edge ? kNegBig : nb_gap;
    M_src_d = edge ? kNegBig : nb_open;
  }
  int32_t I = imax(M_src_i, I_src) + e;
  int32_t D = imax(M_src_d, D_src) + e;
  const bool valid =
      xv >= 1 && xv <= n2 && lane_ok && yv >= 1 && yv <= n1;
  if (!valid) {
    M = kNegBig;
    I = kNegBig;
    D = kNegBig;
  }
  // Boundary cells: compat keeps the x=0 chain in D and the y=0 chain in I
  // with one extra extension (the reference's quirk); textbook in I / D.
  const bool row0 = xv == 0 && yv >= 0 && yv <= n1;
  const bool col0 = yv == 0 && xv >= 1 && xv <= n2;
  if (row0) {
    const bool origin = yv == 0;
    M = origin ? 0 : kNegInf;
    I = origin ? kNegInf : (compat ? kNegInf : o + yv * e);
    D = origin ? kNegInf : (compat ? o + (yv + 1) * e : kNegInf);
  }
  if (col0) {
    M = kNegInf;
    I = compat ? o + (xv + 1) * e : kNegInf;
    D = compat ? kNegInf : o + xv * e;
  }
  const int32_t H = imax(M, imax(I, D));
  int32_t code = 0;
  if (DIRS == kDirsFast4) {
    code = (M == H ? 0 : (I == H ? 1 : 2)) | (I == I_src + e ? 4 : 0) |
           (D == D_src + e ? 8 : 0);
  } else if (DIRS == kDirsFull) {
    code = (M == H ? kHM : 0) | (I == H ? kHI : 0) | (D == H ? kHD : 0) |
           (I == I_src + e ? kIEXT : 0) | (I == M_src_i + e ? kIOPEN : 0) |
           (D == D_src + e ? kDEXT : 0) | (D == M_src_d + e ? kDOPEN : 0);
  }
  c.H2 = c.H1;
  c.H1 = H;
  c.M1 = M;
  c.I1 = I;
  c.D1 = D;
  return code;
}

}  // namespace sa

namespace sa {

// The wide route (nw_banded_diag.cu, band_wide_step): past a cluster's
// 16 x 8192 lanes a band is swept one wavefront a launch, its lanes' state
// in global memory, read from `in` (wavefront a-1) and written to `out`.
// This is one lane l of pair b at wavefront a of parity PAR: the neighbour
// (l+1 on odd wavefronts, l-1 on even ones) is read from `in` before any
// lane of the wavefront moves, the band's edge lane takes none.  Its
// direction code is ORed into word dirs[aidx / kUp, b, l] (written whole at
// the word's first wavefront), and the lane holding (n2, n1) writes the
// pair's finals.  lim: the last lane of the effective band at this parity.
template <int PAR, int DIRS, bool WILDCARD, bool STD>
SA_HD void band_wide_lane(const BandCell* in, BandCell* out,
                          const int32_t* enter_row, const int32_t* n1v,
                          const int32_t* n2v, int32_t* finals,
                          uint32_t* dirs, int B, int L, int a, int he,
                          int lim, bool compat, const Scheme& s, int b,
                          int l) {
  constexpr int kUp = DIRS == kDirsFast4 ? 8 : 4;  // wavefronts a word
  const size_t at = static_cast<size_t>(b) * L + l;
  const bool edge = PAR == 1 ? l == L - 1 : l == 0;
  const BandCell& nb = in[edge ? at : (PAR == 1 ? at + 1 : at - 1)];
  BandCell c = in[at];
  const int32_t q = (a - PAR) / 2 - he;
  const int32_t xv = q - l;
  const int32_t yv = a - xv;
  const int32_t n1 = n1v[b];
  const int32_t n2 = n2v[b];
  const int32_t code = band_cell<PAR, DIRS, WILDCARD, STD>(
      c, band_open<STD>(nb, s), band_gap_src<PAR>(nb), band_char_src<PAR>(nb),
      edge, enter_row[(a - 1) / 2], xv, yv, l <= lim, n1, n2, compat, s);
  out[at] = c;
  if (DIRS != kDirsNone) {
    const int aidx = a - 1;
    const uint32_t v = static_cast<uint32_t>(code)
                       << (DIRS == kDirsFast4 ? 4u * (aidx & 7)
                                              : 8u * (aidx & 3));
    uint32_t* w = dirs + (static_cast<size_t>(aidx / kUp) * B + b) * L + l;
    *w = aidx % kUp == 0 ? v : (*w | v);
  }
  if (xv == n2 && yv == n1) {
    finals[static_cast<size_t>(b) * 3 + 0] = c.M1;
    finals[static_cast<size_t>(b) * 3 + 1] = c.I1;
    finals[static_cast<size_t>(b) * 3 + 2] = c.D1;
  }
}

}  // namespace sa

// Per-lane arithmetic of the banded row sweep (kernel #8, nw_banded.cu),
// shared with the serial host build (host_check.cpp).
//
// It is ops/nw_banded.py::_row0_values and _banded_row_step written for one
// lane k of band row x (cell (x, y = x + k_lo + k)):
//
//   M(x,k) <- H(x-1, k) + sub            -- same lane, previous row
//   D(x,k) <- M/D(x-1, k+1) + gap        -- lane k+1, previous row
//   I(x,k) = k*e + prefixmax_{j<=k} v_j, v_j = M(x, j-1) + o + e - j*e
//
// with the column-0 lane (y == 0) carrying the compat (I) or textbook (D)
// gap chain and the lane right of it seeded with the chain plus e.  The
// caller does the prefix maximum: row_v gives each lane's scan input,
// row_i_masked and row_post turn a lane's inclusive maximum into I, H and
// the direction code.  Every cell outside the band or the pair's matrix is
// computed as the lax twin computes it (NEGBIG-masked), so the codes equal
// the twin's on every lane.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

constexpr int32_t kRowNegBig = -(1 << 24);  // nw_banded.NEGBIG
constexpr int32_t kScanFill = -(1 << 28);   // prefix-max identity

// What is constant along band row x of one pair: the column-0 chain values
// (nw_banded.py:150-161) and the pair's lengths.
struct RowCtx {
  int32_t x, k_lo, n1, n2;
  int32_t i_c, d_c, m_c;
};

SA_HD RowCtx row_ctx(int32_t x, int32_t k_lo, int32_t n1, int32_t n2,
                     bool compat, const Scheme& s) {
  RowCtx r;
  r.x = x;
  r.k_lo = k_lo;
  r.n1 = n1;
  r.n2 = n2;
  if (compat) {
    r.i_c = x == 0 ? kNegInf : s.gap_open + (x + 1) * s.gap_extend;
    r.d_c = kNegInf;
  } else {
    r.i_c = kNegInf;
    r.d_c = x == 0 ? kNegInf : s.gap_open + x * s.gap_extend;
  }
  r.m_c = x == 0 ? 0 : kNegInf;
  return r;
}

SA_HD bool row_valid(const RowCtx& r, int32_t k) {
  const int32_t y = r.x + r.k_lo + k;
  return y >= 1 && y <= r.n1 && r.x <= r.n2;
}

// The direction code of a cell from its planes and parent candidates (the
// row-0 cells pass their own I/D as parents, which no walker reads).
template <int DIRS>
SA_HD int32_t row_code(int32_t M, int32_t I, int32_t D, int32_t H,
                       int32_t I_l, int32_t M_l, int32_t dd, int32_t Dp_r,
                       const Scheme& s) {
  if (DIRS == kDirsFull) {
    return (M == H ? kHM : 0) | (I == H ? kHI : 0) | (D == H ? kHD : 0) |
           (I == I_l + s.gap_extend ? kIEXT : 0) |
           (I == M_l + s.gap_open + s.gap_extend ? kIOPEN : 0) |
           (D == Dp_r + s.gap_extend ? kDEXT : 0) |
           (D == dd + s.gap_extend ? kDOPEN : 0);
  }
  if (DIRS == kDirsFast4) {
    return (M == H ? 0 : (I == H ? 1 : 2)) |
           (I == I_l + s.gap_extend ? 4 : 0) |
           (D == Dp_r + s.gap_extend ? 8 : 0);
  }
  return 0;
}

// Row 0 (x = 0): cell (0, y = k_lo + k), band-masked (_row0_values).
// Returns the row-0 code (the H-argmax bits only; fast4: the plane).
template <int DIRS>
SA_HD int32_t row0_cell(int32_t k, int32_t k_lo, int32_t n1, bool compat,
                        const Scheme& s, int32_t& M, int32_t& I, int32_t& D,
                        int32_t& H) {
  const int32_t y = k_lo + k;
  const bool on = y >= 0 && y <= n1;
  const bool origin = y == 0;
  int32_t m0 = origin ? 0 : kNegInf, i0, d0;
  if (compat) {
    i0 = kNegInf;
    d0 = origin ? kNegInf : s.gap_open + (y + 1) * s.gap_extend;
  } else {
    i0 = origin ? kNegInf : s.gap_open + y * s.gap_extend;
    d0 = kNegInf;
  }
  M = on ? m0 : kRowNegBig;
  I = on ? i0 : kRowNegBig;
  D = on ? d0 : kRowNegBig;
  H = imax(M, imax(I, D));
  if (DIRS == kDirsFull) {
    return (M == H ? kHM : 0) | (I == H ? kHI : 0) | (D == H ? kHD : 0);
  }
  if (DIRS == kDirsFast4) return M == H ? 0 : (I == H ? 1 : 2);
  return 0;
}

// M of lane k on row x >= 1 after the band and column-0 masks: Hp = H of
// the lane on row x-1, s1c = the lane's query code on this row, dc = the
// row's db code.
template <bool WILDCARD>
SA_HD int32_t row_m(const RowCtx& r, int32_t k, int32_t Hp, int32_t s1c,
                    int32_t dc, const Scheme& s) {
  const int32_t y = r.x + r.k_lo + k;
  if (y == 0) return r.m_c;
  const bool eq = WILDCARD ? (s1c & dc) != 0 : s1c == dc;
  return row_valid(r, k) ? Hp + (eq ? s.match : s.mismatch) : kRowNegBig;
}

// D of lane k from lane k+1 of row x-1 (Mp_n, Dp_n; ignored on the last
// lane, whose neighbour is outside the band).  Sets dd = M + o and Dp_r,
// the two D-parent candidates.
SA_HD int32_t row_d(const RowCtx& r, int32_t k, int32_t K, int32_t Mp_n,
                    int32_t Dp_n, const Scheme& s, int32_t& dd,
                    int32_t& Dp_r) {
  const bool last = k == K - 1;
  const int32_t Mp_r = last ? kRowNegBig : Mp_n;
  Dp_r = last ? kRowNegBig : Dp_n;
  dd = Mp_r + s.gap_open;
  const int32_t D = imax(dd, Dp_r) + s.gap_extend;
  const int32_t y = r.x + r.k_lo + k;
  if (y == 0) return r.d_c;
  return row_valid(r, k) ? D : kRowNegBig;
}

// The prefix-max input of lane k: M_l is lane k-1's M on this row (not
// read at lane 0, which takes NEGBIG).
SA_HD int32_t row_v(const RowCtx& r, int32_t k, int32_t M_l,
                    const Scheme& s) {
  const int32_t le = k * s.gap_extend;
  const int32_t y = r.x + r.k_lo + k;
  if (k != 0 && y == 1) return r.i_c + s.gap_extend - le;
  return (k == 0 ? kRowNegBig : M_l) + (s.gap_open + s.gap_extend - le);
}

// I of lane k from the inclusive prefix maximum of the v's up to k.
SA_HD int32_t row_i_masked(const RowCtx& r, int32_t k, int32_t scan,
                           const Scheme& s) {
  const int32_t y = r.x + r.k_lo + k;
  if (y == 0) return r.i_c;
  return row_valid(r, k) ? scan + k * s.gap_extend : kRowNegBig;
}

// The rest of lane k's cell once the scan is known: I (from scan), H and
// the direction code.  I_l and M_l are lane k-1's I and M on this row
// (NEGBIG at lane 0).
template <int DIRS>
SA_HD int32_t row_post(const RowCtx& r, int32_t k, int32_t M, int32_t D,
                       int32_t dd, int32_t Dp_r, int32_t M_l, int32_t I_l,
                       int32_t scan, const Scheme& s, int32_t& I,
                       int32_t& H) {
  I = row_i_masked(r, k, scan, s);
  H = imax(M, imax(I, D));
  return row_code<DIRS>(M, I, D, H, k == 0 ? kRowNegBig : I_l,
                        k == 0 ? kRowNegBig : M_l, dd, Dp_r, s);
}

}  // namespace sa

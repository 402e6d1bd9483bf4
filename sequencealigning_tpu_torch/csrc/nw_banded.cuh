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
// row-0 cells pass their own I/D as parents, which no walker reads): D's
// bits from its two candidates, and the rest once I and H are known (I_l,
// M_l: lane k-1's, NEGBIG at lane 0).
template <int DIRS>
SA_HD uint32_t row_d_bits(int32_t D, int32_t dd, int32_t Dp_r,
                          const Scheme& s) {
  if (DIRS == kDirsFull) {
    return (D == Dp_r + s.gap_extend ? kDEXT : 0) |
           (D == dd + s.gap_extend ? kDOPEN : 0);
  }
  if (DIRS == kDirsFast4) return D == Dp_r + s.gap_extend ? 8u : 0u;
  return 0;
}

template <int DIRS>
SA_HD uint32_t row_hi_bits(int32_t M, int32_t I, int32_t D, int32_t H,
                           int32_t I_l, int32_t M_l, const Scheme& s) {
  if (DIRS == kDirsFull) {
    return (M == H ? kHM : 0) | (I == H ? kHI : 0) | (D == H ? kHD : 0) |
           (I == I_l + s.gap_extend ? kIEXT : 0) |
           (I == M_l + s.gap_open + s.gap_extend ? kIOPEN : 0);
  }
  if (DIRS == kDirsFast4) {
    return (M == H ? 0u : (I == H ? 1u : 2u)) |
           (I == I_l + s.gap_extend ? 4u : 0u);
  }
  return 0;
}

template <int DIRS>
SA_HD int32_t row_code(int32_t M, int32_t I, int32_t D, int32_t H,
                       int32_t I_l, int32_t M_l, int32_t dd, int32_t Dp_r,
                       const Scheme& s) {
  return static_cast<int32_t>(row_hi_bits<DIRS>(M, I, D, H, I_l, M_l, s) |
                              row_d_bits<DIRS>(D, dd, Dp_r, s));
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

// D of lane k from its two candidates dd = M + o and Dp_r of lane k+1 on
// row x-1; row_d takes them from lane k+1 (Mp_n, Dp_n; ignored on the
// last lane, whose neighbour is outside the band) and sets dd and Dp_r.
SA_HD int32_t row_d_from(const RowCtx& r, int32_t k, int32_t dd,
                         int32_t Dp_r, const Scheme& s) {
  const int32_t D = imax(dd, Dp_r) + s.gap_extend;
  const int32_t y = r.x + r.k_lo + k;
  if (y == 0) return r.d_c;
  return row_valid(r, k) ? D : kRowNegBig;
}

SA_HD int32_t row_d(const RowCtx& r, int32_t k, int32_t K, int32_t Mp_n,
                    int32_t Dp_n, const Scheme& s, int32_t& dd,
                    int32_t& Dp_r) {
  const bool last = k == K - 1;
  const int32_t Mp_r = last ? kRowNegBig : Mp_n;
  Dp_r = last ? kRowNegBig : Dp_n;
  dd = Mp_r + s.gap_open;
  return row_d_from(r, k, dd, Dp_r, s);
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

// ---------------------------------------------------------------------------
// The warp route (nw_banded_warp.cu): a warp a pair, thread t holding the
// LPT consecutive lanes k0 = t * LPT .. k0 + LPT - 1 of the band in
// registers, the in-row I chain a thread's fold and a warp's scan.
//
// I[k] = k*e + prefixmax_{j<=k} v_j is the maximum of c_j + (k - j) e over
// j <= k, c_j = v_j + j*e (M of lane j-1 plus o + e, or the column-0 chain
// plus e right of column 0): the running R_k = max(R_{k-1} + e, c_k), one
// add-max a lane, the same integers since nothing overflows.  A thread's
// lanes fold into A_t (R at its last lane from no carry), and R at lane
// k0 - 1 is max_{s<t}(A_s - (s + 1) LPT e) + t LPT e: a plain maximum over
// the threads' keys, a 5-step shuffle scan.

constexpr int kRowWarpMaxLpt = 16;  // lanes a thread of the warp route
constexpr int kRowWarpMaxLanes = 32 * kRowWarpMaxLpt;

// The route of a band of K lanes (a multiple of 128): the warp route's
// lanes a thread, K / 32, when no chunk width is forced and K fits a warp's
// registers; 0 for the block route (nw_banded.cu).
SA_HD int row_warp_lpt(int K, int chunk_lanes) {
  return chunk_lanes == 0 && K > 0 && K % 128 == 0 && K <= kRowWarpMaxLanes
             ? K / 32
             : 0;
}

// Thread t's key for the warp's scan, and R at its lane k0 - 1 from the
// exclusive maximum of the keys left of it (kScanFill for t = 0).
SA_HD int32_t row_key(int32_t A, int t, int lpt, const Scheme& s) {
  return A - (t + 1) * lpt * s.gap_extend;
}
SA_HD int32_t row_r_in(int32_t excl, int t, int lpt, const Scheme& s) {
  return t == 0 ? kScanFill : excl + t * lpt * s.gap_extend;
}

// Lanes i (k = k0 + i) of a thread on row x that hold cells of the pair's
// matrix: lo <= i <= hi.  plain: all of [0, lpt) and neither the column-0
// lane nor the lane right of it (which take the chain), so no lane needs a
// mask.
struct RowSpan {
  int32_t lo, hi;
  bool plain;
};

SA_HD RowSpan row_span(const RowCtx& r, int32_t k0, int lpt) {
  RowSpan p;
  p.lo = 1 - r.x - r.k_lo - k0;
  p.hi = r.x <= r.n2 ? r.n1 - r.x - r.k_lo - k0 : p.lo - 1;
  p.plain = p.lo < 0 && p.hi >= lpt - 1;
  return p;
}

// c of lane k (M_l: lane k-1's M on this row).
SA_HD int32_t row_c(const RowCtx& r, int32_t k, int32_t M_l,
                    const Scheme& s) {
  const int32_t y = r.x + r.k_lo + k;
  if (k != 0 && y == 1) return r.i_c + s.gap_extend;
  return (k == 0 ? kRowNegBig : M_l) + s.gap_open + s.gap_extend;
}

// I of lane k from R.
SA_HD int32_t row_i_from(const RowCtx& r, int32_t k, int32_t R) {
  const int32_t y = r.x + r.k_lo + k;
  if (y == 0) return r.i_c;
  return row_valid(r, k) ? R : kRowNegBig;
}

// Row x before the scan, for the thread whose first lane is k0, in place:
// M and D (holding row x-1's) become row x's, S1 the row's query window;
// Hp still holds row x-1's H.  m_r / d_r / s_r: lane k0 + LPT's M, D and
// query code of row x-1 (NEGBIG, NEGBIG and the entering code past the
// band's last lane); M_left: lane k0 - 1's M on row x (NEGBIG at k0 = 0).
// Each lane's scan input c and D's code bits go to C and bits.  Returns the
// thread's fold A.
template <int LPT, int DIRS, bool WILDCARD, bool PLAIN>
SA_HD int32_t row_warp_pre(const RowCtx& r, int32_t k0, int32_t* M,
                           int32_t* D, const int32_t* Hp, int32_t* S1,
                           int32_t* C, uint32_t* bits, int32_t m_r,
                           int32_t d_r, int32_t s_r, int32_t M_left,
                           int32_t dc, const Scheme& s) {
  int32_t A = 0, M_l = M_left;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int32_t k = k0 + i;
    const int32_t Mp_r = i + 1 < LPT ? M[i + 1] : m_r;
    const int32_t Dp_r = i + 1 < LPT ? D[i + 1] : d_r;
    const int32_t s1 = i + 1 < LPT ? S1[i + 1] : s_r;
    const int32_t dd = Mp_r + s.gap_open;
    int32_t Mk, Dk, c;
    if (PLAIN) {
      const bool eq = WILDCARD ? (s1 & dc) != 0 : s1 == dc;
      Mk = Hp[i] + (eq ? s.match : s.mismatch);
      Dk = imax(dd, Dp_r) + s.gap_extend;
      c = M_l + s.gap_open + s.gap_extend;
    } else {
      Mk = row_m<WILDCARD>(r, k, Hp[i], s1, dc, s);
      Dk = row_d_from(r, k, dd, Dp_r, s);
      c = row_c(r, k, M_l, s);
    }
    A = i == 0 ? c : add_max(A, s.gap_extend, c);
    C[i] = c;
    bits[i] = row_d_bits<DIRS>(Dk, dd, Dp_r, s);
    M[i] = Mk;
    D[i] = Dk;
    S1[i] = s1;
    M_l = Mk;
  }
  return A;
}

// Row x after the scan: H (Hp) becomes row x's and each lane's code (its
// D bits from the first pass and the rest) is ORed into acc at shift.
// R_in: R at lane k0 - 1.  fin (FIN only): the finals of the pair,
// written by the lane kc - k0 == i.
template <int LPT, int DIRS, bool PLAIN, bool FIN>
SA_HD void row_warp_post(const RowCtx& r, int32_t k0, const int32_t* M,
                         const int32_t* D, const int32_t* C,
                         const uint32_t* bits, int32_t* Hp, uint32_t* acc,
                         uint32_t shift, int32_t M_left, int32_t R_in,
                         const Scheme& s, int32_t* fin, int32_t kc) {
  int32_t R = R_in, M_l = M_left;
  int32_t I_l = k0 > 0 ? row_i_from(r, k0 - 1, R_in) : kRowNegBig;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int32_t k = k0 + i;
    R = add_max(R, s.gap_extend, C[i]);
    const int32_t I = PLAIN ? R : row_i_from(r, k, R);
    const int32_t H = max3(M[i], I, D[i]);
    acc[i] |= (row_hi_bits<DIRS>(M[i], I, D[i], H, I_l, M_l, s) | bits[i])
              << shift;
    Hp[i] = H;
    if (FIN && k == kc) {
      fin[0] = M[i];
      fin[1] = I;
      fin[2] = D[i];
    }
    I_l = I;
    M_l = M[i];
  }
}

}  // namespace sa

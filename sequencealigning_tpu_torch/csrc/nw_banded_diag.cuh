// Per-cell arithmetic and tile schedule of the anti-diagonal banded fill,
// shared by the CUDA kernel (nw_banded_diag.cu) and the serial host build
// (host_check.cpp).
//
// The cell is ops/nw_banded_diag.py::_diag_step (boundary variant) written
// for one lane l of wavefront a with parity PAR: lane l holds diagonal
// k = k_lo_even + 2l + PAR, cell x = q - l, y = a - x with
// q = (a - PAR) / 2 - he.  On an odd wavefront (PAR 1) D and the query window
// s1w read lane l+1 of wavefront a-1; on an even one (PAR 0) I and the db
// window s2w read lane l-1; the edge lane (l = L-1, resp. l = 0) takes NEGBIG
// and the entering character instead.  STD opens gaps from H = max(M, I, D)
// (the standard gap-affine model) instead of M.  Iteration i runs wavefronts
// 2i+1 and 2i+2; lane l holds row y = i + 1 + he + l in both.
//
// The tile schedule's index math (which tile a ticket is, the lanes a tile
// computes and owns, the characters a lane holds at a block's start, which
// cell a chunk of iterations needs) lives here too, so the host build runs
// the kernel's schedule serially through it.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"
#include "nw_affine_tiled.cuh"

namespace sa {

// One lane's state: M/I/D and H of wavefront a-1, H of a-2, and the two
// character windows.
struct BandCell {
  int32_t M1, I1, D1, H1, H2, s1w, s2w;
};

// What a lane hands its neighbour before a step: the gap-open source plus o.
template <bool STD>
SA_HD int32_t band_open(const BandCell& c, const Scheme& s) {
  return (STD ? c.H1 : c.M1) + s.gap_open;
}

// One cell anywhere in the band, the x = 0 row and y = 0 column included.
// nb_open / nb_gap / nb_char: the neighbour lane's pre-step band_open, gap
// plane (I1 for PAR 0, D1 for PAR 1) and moving window (s2w for PAR 0, s1w
// for PAR 1) -- NEGBIG, NEGBIG and the entering character at the band's
// edge lane; lane_ok: the lane is inside the effective band (l <= the
// parity's lane limit).  Updates c to wavefront a and returns the direction
// code (fast4 nibble or full 7-bit byte; 0 for kDirsNone).
template <int PAR, int DIRS, bool WILDCARD, bool STD>
SA_HD int32_t band_cell(BandCell& c, int32_t nb_open, int32_t nb_gap,
                        int32_t nb_char, int32_t xv, int32_t yv, bool lane_ok,
                        int32_t n1, int32_t n2, bool compat,
                        const Scheme& s) {
  const int32_t o = s.gap_open, e = s.gap_extend;
  const int32_t own_open = band_open<STD>(c, s);
  if (PAR == 1) {
    c.s1w = nb_char;
  } else {
    c.s2w = nb_char;
  }
  const bool eq = WILDCARD ? (c.s1w & c.s2w) != 0 : c.s1w == c.s2w;
  int32_t M = c.H2 + (eq ? s.match : s.mismatch);
  int32_t I_src, M_src_i, D_src, M_src_d;
  if (PAR == 0) {
    I_src = nb_gap;
    M_src_i = nb_open;
    D_src = c.D1;
    M_src_d = own_open;
  } else {
    I_src = c.I1;
    M_src_i = own_open;
    D_src = nb_gap;
    M_src_d = nb_open;
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

// One cell away from the x = 0 row and the y = 0 column: band_cell's
// integers with fewer instructions.  H2: the lane's H two wavefronts back;
// eq: its characters match; i_open / i_gap: I's sources (the gap-open
// source plus o and I1 of lane l on an odd wavefront, of lane l-1 on an even
// one), d_open / d_gap: D's (lane l+1 on an odd wavefront, l on an even
// one); valid: the cell lies in the matrix and the effective band (MASK:
// else M = I = D = NEGBIG, as band_cell).  I and D are one add and one
// VIADDMAX each (max(open + e, gap + e)), H one VIMNMX3.  Updates M1/I1/D1,
// writes the new H and returns the direction code.
template <int DIRS, bool MASK>
SA_HD int32_t lean_cell(int32_t H2, bool eq, int32_t i_open, int32_t i_gap,
                        int32_t d_open, int32_t d_gap, bool valid,
                        const Scheme& s, int32_t& M1, int32_t& I1,
                        int32_t& D1, int32_t& H) {
  const int32_t e = s.gap_extend;
  int32_t M = H2 + (eq ? s.match : s.mismatch);
  const int32_t Ie = i_gap + e;
  int32_t I = add_max(i_open, e, Ie);
  const int32_t De = d_gap + e;
  int32_t D = add_max(d_open, e, De);
  if (MASK && !valid) {
    M = kNegBig;
    I = kNegBig;
    D = kNegBig;
  }
  H = max3(M, I, D);
  int32_t code = 0;
  if (DIRS == kDirsFast4) {
    code = (M == H ? 0 : (I == H ? 1 : 2)) | (I == Ie ? 4 : 0) |
           (D == De ? 8 : 0);
  } else if (DIRS == kDirsFull) {
    code = (M == H ? kHM : 0) | (I == H ? kHI : 0) | (D == H ? kHD : 0) |
           (I == Ie ? kIEXT : 0) | (I == i_open + e ? kIOPEN : 0) |
           (D == De ? kDEXT : 0) | (D == d_open + e ? kDOPEN : 0);
  }
  M1 = M;
  I1 = I;
  D1 = D;
  return code;
}

// Characters as the kernel holds them: a lane's nibble code (io.encode's
// one-hot codes; the -1 padding becomes 15), LPT lanes of a thread packed 4
// bits a lane.  Cells inside the matrix only ever compare real codes, so
// the nibbles give band_cell's matches there.  cmp: the two windows'
// packed codes combined once a step (AND for the wildcard rule, else XOR),
// eq tested a lane at a time.
template <bool WILDCARD>
SA_HD uint32_t band_cmp(uint32_t s1, uint32_t s2) {
  return WILDCARD ? s1 & s2 : s1 ^ s2;
}
template <bool WILDCARD>
SA_HD bool band_eq(uint32_t cmp, int i) {
  const uint32_t nib = (cmp >> (4 * i)) & 0xfu;
  return WILDCARD ? nib != 0 : nib == 0;
}

// The lanes of wavefront a (parity from q = (a - PAR) / 2 - he) whose cells
// lie in the matrix (1 <= x <= n2, 1 <= y <= n1) and the effective band
// (l <= lim): [vlo, vhi], empty when vlo > vhi.  Lane l is band_cell's
// `valid` iff vlo <= l <= vhi.
SA_HD void band_valid_lanes(int a, int q, int32_t n1, int32_t n2, int lim,
                            int& vlo, int& vhi) {
  const int lo_x = q - n2, hi_x = q - 1;          // x = q - l
  const int lo_y = 1 - a + q, hi_y = n1 - a + q;  // y = a - q + l
  vlo = lo_x > lo_y ? lo_x : lo_y;
  vhi = hi_x < hi_y ? hi_x : hi_y;
  if (lim < vhi) vhi = lim;
}

// ---------------------------------------------------------------------------
// The tile schedule
// ---------------------------------------------------------------------------

// A pair's L lanes are cut into strips of W lanes (strip s owns lanes
// s*W .. s*W + W - 1, the last one the rest) and its n_iters iterations
// into blocks of T; a tile is (block tau, pair b, strip s).  The dependency
// cone widens by one lane a side each iteration (an odd wavefront reads lane
// l+1, an even one l-1), so a tile computes its strip plus `halo` >= T lanes
// on each side (clipped to the band), from the lanes' state at its block's
// start, and keeps only its own lanes: their codes, finals and end state.
// One strip (S = 1) has no halo.  Tickets are tau-major, then pair, then
// strip, so every tile's producers (block tau - 1, strips s - 1 .. s + 1)
// hold earlier tickets.  order 1 reverses the tickets (a schedule that
// cannot be met, for the tests of the stall rule).
struct BandTiles {
  int W;      // lanes a strip owns
  int T;      // iterations a block
  int S;      // strips a pair
  int order;  // 0 in ticket order, 1 reversed
};

SA_HD int band_rows(const BandTiles& g, int n_iters) {
  return (n_iters + g.T - 1) / g.T;
}

// Halo lanes a side: the block's iterations rounded up to 8 lanes, so a
// tile's lanes start and end on a multiple of 8 (of every thread's 2, 4 or
// 8 lanes); none for one strip.
SA_HD int band_halo(const BandTiles& g, int n_iters) {
  const int t = g.T < n_iters ? g.T : n_iters;
  return g.S > 1 ? (t + 7) / 8 * 8 : 0;
}

// Whether g is a schedule the kernel takes for L lanes and n_iters
// iterations: W a positive multiple of 8, S = ceil(L / W), blocks of a
// multiple of 4 iterations when there are several (a block's fast4 and full
// words are then whole), and the halo at most a strip (a tile's halo reads
// only its neighbours' lanes, so two state buffers suffice).
SA_HD bool band_tiles_ok(const BandTiles& g, int L, int n_iters) {
  if (L <= 0 || L % 8 != 0 || n_iters <= 0 || g.W <= 0 || g.W % 8 != 0 ||
      g.T <= 0 || g.S != (L + g.W - 1) / g.W ||
      (g.order != 0 && g.order != 1)) {
    return false;
  }
  if (band_rows(g, n_iters) > 1 && g.T % 4 != 0) return false;
  return band_halo(g, n_iters) <= g.W;
}

struct BandTile {
  int tau, b, s;       // block, pair, strip
  int i0, nit;         // the block's first iteration and its iterations
  int lo, hi;          // lanes computed: [lo, hi)
  int own_lo, own_hi;  // lanes kept: [own_lo, own_hi)
};

SA_HD BandTile band_tile(int ticket, const BandTiles& g, int B, int L,
                         int n_iters) {
  const int per_row = B * g.S;
  const int t =
      g.order ? band_rows(g, n_iters) * per_row - 1 - ticket : ticket;
  BandTile tl;
  tl.tau = t / per_row;
  const int r = t % per_row;
  tl.b = r / g.S;
  tl.s = r % g.S;
  tl.i0 = tl.tau * g.T;
  tl.nit = n_iters - tl.i0 < g.T ? n_iters - tl.i0 : g.T;
  const int halo = band_halo(g, n_iters);
  tl.own_lo = tl.s * g.W;
  tl.own_hi = tl.own_lo + g.W < L ? tl.own_lo + g.W : L;
  tl.lo = tl.own_lo - halo > 0 ? tl.own_lo - halo : 0;
  tl.hi = tl.own_hi + halo < L ? tl.own_hi + halo : L;
  return tl;
}

// The strips of block tau - 1 whose end state a tile reads: s - 1 .. s + 1
// within the pair.
SA_HD int band_dep_lo(const BandTile& t) { return t.s > 0 ? t.s - 1 : 0; }
SA_HD int band_dep_hi(const BandTile& t, const BandTiles& g) {
  return t.s + 1 < g.S ? t.s + 1 : g.S - 1;
}

// The characters lane l holds after iteration i - 1, from the fill's inputs
// (one pair's rows): the query window's is S1[l + i] of S1 = s1w0 ++ c1s
// (the window shifts down one lane an odd wavefront, c1s[i] entering at
// lane L-1), the db window's S2[l - i] of S2 = reversed(c2s) ++ s2w0 (it
// shifts up one lane an even wavefront, c2s[i] entering at lane 0).  The
// characters entering a tile's ends at iteration i are S1[hi + i] and
// S2[lo - i - 1]: the band's own entering characters at its edge lanes.
SA_HD int32_t band_s1(const int32_t* s1w0, const int32_t* c1s, int L,
                      int m) {
  return m < L ? s1w0[m] : c1s[m - L];
}
SA_HD int32_t band_s2(const int32_t* s2w0, const int32_t* c2s, int m) {
  return m >= 0 ? s2w0[m] : c2s[-m - 1];
}

// Which cell the n iterations from i need on lanes [lo, hi) of a pair:
// kBandRamp (band_cell) when a lane may hold an x = 0 or y = 0 cell,
// kBandMasked (lean_cell with its valid mask) when a cell may lie outside
// the matrix or the effective band, else kBandLean.  x = 0 sits at lane
// i - he (odd wavefront) or i + 1 - he (even), y = 0 at lane -he - i - 1.
enum { kBandLean = 0, kBandMasked = 1, kBandRamp = 2 };

SA_HD int band_chunk_mode(int i, int n, int lo, int hi, int he, int32_t n1,
                          int32_t n2, int lim1, int lim0) {
  const int last = i + n - 1;
  const bool row0 = i - he <= hi - 1 && last + 1 - he >= lo;
  const bool col0 = -he - last - 1 <= hi - 1 && -he - i - 1 >= lo;
  if (row0 || col0) return kBandRamp;
  const int lim = lim1 < lim0 ? lim1 : lim0;
  const bool inside = i - he - (hi - 1) >= 1 && last + 1 - he - lo <= n2 &&
                      i + 1 + he + lo >= 1 && last + 1 + he + hi - 1 <= n1 &&
                      hi - 1 <= lim;
  return inside ? kBandLean : kBandMasked;
}

// The iteration and lane of pair (n1, n2)'s corner cell (n2, n1), at
// wavefront a = n1 + n2: false when no wavefront holds it (a = 0).
SA_HD bool band_corner(int32_t n1, int32_t n2, int he, int& a, int& lane) {
  a = n1 + n2;
  const int par = a & 1;
  lane = (a - par) / 2 - he - n2;
  return a >= 1;
}

}  // namespace sa

// Per-cell arithmetic of the Gotoh fills, shared by the CUDA kernels
// (nw_affine_stream.cu, nw_affine_modes.cu) and the serial host build
// (host_check.cpp).
//
// It is ops/nw_affine_stream.py::_stream_step (int32 state) written for one
// lane: the merged-roll D recurrence, the boundary hook at lanes 0 and p
// (global gap chains, or the free end gaps of the textbook semi-global and
// local modes, with local's Smith-Waterman clamp and LSTART bit), the fast4 /
// full direction codes of ops/dirbits.py, and the modes' running argmax.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define SA_HD __host__ __device__ __forceinline__
#else
#define SA_HD static inline
#endif

namespace sa {

constexpr int32_t kNegInf = -32768;      // config.NEG_INF
constexpr int32_t kNegBig = -(1 << 24);  // the modes' argmax and stream init

enum { kDirsNone = 0, kDirsFast4 = 1, kDirsFull = 2 };
enum { kModeGlobal = 0, kModeSemi = 1, kModeLocal = 2 };

// ops/dirbits.py
constexpr int32_t kHM = 1, kHI = 2, kHD = 4, kIEXT = 8, kIOPEN = 16,
                  kDEXT = 32, kDOPEN = 64, kLSTART = 128;

struct Scheme {
  int32_t match, mismatch, gap_open, gap_extend;
};

// One lane's rolling state: H two and one steps back, M/I/D one step back,
// the query code flowing along the lanes and the lane's db code.
struct Cell {
  int32_t H2, H1, M1, I1, D1, s1d, s2v;
};

// What a lane hands its right neighbour (lane x+1) each step, computed from
// its state before the step: the gap-open candidate t0 = M1 + o, the merged
// D source where(D1 >= t0, D1, t0), and the D direction bits.
struct Pre {
  int32_t t0, dsel, dflag;
};

SA_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

// neg: the initial score state, NEG_INF (global fills and the per-pair modes
// fill) or NEGBIG (the streamed modes fill), as in the JAX package.
SA_HD Cell cell_init(int32_t neg = kNegInf) {
  Cell c;
  c.H2 = c.H1 = c.M1 = c.I1 = c.D1 = neg;
  c.s1d = c.s2v = 0;
  return c;
}

template <int DIRS>
SA_HD Pre stream_pre(const Cell& c, const Scheme& s) {
  Pre r;
  r.t0 = c.M1 + s.gap_open;
  const bool cd = c.D1 >= r.t0;
  r.dsel = cd ? c.D1 : r.t0;
  if (DIRS == kDirsFull) {
    r.dflag = (cd ? kDEXT : 0) | (r.t0 >= c.D1 ? kDOPEN : 0);
  } else if (DIRS == kDirsFast4) {
    r.dflag = cd ? 8 : 0;
  } else {
    r.dflag = 0;
  }
  return r;
}

// Boundary cell at local diagonal p (ops/nw_affine.py::_boundary_scalars).
// col = false: the row-0 cell (x = 0, y = p); col = true: the column-0 cell
// (x = p, y = 0).  Compat keeps the chain o + (p+1)e in D on row 0 and in I
// on column 0; textbook keeps o + p*e in the other plane.  p = 0 is the
// origin: M = 0, I = D = -inf.
SA_HD void boundary(int32_t p, bool compat, bool col, const Scheme& s,
                    int32_t& M, int32_t& I, int32_t& D) {
  const bool origin = p == 0;
  const int32_t chain = compat ? s.gap_open + (p + 1) * s.gap_extend
                               : s.gap_open + p * s.gap_extend;
  const int32_t v = origin ? kNegInf : chain;
  const bool in_d = compat != col;
  M = origin ? 0 : kNegInf;
  I = in_d ? kNegInf : v;
  D = in_d ? v : kNegInf;
}

// One cell of step t at lane x.  pre: this lane's own stream_pre; lH2, lpre,
// ls1d: lane x-1's H2, stream_pre and query code before the step (for x = 0,
// lane P-1's: the roll is a torus, as jnp.roll).  at0 = (x == 0), atp =
// (x == p), p = t mod S (the diagonal d in a per-pair fill); dc replaces the
// lane's db code at lane p (a per-pair fill passes the lane's own).  Updates c
// and returns the direction code (0 when DIRS is kDirsNone).  Global mode
// overrides lane p first, then lane 0, so at p == 0 lane 0 wins, as in
// _stream_step; semi and local write M = 0, I = D = -inf on both, and local
// clamps M at 0 with the restart (and every boundary cell) marked LSTART.
// The textbook modes use COMPAT = false and DIRS none or full.
template <int DIRS, int MODE, bool COMPAT, bool WILDCARD>
SA_HD int32_t stream_cell(Cell& c, const Pre& pre, int32_t lH2,
                          const Pre& lpre, int32_t ls1d, bool at0, bool atp,
                          int32_t p, int32_t qc, int32_t dc,
                          const Scheme& s) {
  const int32_t s1d = at0 ? qc : ls1d;
  const int32_t s2v = atp ? dc : c.s2v;
  const bool eq = WILDCARD ? (s1d & s2v) != 0 : s1d == s2v;
  int32_t M = lH2 + (eq ? s.match : s.mismatch);
  bool restart = false;
  if (MODE == kModeLocal) {
    restart = M < 0;
    M = imax(M, 0);
  }
  const bool ci = c.I1 >= pre.t0;
  int32_t I = (ci ? c.I1 : pre.t0) + s.gap_extend;
  int32_t D = lpre.dsel + s.gap_extend;
  if (MODE == kModeGlobal) {
    if (atp) boundary(p, COMPAT, true, s, M, I, D);
    if (at0) boundary(p, COMPAT, false, s, M, I, D);
  } else if (at0 || atp) {
    M = 0;
    I = kNegInf;
    D = kNegInf;
    restart = true;
  }
  const int32_t H = imax(M, imax(I, D));
  int32_t code = 0;
  if (DIRS == kDirsFull) {
    code = (M == H ? kHM : 0) | (I == H ? kHI : 0) | (D == H ? kHD : 0) |
           (ci ? kIEXT : 0) | (pre.t0 >= c.I1 ? kIOPEN : 0) | lpre.dflag;
    if (MODE == kModeLocal && restart) code |= kLSTART;
  } else if (DIRS == kDirsFast4) {
    // H-argmax plane, priority M > I > D, plus the two extend flags.
    code = (M == H ? 0 : (I == H ? 1 : 2)) | (ci ? 4 : 0) | lpre.dflag;
  }
  c.H2 = c.H1;
  c.H1 = H;
  c.M1 = M;
  c.I1 = I;
  c.D1 = D;
  c.s1d = s1d;
  c.s2v = s2v;
  return code;
}

// The running argmax of the textbook modes (ops/nw_affine_modes.py::
// _fill_modes_lax) at cell (x, y) of a pair with lengths (n1, n2), n2 = -1
// for no pair, on the pair's local diagonal pd: local takes M on
// 1 <= x <= n2, 1 <= y <= n1; semi takes H on the valid cells of the last row
// or column.  Strict > keeps each lane's earliest diagonal.
template <int MODE>
SA_HD void modes_update(int32_t x, int32_t y, int32_t pd, int32_t n1,
                        int32_t n2, int32_t M, int32_t H, int32_t& bv,
                        int32_t& bd) {
  bool elig;
  int32_t score;
  if (MODE == kModeLocal) {
    elig = x >= 1 && x <= n2 && y >= 1 && y <= n1;
    score = M;
  } else {
    elig = x >= 0 && x <= n2 && y >= 0 && y <= n1 && (x == n2 || y == n1);
    score = H;
  }
  if (elig && score > bv) {
    bv = score;
    bd = pd;
  }
}

}  // namespace sa

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

// Hopper's DPX instructions on the card, the same integers from plain
// maxima on the host.
// max(a + b, c): one VIADDMAX on sm_90.
SA_HD int32_t add_max(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__)
  return __viaddmax_s32(a, b, c);
#else
  return imax(a + b, c);
#endif
}

// max(a, b, c): one VIMNMX3 on sm_90.
SA_HD int32_t max3(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__)
  return __vimax3_s32(a, b, c);
#else
  return imax(a, imax(b, c));
#endif
}

// max(a, b) and ge = (a >= b), for a compare whose result is also a
// direction bit: __vibmax_s32 on the card (ptxas for sm_90a lowers it to a
// compare and a select, no fewer instructions than the plain form).
SA_HD int32_t bmax(int32_t a, int32_t b, bool& ge) {
#if defined(__CUDA_ARCH__)
  return __vibmax_s32(a, b, &ge);
#else
  ge = a >= b;
  return ge ? a : b;
#endif
}

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

// The state after step t (t >= -1) of a lane x > t of a per-pair fill (the
// cells (x, t - x) above the pair's matrix): every lane of the pair's db
// holds the same, since its query code is still 0, which no db code
// matches, and its left neighbour is such a lane too.  The per-pair modes
// fill starts a warp's lanes from it instead of sweeping that triangle;
// only the IEXT / IOPEN bits of the row-0 cells (x, 0) read it.
template <int MODE>
SA_HD Cell triangle_state(int32_t t, const Scheme& s) {
  Cell c = cell_init(kNegInf);
  c.s2v = 1;
  for (int32_t d = 0; d <= t; ++d) {
    const Pre pre = stream_pre<kDirsNone>(c, s);
    stream_cell<kDirsNone, MODE, false, false>(c, pre, c.H2, pre, 0, false,
                                               false, d, 0, c.s2v, s);
  }
  return c;
}

// ---------------------------------------------------------------------------
// The streamed fills' cell since the warp-ring schedule (nw_affine_stream.cu,
// stream_ring.cuh): the same integers as stream_pre / stream_cell /
// modes_update, each max written with its compare (bmax), the boundary work
// only in a lane that can need it, the codes kept by the caller, and the
// modes' eligibility as one window of steps a lane.
// ---------------------------------------------------------------------------

// stream_pre through bmax.
template <int DIRS>
SA_HD Pre ring_pre(const Cell& c, const Scheme& s) {
  Pre r;
  r.t0 = c.M1 + s.gap_open;
  bool cd;
  r.dsel = bmax(c.D1, r.t0, cd);
  if (DIRS == kDirsFull) {
    r.dflag = (cd ? kDEXT : 0) | (r.t0 >= c.D1 ? kDOPEN : 0);
  } else if (DIRS == kDirsFast4) {
    r.dflag = cd ? 8 : 0;
  } else {
    r.dflag = 0;
  }
  return r;
}

// Whether a lane's query and db codes match (stream_cell's test).
template <bool WILDCARD>
SA_HD bool codes_match(int32_t s1d, int32_t s2v) {
  return WILDCARD ? (s1d & s2v) != 0 : s1d == s2v;
}

// stream_cell for one lane, the codes kept by the caller: eq is
// codes_match of the query code entering the lane (the left lane's s1d, or
// the step's query code at lane 0) and the lane's db code (the step's at
// lane p); ldsel / lflag are the left lane's merged D source and D bits;
// c.s1d and c.s2v are neither read nor written.  ATP / AT0: whether the
// lane can be lane p / lane 0 at all -- when false, atp / at0 are ignored
// and no boundary code is emitted for it; when true, as stream_cell.
// Returns the direction code.
template <int DIRS, int MODE, bool COMPAT, bool ATP, bool AT0>
SA_HD int32_t ring_cell(Cell& c, const Pre& pre, int32_t lH2, int32_t ldsel,
                        int32_t lflag, bool eq, bool at0, bool atp,
                        int32_t p, const Scheme& s) {
  const bool ap = ATP && atp;
  const bool a0 = AT0 && at0;
  int32_t M = lH2 + (eq ? s.match : s.mismatch);
  bool restart = false;
  if (MODE == kModeLocal) {
    bool nonneg;
    M = bmax(M, 0, nonneg);
    restart = !nonneg;
  }
  bool ci;
  int32_t I = bmax(c.I1, pre.t0, ci) + s.gap_extend;
  int32_t D = ldsel + s.gap_extend;
  if (ATP || AT0) {
    if (MODE == kModeGlobal) {
      if (ap) boundary(p, COMPAT, true, s, M, I, D);
      if (a0) boundary(p, COMPAT, false, s, M, I, D);
    } else if (a0 || ap) {
      M = 0;
      I = kNegInf;
      D = kNegInf;
      restart = true;
    }
  }
  // H = max(M, I, D) and its argmax with priority M > I > D: mfirst is
  // M == H, ifirst is I == max(I, D).
  bool ifirst, mfirst;
  const int32_t id = bmax(I, D, ifirst);
  const int32_t H = bmax(M, id, mfirst);
  int32_t code = 0;
  if (DIRS == kDirsFull) {
    code = (mfirst ? kHM : 0) | (I == H ? kHI : 0) | (D == H ? kHD : 0) |
           (ci ? kIEXT : 0) | (pre.t0 >= c.I1 ? kIOPEN : 0) | lflag;
    if (MODE == kModeLocal && restart) code |= kLSTART;
  } else if (DIRS == kDirsFast4) {
    code = (mfirst ? 0 : (ifirst ? 1 : 2)) | (ci ? 4 : 0) | lflag;
  }
  c.H2 = c.H1;
  c.H1 = H;
  c.M1 = M;
  c.I1 = I;
  c.D1 = D;
  return code;
}

// Appends a step's direction code to a lane's word: a shift register, so
// the code of step d lands in nibble d & 7 (fast4) or byte d & 3 (full) of
// the word completed at d | 7 (d | 3) with no shift by the step's position.
// One funnel shift on the card.
template <int DIRS>
SA_HD uint32_t push_code(uint32_t acc, int32_t code) {
  constexpr int kBits = DIRS == kDirsFast4 ? 4 : 8;
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(acc, static_cast<uint32_t>(code), kBits);
#else
  return (acc >> kBits) | (static_cast<uint32_t>(code) << (32 - kBits));
#endif
}

// The window of steps in which a lane's current pair has an eligible cell
// (modes_update's test), set when the lane turns over to the pair at step t
// (t = k*S + x, the pair's cell (x, 0)): the cell of step t' is eligible
// iff (unsigned)(t' - lo) < len.  n2 = -1: no pair.  Local takes
// 1 <= x <= n2, 1 <= y <= n1; semi the last column (x == n2, every y) or
// the last row (y == n1).
template <int MODE>
SA_HD void modes_window(int32_t x, int32_t t, int32_t n1, int32_t n2,
                        int32_t& lo, int32_t& len) {
  if (MODE == kModeLocal) {
    lo = t + 1;
    len = x >= 1 && x <= n2 ? n1 : 0;
  } else if (x == n2) {
    lo = t;
    len = n1 + 1;
  } else {
    lo = t + n1;
    len = x >= 0 && x < n2 ? 1 : 0;
  }
}

// modes_update in a lane's window: bd keeps the step of the best score (the
// pair's diagonal once its slot's first step is subtracted); strict >, so
// each lane keeps its earliest diagonal.
template <int MODE>
SA_HD void modes_track(int32_t t, int32_t lo, int32_t len, int32_t M,
                       int32_t H, int32_t& bv, int32_t& bd) {
  const int32_t score = MODE == kModeLocal ? M : H;
  if (static_cast<uint32_t>(t - lo) < static_cast<uint32_t>(len) &&
      score > bv) {
    bv = score;
    bd = t;
  }
}

}  // namespace sa

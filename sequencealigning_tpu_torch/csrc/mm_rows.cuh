// Per-lane arithmetic and the strip schedule of the Myers-Miller score rows
// (mm_rows.cu), shared with the serial host build (host_check.cpp).
//
// It is ops/mm_align.py::rows_torch (the JAX package's _rows_fn) written
// for one thread's LPT consecutive lanes j = jf .. jf + LPT - 1 of row i:
//
//   DDn[j]  = max(CC[j] + o, DD[j]) + e
//   Mrow[j] = CC[j-1] + (q[i-1] == d[j] ? match : mismatch)
//   B[j]    = max(Mrow[j], DDn[j])
//   E[j]    = max(B[j-1] + o + e, E[j-1] + e),   E[0] = NEG
//   CCn[j]  = max(B[j], E[j])
//
// with column 0 of DD, B and CC set to the chain tb + i*e.  Plain int32
// arithmetic throughout: NEG (-32768) is a number here, not minus infinity
// (row 0's o + j*e passes below it past j ~ 5000, and E[0] = NEG then beats
// real lanes), so nothing is clamped and nothing is masked.  The gap model
// is the standard one (gaps open from H), unlike the reference fills' cells
// of pair_sweep.cuh and nw_affine_tiled.cuh.
//
// The in-row E chain crosses threads and strips as a max-plus scan.  A
// thread's lanes give A, the largest c[k] + (jf + LPT - k) e over its
// c[k] = B[k-1] + o + e (k = jf + 1 .. jf + LPT): E at the next thread's
// first lane is max(E[jf] + LPT e, A).  Taken relative to the strip's first
// lane j0, thread t's key a_t = A_t - (t + 1) LPT e turns that into a plain
// maximum: E[jf(t)] = max(X, a_0 .. a_{t-1}) + t LPT e, X being E[j0] from
// the strip on the left (NEG for strip 0, whose j0 is column 0).  The same
// integers as the torch twin's cummax, since nothing overflows.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

constexpr int kMmWarpLanes = 32;  // threads a strip (one warp)
constexpr int kMmGroup = 32;      // rows a hand-over (a warp lane a row)
constexpr int32_t kMmPadCode = -4;  // db code of lanes past n (never read)

// One sweep of a launch: the whole padded query and db (forward or
// reversed, d left-padded by one) and the subproblem's offsets.
struct MmSweep {
  const int32_t* q;
  const int32_t* d;
  int32_t q_off, m, d_off, tb;
};

// Lanes a strip, strips a sweep.
SA_HD int mm_strip_lanes(int lpt) { return kMmWarpLanes * lpt; }
SA_HD int mm_strips(int n, int lpt) {
  return (n + mm_strip_lanes(lpt)) / mm_strip_lanes(lpt);  // ceil((n+1)/W)
}

// Lanes a thread by the rule: the narrowest of 4, 8, 16 whose two sweeps'
// strips fit one warp a scheduler (4 an SM), else 16.
SA_HD int mm_lanes_per_thread(int n, int sms) {
  for (int lpt = 4; lpt < 16; lpt *= 2) {
    if (2 * mm_strips(n, lpt) <= 4 * sms) return lpt;
  }
  return 16;
}

// Rows a hand-over column keeps (row 0 included) over both sweeps.
SA_HD int mm_bnd_rows(int m_f, int m_r) {
  return (m_f > m_r ? m_f : m_r) + 1;
}

// A launch's scratch, in int32 words: ctr holds [0] the ticket, [1] the
// status word, then a progress count a strip of each sweep; bnd a hand-over
// column a strip of each sweep (mm_bnd_offset).
SA_HD int64_t mm_ctr_words(int n, int lpt) {
  return 2 + 2 * static_cast<int64_t>(mm_strips(n, lpt));
}
SA_HD int64_t mm_bnd_words(int n, int m_f, int m_r, int lpt) {
  return 2 * static_cast<int64_t>(mm_strips(n, lpt)) * 2 *
         mm_bnd_rows(m_f, m_r);
}

// Ticket t: sweep t & 1, strip t >> 1 (a strip always after the one on
// its left, so a wait is on a strip some running warp already holds).
SA_HD int mm_ticket_sweep(int t) { return t & 1; }
SA_HD int mm_ticket_strip(int t) { return t >> 1; }

// The hand-over column of (sweep, strip): cc at [0, rows), the strip's last
// lane's CC on row i; x at [rows, 2 rows), E at the next strip's first lane
// on row i.  rows = max(m) + 1 over both sweeps.
SA_HD int64_t mm_bnd_offset(int sweep, int strip, int nstrips, int rows) {
  return (static_cast<int64_t>(sweep) * nstrips + strip) * 2 * rows;
}

// Row 0 of lane j.
SA_HD int32_t mm_cc0(int32_t j, const Scheme& s) {
  return j == 0 ? 0 : s.gap_open + j * s.gap_extend;
}

// The lane's db code (kMmPadCode past n).
SA_HD int32_t mm_dcode(const MmSweep& w, int32_t j, int32_t n) {
  return j <= n ? w.d[w.d_off + j] : kMmPadCode;
}

// Row i before the scan, for the thread whose first lane is jf: DD becomes
// row i's (in place), B gets row i's B; CC still holds row i-1, cc_left is
// row i-1's CC at jf - 1 (any value at column 0).  Returns A.
template <int LPT>
SA_HD int32_t mm_pre(const int32_t* CC, int32_t* DD, int32_t* B,
                     const int32_t* dc, int32_t qc, int32_t cc_left,
                     bool col0, int32_t chain, const Scheme& s) {
  const int32_t oe = s.gap_open + s.gap_extend;
  int32_t A = 0;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    int32_t ddn = imax(CC[k] + s.gap_open, DD[k]) + s.gap_extend;
    const int32_t left = k == 0 ? cc_left : CC[k - 1];
    const int32_t mrow = left + (dc[k] == qc ? s.match : s.mismatch);
    int32_t b = imax(mrow, ddn);
    if (k == 0 && col0) {
      ddn = chain;
      b = chain;
    }
    DD[k] = ddn;
    B[k] = b;
    A = k == 0 ? b + oe : imax(A + s.gap_extend, b + oe);
  }
  return A;
}

// Thread t's scan key, and E at its first lane from the exclusive maximum
// of the keys left of it (X included).
SA_HD int32_t mm_key(int32_t A, int t, int lpt, const Scheme& s) {
  return A - (t + 1) * lpt * s.gap_extend;
}
SA_HD int32_t mm_e_first(int32_t excl, int t, int lpt, const Scheme& s) {
  return excl + t * lpt * s.gap_extend;
}

// Row i after the scan: CC becomes row i's from B and E (E[jf] given).
template <int LPT>
SA_HD void mm_post(int32_t* CC, const int32_t* B, int32_t e_first, bool col0,
                   int32_t chain, const Scheme& s) {
  const int32_t oe = s.gap_open + s.gap_extend;
  int32_t E = e_first;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    if (k > 0) E = imax(E + s.gap_extend, B[k - 1] + oe);
    CC[k] = imax(B[k], E);
  }
  if (col0) CC[0] = chain;
}

}  // namespace sa

// Per-lane arithmetic, the wavefront step and the level schedule of the
// Myers-Miller score rows (mm_rows.cu), shared with the serial host build
// (host_check.cpp).
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
// The in-row E chain runs through the lanes in order, one add-max a lane:
// the torch twin's cummax(c - j*e) + j*e is the same maximum of
// c[k] + (j - k) e, and nothing overflows, so the integers are equal.
//
// A wavefront inside each strip (a warp, 32 threads x LPT lanes): at step
// g thread t computes row i = g - t.  What it needs from its left
// neighbour, E at its first lane on row i and CC at jf - 1 on row i - 1,
// thread t - 1 computed on its previous steps, so they come over one
// shuffle each; the row's query code moves one thread along the warp a
// step.  The strip's first thread takes them from the strip on its left: a
// hand-over column, a row's CC and E each in a 64-bit word with the row's
// tag (mm_pack), so a word read is either the row's or visibly not yet
// written.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

constexpr int kMmWarpLanes = 32;  // threads a strip (one warp)
constexpr int kMmAhead = 8;       // steps ahead the first thread's loads go
constexpr int32_t kMmPadCode = -4;  // db code of lanes past n (never read)

// A level's node table, int64 a cell, kMmCols a node: the caller's two
// sweeps (query offset, rows, db offset, column-0 chain base; forward, then
// reverse) and the node's columns - 1, then the launch's plan
// (mm_plan_level): strips, first ticket, first hand-over word (64-bit),
// rows a hand-over column, first output word.
enum {
  kMmQOffF, kMmMF, kMmDOffF, kMmTbF, kMmQOffR, kMmMR, kMmDOffR, kMmTbR,
  kMmN, kMmStrips, kMmTicket0, kMmBnd0, kMmRows, kMmOut0,
  kMmCols = 16
};

// One sweep of a node: the whole padded query and db (forward or reversed,
// d left-padded by one) and the subproblem's offsets.
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

// Warps an SM the launch's grid holds (kMmWarpsPerSm x SMs, strips by
// ticket over them).
constexpr int kMmWarpsPerSm = 8;

// Lanes a thread.  A step is ~10 integer instructions a lane plus a fixed
// part (the shuffles, the first thread's words, the last thread's stores),
// issued in order by one warp, and a strip starts ~50-70 steps after its
// left one.  Measured on an H100 over every level of the ~6 kb and 100 kb
// escapes (csrc/stream_sweep.py --mm), 16 lanes a thread was the fastest
// of 8 to 32 or within ~4% of it on each level.  A level whose strips
// outnumber the grid's warps stays correct: a warp takes its next ticket
// only when its strip is done, and waits only on a lower ticket, which a
// running warp holds or has finished.
constexpr int kMmLanesPerThread = 16;

// The table's columns a caller fills and reads, for its planner: the
// columns a node, the first of each sweep's four (q_off, m, d_off, tb),
// the node's columns - 1, its first ticket and its first output word.
SA_HD void mm_table_cols(int64_t* cols) {
  cols[0] = kMmCols;
  cols[1] = kMmQOffF;
  cols[2] = kMmQOffR;
  cols[3] = kMmN;
  cols[4] = kMmTicket0;
  cols[5] = kMmOut0;
}

// Fills the plan columns of a level's table at lpt lanes a thread and
// words: [0] the int32 words of ctr (the ticket and the status word), [1]
// those of bnd (a hand-over column a strip of each sweep, two 64-bit words
// a row), [2] those of out (the four rows of each node, n + 1 each), [3]
// the tickets.  False for a node with a negative size or offset.
SA_HD bool mm_plan_level(int64_t* table, int count, int lpt,
                         int64_t* words) {
  int64_t ticket = 0, bnd = 0, out = 0;
  for (int k = 0; k < count; ++k) {
    int64_t* r = table + k * kMmCols;
    for (int c = kMmQOffF; c <= kMmN; ++c) {
      if (c != kMmTbF && c != kMmTbR && r[c] < 0) return false;
    }
    const int S = mm_strips(static_cast<int>(r[kMmN]), lpt);
    // Rows 0 .. max(m) of a column, and one more that a sweep without rows
    // reads ahead of (never checked).
    const int64_t rows = (r[kMmMF] > r[kMmMR] ? r[kMmMF] : r[kMmMR]) + 2;
    r[kMmStrips] = S;
    r[kMmTicket0] = ticket;
    r[kMmBnd0] = bnd;
    r[kMmRows] = rows;
    r[kMmOut0] = out;
    ticket += 2 * S;
    bnd += 2 * static_cast<int64_t>(S) * 2 * rows;
    out += 4 * (r[kMmN] + 1);
  }
  words[0] = 2;
  words[1] = 2 * bnd;
  words[2] = out;
  words[3] = ticket;
  return true;
}

// What a ticket's warp works on: ticket t is node k's (sweep (t - t0) & 1,
// strip (t - t0) >> 1), so a strip always comes after the one on its left
// and a wait is on a strip some running warp already holds.  my / left:
// the hand-over columns, in 64-bit words (left < 0 for strip 0); out: the
// sweep's CC row (DD n + 1 words on).
struct MmStrip {
  MmSweep w;
  int32_t n, strip, rows;
  int64_t my, left, out;
};

SA_HD MmStrip mm_strip_at(const int64_t* table, int count, int t,
                          const int32_t* qf, const int32_t* qr,
                          const int32_t* df, const int32_t* dr) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {  // the last node whose first ticket is <= t
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * kMmCols + kMmTicket0] <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int64_t* r = table + lo * kMmCols;
  const int local = t - static_cast<int>(r[kMmTicket0]);
  const int sweep = local & 1;
  const int base = sweep ? kMmQOffR : kMmQOffF;
  MmStrip s;
  s.w.q = sweep ? qr : qf;
  s.w.d = sweep ? dr : df;
  s.w.q_off = static_cast<int32_t>(r[base]);
  s.w.m = static_cast<int32_t>(r[base + 1]);
  s.w.d_off = static_cast<int32_t>(r[base + 2]);
  s.w.tb = static_cast<int32_t>(r[base + 3]);
  s.n = static_cast<int32_t>(r[kMmN]);
  s.strip = local >> 1;
  s.rows = static_cast<int32_t>(r[kMmRows]);
  const int S = static_cast<int>(r[kMmStrips]);
  s.my = r[kMmBnd0] + (static_cast<int64_t>(sweep) * S + s.strip) * 2 * s.rows;
  s.left = s.strip > 0 ? s.my - 2 * s.rows : -1;
  s.out = r[kMmOut0] + 2 * sweep * (r[kMmN] + 1);
  return s;
}

// A hand-over word: a row's value and its tag (the row + 1; the column is
// zeroed before the launch, so a word not yet written reads tag 0).  Row
// i's CC is word 2i of its column, E at the next strip's first lane word
// 2i + 1.
SA_HD uint64_t mm_pack(int32_t v, int32_t row) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(row + 1)) << 32) |
         static_cast<uint32_t>(v);
}
SA_HD int32_t mm_value(uint64_t w) { return static_cast<int32_t>(w); }
SA_HD bool mm_holds(uint64_t w, int32_t row) {
  return static_cast<int32_t>(w >> 32) == row + 1;
}

// Row 0 of lane j.
SA_HD int32_t mm_cc0(int32_t j, const Scheme& s) {
  return j == 0 ? 0 : s.gap_open + j * s.gap_extend;
}

// The lane's db code (kMmPadCode past n).
SA_HD int32_t mm_dcode(const MmSweep& w, int32_t j, int32_t n) {
  return j <= n ? w.d[w.d_off + j] : kMmPadCode;
}

// The row thread t computes at step g (active while 1 <= i <= m).
SA_HD int mm_row_at(int g, int t) { return g - t; }

// Row i of the thread whose first lane is jf, in place: CC and DD hold row
// i-1 and become row i's.  cc_left is row i-1's CC at jf - 1 and e_in E at
// jf on row i (any value and NEG at column 0).  Returns E at jf + LPT on
// row i, what the next thread (or strip) takes as its e_in.
template <int LPT>
SA_HD int32_t mm_step(int32_t* CC, int32_t* DD, const int32_t* dc,
                      int32_t qc, int32_t cc_left, int32_t e_in, bool col0,
                      int32_t chain, const Scheme& s) {
  const int32_t oe = s.gap_open + s.gap_extend;
  int32_t left = cc_left, E = e_in, b_prev = 0;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    int32_t ddn = add_max(CC[k], s.gap_open, DD[k]) + s.gap_extend;
    const int32_t mrow = left + (dc[k] == qc ? s.match : s.mismatch);
    int32_t b = imax(mrow, ddn);
    if (k == 0 && col0) {
      ddn = chain;
      b = chain;
    }
    if (k > 0) E = add_max(E, s.gap_extend, b_prev + oe);
    left = CC[k];
    DD[k] = ddn;
    CC[k] = imax(b, E);
    b_prev = b;
  }
  if (col0) CC[0] = chain;
  return add_max(E, s.gap_extend, b_prev + oe);
}

}  // namespace sa

// Per-cell arithmetic and the strip schedule of the tiled score-only Gotoh
// fill, shared by the CUDA kernels (nw_affine_tiled.cu) and the serial host
// build (host_check.cpp).
//
// The cell is ops/nw_affine_tiled.py::_tile_step written for one lane: the
// strip holds cells x = x0 + lane of the db axis, step g holds y = g - lane;
// the merged-roll Gotoh recurrence of _stream_step inside the strip, lane 0
// fed by the carried boundary column (H and max(M + o, D) at x0 - 1)
// instead of a left neighbour, and the y = 0 chain written where lane == g.
// The boundary column of strip 0 is the x = 0 column in closed form
// (_boundary0); every later strip's is the previous strip's last lane,
// published row by row into a ring slot in global memory.
//
// The schedule's index math (which strip a ticket is, when a strip waits
// for which counter, which ring slot it reads and writes) lives here too,
// so the host build runs the kernels' schedule serially through it.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

// ---------------------------------------------------------------------------
// Cell arithmetic (Hopper's DPX instructions on the card through
// nw_affine_stream.cuh's add_max / max3, the same integers from plain
// maxima on the host)
// ---------------------------------------------------------------------------

// What a lane hands its right neighbour for D: max(M1 + o, D1), from its
// state before the step (stream_pre's dsel).
SA_HD int32_t tile_dsel(int32_t M1, int32_t D1, const Scheme& s) {
  return add_max(M1, s.gap_open, D1);
}

// Whether a lane's query and db codes match: q and d hold nibble codes
// (io.encode's), the lane's in the bits of mask; so the kernels compare a
// thread's lanes packed 4 bits a lane in one register, one LOP3 a lane.
// Wildcard: the codes' bits intersect; else they are equal.
template <bool WILDCARD>
SA_HD bool tile_eq(uint32_t q, uint32_t d, uint32_t mask) {
  return WILDCARD ? (q & d & mask) != 0 : ((q ^ d) & mask) == 0;
}

// The x = 0 boundary column at row y (_boundary0): M, D and H.  Compat
// keeps the chain o + (y+1)e in D, textbook o + y*e in I (D stays -inf, H
// sees it); y < 0 (the row before the first) is -inf everywhere.  H is the
// maximum of the three planes, so a chain below kNegInf leaves H at
// kNegInf, as in the other fills and the scalar oracle.
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
  H = imax(compat ? D : s.gap_open + y * s.gap_extend, kNegInf);
}

// A boundary column row as it is carried: H(y) and max(M(y) + o, D(y)),
// two int32 a row (col[2y], col[2y + 1]).  Reads on the card bypass L1
// (another SM wrote the row during this launch).
SA_HD int32_t col_load(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

// What the strip's lane 0 reads at the step holding row y: the query code
// y - 1 (0 outside 1 <= y <= L1, as the zero-padded query), and the carried
// boundary column's H(y - 1) and max(M(y) + o, D(y)) -- the values a left
// neighbour would hand over.  Strip 0 (col == nullptr) takes the closed
// form; a later strip reads the column (rows 0..n1 of the previous strip's
// last lane) and -inf past row n1 (those cells never reach the corner).
// q: the pair's query codes.
SA_HD void tile_stage_row(int32_t y, int32_t n1, int L1, const int32_t* q,
                          const int32_t* col, bool compat, const Scheme& s,
                          int32_t& qc, int32_t& hb, int32_t& od) {
  qc = y >= 1 && y <= L1 ? q[y - 1] : 0;
  if (col == nullptr) {
    int32_t m_, d_, mb, db;
    tile_boundary0(y - 1, compat, s, m_, d_, hb);
    tile_boundary0(y, compat, s, mb, db, d_);
    od = imax(mb + s.gap_open, db);
    return;
  }
  hb = y >= 1 && y - 1 <= n1 ? col_load(col + 2 * (y - 1)) : kNegInf;
  od = y >= 0 && y <= n1 ? col_load(col + 2 * y + 1)
                         : imax(kNegInf + s.gap_open, kNegInf);
}

// One cell of a strip step: updates the lane's M1, I1, D1 in place and
// returns its H.  eq: the lane's query code (the left neighbour's before
// the step) matches its db code; lH2, ldsel: the left neighbour's H two
// steps back and max(M1 + o, D1) before the step (for the strip's lane 0,
// the staged boundary row: H(y-1) and max(M(y) + o, D(y))).  atg: this lane
// holds cell (xg, 0), whose x-chain boundary (compat in I with one extra
// extension, textbook in D) overrides the recurrence.  I = max(M1 + o, I1)
// + e is one VIADDMAX after the add, H one VIMNMX3.
template <bool COMPAT>
SA_HD int32_t tile_cell(bool eq, int32_t lH2, int32_t ldsel, bool atg,
                        int32_t xg, int32_t& M1, int32_t& I1, int32_t& D1,
                        const Scheme& s) {
  int32_t M = lH2 + (eq ? s.match : s.mismatch);
  int32_t I = add_max(M1, s.gap_open + s.gap_extend, I1 + s.gap_extend);
  int32_t D = ldsel + s.gap_extend;
  if (atg) {
    M = kNegInf;
    I = COMPAT ? s.gap_open + (xg + 1) * s.gap_extend : kNegInf;
    D = COMPAT ? kNegInf : s.gap_open + xg * s.gap_extend;
  }
  M1 = M;
  I1 = I;
  D1 = D;
  return max3(M, I, D);
}

// ---------------------------------------------------------------------------
// The strip schedule
// ---------------------------------------------------------------------------

// A pair's db axis is cut into strips of W lanes; strip s holds x = s*W + 1
// .. s*W + W.  A work item is one (pair, strip); the items are handed out
// in ticket order, strip-major ((s, b) sorted), so every strip's producer
// (strip s - 1 of its pair) holds an earlier ticket.  items: (n, 3) int32
// rows (pair b, strip s, gs), gs the strip's index in the launch's strip
// counters (a pair's strips are consecutive there).
struct StripItem {
  int b, s, gs;
};

SA_HD StripItem strip_item(const int32_t* items, int ticket) {
  StripItem it;
  it.b = items[3 * ticket];
  it.s = items[3 * ticket + 1];
  it.gs = items[3 * ticket + 2];
  return it;
}

// Strips of a pair with n2 db positions (0 for n2 <= 0: the host's closed
// form).
SA_HD int strip_count(int32_t n2, int W) {
  return n2 > 0 ? (n2 + W - 1) / W : 0;
}

// The ring slot strip s of pair b writes (strip s + 1 reads it): K slots a
// pair, each 2 * nrow int32.
SA_HD size_t strip_slot(int b, int s, int K, int nrow) {
  return (static_cast<size_t>(b) * K + s % K) * 2 * static_cast<size_t>(nrow);
}

// The strip's steps: n1 + W (its last lane reaches row n1), or, for the
// pair's last strip, up to the corner's step gcap = n2 - x0 + n1.
SA_HD int strip_steps(int32_t n1, int32_t n2, int x0, int W, bool last) {
  return last ? n2 - x0 + n1 + 1 : n1 + W;
}

// Rows of the producer's column the consumer needs published before it
// stages the R steps from g: rows 0..g+R-1 (H(y-1) and max(M(y)+o, D(y))
// for y < g + R), none past n1 (the producer never writes them).
SA_HD int chunk_rows_needed(int g, int R, int32_t n1) {
  return g + R < n1 + 1 ? g + R : n1 + 1;
}

// The value a producer publishes after writing column row y: rows 0..y are
// in place.  It publishes at every R-th row (R a power of two, 2-128) and
// at row n1; -1 otherwise.
SA_HD int chunk_publish(int y, int R, int32_t n1) {
  return ((y + 1) & (R - 1)) == 0 || y == n1 ? y + 1 : -1;
}

// A consumer that staged the R steps from g publishes g + R: it will read
// no row below g + R - 1 again (H(y - 1) at y = g + R).  kStripDone when
// its strip is finished.
constexpr int32_t kStripDone = 0x3fffffff;
SA_HD int chunk_consumed(int g, int R) { return g + R; }

// What a producer writing its ring slot during the R steps from g must
// see from the slot's last reader (strip s - K + 1 of its pair, the reader
// of strip s - K's column): consumed >= the highest row it writes + 2.
// 0 when it needs nothing (no reader yet, s < K; or no rows this chunk).
SA_HD int ring_rows_needed(int g, int R, int W, int32_t n1, int s, int K) {
  if (s < K) return 0;
  const int y_hi = g + R - W < n1 ? g + R - W : n1;
  return y_hi >= 0 ? y_hi + 2 : 0;
}

// ---------------------------------------------------------------------------
// The shard schedule (sa_tiled_shard_fill: one pair's db axis over several
// launches, one a device of a mesh)
// ---------------------------------------------------------------------------

// A pair's db axis is cut into segments of seg_strips strips (a segment is
// the W lanes a device owns in one round of parallel/seqpar.py); segment k
// runs in launch k % D, so a launch holds segments d, d + D, d + 2D, ...
// of every pair.  A strip's carried column comes from the previous strip:
// inside a segment through a whole column in the launch's own memory (by
// the strip's index gs in the launch's counters, the producer's at gs - 1),
// across segments through a boundary buffer in the consumer's memory,
// which the producer (another launch, perhaps on another card) writes.
// A boundary buffer is kShardHead int32 -- [0] the rows published, the
// rest padding -- and then the column's 2 * nrow int32.  bufs: (B * nseg)
// addresses, the buffer entering segment k of pair b at b * nseg + k (0
// for k = 0, whose column is the closed form).
constexpr int kShardHead = 32;

// Where a strip's lane 0 reads its column and where its last lane writes
// the next one: the column (nullptr: the closed form, resp. no next strip)
// and the word counting its published rows, and whether that word lies in
// a boundary buffer (written across launches) or in the launch's counters.
struct StripIO {
  const int32_t* cin;
  const int32_t* cin_rows;
  bool cin_peer;
  int32_t* cout;
  int32_t* cout_rows;
  bool cout_peer;
};

SA_HD int32_t* shard_buf(const int64_t* bufs, int b, int k, int nseg) {
  return reinterpret_cast<int32_t*>(
      static_cast<uintptr_t>(bufs[static_cast<size_t>(b) * nseg + k]));
}

// The strip's column hand-over in a shard launch: col holds a whole column
// (2 * nrow int32) per strip of the launch, by gs; prog the launch's
// published-row counts, by gs.  last: the pair's last strip.
SA_HD StripIO shard_strip_io(const StripItem& it, bool last, int seg_strips,
                             int nseg, const int64_t* bufs, int32_t* col,
                             int32_t* prog, int nrow) {
  StripIO io;
  const int k = it.s / seg_strips;
  const int j = it.s - k * seg_strips;
  const size_t span = 2 * static_cast<size_t>(nrow);
  io.cin = nullptr;
  io.cin_rows = nullptr;
  io.cin_peer = false;
  if (it.s > 0 && j == 0) {
    int32_t* buf = shard_buf(bufs, it.b, k, nseg);
    io.cin = buf + kShardHead;
    io.cin_rows = buf;
    io.cin_peer = true;
  } else if (it.s > 0) {
    io.cin = col + (it.gs - 1) * span;
    io.cin_rows = prog + it.gs - 1;
  }
  io.cout = nullptr;
  io.cout_rows = nullptr;
  io.cout_peer = false;
  if (!last && j == seg_strips - 1) {
    int32_t* buf = shard_buf(bufs, it.b, k + 1, nseg);
    io.cout = buf + kShardHead;
    io.cout_rows = buf;
    io.cout_peer = true;
  } else if (!last) {
    io.cout = col + it.gs * span;
    io.cout_rows = prog + it.gs;
  }
  return io;
}

}  // namespace sa

#if defined(__CUDACC__)
namespace sa {

// ---------------------------------------------------------------------------
// The hand-over between CTAs of one launch (device code only; the banded
// fill's tiles use it too): release stores of a progress count, acquire
// waits on it, and the spin limit that turns a schedule that cannot be met
// into an error instead of a hang.
// ---------------------------------------------------------------------------

constexpr int kSmWords = 8;  // SM bitmap words a pair (256 SMs)
constexpr unsigned kSpinLimit = 1u << 22;
constexpr int kErrStalled = 1;

__device__ __forceinline__ int32_t ld_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int32_t v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The same at system scope, for a count another launch reads -- perhaps
// on another card, writing into this card's memory through peer access
// (the shard fill's boundary buffers).
__device__ __forceinline__ int32_t ld_acquire_sys(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.sys.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(int32_t* p, int32_t v) {
  asm volatile("st.release.sys.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

template <bool SYS>
__device__ __forceinline__ int32_t ld_acquire_at(const int32_t* p) {
  return SYS ? ld_acquire_sys(p) : ld_acquire(p);
}

// Waits until *p >= target, sleeping sleep_ns between polls.  False when
// the launch's status is set, or the value stalls for kSpinLimit polls
// (then this wait sets it).  SYS: *p is written by another launch.
template <bool SYS = false>
__device__ __forceinline__ bool wait_at_least(const int32_t* p,
                                              int32_t target,
                                              int32_t* status,
                                              unsigned sleep_ns = 256) {
  int32_t last = ld_acquire_at<SYS>(p);
  unsigned stall = 0;
  while (last < target) {
    if (*reinterpret_cast<volatile int32_t*>(status) != 0) return false;
    if (++stall > kSpinLimit) {
      atomicCAS(status, 0, kErrStalled);
      return false;
    }
    __nanosleep(sleep_ns);
    const int32_t v = ld_acquire_at<SYS>(p);
    if (v != last) {
      last = v;
      stall = 0;
    }
  }
  return true;
}

// Marks the SM running this CTA in a pair's bitmap (kSmWords words).
__device__ __forceinline__ void mark_sm(uint32_t* sms) {
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  atomicOr(sms + (smid / 32) % kSmWords, 1u << (smid % 32));
}

}  // namespace sa
#endif

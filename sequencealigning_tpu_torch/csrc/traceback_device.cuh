// The device walks' per-step rules, shared by the CUDA kernels
// (traceback_device.cu) and the serial host build (host_check.cpp).
//
// walk_step is ops/traceback_device.py::_plane_step for one pair, and on
// the fast4 code (x+y-1) & 7 of banded_word's word the host walker
// ops/traceback.py::banded_diag_fast4_traceback_pair (a read outside the
// band gives code 0 and the walk advances); walk_fast4_staged is
// ops/traceback_device.py::_walk_fast4_impl for one pair, walk_modes_staged
// _walk_modes_impl, both over the staged schedule below.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define SA_HD __host__ __device__ __forceinline__
#define SA_HDM __host__ __device__ __forceinline__
#else
#define SA_HD static inline
#define SA_HDM inline
#endif

namespace sa {

// Walk planes: 0 = M, 1 = I, 2 = D, 3 = pending (the plane comes from the
// next cell's H-argmax code; set only after a diagonal move).
constexpr int32_t kPend = 3;

// nib: the fast4 code of cell (x, y).  Returns the op code (0 = stop,
// 1 = M, 2 = I, 3 = D) and moves (x, y, plane).  At x == 0 the only move is
// I, at y == 0 it is D; at the origin the walk stops.  STD walks the
// any-state-open model (the banded fill's model "std"): a gap open goes to
// the pending plane, resolved from the next cell's code, instead of M.
template <bool STD = false>
SA_HD uint32_t walk_step(uint32_t nib, int32_t& x, int32_t& y,
                         int32_t& plane) {
  if (plane == kPend) {
    const int32_t code = static_cast<int32_t>(nib & 3u);
    plane = code < 2 ? code : 2;
  }
  const bool at_x0 = x == 0;
  const bool at_y0 = y == 0;
  if (at_x0 && at_y0) return 0;
  const int32_t eff = at_x0 ? 1 : (at_y0 ? 2 : plane);
  if (eff == 0) {
    plane = kPend;
  } else if (eff == 1) {
    plane = (nib & 4u) ? 1 : (STD ? kPend : 0);
  } else {
    plane = (nib & 8u) ? 2 : (STD ? kPend : 0);
  }
  x -= (eff == 0 || eff == 2) ? 1 : 0;
  y -= (eff == 0 || eff == 1) ? 1 : 0;
  return static_cast<uint32_t>(eff + 1);
}

// The band lane of cell (x, y) in the banded fill's wavefront layout
// (ops/nw_banded_diag.py): (y - x - k_lo_even) >> 1, an arithmetic shift,
// floor division as Python's >> on negative values.
SA_HD int32_t band_lane(int32_t x, int32_t y, int32_t k_lo_even) {
  return (y - x - k_lo_even) >> 1;
}

// Word dirs[r, b, lane] of the (W, NB, L) tensor, 0 outside the band or the
// tensor (the host walker's rule).
SA_HD uint32_t banded_word(const uint32_t* dirs, int W, int NB, int L,
                           size_t b, int32_t r, int32_t lane) {
  if (lane < 0 || lane >= L || r < 0 || r >= W) return 0;
  return dirs[(static_cast<size_t>(r) * NB + b) * L + lane];
}

// The banded walk's staged window (traceback_device.cu; host_check.cpp runs
// it serially).  One 128-byte row segment dirs[r, b, lo .. lo + 32) holds
// 8 anti-diagonals x 32 band lanes; a step lowers a = x + y - 1 by 1 or 2
// (so the row r = a >> 3 by at most one) and moves the band lane by at most
// one (an M move keeps it), so the walk stays some steps in a row and near
// its lane.  Rows are staged in batches of kWalkDepth: batch m holds rows
// m * kWalkDepth .. + kWalkDepth - 1, row r in slot r % (2 * kWalkDepth) of
// a ring of two batches, each row the 32 lanes from window_at(the walk's
// lane when the batch was staged).  The seed's batch and the one below are
// staged at the start, from the seed's lane; when the walk enters batch m,
// batch m - 1 goes into the slots of batch m + 1, which it has left, from
// the lane the walk should be in halfway through batch m - 1 if it keeps
// its drift (its lane on entering batch m, plus 1.5 times the lanes it
// moved over batch m + 1): a long gap moves the walk half a lane a step,
// 32 lanes a batch, which a window centred on its lane would lose.  Rows
// past the tensor are staged as zeros.  The walk reads lanes lo .. lo +
// win - 1 of a row from the stage; a word of another lane of the band is a
// direct load (the slow path); a lane outside the band reads 0 as
// banded_word does.  The walk keeps the word it read while it stays in
// the row and the lane.  Where x or y reaches 0 every move left is forced
// (I at x == 0, D at y == 0), so the rest of the walk reads no word.
constexpr int kWalkWindow = 32;  // lanes a staged row (a warp's 128 bytes)
constexpr int kWalkDepth = 8;    // rows a staged batch

// The first lane of the window around `center`: win / 2 below it, rounded
// down to a multiple of 4 lanes (a 16-byte copy boundary), within the band
// of L >= kWalkWindow lanes.
SA_HD int32_t window_at(int32_t center, int win, int L) {
  const int32_t lo = (center - win / 2) & ~3;
  return lo < 0 ? 0 : lo > L - kWalkWindow ? L - kWalkWindow : lo;
}

// The window's lanes read from the stage (0 the default, kWalkWindow);
// false when out of 1..kWalkWindow.
SA_HD bool walk_window(int& win) {
  if (win == 0) win = kWalkWindow;
  return win >= 1 && win <= kWalkWindow;
}

// One interior step (x > 0 and y > 0) of walk_step on the fast4 code nib:
// the same moves, written for the banded walk's dependent chain.
template <bool STD>
SA_HD uint32_t walk_step_interior(uint32_t nib, int32_t& x, int32_t& y,
                                  int32_t& plane) {
  const int32_t code = static_cast<int32_t>(nib & 3u);
  const int32_t eff = plane == kPend ? (code < 2 ? code : 2) : plane;
  const bool ext = (nib >> (eff + 1)) & 1u;  // bit 2 on I, bit 3 on D
  plane = eff == 0 ? kPend : (ext ? eff : (STD ? kPend : 0));
  x -= eff != 1;
  y -= eff != 2;
  return static_cast<uint32_t>(eff + 1);
}

SA_HD int clz32(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __clz(u);
#else
  return u ? __builtin_clz(u) : 32;
#endif
}

// The banded walk's moves from its interior cell (x, y), a = x + y - 1, on
// v, the word of the cell's row and band lane.  On a pending plane, the
// run of M moves the word holds from the cell down (the cells at a, a - 2,
// ... of this lane whose codes are 0, at most 4, at most min(x, y)): an M
// move keeps the lane and the pending plane, so walk_step would take them
// one at a time to the same end.  Otherwise one walk_step.  Returns the
// number of moves k and their op codes in bits, 2 bits each in order.
template <bool STD>
SA_HD int walk_banded_moves(uint32_t v, int32_t a, int32_t& x, int32_t& y,
                            int32_t& plane, uint32_t& bits) {
  const int p = a & 7;  // the cell's nibble in v
  if (plane == kPend) {
    // Bit 4j of z: nibble j's code is 0.  Shifted so that nibbles p, p - 2,
    // p - 4, p - 6 sit at bits 28, 20, 12, 4; u marks where the run stops.
    const uint32_t z = ~(v | (v >> 1)) & 0x11111111u;
    const uint32_t u = ~(z << (28 - 4 * p)) & 0x10101010u;
    int k = u ? (clz32(u) - 3) >> 3 : 4;
    const int32_t room = x < y ? x : y;
    k = k < room ? k : room;
    if (k > 0) {
      x -= k;
      y -= k;
      bits = 0x55u & ((1u << (2 * k)) - 1u);
      return k;
    }
  }
  bits = walk_step_interior<STD>((v >> (4 * p)) & 0xFu, x, y, plane);
  return 1;
}

// Appends k <= 16 op codes (bits, 2 each) to a walk's packed output at
// step i: the word in progress in `word`, whole words stored to out[w++].
SA_HD void emit_ops(uint32_t bits, int k, int& i, int& w, uint32_t& word,
                    uint32_t* out) {
  const int used = i & 15;
  word |= bits << (2 * used);
  i += k;
  if (used + k >= 16) {
    out[w++] = word;
    word = used ? bits >> (2 * (16 - used)) : 0;
  }
}

// Appends n op codes `code` to a walk's packed output at step i (as
// emit_ops).
SA_HD void emit_run(uint32_t code, int32_t n, int& i, int& w, uint32_t& word,
                    uint32_t* out) {
  const uint32_t pat = code * 0x55555555u;
  while (n > 0) {
    const int take = n < 16 - (i & 15) ? n : 16 - (i & 15);
    emit_ops(take == 16 ? pat : pat & ((1u << (2 * take)) - 1u), take, i, w,
             word, out);
    n -= take;
  }
}

// Appends k <= 32 op codes `code` to a walk's packed output at step i (as
// emit_run, written without its loop: a staged walk's run of M moves).
SA_HD void emit_run32(uint32_t code, int k, int& i, int& w, uint32_t& word,
                      uint32_t* out) {
  const uint32_t pat = code * 0x55555555u;
  const int used = i & 15;
  const int end = used + k;  // 1 .. 47 codes from the word's start
  const int first = end < 16 ? end : 16;
  word |= (pat << (2 * used)) & (first == 16 ? ~0u : (1u << (2 * first)) - 1u);
  i += k;
  if (end >= 16) {
    out[w++] = word;
    if (end >= 32) out[w++] = pat;
    const int rest = end & 15;
    word = rest ? pat & ((1u << (2 * rest)) - 1u) : 0u;
  }
}

// The modes walk's plane for a cell with no H-plane bit (a corrupt fill).
constexpr int32_t kBroken = 4;

// One step of the textbook-modes walk on the full direction byte of cell
// (x, y).  A pending plane resolves from the H bits, priority M > I > D
// (kBroken when none is set).  Then, while st == 0: broken (kBroken plane or
// x/y below 0) sets st = 2, else the stop rule sets st = 1 (semi: x == 0 or
// y == 0; local: an M-plane LSTART cell); broken wins over stop.  A walk that
// has stopped emits 0 and moves no more; otherwise the op code is plane + 1
// (1 = M, 2 = I, 3 = D) and the walk moves, an M move leaving the plane
// pending, an I or D move staying on IEXT / DEXT.
template <bool LOCAL>
SA_HD uint32_t walk_modes_step(uint32_t byte, int32_t& x, int32_t& y,
                               int32_t& plane, int32_t& st) {
  if (plane == kPend) {
    plane = (byte & 1u) ? 0 : (byte & 2u) ? 1 : (byte & 4u) ? 2 : kBroken;
  }
  const bool stop_now =
      LOCAL ? (plane == 0 && (byte & 128u) != 0) : (x == 0 || y == 0);
  const bool broken = plane == kBroken || x < 0 || y < 0;
  if (st == 0) st = broken ? 2 : (stop_now ? 1 : 0);
  if (st != 0) return 0;
  const uint32_t op = static_cast<uint32_t>(plane + 1);
  const bool step_x = plane == 0 || plane == 2;
  const bool step_y = plane == 0 || plane == 1;
  if (plane == 0) {
    plane = kPend;
  } else if (plane == 1) {
    plane = (byte & 8u) ? 1 : 0;
  } else {
    plane = (byte & 32u) ? 2 : 0;
  }
  x -= step_x ? 1 : 0;
  y -= step_y ? 1 : 0;
  return op;
}

// ---------------------------------------------------------------------------
// The fast4 and modes walks' staged schedule (traceback_device.cu runs it a
// warp a pair; host_check.cpp runs it serially, the warp's lanes in a loop).
//
// Layout: cell (x, y) of a pair at (row, off) lies in word-row r = d >> SHIFT
// of dirs (NW, R, P), d = x + y + off, lane x, code d & (2^SHIFT - 1) of the
// word (fast4: SHIFT 3, a nibble; modes: SHIFT 2, a byte).  An M move lowers
// x by 1 and d by 2, so on the walk's DP diagonal k = y - x its lane is
// x = (d - off - k) / 2: it falls 4 (fast4) or 2 (modes) lanes a word-row,
// and every M move reads another lane's word.
//
// Staging: the rows are copied in batches of 64 anti-diagonals (batch
// d >> 6: 8 word-rows for fast4, 16 for modes), each row the 32 lanes (128
// bytes) around its middle diagonal's lane on a predicted diagonal kq
// (lo_of), so each row's window is sheared along the diagonal at no cost (a
// copy a row).  A warp's ring holds kSlots batch slots; each row padded to
// kStagePitch words,
// so that the probe's cells, 4 (fast4) or 2 (modes) to a row at about the
// same window index, fall in few banks.  While the walk is in batch m,
// batches m and m - 1 are readable and m - 2 in flight: the seed's batch
// and the two below are staged at the start on the seed's diagonal;
// entering batch m from m + 1 stages m - 2 into the slot of m + 1 (which
// the walk has left) on the walk's diagonal plus its drift over batch m + 1
// extrapolated to that batch's middle (2.5 batches ahead), and waits for
// m - 1.  Rows past the tensor are neither copied
// nor read from the stage.
//
// Iteration: on a pending plane, the warp's lane j reads cell (x - j,
// y - j) of the M diagonal from the stage and tests whether the pending
// plane resolves to an M move there (fast4: code & 3 == 0; modes: the M
// bit, and for local not LSTART); the run is the trailing ones of the
// ballot, cut by min(x, y), by the modes walk's step cap and by any cell
// not in a readable row's window.  A run of k moves is emitted at once.
// Otherwise (another plane, or no M move at the walk's cell) one step of
// walk_step_interior / walk_modes_step on the walk's cell, read from the
// stage.  A cell inside the tensor that the stage misses, but that windows
// on its own diagonal would hold, means a gap took the walk off the
// diagonal the windows were laid on: the ring is restaged from the walk's
// cell (restart, counted) once its copies in flight have landed.  Any
// other cell outside the stage is a direct load (the slow path, counted;
// the modes walk clips its indices into the tensor as walk_modes_torch
// does).  Every
// batch is 64 anti-diagonals and a run at most 32 M moves (62 diagonals),
// so the probe never needs a row below batch m - 1 and the walk enters at
// most one batch an iteration.  The fast4 walk ends at x == 0 or y == 0 and
// writes the forced moves to the origin a word at a time.
constexpr int kStagePitch = 36;  // words a staged row takes (144 bytes)
constexpr int kBatchShift = 6;   // a staged batch: 64 anti-diagonals
// The ring's batch slots: 3, 6 and 16 measured alike at one pair, 3
// faster than 6 at 4096 pairs.
constexpr int kSlots = 3;
constexpr int kWalkWarps = 4;  // pairs (warps) a block of the staged walks

SA_HD int trailing_ones(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __ffs(~u) == 0 ? 32 : __ffs(~u) - 1;
#else
  return ~u ? __builtin_ctz(~u) : 32;
#endif
}

// One pair's ring: which batches are staged where, and their windows.  Ops
// is the warp (traceback_device.cu) or its serial host twin
// (host_check.cpp): copy / wait / sync the rows, read a staged word, keep
// each slot's window offset.
template <int SHIFT, class Ops>
struct StageRing {
  static constexpr int kRows = 1 << (kBatchShift - SHIFT);  // rows a batch
  static constexpr int kHalf = 1 << (SHIFT - 1);  // a row's middle diagonal

  Ops& ops;
  const uint32_t* dirs;
  int nw, R, P;
  size_t row;
  int32_t off;
  int32_t m = -2;          // the walk's batch (-2: nothing staged)
  int s0 = 0, s1 = 0;      // the slots of batches m and m - 1
  int32_t e0 = 0, e1 = 0;  // their windows' offsets, off + kq
  int32_t k_in = 0;        // the walk's diagonal on entering batch m + 1

  // The first lane of row r's window for the offset e = off + kq: 16 lanes
  // below the lane of the row's middle diagonal, rounded down to 8 lanes
  // (a 128-byte copy then spans four 32-byte sectors, not five), within
  // the row (P >= 32, a multiple of 4: the last window 16-byte aligned).
  SA_HDM int32_t lo_of(int32_t r, int32_t e) const {
    const int32_t lo = ((((r << SHIFT) + kHalf - e) >> 1) - 16) & ~7;
    return lo < 0 ? 0 : (lo > P - kWalkWindow ? P - kWalkWindow : lo);
  }

  // Copies batch b >= 0 into slot q, its windows on offset e.
  SA_HDM void stage(int32_t b, int q, int32_t e) {
    const int32_t r0 = b * kRows;
    int n = nw - r0;
    n = n < 0 ? 0 : (n > kRows ? kRows : n);
    ops.set_offset(q, e);
    ops.copy(q * kRows, n, q, [&](int j) {
      const int32_t r = r0 + j;
      return dirs + (static_cast<size_t>(r) * R + row) * P + lo_of(r, e);
    });
  }

  // Stages the seed's batch and the two below (none for d < 0).
  SA_HDM void init(int32_t x, int32_t y) {
    if (x + y + off < 0) return;
    ops.init();
    stage_from(x, y);
  }

  // From cell (x, y): its batch m and the two below, batch b in slot
  // b % kSlots, every window on the cell's diagonal; waits for m and m - 1.
  SA_HDM void stage_from(int32_t x, int32_t y) {
    m = (x + y + off) >> kBatchShift;
    k_in = y - x;
    e0 = e1 = off + k_in;
    s0 = m % kSlots;
    for (int t = 0, q = s0; t < kSlots && m - t >= 0;
         ++t, q = q ? q - 1 : kSlots - 1) {
      stage(m - t, q, e0);
    }
    ops.wait(s0);
    s1 = s0 ? s0 - 1 : kSlots - 1;
    if (m > 0) ops.wait(s1);
  }

  // Whether cell (x, y), inside the tensor but not staged, would be staged
  // by windows on its own diagonal: the walk left the diagonal the staged
  // windows were laid on (a gap), and restart can follow it.
  SA_HDM bool stale(int32_t x, int32_t y) const {
    const int32_t r = (x + y + off) >> SHIFT;
    if (m < 0 || static_cast<uint32_t>(r) >= static_cast<uint32_t>(nw) ||
        static_cast<uint32_t>(x) >= static_cast<uint32_t>(P)) {
      return false;
    }
    const int32_t li = x - lo_of(r, off + y - x);
    return static_cast<uint32_t>(li) < static_cast<uint32_t>(kWalkWindow);
  }

  // Restages the ring from cell (x, y) once every copy in flight has
  // landed (the slots' barriers keep their phases).
  SA_HDM void restart(int32_t x, int32_t y) {
    ops.sync();
    ops.drain();
    stage_from(x, y);
    ops.count_restart();
  }

  // After a move to (x, y): enters the batches below m the walk reached.
  // Batch m - 2 takes the slot of batch m + 1, which the walk has left
  // (slot b % kSlots throughout, tracked without a division).
  SA_HDM void advance(int32_t x, int32_t y) {
    const int32_t b = (x + y + off) >> kBatchShift;
    while (m > 0 && b < m) {
      --m;
      const int32_t k = y - x;
      const int32_t dk = k - k_in;
      k_in = k;
      ops.sync();  // the warp's reads of that slot are done
      if (m >= kSlots - 1) stage(m - kSlots + 1, s0, off + k + dk * 5 / 2);
      s0 = s1;
      e0 = e1;
      s1 = s0 ? s0 - 1 : kSlots - 1;
      if (m > 0) {
        ops.wait(s1);
        e1 = ops.offset(s1);
      }
    }
  }

  // The staged word of the cell at diagonal dj and lane xj into v; false
  // (v = 0) where its row is not readable or its lane not in the window.
  SA_HDM bool read(int32_t dj, int32_t xj, uint32_t& v) const {
    const int32_t r = dj >> SHIFT;
    const int32_t b = dj >> kBatchShift;
    const bool cur = b == m;
    const int32_t li = xj - lo_of(r, cur ? e0 : e1);
    const bool ok = static_cast<uint32_t>(r) < static_cast<uint32_t>(nw) &&
                    (cur || b == m - 1) &&
                    static_cast<uint32_t>(li) < static_cast<uint32_t>(kWalkWindow);
    v = ok ? ops.word((cur ? s0 : s1) * kRows + (r & (kRows - 1)), li) : 0u;
    return ok;
  }

  SA_HDM void drain() { ops.drain(); }
};

// Ends a walk's packed output: the word in progress, then zeros to out[WP].
template <class Ops>
SA_HD void finish_ops(Ops& ops, int i, int w, uint32_t word, uint32_t* out,
                      int WP) {
  if (i & 15) out[w++] = word;
  for (int t = w + ops.lane(); t < WP; t += ops.lanes()) out[t] = 0;
}

// The fast4 walk of one pair from its corner (x, y) on plane `plane`:
// dirs (NW, R, P) fast4 words, its cell (x, y) at nibble d & 7 of
// dirs[d >> 3, row, x], d = x + y + off.  Writes the op codes 16 to a u32
// into out[0 .. WP) in walk order, zero past the walk; (x, y) ends at the
// origin.  nslow counts the words the slow path read.
template <class Ops>
SA_HD void walk_fast4_staged(Ops& ops, const uint32_t* dirs, int NW, int R,
                             int P, size_t row, int32_t off, int32_t& x,
                             int32_t& y, int32_t plane,
                             uint32_t* out, int WP, int32_t& n_ops,
                             unsigned& nslow) {
  uint32_t word = 0;
  int i = 0;
  int w = 0;
  if (x > 0 && y > 0) {
    StageRing<3, Ops> ring{ops, dirs, NW, R, P, row, off};
    ring.init(x, y);
    for (;;) {
      const int32_t d = x + y + off;
      const int32_t room = x < y ? x : y;
      uint32_t mm, okm, v0;
      ops.probe(
          [&](int j, uint32_t& v, bool& ok, bool& mv) {
            const int32_t dj = d - 2 * j;
            ok = ring.read(dj, x - j, v);
            mv = ok && j < room && ((v >> (4 * (dj & 7))) & 3u) == 0;
          },
          mm, okm, v0);
      const int k = plane == kPend ? trailing_ones(mm) : 0;
      if (k > 0) {
        x -= k;
        y -= k;
        emit_run32(1u, k, i, w, word, out);
      } else {
        if (!(okm & 1u)) {
          if (ring.stale(x, y)) {
            ring.restart(x, y);
            continue;
          }
          v0 = dirs[(static_cast<size_t>(d >> 3) * R + row) * P + x];
          ++nslow;
        }
        emit_ops(walk_step_interior<false>((v0 >> (4 * (d & 7))) & 0xFu, x,
                                           y, plane),
                 1, i, w, word, out);
      }
      if (x == 0 || y == 0) break;
      ring.advance(x, y);
    }
    ring.drain();
  }
  // Forced moves to the origin: I at x == 0, D at y == 0.
  emit_run(x == 0 ? 2u : 3u, x + y, i, w, word, out);
  x = 0;
  y = 0;
  n_ops = i;
  finish_ops(ops, i, w, word, out, WP);
}

// The textbook-modes walk of one pair from its end cell (x, y): dirs (NW,
// R, P) full bytes, the cell's byte d & 3 of dirs[d >> 2, row, x] (the slow
// path clipping both indices into the tensor, as the JAX walk does), each
// step walk_modes_step's.  Writes the op codes 16 to a u32 into out[0 ..
// WP) in walk order, zero past the walk, and takes at most WP * 16 steps; a
// walk still running then is broken (st = 2).
template <bool LOCAL, class Ops>
SA_HD void walk_modes_staged(Ops& ops, const uint32_t* dirs, int NW, int R,
                             int P, size_t row, int32_t off, int32_t& x,
                             int32_t& y, int32_t& st,
                             int32_t& n_ops, uint32_t* out, int WP,
                             unsigned& nslow) {
  int32_t plane = kPend;
  st = 0;
  uint32_t word = 0;
  int i = 0;
  int w = 0;
  const int cap = WP * 16;
  StageRing<2, Ops> ring{ops, dirs, NW, R, P, row, off};
  ring.init(x, y);
  while (i < cap) {
    const int32_t d = x + y + off;
    int32_t room = x < y ? x : y;
    room = room < cap - i ? room : cap - i;
    uint32_t mm, okm, v0;
    ops.probe(
        [&](int j, uint32_t& v, bool& ok, bool& mv) {
          const int32_t dj = d - 2 * j;
          ok = ring.read(dj, x - j, v);
          const uint32_t byte = v >> (8 * (dj & 3));
          mv = ok && j < room && (byte & 1u) != 0 &&
               !(LOCAL && (byte & 128u) != 0);
        },
        mm, okm, v0);
    const int k = plane == kPend ? trailing_ones(mm) : 0;
    if (k > 0) {
      x -= k;
      y -= k;
      emit_run32(1u, k, i, w, word, out);
    } else {
      if (!(okm & 1u)) {
        if (ring.stale(x, y)) {
          ring.restart(x, y);
          continue;
        }
        int32_t dw = d >> 2;
        dw = dw < 0 ? 0 : (dw > NW - 1 ? NW - 1 : dw);
        const int32_t xc = x < 0 ? 0 : (x > P - 1 ? P - 1 : x);
        v0 = dirs[(static_cast<size_t>(dw) * R + row) * P + xc];
        ++nslow;
      }
      const uint32_t op = walk_modes_step<LOCAL>((v0 >> (8 * (d & 3))) & 0xFFu,
                                                 x, y, plane, st);
      if (st != 0) break;
      emit_ops(op, 1, i, w, word, out);
    }
    ring.advance(x, y);
  }
  ring.drain();
  if (st == 0) st = 2;
  n_ops = i;
  finish_ops(ops, i, w, word, out, WP);
}

}  // namespace sa

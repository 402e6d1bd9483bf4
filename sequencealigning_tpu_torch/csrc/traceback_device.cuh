// The device walks' per-step rules, shared by the CUDA kernels
// (traceback_device.cu) and the serial host build (host_check.cpp).
//
// walk_step is ops/traceback_device.py::_plane_step for one pair, and on
// the fast4 code (x+y-1) & 7 of banded_word's word the host walker
// ops/traceback.py::banded_diag_fast4_traceback_pair (a read outside the
// band gives code 0 and the walk advances); walk_modes_pair is
// ops/traceback_device.py::_walk_modes_impl for one pair.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define SA_HD __host__ __device__ __forceinline__
#else
#define SA_HD static inline
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

// Walks one pair of a textbook-modes fill from its end cell (x, y): dirs is
// (W, R, P) u32 full bytes, the cell's byte d & 3 of word
// dirs[d >> 2, row, x] with d = x + y + off, both indices clipped into the
// tensor as the JAX walk clips them.  Writes the op codes 16 to a u32 into
// out[0 .. WP) in walk order (end to start), zero past the walk, and runs at
// most WP * 16 steps; a walk still running then is broken (st = 2).
template <bool LOCAL>
SA_HD void walk_modes_pair(const uint32_t* dirs, int W, int R, int P,
                           size_t row, int32_t off, int32_t& x, int32_t& y,
                           int32_t& st, int32_t& n_ops, uint32_t* out,
                           int WP) {
  int32_t plane = kPend;
  st = 0;
  uint32_t word = 0;
  int i = 0;
  int w = 0;
  for (; i < WP * 16; ++i) {
    const int32_t d = x + y + off;
    int32_t dw = d >> 2;
    dw = dw < 0 ? 0 : (dw > W - 1 ? W - 1 : dw);
    const int32_t xc = x < 0 ? 0 : (x > P - 1 ? P - 1 : x);
    const uint32_t v = dirs[(static_cast<size_t>(dw) * R + row) * P + xc];
    const uint32_t byte = (v >> (8 * (d & 3))) & 0xFFu;
    const uint32_t op = walk_modes_step<LOCAL>(byte, x, y, plane, st);
    if (st != 0) break;
    word |= op << (2 * (i & 15));
    if ((i & 15) == 15) {
      out[w++] = word;
      word = 0;
    }
  }
  if (st == 0) st = 2;
  n_ops = i;
  if (i & 15) out[w++] = word;
  for (; w < WP; ++w) out[w] = 0;
}

}  // namespace sa

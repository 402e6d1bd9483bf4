// The device walks' per-step rules, shared by the CUDA kernels
// (traceback_device.cu) and the serial host build (host_check.cpp).
//
// walk_step is ops/traceback_device.py::_plane_step for one pair;
// walk_banded_pair is the host walker
// ops/traceback.py::banded_diag_fast4_traceback_pair for one pair (a read
// outside the band gives code 0 and the walk advances); walk_modes_pair is
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

// The fast4 code of cell (x, y) in the banded fill's wavefront layout
// (ops/nw_banded_diag.py): nibble (x+y-1) & 7 of word
// dirs[(x+y-1) >> 3, b, (y-x-k_lo_even) >> 1] of the (W, NB, L) tensor; 0
// outside the band or the tensor (the host walker's rule).
SA_HD uint32_t banded_nibble(const uint32_t* dirs, int W, int NB, int L,
                             size_t b, int32_t k_lo_even, int32_t x,
                             int32_t y) {
  const int32_t a = x + y - 1;
  const int32_t d = y - x - k_lo_even;
  // Floor division by 2, as Python's >> on negative values.
  const int32_t lane = d >= 0 ? d / 2 : -((1 - d) / 2);
  if (lane < 0 || lane >= L || a < 0 || (a >> 3) >= W) return 0;
  const uint32_t v = dirs[(static_cast<size_t>(a >> 3) * NB + b) * L + lane];
  return (v >> (4 * (a & 7))) & 0xFu;
}

// Walks one pair of a banded fast4 fill from (x, y) on plane (the finals'
// seed) to the origin, at most x + y steps, writing the op codes 16 to a u32
// into out[0 .. WP) in walk order (end to start), zero past the walk.
template <bool STD>
SA_HD void walk_banded_pair(const uint32_t* dirs, int W, int NB, int L,
                            size_t b, int32_t k_lo_even, int32_t& x,
                            int32_t& y, int32_t plane, int32_t& n_ops,
                            uint32_t* out, int WP) {
  const int steps = x + y;
  uint32_t word = 0;
  int i = 0;
  int w = 0;
  while (i < steps && (x != 0 || y != 0)) {
    const uint32_t nib = banded_nibble(dirs, W, NB, L, b, k_lo_even, x, y);
    word |= walk_step<STD>(nib, x, y, plane) << (2 * (i & 15));
    ++i;
    if ((i & 15) == 0) {
      out[w++] = word;
      word = 0;
    }
  }
  if (i & 15) out[w++] = word;
  for (; w < WP; ++w) out[w] = 0;
  n_ops = i;
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

// One step of the fast4 first-path walk, shared by the CUDA kernel
// (traceback_device.cu) and the serial host build (host_check.cpp).
//
// It is ops/traceback_device.py::_plane_step (std=False) for one pair.
#pragma once

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
// I, at y == 0 it is D; at the origin the walk stops.
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
    plane = (nib & 4u) ? 1 : 0;
  } else {
    plane = (nib & 8u) ? 2 : 0;
  }
  x -= (eff == 0 || eff == 2) ? 1 : 0;
  y -= (eff == 0 || eff == 1) ? 1 : 0;
  return static_cast<uint32_t>(eff + 1);
}

}  // namespace sa

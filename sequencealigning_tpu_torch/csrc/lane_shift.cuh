// The one-lane shift of the anti-diagonal fills (device code only), shared by
// nw_affine_stream.cu and nw_affine_modes.cu.
//
// A block holds one row of P lanes, LPT consecutive lanes a thread.  Each
// step, lane x needs lane x-1's state from before the step; inside a thread
// that is a register, across threads of a warp __shfl_up_sync, and at warp
// edges and for the torus wrap (lane 0 receives lane P-1, as jnp.roll does)
// shared memory, double-buffered by step parity so one __syncthreads() a step
// suffices.
#pragma once

#include <stdint.h>

namespace sa {

constexpr unsigned kFullMask = 0xffffffffu;

struct ShiftSmem {
  int32_t edge[2][3][32];  // last lane of each warp (up to 32 warps)
  int32_t torus[2][3];     // lane P-1, for lane 0
};

// Hands this thread's last-lane values (h, d, s) to the owner of the next
// lanes and returns in them what the owner of the previous lanes handed this
// one (thread 0 gets lane P-1's).  j: thread index; nreal: threads that own
// real lanes; buf: step parity.  Holds the step's one __syncthreads().
__device__ __forceinline__ void shift_lanes(ShiftSmem& sm, int j, int nreal,
                                            int buf, int32_t& h, int32_t& d,
                                            int32_t& s) {
  const int warp = j >> 5;
  const int wl = j & 31;
  const int32_t eH = h, eD = d, eS = s;
  h = __shfl_up_sync(kFullMask, eH, 1);
  d = __shfl_up_sync(kFullMask, eD, 1);
  s = __shfl_up_sync(kFullMask, eS, 1);
  if (wl == 31) {
    sm.edge[buf][0][warp] = eH;
    sm.edge[buf][1][warp] = eD;
    sm.edge[buf][2][warp] = eS;
  }
  if (j == nreal - 1) {
    sm.torus[buf][0] = eH;
    sm.torus[buf][1] = eD;
    sm.torus[buf][2] = eS;
  }
  __syncthreads();
  if (wl == 0) {
    const int32_t* src0 =
        j == 0 ? &sm.torus[buf][0] : &sm.edge[buf][0][warp - 1];
    const int stride = j == 0 ? 1 : 32;
    h = src0[0];
    d = src0[stride];
    s = src0[2 * stride];
  }
}

}  // namespace sa

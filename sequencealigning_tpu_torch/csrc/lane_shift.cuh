// The one-lane shift of the per-pair anti-diagonal fills (device code only),
// shared by nw_affine.cu and nw_linear.cu.
//
// A block holds a contiguous run of lanes, LPT consecutive lanes a thread.
// Each step a lane needs a neighbour's state from before the step: inside a
// thread that is a register, across threads of a warp a shuffle, and at warp
// edges shared memory, double-buffered by step parity so one barrier a step
// suffices.
//
// shift_lanes moves lane x-1 to lane x.  Its block's first lane receives the
// last lane of the previous block of a cluster row (distributed shared
// memory, one cluster barrier a step), or, for a row held by one block, the
// block's own last lane (the torus wrap of jnp.roll).
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

namespace sa {

constexpr unsigned kFullMask = 0xffffffffu;

struct ShiftSmem {
  int32_t edge[2][3][32];  // a lane at each warp edge (up to 32 warps)
  int32_t last[2][3];      // the block's last real lane, for the next block
};

// Hands this thread's last-lane values (h, d, s) to the owner of the next
// lanes and returns in them what the owner of the previous lanes handed this
// one; thread 0 reads prev->last, the last lane of the previous block (prev
// is &sm for a row held by one block, the previous CTA's ShiftSmem mapped
// from the cluster otherwise).  j: thread index; nreal: threads of this
// block that own real lanes; buf: step parity; cluster: synchronise the
// cluster instead of the block.  Holds the step's one barrier.
__device__ __forceinline__ void shift_lanes(ShiftSmem& sm,
                                            const ShiftSmem* prev,
                                            bool cluster, int j, int nreal,
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
    sm.last[buf][0] = eH;
    sm.last[buf][1] = eD;
    sm.last[buf][2] = eS;
  }
  if (cluster) {
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (wl == 0) {
    if (j == 0) {
      h = prev->last[buf][0];
      d = prev->last[buf][1];
      s = prev->last[buf][2];
    } else {
      h = sm.edge[buf][0][warp - 1];
      d = sm.edge[buf][1][warp - 1];
      s = sm.edge[buf][2][warp - 1];
    }
  }
}

}  // namespace sa

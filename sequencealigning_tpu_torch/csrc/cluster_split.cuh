// How the fills lay one row of P lanes over thread blocks, shared with the
// serial host build (host_check.cpp), plus the launcher (device builds
// only): the streamed fills (nw_affine_stream.cu) through plan_split, the
// per-pair fills (pair_sweep.cuh) through stream_ring.cuh::pair_plan.
//
// Up to 8192 lanes one block holds the whole row, 4, 8 or 16 lanes a thread
// in registers.  Past that the row is split over a thread-block cluster:
// each CTA holds a contiguous slice of cta_lanes lanes (the last CTA the
// rest), the warp rings cross CTA edges through distributed shared memory,
// and lane 0's torus neighbour, lane P-1, lives in the last CTA.  The split
// width can be forced (a multiple of 128) so the split can be exercised at
// any lane width.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

constexpr int kMaxThreads = 512;       // threads a block at most
constexpr int kMaxClusterCtas = 16;    // the non-portable cluster limit

struct Split {
  int lpt;        // lanes a thread
  int cta_lanes;  // lanes a CTA (the last one may hold fewer)
  int nctas;      // CTAs a row; 0 when P is out of range
};

SA_HD int lanes_per_thread_for(int lanes) {
  for (int lpt = 4; lpt <= 16; lpt *= 2) {
    if (lanes / lpt <= kMaxThreads) return lpt;
  }
  return 0;
}

// The split of a row of P lanes (a multiple of 128).  cta_lanes == 0: the
// automatic split -- one block for P <= 8192; past it CTAs of 512 threads x
// 8 lanes (4096 lanes), or x 16 lanes (8192) past 8 x 4096 lanes, so up to
// 49152 lanes take at most 8 CTAs (the portable cluster size).
// cta_lanes > 0 forces CTAs of that many lanes (a multiple of 128, at most
// 8192, at most 16 CTAs).
SA_HD Split plan_split(int P, int cta_lanes) {
  Split sp = {0, 0, 0};
  if (P <= 0 || P % 128 != 0 || cta_lanes < 0 || cta_lanes % 128 != 0 ||
      cta_lanes > 8192) {
    return sp;
  }
  if (cta_lanes == 0) {
    if (P <= 8192) {
      cta_lanes = P;
    } else if (P <= 8 * 4096) {
      cta_lanes = 4096;
    } else {
      cta_lanes = 8192;
    }
  }
  if (cta_lanes >= P) cta_lanes = P;
  const int nctas = (P + cta_lanes - 1) / cta_lanes;
  if (nctas > kMaxClusterCtas) return sp;
  sp.lpt = lanes_per_thread_for(cta_lanes);
  sp.cta_lanes = cta_lanes;
  sp.nctas = sp.lpt ? nctas : 0;
  return sp;
}

// The first lane and the number of lanes of CTA `rank`.
SA_HD int cta_first_lane(int rank, const Split& sp) {
  return rank * sp.cta_lanes;
}
SA_HD int cta_real_lanes(int rank, const Split& sp, int P) {
  const int lo = rank * sp.cta_lanes;
  const int hi = lo + sp.cta_lanes < P ? lo + sp.cta_lanes : P;
  return hi - lo;
}
// The CTA holding the lanes just left of CTA `rank` (the torus wraps lane 0
// to lane P-1 in the last CTA).
SA_HD int prev_cta(int rank, const Split& sp) {
  return rank == 0 ? sp.nctas - 1 : rank - 1;
}
// Threads a CTA (all CTAs of a cluster have the same).
SA_HD int cta_threads(const Split& sp) {
  return (sp.cta_lanes / sp.lpt + 31) / 32 * 32;
}

}  // namespace sa

#if defined(__CUDACC__)
#include <cuda_runtime.h>

namespace sa {

constexpr int kClusterUnschedulable = -3;

// Launches fn over `rows` rows of sp.nctas CTAs each: a plain launch for one
// CTA a row, else a cluster launch with cluster dimension (nctas, 1, 1)
// (cudaLaunchKernelEx; non-portable sizes past 8 CTAs are allowed).  A
// cluster shape the card cannot schedule (cudaOccupancyMaxActiveClusters
// gives 0) returns kClusterUnschedulable and is never run another way.
// Otherwise returns the launch's cudaGetLastError().
inline int launch_split(const void* fn, const Split& sp, int rows,
                        void** args, void* stream) {
  const dim3 grid(rows * sp.nctas);
  const dim3 block(cta_threads(sp));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sp.nctas == 1) {
    cudaLaunchKernel(fn, grid, block, args, 0, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (sp.nctas > 8) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                         1);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sp.nctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return kClusterUnschedulable;
  cudaLaunchKernelExC(&cfg, fn, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sa
#endif

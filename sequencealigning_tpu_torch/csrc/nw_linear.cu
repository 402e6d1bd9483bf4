// Per-pair linear-gap NW fill for Hopper (sm_90a).
//
// Replaces ops/nw_linear.py::_linear_fill_lax, a lax.scan on the TPU (the
// JAX package has no Pallas kernel for it).  Same contract: each pair
// sweeps its D_total = l1 + l2 + 1 anti-diagonals with its db preloaded on
// P lanes (s2v[b, 1..L2]), lane x of diagonal d being cell (x, d - x); lanes
// 0 and d are the boundaries.  Outputs per pair: the corner score (the
// score at lane n2 on diagonal n1 + n2, added into the caller-zeroed
// corner[b]) and the maximum over the pair's valid cells (atomicMax into
// runmax[b], which the caller fills with NEGBIG), plus on request the 4
// path bits of each cell (nw_linear.cuh), byte d & 3 of word
// dirs[d >> 2, b, x], in ceil(D_total / 4) words.  Local mode is two
// launches, as in the JAX package: the first (no dirs) gives each pair's
// maximum, which the second reads as maxv to set the ISMAX bits.
//
// Design: kernel #7's per-pair shape (nw_affine.cu): one thread block a
// pair up to 8192 lanes, past that a thread-block cluster a pair
// (cluster_split.cuh, up to 131072 lanes), LPT consecutive lanes a thread
// in registers, the one-lane shift of lane_shift.cuh (one barrier a
// diagonal) carrying lane x-1's score two and one diagonals back and its
// query code with its gap flag packed into one word; the lane-0 query code
// of diagonal d, seq1[clip(d-1, 0, L1p-1)], staged in shared memory 128
// diagonals at a time.  Each thread ORs four diagonals of its lanes' bytes
// in registers and stores them as 16-byte words.  The lanes' running maxima
// are reduced in each warp at the end, one atomicMax a warp.
//
// What bounds it on this card: the integer work of the recurrence (~14
// operations a cell, ~22 with its bits), of which half the lane-steps lie
// outside the pair's matrix, and the diagonal's barrier; one block a pair
// fills the card only at 132 pairs or more.  The byte stores (1 B a
// lane-step) are a few percent of HBM time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_split.cuh"
#include "lane_shift.cuh"
#include "nw_linear.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCodeChunk = 128;  // diagonals of query codes staged at a time

// query: (B, L1p); s2v: (B, P); n1v/n2v/maxv: (B,); corner: (B,), zeroed;
// runmax: (B,), NEGBIG-filled; dirs: (ceil(D_total/4), B, P) u32.  sp: the
// pair's split; block i holds CTA i % nctas of pair i / nctas when CLUSTER.
template <int LPT, bool DIRS, bool COMPAT, bool LOCAL, bool CLUSTER>
__global__ void __launch_bounds__(sa::kMaxThreads)
    linear_fill_kernel(const int32_t* __restrict__ query,
                       const int32_t* __restrict__ s2v,
                       const int32_t* __restrict__ n1v,
                       const int32_t* __restrict__ n2v,
                       const int32_t* __restrict__ maxv,
                       int32_t* __restrict__ corner,
                       int32_t* __restrict__ runmax,
                       uint32_t* __restrict__ dirs, int B, int L1p, int P,
                       int D_total, sa::Scheme sc, sa::Split sp) {
  __shared__ int32_t qs[kCodeChunk];
  __shared__ sa::ShiftSmem sm;

  int rank = 0;
  int b = blockIdx.x;
  if constexpr (CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    b = blockIdx.x / sp.nctas;
  }
  const int j = threadIdx.x;
  const int nreal = sa::cta_real_lanes(rank, sp, P) / LPT;
  const bool real = j < nreal;
  const int base = sa::cta_first_lane(rank, sp) + j * LPT;
  const sa::ShiftSmem* prev = &sm;
  if constexpr (CLUSTER) {
    prev = cg::this_cluster().map_shared_rank(&sm, sa::prev_cta(rank, sp));
  }
  const int32_t n1 = n1v[b];
  const int32_t n2 = n2v[b];
  const int32_t mv = maxv[b];
  const int32_t dsum = n1 + n2;

  sa::LinCell c[LPT];
  uint32_t acc[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    c[i] = sa::lin_init();
    c[i].s2v = real ? s2v[static_cast<size_t>(b) * P + base + i] : 0;
    acc[i] = 0;
  }

  const size_t qrow = static_cast<size_t>(b) * L1p;
  for (int d = 0; d < D_total; ++d) {
    const int dc = d % kCodeChunk;
    if (dc == 0) {
      __syncthreads();
      for (int i = j; i < kCodeChunk; i += blockDim.x) {
        const int q = min(max(d + i - 1, 0), L1p - 1);
        qs[i] = query[qrow + q];
      }
      __syncthreads();
    }
    int32_t nS2 = c[LPT - 1].S2;
    int32_t nS1 = c[LPT - 1].S1;
    int32_t nX = c[LPT - 1].s1d | (c[LPT - 1].G1 << 8);
    sa::shift_lanes(sm, prev, CLUSTER, j, nreal, d & 1, nS2, nS1, nX);
    const int32_t qc = qs[dc];
    const uint32_t shift = 8u * (d & 3);

    // Right to left, so lane i-1 still holds its pre-step state for lane i.
#pragma unroll
    for (int i = LPT - 1; i >= 0; --i) {
      const int x = base + i;
      int32_t lS2, lS1, lG1, ls1d;
      if (i == 0) {
        lS2 = nS2;
        lS1 = nS1;
        lG1 = nX >> 8;
        ls1d = nX & 0xff;
      } else {
        lS2 = c[i - 1].S2;
        lS1 = c[i - 1].S1;
        lG1 = c[i - 1].G1;
        ls1d = c[i - 1].s1d;
      }
      const int32_t code = sa::linear_cell<COMPAT, LOCAL, DIRS>(
          c[i], lS2, lS1, lG1, ls1d, x == 0, x == d, d, qc,
          sa::linear_valid(x, d, n1, n2), mv, sc);
      if (DIRS) acc[i] |= static_cast<uint32_t>(code) << shift;
      if (real && d == dsum && x == n2) atomicAdd(corner + b, c[i].S1);
    }

    if (DIRS && ((d & 3) == 3 || d == D_total - 1)) {
      if (real) {
        uint32_t* dst = dirs + (static_cast<size_t>(d >> 2) * B + b) * P + base;
#pragma unroll
        for (int i = 0; i < LPT; i += 4) {
          *reinterpret_cast<uint4*>(dst + i) =
              make_uint4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
        }
      }
#pragma unroll
      for (int i = 0; i < LPT; ++i) acc[i] = 0;
    }
  }

  int32_t best = sa::kLinNegBig;
  if (real) {
#pragma unroll
    for (int i = 0; i < LPT; ++i) best = sa::imax(best, c[i].best);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    best = sa::imax(best, __shfl_xor_sync(sa::kFullMask, best, off));
  }
  if ((j & 31) == 0) atomicMax(runmax + b, best);
  // Keep this CTA's shared memory alive until its neighbour has read it.
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

typedef void (*LinearKernel)(const int32_t*, const int32_t*, const int32_t*,
                             const int32_t*, const int32_t*, int32_t*,
                             int32_t*, uint32_t*, int, int, int, int,
                             sa::Scheme, sa::Split);

template <int LPT, bool DIRS, bool CL>
LinearKernel pick_mode(bool compat, bool local) {
  if (local) {
    return compat ? linear_fill_kernel<LPT, DIRS, true, true, CL>
                  : linear_fill_kernel<LPT, DIRS, false, true, CL>;
  }
  return compat ? linear_fill_kernel<LPT, DIRS, true, false, CL>
                : linear_fill_kernel<LPT, DIRS, false, false, CL>;
}

template <int LPT>
LinearKernel pick_dirs(const sa::Split& sp, bool dirs, bool compat,
                       bool local) {
  if (sp.nctas > 1) {
    return dirs ? pick_mode<LPT, true, true>(compat, local)
                : pick_mode<LPT, false, true>(compat, local);
  }
  return dirs ? pick_mode<LPT, true, false>(compat, local)
              : pick_mode<LPT, false, false>(compat, local);
}

}  // namespace

// query: (B, L1p) int32 codes; s2v: (B, P) int32 (db at lanes 1..L2);
// n1v/n2v: (B,) int32 lengths; maxv: (B,) int32 (pass 1's maxima for local
// with dirs, else unused); corner: (B,) int32, zeroed; runmax: (B,) int32,
// filled with -2^30; dirs: (ceil(D_total/4), B, P) u32, unused without
// dirs.  cta_lanes: 0, or the forced CTA width of the split.  Returns the
// cudaGetLastError() of the launch, -1 for an unsupported shape, -3 for a
// cluster the card cannot schedule.
extern "C" int sa_linear_fill(const int32_t* query, const int32_t* s2v,
                              const int32_t* n1v, const int32_t* n2v,
                              const int32_t* maxv, int32_t* corner,
                              int32_t* runmax, uint32_t* dirs, int B, int L1p,
                              int P, int D_total, int match, int mismatch,
                              int gap_open, int gap_extend, int with_dirs,
                              int compat, int local, int cta_lanes,
                              void* stream) {
  const sa::Split sp = sa::plan_split(P, cta_lanes);
  if (sp.nctas == 0 || B <= 0 || L1p <= 0 || D_total <= 0) return -1;
  LinearKernel fn = nullptr;
  const bool w = with_dirs != 0, c = compat != 0, l = local != 0;
  switch (sp.lpt) {
    case 4: fn = pick_dirs<4>(sp, w, c, l); break;
    case 8: fn = pick_dirs<8>(sp, w, c, l); break;
    case 16: fn = pick_dirs<16>(sp, w, c, l); break;
  }
  if (fn == nullptr) return -1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  sa::Split split = sp;
  void* args[] = {&query, &s2v, &n1v, &n2v,    &maxv, &corner, &runmax,
                  &dirs,  &B,   &L1p, &P,      &D_total, &sc,  &split};
  return sa::launch_split(reinterpret_cast<const void*>(fn), sp, B, args,
                          stream);
}

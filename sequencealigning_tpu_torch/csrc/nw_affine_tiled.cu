// Tiled score-only Gotoh fill for pairs of any length, for Hopper (sm_90a).
//
// Replaces the TPU kernels ops/nw_affine_tiled.py::_tile_kernel (launched by
// _tile_fill_pallas; the batched fill) and ::_folded_kernel (launched by
// _tile_fill_folded_pallas; 1-4 pairs).  Same contract as the lax fills:
// each pair's M/I/D corner values at (n2, n1), exact Gotoh whatever the
// tiling, so the kernels choose their own tile widths.  The db axis is cut
// into tiles of WV lanes; a tile is swept anti-diagonal by anti-diagonal
// (lane l holds x = x0 + l, step g holds y = g - l), and the only coupling
// between consecutive tiles is the boundary column at the tile edge (M, D, H
// at x = x0 - 1 for every y), O(n1) values a pair.  The per-cell work is
// nw_affine_tiled.cuh::tile_cell.
//
// Design: one pair a CTA (sa_tiled_fill, kernel #4) or a cluster of `fold`
// CTAs (sa_tiled_fold_fill, kernel #5), every tile of the pair swept inside
// the one launch.  A CTA holds up to 4096 lanes, 4 or 8 consecutive lanes a
// thread in registers (512 threads at 4096 lanes).  The x-1 shift is
// stream_cell's (lane_shift.cuh::shift_lanes, one barrier a step); in a
// cluster the tile is one row of fold x cta_lanes lanes and a CTA's first
// lane reads the previous CTA's last lane through distributed shared memory,
// one cluster barrier a step -- the Hopper counterpart of the TPU kernel's
// sublane fold, which keeps a few long pairs from leaving most of the card
// idle.  The tile's lane 0 takes the carried boundary column instead: a
// (3, n1 + 1) int32 buffer a pair in global memory, used in place -- lane 0
// reads row y at step y, and the tile's last lane writes row g - WV + 1 at
// step g, a row lane 0 read WV - 1 steps earlier.  CTA 0 stages the query
// codes and the boundary rows of 128 steps at a time in shared memory; rows
// past n1 are never read.  The y = 0 chain (lane == g) and the corner
// capture (the lane holding n2 - x0 at step n2 - x0 + n1 of the last tile)
// follow _tile_step.  A pair's steps end at its own corner: n1 + WV a tile,
// the last tile up to the capture step.
//
// What bounds it on this card: the per-step block (or cluster) barrier and
// the integer ALU work of the recurrence (~20 operations a cell); a pair's
// tiles run one after another on one CTA (#4) or one cluster (#5), so a
// batch of B pairs keeps B (or fold x B) SMs busy.  Memory traffic is the
// boundary column, 12 bytes a row a tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_split.cuh"
#include "lane_shift.cuh"
#include "nw_affine_tiled.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kStageChunk = 128;  // steps of query codes and boundary rows
constexpr int kMaxTileCta = 4096;  // lanes a CTA at most

// query: (B, L1) int32 codes; db: (B, L2) int32 codes; n1v/n2v: (B,)
// lengths; finals: (B, 3) int32, zeroed by the caller (a pair with n2 = 0 is
// left untouched); bnd: (B, 3, nrow) int32 scratch (nrow >= n1 + 1), the
// boundary column planes M, D, H.  sp: the tile's split, all CTAs full
// (cluster_split.cuh); CLUSTER: block b holds CTA b % nctas of pair
// b / nctas, else one block a pair.
template <int LPT, bool COMPAT, bool WILDCARD, bool CLUSTER>
__global__ void __launch_bounds__(sa::kMaxThreads)
    tiled_fill_kernel(const int32_t* __restrict__ query,
                      const int32_t* __restrict__ db,
                      const int32_t* __restrict__ n1v,
                      const int32_t* __restrict__ n2v,
                      int32_t* __restrict__ finals, int32_t* __restrict__ bnd,
                      int L1, int L2, int nrow, sa::Scheme sc, sa::Split sp) {
  __shared__ int32_t qsm[kStageChunk];  // query code y - 1 of lane 0
  __shared__ int32_t hsm[kStageChunk];  // boundary H(y - 1)
  __shared__ int32_t osm[kStageChunk];  // boundary max(M(y) + o, D(y))
  __shared__ sa::ShiftSmem sm;

  int rank = 0;
  int b = blockIdx.x;
  const sa::ShiftSmem* prev = &sm;
  if constexpr (CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    b = blockIdx.x / sp.nctas;
    prev = cg::this_cluster().map_shared_rank(&sm, sa::prev_cta(rank, sp));
  }
  const int j = threadIdx.x;
  const int WV = sp.nctas * sp.cta_lanes;  // the (virtual) tile's lanes
  const int nreal = sp.cta_lanes / LPT;
  const bool real = j < nreal;
  const int lane0 = sa::cta_first_lane(rank, sp) + j * LPT;
  // The owner of the tile's last lane emits the next tile's boundary.
  const bool edge_owner = rank == sp.nctas - 1 && j == nreal - 1;
  const int32_t n1 = n1v[b];
  const int32_t n2 = n2v[b];
  if (n2 <= 0) return;  // the whole cluster: the host's closed form
  const int n_tiles = (n2 + WV - 1) / WV;
  const int32_t* q = query + static_cast<size_t>(b) * L1;
  int32_t* bM = bnd + static_cast<size_t>(b) * 3 * nrow;
  int32_t* bD = bM + nrow;
  int32_t* bH = bD + nrow;

  for (int t = 0; t < n_tiles; ++t) {
    const int x0 = t * WV + 1;
    const bool last = t == n_tiles - 1;
    const int gcap = n2 - x0 + n1;  // the corner's step in the last tile
    const int g_end = last ? gcap + 1 : n1 + WV;
    int cap_i = -1;  // this thread's lane holding the corner, if any
    if (last && real && n2 - x0 >= lane0 && n2 - x0 < lane0 + LPT) {
      cap_i = n2 - x0 - lane0;
    }
    sa::Cell c[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      c[i] = sa::cell_init();
      const int x = x0 + lane0 + i;  // db code x - 1
      c[i].s2v = real && x <= n2 ? db[static_cast<size_t>(b) * L2 + x - 1]
                                 : 0;
    }
    for (int g = 0; g < g_end; ++g) {
      const int gc = g % kStageChunk;
      if (gc == 0 && rank == 0) {
        __syncthreads();
        for (int i = j; i < kStageChunk; i += blockDim.x) {
          sa::tile_stage_row(t, g + i, n1, L1, q, bM, bD, bH, COMPAT, sc,
                             qsm[i], hsm[i], osm[i]);
        }
        __syncthreads();
      }
      sa::Pre pre[LPT];
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        pre[i] = sa::stream_pre<sa::kDirsNone>(c[i], sc);
      }
      int32_t nH = c[LPT - 1].H2;
      int32_t nD = pre[LPT - 1].dsel;
      int32_t nS = c[LPT - 1].s1d;
      sa::shift_lanes(sm, prev, CLUSTER, j, nreal, g & 1, nH, nD, nS);
      if (rank == 0 && j == 0) {
        // The tile's lane 0 reads the carried boundary column.
        nH = hsm[gc];
        nD = osm[gc];
        nS = qsm[gc];
      }
      // Right to left, so lane i-1 still holds its pre-step state for lane i.
      // One tile_cell a lane, its operands chosen first: two inlined calls
      // (one reading c[i - 1]) kept the lanes' state out of registers.
#pragma unroll
      for (int i = LPT - 1; i >= 0; --i) {
        const int lane = lane0 + i;
        int32_t lH2, ldsel, ls1d;
        if (i == 0) {
          lH2 = nH;
          ldsel = nD;
          ls1d = nS;
        } else {
          lH2 = c[i - 1].H2;
          ldsel = pre[i - 1].dsel;
          ls1d = c[i - 1].s1d;
        }
        sa::tile_cell<COMPAT, WILDCARD>(c[i], pre[i].t0, lH2, ldsel, ls1d,
                                        lane == g, x0 + lane, sc);
      }
      if (g == gcap && cap_i >= 0) {
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          if (i == cap_i) {
            int32_t* f = finals + static_cast<size_t>(b) * 3;
            f[0] = c[i].M1;
            f[1] = c[i].I1;
            f[2] = c[i].D1;
          }
        }
      }
      if (edge_owner && !last && g >= WV - 1) {
        const int y = g - WV + 1;
        bM[y] = c[LPT - 1].M1;
        bD[y] = c[LPT - 1].D1;
        bH[y] = c[LPT - 1].H1;
      }
    }
    // The emitted column is read by CTA 0 in the next tile; the barrier also
    // keeps this CTA's shared memory alive for its neighbour.
    if (edge_owner) __threadfence();
    if constexpr (CLUSTER) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
}

typedef void (*TiledKernel)(const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, int32_t*, int32_t*, int, int, int,
                            sa::Scheme, sa::Split);

template <int LPT, bool CL>
TiledKernel pick(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? tiled_fill_kernel<LPT, true, true, CL>
                    : tiled_fill_kernel<LPT, true, false, CL>;
  }
  return wildcard ? tiled_fill_kernel<LPT, false, true, CL>
                  : tiled_fill_kernel<LPT, false, false, CL>;
}

int launch(const sa::Split& sp, const int32_t* query, const int32_t* db,
           const int32_t* n1v, const int32_t* n2v, int32_t* finals,
           int32_t* bnd, int B, int L1, int L2, int match, int mismatch,
           int gap_open, int gap_extend, int compat, int wildcard,
           void* stream) {
  if (sp.nctas == 0 || sp.cta_lanes > kMaxTileCta || B <= 0 || L1 <= 0 ||
      L2 <= 0) {
    return -1;
  }
  const bool cl = sp.nctas > 1;
  TiledKernel fn = nullptr;
  switch (sp.lpt) {
    case 4:
      fn = cl ? pick<4, true>(compat != 0, wildcard != 0)
              : pick<4, false>(compat != 0, wildcard != 0);
      break;
    case 8:
      fn = cl ? pick<8, true>(compat != 0, wildcard != 0)
              : pick<8, false>(compat != 0, wildcard != 0);
      break;
  }
  if (fn == nullptr) return -1;
  int nrow = L1 + 1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  sa::Split split = sp;
  void* args[] = {&query, &db, &n1v, &n2v, &finals, &bnd,
                  &L1,    &L2, &nrow, &sc, &split};
  return sa::launch_split(reinterpret_cast<const void*>(fn), sp, B, args,
                          stream);
}

}  // namespace

// Kernel #4: one CTA a pair, tiles of tile_lanes lanes (a multiple of 128,
// at most 4096).  query: (B, L1) int32; db: (B, L2) int32; n1v/n2v: (B,)
// int32; finals: (B, 3) int32, zeroed; bnd: (B, 3, L1 + 1) int32 scratch.
// Returns the cudaGetLastError() of the launch, -1 for an unsupported shape.
extern "C" int sa_tiled_fill(const int32_t* query, const int32_t* db,
                             const int32_t* n1v, const int32_t* n2v,
                             int32_t* finals, int32_t* bnd, int B, int L1,
                             int L2, int match, int mismatch, int gap_open,
                             int gap_extend, int compat, int wildcard,
                             int tile_lanes, void* stream) {
  const sa::Split sp = sa::plan_split(tile_lanes, tile_lanes);
  return launch(sp, query, db, n1v, n2v, finals, bnd, B, L1, L2, match,
                mismatch, gap_open, gap_extend, compat, wildcard, stream);
}

// Kernel #5: a cluster of `fold` CTAs of cta_lanes lanes a pair (2 to 8
// CTAs; the tile is fold x cta_lanes lanes), same arguments otherwise.
// Returns -3 for a cluster the card cannot schedule.
extern "C" int sa_tiled_fold_fill(const int32_t* query, const int32_t* db,
                                  const int32_t* n1v, const int32_t* n2v,
                                  int32_t* finals, int32_t* bnd, int B,
                                  int L1, int L2, int match, int mismatch,
                                  int gap_open, int gap_extend, int compat,
                                  int wildcard, int fold, int cta_lanes,
                                  void* stream) {
  if (fold < 2 || fold > 8) return -1;
  const sa::Split sp = sa::plan_split(fold * cta_lanes, cta_lanes);
  if (sp.nctas != fold) return -1;
  return launch(sp, query, db, n1v, n2v, finals, bnd, B, L1, L2, match,
                mismatch, gap_open, gap_extend, compat, wildcard, stream);
}

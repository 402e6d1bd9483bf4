// Per-pair semi-global and local Gotoh fill for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/nw_affine_modes.py::_modes_kernel (launched by
// modes_fill_pallas).  Same contract as _fill_modes_lax: each pair sweeps its
// D_total = L1 + L2 + 1 anti-diagonals with its db preloaded on P lanes
// (s2v[b, 1..L2]); lane 0 and lane d are the free-end-gap boundaries, local
// mode clamps M at 0 and marks restarts LSTART.  Each lane keeps a running
// argmax (best score, its diagonal) over the mode's eligible cells; the
// kernel writes the (B, P) per-lane buffers and the full direction bytes,
// byte d & 3 of word dirs[d >> 2, b, x], in ceil(D_total / 4) words.
//
// Design: one thread block per pair up to 8192 lanes, past that one
// thread-block cluster per pair (cluster_split.cuh, as the streamed fill),
// LPT consecutive lanes a thread in registers, the one-lane shift of
// lane_shift.cuh (one barrier a step), and the per-cell arithmetic of the
// streamed fill (nw_affine_stream.cuh::stream_cell with the MODE hook, each
// lane passing its own db code).  The lane-0 query code of diagonal d,
// seq1[clip(d-1, 0, L1-1)], is staged in shared memory 128 diagonals at a
// time.
//
// What bounds it on this card: the small batches it serves (fewer than 32
// pairs, one block each) use at most 31 of the 132 SMs, so it is bound by
// the latency of each block's serial diagonal loop (one barrier a step), not
// by throughput; the TPU kernel's (batch tiles, diagonal chunks) grid and its
// masked lane-reduce gather of the query column have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_split.cuh"
#include "lane_shift.cuh"
#include "nw_affine_stream.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCodeChunk = 128;  // diagonals of query codes staged at a time

// out: bv then bd, each (B, P) int32.  sp: the pair's split
// (cluster_split.cuh); block i holds CTA i % nctas of pair i / nctas.
// CLUSTER: the pair is split over a cluster (sp.nctas > 1).
template <int LPT, int DIRS, int MODE, bool WILDCARD, bool CLUSTER>
__global__ void __launch_bounds__(sa::kMaxThreads)
    modes_fill_kernel(const int32_t* __restrict__ query,
                      const int32_t* __restrict__ s2v,
                      const int32_t* __restrict__ n1s,
                      const int32_t* __restrict__ n2s,
                      int32_t* __restrict__ out, uint32_t* __restrict__ dirs,
                      int B, int L1, int P, int D_total, sa::Scheme sc,
                      sa::Split sp) {
  __shared__ int32_t qs[kCodeChunk];
  __shared__ sa::ShiftSmem sm;

  constexpr bool cluster = CLUSTER;
  int rank = 0;
  int b = blockIdx.x;
  if constexpr (CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    b = blockIdx.x / sp.nctas;
  }
  const int j = threadIdx.x;
  // Threads at or past nreal own no real lane.
  const int nreal = sa::cta_real_lanes(rank, sp, P) / LPT;
  const bool real = j < nreal;
  const int base = sa::cta_first_lane(rank, sp) + j * LPT;
  const sa::ShiftSmem* prev = &sm;
  if constexpr (CLUSTER) {
    prev = cg::this_cluster().map_shared_rank(&sm, sa::prev_cta(rank, sp));
  }
  const int32_t n1 = n1s[b];
  const int32_t n2 = n2s[b];

  sa::Cell c[LPT];
  uint32_t acc[LPT];
  int32_t bv[LPT], bd[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    c[i] = sa::cell_init(sa::kNegInf);
    c[i].s2v = real ? s2v[static_cast<size_t>(b) * P + base + i] : 0;
    acc[i] = 0;
    bv[i] = sa::kNegBig;
    bd[i] = 0;
  }

  const size_t qrow = static_cast<size_t>(b) * L1;
  for (int d = 0; d < D_total; ++d) {
    const int dc = d % kCodeChunk;
    if (dc == 0) {
      __syncthreads();
      for (int i = j; i < kCodeChunk; i += blockDim.x) {
        const int q = min(max(d + i - 1, 0), L1 - 1);
        qs[i] = query[qrow + q];
      }
      __syncthreads();
    }

    sa::Pre pre[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) pre[i] = sa::stream_pre<DIRS>(c[i], sc);

    int32_t nH = c[LPT - 1].H2;
    int32_t nD = pre[LPT - 1].dsel;
    int32_t nS = c[LPT - 1].s1d | (pre[LPT - 1].dflag << 8);
    sa::shift_lanes(sm, prev, cluster, j, nreal, d & 1, nH, nD, nS);
    const int32_t qc = qs[dc];
    const uint32_t shift = 8u * (d & 3);

    // Right to left, so lane i-1 still holds its pre-step state for lane i.
#pragma unroll
    for (int i = LPT - 1; i >= 0; --i) {
      const int x = base + i;
      int32_t lH2, ls1d;
      sa::Pre lpre;
      if (i == 0) {
        lH2 = nH;
        lpre.t0 = 0;
        lpre.dsel = nD;
        lpre.dflag = nS >> 8;
        ls1d = nS & 0xff;
      } else {
        lH2 = c[i - 1].H2;
        lpre = pre[i - 1];
        ls1d = c[i - 1].s1d;
      }
      const int32_t code = sa::stream_cell<DIRS, MODE, false, WILDCARD>(
          c[i], pre[i], lH2, lpre, ls1d, x == 0, x == d, d, qc, c[i].s2v, sc);
      if (DIRS != sa::kDirsNone) acc[i] |= static_cast<uint32_t>(code) << shift;
      sa::modes_update<MODE>(x, d - x, d, n1, n2, c[i].M1, c[i].H1, bv[i],
                             bd[i]);
    }

    if (DIRS != sa::kDirsNone && ((d & 3) == 3 || d == D_total - 1)) {
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

  if (real) {
    const size_t at = static_cast<size_t>(b) * P + base;
    const size_t plane = static_cast<size_t>(B) * P;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      out[at + i] = bv[i];
      out[plane + at + i] = bd[i];
    }
  }
  // Keep this CTA's shared memory alive until its neighbour has read it.
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

typedef void (*ModesKernel)(const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, int32_t*, uint32_t*, int, int,
                            int, int, sa::Scheme, sa::Split);

template <int LPT, int DIRS, bool CL>
ModesKernel pick_mode(bool local, bool wildcard) {
  if (local) {
    return wildcard ? modes_fill_kernel<LPT, DIRS, sa::kModeLocal, true, CL>
                    : modes_fill_kernel<LPT, DIRS, sa::kModeLocal, false, CL>;
  }
  return wildcard ? modes_fill_kernel<LPT, DIRS, sa::kModeSemi, true, CL>
                  : modes_fill_kernel<LPT, DIRS, sa::kModeSemi, false, CL>;
}

template <int LPT, bool CL>
ModesKernel pick_cl(int dirs_mode, bool local, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_mode<LPT, sa::kDirsNone, CL>(local, wildcard);
    case sa::kDirsFull:
      return pick_mode<LPT, sa::kDirsFull, CL>(local, wildcard);
    default:
      return nullptr;
  }
}

// The instance for a split: the cluster instances for more than one CTA.
template <int LPT>
ModesKernel pick_dirs(const sa::Split& sp, int dirs_mode, bool local,
                      bool wildcard) {
  return sp.nctas > 1 ? pick_cl<LPT, true>(dirs_mode, local, wildcard)
                      : pick_cl<LPT, false>(dirs_mode, local, wildcard);
}

}  // namespace

// query: (B, L1) int32 codes; s2v: (B, P) int32 (db at lanes 1..L2); n1/n2:
// (B,) int32 lengths; out: bv then bd, each (B, P) int32; dirs:
// (ceil(D_total/4), B, P) u32 full bytes, unused for dirs_mode 0.  dirs_mode:
// 0 (none) or 2 (full); local != 0: local, else semi-global; cta_lanes: 0,
// or the forced CTA width of the split.  Returns the cudaGetLastError() of
// the launch, -1 for an unsupported shape or mode, -3 for a cluster the card
// cannot schedule.
extern "C" int sa_modes_fill(const int32_t* query, const int32_t* s2v,
                             const int32_t* n1, const int32_t* n2,
                             int32_t* out, uint32_t* dirs, int B, int L1,
                             int P, int D_total, int match, int mismatch,
                             int gap_open, int gap_extend, int dirs_mode,
                             int local, int wildcard, int cta_lanes,
                             void* stream) {
  const sa::Split sp = sa::plan_split(P, cta_lanes);
  if (sp.nctas == 0 || B <= 0 || L1 <= 0 || D_total <= 0) return -1;
  ModesKernel fn = nullptr;
  switch (sp.lpt) {
    case 4:
      fn = pick_dirs<4>(sp, dirs_mode, local != 0, wildcard != 0);
      break;
    case 8:
      fn = pick_dirs<8>(sp, dirs_mode, local != 0, wildcard != 0);
      break;
    case 16:
      fn = pick_dirs<16>(sp, dirs_mode, local != 0, wildcard != 0);
      break;
  }
  if (fn == nullptr) return -1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  sa::Split split = sp;
  void* args[] = {&query, &s2v, &n1, &n2,      &out, &dirs,
                  &B,     &L1,  &P,  &D_total, &sc,  &split};
  return sa::launch_split(reinterpret_cast<const void*>(fn), sp, B, args,
                          stream);
}

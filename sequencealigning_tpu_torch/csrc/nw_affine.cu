// Per-pair global Gotoh fill for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/nw_affine.py::_gotoh_kernel (launched by
// gotoh_fill_pallas).  Same contract as _gotoh_fill_lax: each pair sweeps its
// D_total = l1 + l2 + 1 anti-diagonals with its db preloaded on P lanes
// (s2v[b, 1..L2]); lane 0 and lane d are the boundaries, whose compat or
// textbook gap chains the global mode of stream_cell writes.  Each pair's
// corner finals are M/I/D summed over the lanes where n2mask is set, on the
// diagonal d == dsum[b] (one lane, n2, in every layout the callers build);
// the kernel adds them into the caller-zeroed (B, 3) finals.  Optional full
// direction bytes, byte d & 3 of word dirs[d >> 2, b, x], in
// ceil(D_total / 4) words (the lax twin's length; the TPU kernel pads to
// whole 64-diagonal chunks).
//
// Design: one thread block per pair up to 8192 lanes, past that one
// thread-block cluster per pair (cluster_split.cuh), LPT consecutive lanes a
// thread in registers, the one-lane shift of lane_shift.cuh (one barrier a
// step) and the per-cell arithmetic nw_affine_stream.cuh::stream_cell<DIRS,
// kModeGlobal, COMPAT, WILDCARD>, each lane passing its own db code.  The
// lane-0 query code of diagonal d, seq1[clip(d-1, 0, L1p-1)], is staged in
// shared memory 128 diagonals at a time.  The epilogue is a corner capture
// instead of the modes' per-lane argmax: each lane keeps one bit of n2mask,
// and on its pair's diagonal dsum the lanes whose bit is set add M/I/D
// atomically.
//
// What bounds it on this card: the integer work of the recurrence (10
// operations a true cell score-only, 26 with the full codes), but half of a
// pair's lane-steps lie outside its matrix (lanes x > d early, x < d - L1
// late), so it does at most half the useful work of a lane-step; one block a
// pair fills the card only at 132 pairs or more.  The direction stores (1 B
// a lane-step) are a few percent of HBM time.  The TPU kernel's
// (batch tiles, diagonal chunks) grid, its gated capture and its masked
// lane-reduce gather of the query column have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_split.cuh"
#include "lane_shift.cuh"
#include "nw_affine_stream.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCodeChunk = 128;  // diagonals of query codes staged at a time

// query: (B, L1p); s2v/n2mask: (B, P); dsum: (B,); finals: (B, 3), zeroed.
// sp: the pair's split (cluster_split.cuh); block i holds CTA i % nctas of
// pair i / nctas.  CLUSTER: the pair is split over a cluster (sp.nctas > 1).
template <int LPT, int DIRS, bool COMPAT, bool WILDCARD, bool CLUSTER>
__global__ void __launch_bounds__(sa::kMaxThreads)
    gotoh_fill_kernel(const int32_t* __restrict__ query,
                      const int32_t* __restrict__ s2v,
                      const int32_t* __restrict__ dsum,
                      const int32_t* __restrict__ n2mask,
                      int32_t* __restrict__ finals,
                      uint32_t* __restrict__ dirs, int B, int L1p, int P,
                      int D_total, sa::Scheme sc, sa::Split sp) {
  static_assert(LPT <= 32, "the capture mask holds one bit a lane");
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
  const int32_t ds = dsum[b];

  sa::Cell c[LPT];
  uint32_t acc[LPT];
  uint32_t cap = 0;  // bit i: n2mask is set at lane base + i
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const size_t at = static_cast<size_t>(b) * P + base + i;
    c[i] = sa::cell_init(sa::kNegInf);
    c[i].s2v = real ? s2v[at] : 0;
    if (real && n2mask[at] != 0) cap |= 1u << i;
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
      const int32_t code = sa::stream_cell<DIRS, sa::kModeGlobal, COMPAT,
                                           WILDCARD>(
          c[i], pre[i], lH2, lpre, ls1d, x == 0, x == d, d, qc, c[i].s2v, sc);
      if (DIRS != sa::kDirsNone) acc[i] |= static_cast<uint32_t>(code) << shift;
    }

    if (d == ds && cap != 0) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if ((cap >> i) & 1u) {
          atomicAdd(finals + static_cast<size_t>(b) * 3 + 0, c[i].M1);
          atomicAdd(finals + static_cast<size_t>(b) * 3 + 1, c[i].I1);
          atomicAdd(finals + static_cast<size_t>(b) * 3 + 2, c[i].D1);
        }
      }
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
  // Keep this CTA's shared memory alive until its neighbour has read it.
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

typedef void (*GotohKernel)(const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, int32_t*, uint32_t*, int, int,
                            int, int, sa::Scheme, sa::Split);

template <int LPT, int DIRS, bool CL>
GotohKernel pick_flags(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? gotoh_fill_kernel<LPT, DIRS, true, true, CL>
                    : gotoh_fill_kernel<LPT, DIRS, true, false, CL>;
  }
  return wildcard ? gotoh_fill_kernel<LPT, DIRS, false, true, CL>
                  : gotoh_fill_kernel<LPT, DIRS, false, false, CL>;
}

// The two dirs modes of the TPU kernel: score-only and full 7-bit bytes.
template <int LPT, bool CL>
GotohKernel pick_cl(int dirs_mode, bool compat, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_flags<LPT, sa::kDirsNone, CL>(compat, wildcard);
    case sa::kDirsFull:
      return pick_flags<LPT, sa::kDirsFull, CL>(compat, wildcard);
    default:
      return nullptr;
  }
}

template <int LPT>
GotohKernel pick_dirs(const sa::Split& sp, int dirs_mode, bool compat,
                      bool wildcard) {
  return sp.nctas > 1 ? pick_cl<LPT, true>(dirs_mode, compat, wildcard)
                      : pick_cl<LPT, false>(dirs_mode, compat, wildcard);
}

}  // namespace

// query: (B, L1p) int32 codes; s2v: (B, P) int32 (db at lanes 1..L2);
// dsum: (B,) int32 = n1 + n2; n2mask: (B, P) int32; finals: (B, 3) int32,
// zeroed by the caller; dirs: (ceil(D_total/4), B, P) u32 full bytes, unused
// for dirs_mode 0.  dirs_mode: 0 (none) or 2 (full); cta_lanes: 0, or the
// forced CTA width of the split.  Returns the cudaGetLastError() of the
// launch, -1 for an unsupported shape or mode, -3 for a cluster the card
// cannot schedule.
extern "C" int sa_gotoh_fill(const int32_t* query, const int32_t* s2v,
                             const int32_t* dsum, const int32_t* n2mask,
                             int32_t* finals, uint32_t* dirs, int B, int L1p,
                             int P, int D_total, int match, int mismatch,
                             int gap_open, int gap_extend, int dirs_mode,
                             int compat, int wildcard, int cta_lanes,
                             void* stream) {
  const sa::Split sp = sa::plan_split(P, cta_lanes);
  if (sp.nctas == 0 || B <= 0 || L1p <= 0 || D_total <= 0) return -1;
  GotohKernel fn = nullptr;
  const bool c = compat != 0, w = wildcard != 0;
  switch (sp.lpt) {
    case 4: fn = pick_dirs<4>(sp, dirs_mode, c, w); break;
    case 8: fn = pick_dirs<8>(sp, dirs_mode, c, w); break;
    case 16: fn = pick_dirs<16>(sp, dirs_mode, c, w); break;
  }
  if (fn == nullptr) return -1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  sa::Split split = sp;
  void* args[] = {&query, &s2v, &dsum, &n2mask,  &finals, &dirs,
                  &B,     &L1p, &P,    &D_total, &sc,     &split};
  return sa::launch_split(reinterpret_cast<const void*>(fn), sp, B, args,
                          stream);
}

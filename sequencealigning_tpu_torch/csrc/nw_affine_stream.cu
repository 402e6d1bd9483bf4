// Streamed batched Gotoh fill for Hopper (sm_90a): global, semi-global and
// local modes.
//
// Replaces the TPU kernels ops/nw_affine_stream.py::_stream_kernel (launched
// by gotoh_fill_stream_pallas; global mode) and
// ops/nw_affine_stream_modes.py::_stream_modes_kernel (launched by
// gotoh_fill_stream_modes_pallas; textbook semi-global and local).  Same
// contracts as gotoh_fill_stream_lax / gotoh_fill_stream_modes_lax: each
// stream row pipelines np_slots pairs along the P lanes, a new pair entering
// every S steps.  Global mode writes each pair's M/I/D corner finals; the
// modes write each pair's per-lane running argmax (best score, local
// diagonal).  Direction words follow the reference layout (the code of cell
// (x, y) of slot k at step d = k*S + x + y sits in word dirs[d >> 3, row, x],
// nibble d & 7, for fast4; byte d & 3 of word dirs[d >> 2, row, x] for full).
//
// Design: one thread block per stream row up to 8192 lanes, past that one
// thread-block cluster per row (cluster_split.cuh: CTAs of 4096 or 8192
// lanes, the lane shift crossing CTA edges through distributed shared memory
// with one cluster barrier a step); each thread owns LPT consecutive lanes
// and keeps their state (H2, H1, M1, I1, D1, s1d, s2v) in registers.  The
// one-lane shift of the anti-diagonal recurrence is lane_shift.cuh: one
// barrier a step.  Query/db codes are staged in shared memory 128 steps at a
// time (each CTA of a cluster stages its own copy).  A pair's finals are
// written once, by the thread owning lane n2 at step k*S + n1 + n2;
// direction codes are packed in registers and stored as one coalesced u32
// per lane every 8 (fast4) or 4 (full) steps.  The cluster split costs a
// cluster barrier where one block pays a block barrier; rows past 32768
// lanes take the 16-lane variants, which spill.
//
// The modes' running argmax: lane x holds the younger pair (slot t / S) from
// step p == x of its slot and the older one before, so one (best, diagonal)
// register pair a lane suffices.  At p == x the lane writes its older pair's
// argmax to bv/bd[slot, row, x] and starts the younger's; the TPU kernel's
// even/odd parity accumulators and per-group merges have no counterpart.
//
// What bounds it on this card: the per-step barrier and the integer ALU
// work of the recurrence (~30 operations a cell, ~10 more for the modes'
// argmax), then the direction store bandwidth, 0.5 B a cell in fast4 and 1 B
// in full.  The modes' 8-lane variants sit at the 128-register cap, which
// leaves one block a SM where the global 4-lane variant fits two.  The TPU
// kernel's masked lane-reduce gather of the codes and its sequential (rows,
// slots, chunks) grid have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "cluster_split.cuh"
#include "lane_shift.cuh"
#include "nw_affine_stream.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCodeChunk = 128;  // steps of query/db codes staged at a time

// out: global mode, the (R*NP, 3) finals; the modes, bv then bd, each
// (NP, R, P).  sp: the row's split (cluster_split.cuh); block b holds CTA
// b % nctas of row b / nctas.  CLUSTER: the row is split over a cluster
// (sp.nctas > 1); the one-block instances keep the block barrier and local
// shared memory at compile time.
template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD,
          bool CLUSTER>
__global__ void __launch_bounds__(sa::kMaxThreads)
    stream_fill_kernel(const int32_t* __restrict__ qstream,
                       const int32_t* __restrict__ dstream,
                       const int32_t* __restrict__ dsum,
                       const int32_t* __restrict__ n2s,
                       int32_t* __restrict__ out,
                       uint32_t* __restrict__ dirs, int R, int T, int P,
                       int S, int NP, sa::Scheme sc, sa::Split sp) {
  constexpr bool kModes = MODE != sa::kModeGlobal;
  __shared__ int32_t qs[kCodeChunk];
  __shared__ int32_t ds[kCodeChunk];
  __shared__ sa::ShiftSmem sm;

  constexpr bool cluster = CLUSTER;
  int rank = 0;
  int row = blockIdx.x;
  if constexpr (CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    row = blockIdx.x / sp.nctas;
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

  sa::Cell c[LPT];
  uint32_t acc[LPT];
  int32_t bv[LPT], bd[LPT];  // the modes' running argmax
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    c[i] = sa::cell_init(kModes ? sa::kNegBig : sa::kNegInf);
    acc[i] = 0;
    bv[i] = sa::kNegBig;
    bd[i] = 0;
  }
  // The modes: lengths of the younger (slot k) and older (slot k-1) pairs,
  // n2 = -1 where the slot holds no pair.
  int slot = 0;
  int32_t n1y = -1, n2y = -1, n1o = -1, n2o = -1;
  const size_t plane = static_cast<size_t>(NP) * R * P;
  auto flush_argmax = [&](int k, int i) {
    if (k < 0 || k >= NP) return;
    const size_t at = (static_cast<size_t>(k) * R + row) * P + base + i;
    out[at] = bv[i];
    out[plane + at] = bd[i];
    bv[i] = sa::kNegBig;
    bd[i] = 0;
  };

  // Next step (after `after`) at which a pair's corner lies on one of this
  // thread's lanes; INT_MAX if none.
  auto next_capture = [&](int after) {
    int best = INT_MAX;
    if (kModes || !real) return best;
    for (int k = 0; k < NP; ++k) {
      const int x = n2s[k * R + row];
      const int tc = k * S + dsum[k * R + row];
      if (x >= base && x < base + LPT && tc > after && tc < best) best = tc;
    }
    return best;
  };
  int cap_next = next_capture(-1);

  const size_t code_row = static_cast<size_t>(row) * T;
  int p = 0;  // t mod S: the younger pair's local anti-diagonal
  for (int t = 0; t < T; ++t) {
    const int tc = t % kCodeChunk;
    if (tc == 0) {
      __syncthreads();
      for (int i = j; i < kCodeChunk; i += blockDim.x) {
        const int tt = t + i;
        qs[i] = tt < T ? qstream[code_row + tt] : 0;
        ds[i] = tt < T ? dstream[code_row + tt] : 0;
      }
      __syncthreads();
    }
    if (kModes && p == 0) {
      slot = t / S;
      n1o = n1y;
      n2o = n2y;
      n2y = slot < NP ? n2s[slot * R + row] : -1;
      n1y = slot < NP ? dsum[slot * R + row] - n2y : -1;
    }

    sa::Pre pre[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) pre[i] = sa::stream_pre<DIRS>(c[i], sc);

    // Hand this thread's last lane to the next thread.
    int32_t nH = c[LPT - 1].H2;
    int32_t nD = pre[LPT - 1].dsel;
    int32_t nS = c[LPT - 1].s1d | (pre[LPT - 1].dflag << 8);
    sa::shift_lanes(sm, prev, cluster, j, nreal, t & 1, nH, nD, nS);
    const int32_t qc = qs[tc];
    const int32_t dc = ds[tc];
    const uint32_t shift =
        DIRS == sa::kDirsFast4 ? 4u * (t & 7) : 8u * (t & 3);

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
      const int32_t code = sa::stream_cell<DIRS, MODE, COMPAT, WILDCARD>(
          c[i], pre[i], lH2, lpre, ls1d, x == 0, x == p, p, qc, dc, sc);
      if (DIRS != sa::kDirsNone) acc[i] |= static_cast<uint32_t>(code) << shift;
      if (kModes) {
        // Lane x turns over from the older pair to the younger at p == x.
        if (x == p && real) flush_argmax(slot - 1, i);
        const bool young = x <= p;
        const int32_t pk = young ? p : p + S;
        sa::modes_update<MODE>(x, pk - x, pk, young ? n1y : n1o,
                               young ? n2y : n2o, c[i].M1, c[i].H1, bv[i],
                               bd[i]);
      }
    }

    if (!kModes && t == cap_next) {
      for (int k = 0; k < NP; ++k) {
        const int x = n2s[k * R + row];
        if (k * S + dsum[k * R + row] != t || x < base || x >= base + LPT)
          continue;
        int32_t* f = out + (static_cast<size_t>(row) * NP + k) * 3;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          if (base + i == x) {
            f[0] = c[i].M1;
            f[1] = c[i].I1;
            f[2] = c[i].D1;
          }
        }
      }
      cap_next = next_capture(t);
    }

    if (DIRS != sa::kDirsNone) {
      const bool flush =
          DIRS == sa::kDirsFast4 ? (t & 7) == 7 : (t & 3) == 3;
      if (flush) {
        if (real) {
          const int w = DIRS == sa::kDirsFast4 ? t >> 3 : t >> 2;
          uint32_t* dst =
              dirs + (static_cast<size_t>(w) * R + row) * P + base;
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
    if (++p == S) p = 0;
  }
  if (kModes && real) {
    // The last slot's pair, when it is real (T may end within its window):
    // lanes below S hold it, lanes at or past S never held an eligible cell.
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      if (base + i < S) flush_argmax(slot, i);
    }
  }
  // Keep this CTA's shared memory alive until its neighbour has read it.
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

typedef void (*FillKernel)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, int32_t*, uint32_t*, int, int, int,
                           int, int, sa::Scheme, sa::Split);

template <int LPT, int DIRS, int MODE, bool CL>
FillKernel pick_flags(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? stream_fill_kernel<LPT, DIRS, MODE, true, true, CL>
                    : stream_fill_kernel<LPT, DIRS, MODE, true, false, CL>;
  }
  return wildcard ? stream_fill_kernel<LPT, DIRS, MODE, false, true, CL>
                  : stream_fill_kernel<LPT, DIRS, MODE, false, false, CL>;
}

template <int LPT, bool CL>
FillKernel pick_dirs(int dirs_mode, bool compat, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_flags<LPT, sa::kDirsNone, sa::kModeGlobal, CL>(compat,
                                                                 wildcard);
    case sa::kDirsFast4:
      return pick_flags<LPT, sa::kDirsFast4, sa::kModeGlobal, CL>(compat,
                                                                  wildcard);
    case sa::kDirsFull:
      return pick_flags<LPT, sa::kDirsFull, sa::kModeGlobal, CL>(compat,
                                                                 wildcard);
    default:
      return nullptr;
  }
}

// The textbook modes: textbook scoring (compat false), dirs none or full.
template <int LPT, int MODE, bool CL>
FillKernel pick_modes_dirs(int dirs_mode, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return wildcard
                 ? stream_fill_kernel<LPT, sa::kDirsNone, MODE, false, true, CL>
                 : stream_fill_kernel<LPT, sa::kDirsNone, MODE, false, false,
                                      CL>;
    case sa::kDirsFull:
      return wildcard
                 ? stream_fill_kernel<LPT, sa::kDirsFull, MODE, false, true, CL>
                 : stream_fill_kernel<LPT, sa::kDirsFull, MODE, false, false,
                                      CL>;
    default:
      return nullptr;
  }
}

template <int LPT, bool CL>
FillKernel pick_modes(int dirs_mode, bool local, bool wildcard) {
  return local ? pick_modes_dirs<LPT, sa::kModeLocal, CL>(dirs_mode, wildcard)
               : pick_modes_dirs<LPT, sa::kModeSemi, CL>(dirs_mode, wildcard);
}

// The instance for a split: the cluster instances for more than one CTA.
template <int LPT>
FillKernel pick_global(const sa::Split& sp, int dirs_mode, bool compat,
                       bool wildcard) {
  return sp.nctas > 1 ? pick_dirs<LPT, true>(dirs_mode, compat, wildcard)
                      : pick_dirs<LPT, false>(dirs_mode, compat, wildcard);
}

template <int LPT>
FillKernel pick_textbook(const sa::Split& sp, int dirs_mode, bool local,
                         bool wildcard) {
  return sp.nctas > 1 ? pick_modes<LPT, true>(dirs_mode, local, wildcard)
                      : pick_modes<LPT, false>(dirs_mode, local, wildcard);
}

int launch(FillKernel fn, const sa::Split& sp, const int32_t* qstream,
           const int32_t* dstream, const int32_t* dsum, const int32_t* n2,
           int32_t* out, uint32_t* dirs, int R, int T, int P, int S, int NP,
           sa::Scheme sc, void* stream) {
  if (fn == nullptr) return -1;
  sa::Split split = sp;
  void* args[] = {&qstream, &dstream, &dsum, &n2, &out, &dirs, &R,
                  &T,       &P,       &S,    &NP, &sc,  &split};
  return sa::launch_split(reinterpret_cast<const void*>(fn), sp, R, args,
                          stream);
}

}  // namespace

// CTAs a row of P lanes takes (cluster_split.cuh::plan_split; cta_lanes 0
// for the automatic split), 0 if P or cta_lanes is out of range.
extern "C" int sa_fill_ctas(int P, int cta_lanes) {
  return sa::plan_split(P, cta_lanes).nctas;
}

// qstream/dstream: (R, T) int32 codes; dsum/n2: (NP, R) int32; finals:
// (R*NP, 3) int32, pair b = row b / NP, slot b % NP; dirs: (T/8, R, P) u32
// for fast4, (T/4, R, P) for full, unused for none.  cta_lanes: 0, or the
// forced CTA width of the split.  Returns the cudaGetLastError() of the
// launch, -1 for an unsupported shape or mode, -3 for a cluster the card
// cannot schedule.
extern "C" int sa_stream_fill(const int32_t* qstream, const int32_t* dstream,
                              const int32_t* dsum, const int32_t* n2,
                              int32_t* finals, uint32_t* dirs, int R, int T,
                              int P, int S, int NP, int match, int mismatch,
                              int gap_open, int gap_extend, int dirs_mode,
                              int compat, int wildcard, int cta_lanes,
                              void* stream) {
  const sa::Split sp = sa::plan_split(P, cta_lanes);
  if (sp.nctas == 0 || R <= 0 || T <= 0 || S <= 0 || NP <= 0) return -1;
  FillKernel fn = nullptr;
  switch (sp.lpt) {
    case 4:
      fn = pick_global<4>(sp, dirs_mode, compat != 0, wildcard != 0);
      break;
    case 8:
      fn = pick_global<8>(sp, dirs_mode, compat != 0, wildcard != 0);
      break;
    case 16:
      fn = pick_global<16>(sp, dirs_mode, compat != 0, wildcard != 0);
      break;
  }
  return launch(fn, sp, qstream, dstream, dsum, n2, finals, dirs, R, T, P, S,
                NP, sa::Scheme{match, mismatch, gap_open, gap_extend}, stream);
}

// The textbook modes (local != 0: local, else semi-global), same layout but
// out: bv then bd, each (NP, R, P) int32, pre-filled with (NEGBIG, 0): the
// kernel writes lanes below S only.  dirs_mode: 0 (none) or 2 (full).
extern "C" int sa_stream_modes_fill(const int32_t* qstream,
                                    const int32_t* dstream,
                                    const int32_t* dsum, const int32_t* n2,
                                    int32_t* out, uint32_t* dirs, int R, int T,
                                    int P, int S, int NP, int match,
                                    int mismatch, int gap_open,
                                    int gap_extend, int dirs_mode, int local,
                                    int wildcard, int cta_lanes,
                                    void* stream) {
  const sa::Split sp = sa::plan_split(P, cta_lanes);
  if (sp.nctas == 0 || R <= 0 || T <= 0 || S <= 0 || NP <= 0) return -1;
  FillKernel fn = nullptr;
  switch (sp.lpt) {
    case 4:
      fn = pick_textbook<4>(sp, dirs_mode, local != 0, wildcard != 0);
      break;
    case 8:
      fn = pick_textbook<8>(sp, dirs_mode, local != 0, wildcard != 0);
      break;
    case 16:
      fn = pick_textbook<16>(sp, dirs_mode, local != 0, wildcard != 0);
      break;
  }
  return launch(fn, sp, qstream, dstream, dsum, n2, out, dirs, R, T, P, S,
                NP, sa::Scheme{match, mismatch, gap_open, gap_extend}, stream);
}

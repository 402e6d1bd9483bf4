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
// Design: the warp rings of the streamed fills (stream_ring.cuh), one pair
// a row.  A pair's lanes are split over a cluster of a few CTAs on distinct
// SMs (stream_ring.cuh::pair_plan: about SMs / B CTAs a pair, so the small
// batches this kernel serves fill the card), LPT consecutive lanes a thread
// in registers, and each warp sweeps at its own pace: its first lane's left
// neighbour arrives through a ring in shared memory (the next CTA's, through
// distributed shared memory, for a CTA's last warp), one acquire and one
// release a chunk of steps, no block barrier a step.  A warp sweeps only the
// steps that hold cells of the pair's matrix on its lanes: from its first
// lane's row-0 cell to its last lane's row-n1 cell, plus one step that feeds
// the next warp; a warp wholly past the pair's db sweeps none.  Its lanes
// start from the state the skipped triangle above the matrix leaves them in
// (nw_affine_stream.cuh::triangle_state).  The cell is stream_cell with
// modes_update, each lane in increasing y, so the earliest diagonal wins.
// Every byte of a cell outside the pair's matrix is written 0, and so are
// lane 0's D bits (the plain version takes them from lane P-1 through the
// torus roll; no walker reads them): every dirs word is written.  A wait
// that stalls sets the launch's status word and the wrapper raises.
//
// What bounds it on this card: the serial chain of a pair's D_total steps,
// each a warp's step of LPT cells (its compares and selects); the skipped
// triangles halve the lane-steps of the old one-block-a-pair kernel, and the
// split puts a small batch on most of the SMs instead of one a pair.  The
// TPU kernel's (batch tiles, diagonal chunks) grid and its masked
// lane-reduce gather of the query column have no counterpart here.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_split.cuh"
#include "nw_affine_stream.cuh"
#include "stream_ring.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;

using Ring = sa::RingShape;

// A thread's lanes: their state (c[i].s2v the lane's db code), direction
// words, running argmax, and lim[i]: the steps t with (unsigned)(t - x) <
// lim[i] hold a cell of the pair's matrix (n1 + 1 for x <= n2, else 0).
template <int LPT>
struct PairLanes {
  sa::Cell c[LPT];
  uint32_t acc[LPT];
  int32_t bv[LPT], bd[LPT];
  uint32_t lim[LPT];
};

// Lane I of one step t of a thread's lanes, then lanes I-1 .. 0: right to
// left, so lane i-1 still holds its pre-step state for lane i (a recursion
// rather than a loop, so the lanes stay in registers).  mine: lane I's
// stream_pre, computed by the lane to its right; (lH, lD, lS): what the lane
// left of lane 0 handed over (H2, merged D source, query code | D bits <<
// 8); qc: the step's query code (lane 0 of the pair only).
template <int I, int LPT, int DIRS, int MODE, bool WILDCARD>
__device__ __forceinline__ void pair_lanes(PairLanes<LPT>& L,
                                           const sa::Pre& mine, int32_t lH,
                                           int32_t lD, int32_t lS, int t,
                                           int base, int32_t qc, int32_t n1,
                                           int32_t n2, uint32_t shift,
                                           const sa::Scheme& sc) {
  const int x = base + I;
  int32_t lh2, ls1d;
  sa::Pre left;
  if constexpr (I == 0) {
    lh2 = lH;
    left.t0 = 0;
    left.dsel = lD;
    left.dflag = lS >> 8;
    ls1d = lS & 0xff;
  } else {
    left = sa::stream_pre<DIRS>(L.c[I - 1], sc);
    lh2 = L.c[I - 1].H2;
    ls1d = L.c[I - 1].s1d;
  }
  int32_t code = sa::stream_cell<DIRS, MODE, false, WILDCARD>(
      L.c[I], mine, lh2, left, ls1d, x == 0, x == t, t, qc, L.c[I].s2v, sc);
  if constexpr (DIRS != sa::kDirsNone) {
    if (static_cast<uint32_t>(t - x) >= L.lim[I]) code = 0;
    L.acc[I] |= static_cast<uint32_t>(code) << shift;
  }
  sa::modes_update<MODE>(x, t - x, t, n1, n2, L.c[I].M1, L.c[I].H1, L.bv[I],
                         L.bd[I]);
  if constexpr (I > 0) {
    pair_lanes<I - 1, LPT, DIRS, MODE, WILDCARD>(L, left, lH, lD, lS, t, base,
                                                 qc, n1, n2, shift, sc);
  }
}

// Zeroes words [w0, w1) of a thread's LPT lanes starting at dst (row
// stride `stride` words).
template <int LPT>
__device__ __forceinline__ void zero_words(uint32_t* dst, size_t stride,
                                           int w0, int w1) {
  for (int w = w0; w < w1; ++w) {
    uint32_t* p = dst + static_cast<size_t>(w) * stride;
    if constexpr (LPT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < LPT; i += 4) {
        *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
      }
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(0, 0);
    }
  }
}

// Stores a thread's direction words of word row w (when its lanes are
// real) and clears them.
template <int LPT>
__device__ __forceinline__ void store_words(PairLanes<LPT>& L, uint32_t* dst0,
                                            size_t stride, int w, bool real) {
  if (real) {
    uint32_t* dst = dst0 + static_cast<size_t>(w) * stride;
    if constexpr (LPT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < LPT; i += 4) {
        *reinterpret_cast<uint4*>(dst + i) =
            make_uint4(L.acc[i], L.acc[i + 1], L.acc[i + 2], L.acc[i + 3]);
      }
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(L.acc[0], L.acc[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < LPT; ++i) L.acc[i] = 0;
}

// out: bv then bd, each (B, P) int32.  sp: the pair's split
// (stream_ring.cuh::pair_plan); block i holds CTA i % nctas of pair i /
// nctas.  status: set when a wait stalls.
template <int LPT, int DIRS, int MODE, bool WILDCARD>
__global__ void __launch_bounds__(sa::pair_max_threads(LPT))
    modes_pair_kernel(const int32_t* __restrict__ query,
                      const int32_t* __restrict__ s2v,
                      const int32_t* __restrict__ n1s,
                      const int32_t* __restrict__ n2s,
                      int32_t* __restrict__ out, uint32_t* __restrict__ dirs,
                      int32_t* status, int B, int L1, int P, int D_total,
                      sa::Scheme sc, sa::Split sp, Ring rg) {
  constexpr bool kDirs = DIRS != sa::kDirsNone;
  constexpr int kWarpLanes = 32 * LPT;
  __shared__ sa::RingSmem sm;

  const bool cluster = sp.nctas > 1;
  int rank = 0;
  int b = blockIdx.x;
  if (cluster) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    b = blockIdx.x / sp.nctas;
  }
  const int j = threadIdx.x;
  const int warp = j >> 5;
  const int wl = j & 31;
  const int cta_lanes = sa::cta_real_lanes(rank, sp, P);
  const int nreal = cta_lanes / LPT;
  const int nwarps = (nreal + 31) >> 5;
  const int cta0 = sa::cta_first_lane(rank, sp);
  const int C = rg.chunk;
  const int32_t n1 = n1s[b];
  const int32_t n2 = n2s[b];

  // A warp's lanes [wb, we); the next warp starts at we (in the next CTA
  // for the CTA's last warp).
  auto warp_end = [&](int u) {
    const int e = cta0 + (u + 1) * kWarpLanes;
    return e < cta0 + cta_lanes ? e : cta0 + cta_lanes;
  };
  if (j < sa::kRingMaxWarps) {
    sm.full[j] = 0;
    // Chunks of warp j's output its consumer never reads: those before the
    // consumer's first step, the consumer's first lane.
    sm.freed[j] = warp_end(j) / C;
  }
  if (cluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  const int wb = cta0 + warp * kWarpLanes;
  const int we = warp_end(warp);
  const bool real = j < nreal;
  const int base = cta0 + j * LPT;
  const int W = (D_total + 3) >> 2;
  const size_t stride = static_cast<size_t>(B) * P;
  uint32_t* dst0 = dirs + static_cast<size_t>(b) * P + base;
  // The warp sweeps steps [wb, t_end]: its first lane's row-0 cell to its
  // last lane's row-n1 cell, and one more step when the next warp holds
  // lanes of the pair's db (its first lane needs the state after t_end).
  const bool active = warp < nwarps && n1 >= 0 && n2 >= 0 && wb <= n2;
  const bool has_next = active && we <= n2;
  const int t_end = (we - 1 < n2 ? we - 1 : n2) + n1 + (has_next ? 1 : 0);

  PairLanes<LPT> L;
  bool stalled = false;
  if (active) {
    const sa::Cell tri = sa::triangle_state<MODE>(wb - 1, sc);
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int x = base + i;
      L.c[i] = tri;
      L.c[i].s1d = 0;
      L.c[i].s2v = real ? s2v[static_cast<size_t>(b) * P + x] : 0;
      L.acc[i] = 0;
      L.bv[i] = sa::kNegBig;
      L.bd[i] = 0;
      L.lim[i] = x <= n2 ? static_cast<uint32_t>(n1 + 1) : 0u;
    }
    // The words before the warp's first step hold no cell of its lanes.
    if (kDirs && real) zero_words<LPT>(dst0, stride, 0, wb >> 2);

    const bool head = wb == 0;  // holds lane 0
    const bool lane0 = head && j == 0;
    const bool consumer = wl == 0 && !head;
    // The thread of the warp's last lane feeds the next warp's ring.
    const bool producer = has_next && base + LPT == we;
    const bool last_warp = warp == nwarps - 1;
    const bool out_remote = last_warp && cluster;
    // A ring between two CTAs is waited on at the cluster scope, one inside
    // a CTA at the CTA scope (with the deferred store below, one pair of
    // 2046 bp semi-global took 1.32 ms against 1.46 with neither on an
    // NVIDIA H100 80GB HBM3 at 700 W, csrc/stream_sweep.py --others).
    const bool in_remote = warp == 0 && cluster;
    const int nxt_w = last_warp ? 0 : warp + 1;
    // The consumer waits only for the chunks holding its first lane's
    // cells: the producer's last step is wb + n1.
    const int need_end = wb + n1;
    const size_t qrow = static_cast<size_t>(b) * L1;
    auto qcode = [&](int t) {
      const int q = t - 1 < 0 ? 0 : (t - 1 > L1 - 1 ? L1 - 1 : t - 1);
      return query[qrow + q];
    };
    const int k0 = wb / C;
    int32_t next = head && wl < C ? qcode(k0 * C + wl) : 0;
    for (int k = k0; k * C <= t_end; ++k) {
      const uint32_t in_full = sa::smem_addr(&sm.full[warp]);
      const uint32_t out_freed = sa::smem_addr(&sm.freed[warp]);
      bool bad = false;
      if (consumer && k * C <= need_end) {
        bad = !sa::ring_wait(in_full, sa::ring_full_need(k), in_remote,
                             status);
      }
      if (producer) {
        bad |= !sa::ring_wait(out_freed, sa::ring_free_need(k, rg.slots),
                              out_remote, status);
      }
      if (__any_sync(kFull, bad)) {
        stalled = true;
        break;
      }
      // What the first thread acquired, for the rest of the warp.
      __syncwarp();
      const int32_t codes = next;
      if (head && wl < C) next = qcode((k + 1) * C + wl);
      const uint32_t at = 16 * (k % rg.slots) * C;
      const uint32_t rin = sa::smem_addr(sm.entry[warp]) + at;
      uint32_t rout = sa::smem_addr(sm.entry[nxt_w]) + at;
      if (out_remote) rout = sa::cluster_addr(rout, rank + 1);
      const int t_lo = k * C > wb ? k * C : wb;
      const int t_hi = k * C + C - 1 < t_end ? k * C + C - 1 : t_end;
      // The words the chunk's last step completes are stored after its
      // releases, so a release does not wait for a store just issued.
      bool deferred = false;
      for (int t = t_lo; t <= t_hi; ++t) {
        const int e = t - k * C;
        int4 left = make_int4(0, 0, 0, 0);
        if (consumer) left = sa::ring_get(rin + 16 * e);
        const sa::Pre last = sa::stream_pre<DIRS>(L.c[LPT - 1], sc);
        const int32_t nH = L.c[LPT - 1].H2;
        const int32_t nD = last.dsel;
        const int32_t nS = L.c[LPT - 1].s1d | last.dflag << 8;
        if (producer) sa::ring_put(rout + 16 * e, out_remote, nH, nD, nS);
        int32_t lH = __shfl_up_sync(kFull, nH, 1);
        int32_t lD = __shfl_up_sync(kFull, nD, 1);
        int32_t lS = __shfl_up_sync(kFull, nS, 1);
        if (consumer) {
          lH = left.x;
          lD = left.y;
          lS = left.z;
        }
        int32_t qc = 0;
        if (head) {
          qc = __shfl_sync(kFull, codes, e);
          // Lane 0 takes no D bits from the left (a fixed 0).
          if (lane0) lS = 0;
        }
        pair_lanes<LPT - 1, LPT, DIRS, MODE, WILDCARD>(
            L, last, lH, lD, lS, t, base, qc, n1, n2, 8u * (t & 3), sc);
        if (kDirs && ((t & 3) == 3 || t == t_end)) {
          if (t == t_hi) {
            deferred = true;
          } else {
            store_words<LPT>(L, dst0, stride, t >> 2, real);
          }
        }
      }
      __syncwarp();
      if (consumer) {
        // The producer's count: the warp to the left, or the previous
        // CTA's last warp.
        uint32_t in_freed = sa::smem_addr(&sm.freed[warp > 0 ? warp - 1 : 0]);
        if (warp == 0) {
          in_freed = sa::cluster_addr(
              sa::smem_addr(&sm.freed[sa::ring_warps(rank - 1, sp, P) - 1]),
              rank - 1);
        }
        sa::ring_release(in_freed, k + 1, in_remote);
      }
      if (producer) {
        uint32_t out_full = sa::smem_addr(&sm.full[nxt_w]);
        if (last_warp) out_full = sa::cluster_addr(out_full, rank + 1);
        sa::ring_release(out_full, k + 1, out_remote);
      }
      if (deferred) store_words<LPT>(L, dst0, stride, t_hi >> 2, real);
    }
    if (kDirs && real && !stalled) {
      zero_words<LPT>(dst0, stride, (t_end >> 2) + 1, W);
    }
  } else if (real && warp < nwarps) {
    // No cell of the pair on these lanes.
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      L.bv[i] = sa::kNegBig;
      L.bd[i] = 0;
    }
    if (kDirs) zero_words<LPT>(dst0, stride, 0, W);
  }
  if (real && !stalled) {
    const size_t at = static_cast<size_t>(b) * P + base;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      out[at + i] = L.bv[i];
      out[stride + at + i] = L.bd[i];
    }
  }
  // Keep this CTA's shared memory alive until its neighbours are done.
  if (cluster) cg::this_cluster().sync();
}

typedef void (*PairKernel)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, int32_t*, uint32_t*, int32_t*, int,
                           int, int, int, sa::Scheme, sa::Split, Ring);

template <int LPT, int DIRS>
PairKernel pick_mode(bool local, bool wildcard) {
  if (local) {
    return wildcard ? modes_pair_kernel<LPT, DIRS, sa::kModeLocal, true>
                    : modes_pair_kernel<LPT, DIRS, sa::kModeLocal, false>;
  }
  return wildcard ? modes_pair_kernel<LPT, DIRS, sa::kModeSemi, true>
                  : modes_pair_kernel<LPT, DIRS, sa::kModeSemi, false>;
}

template <int LPT>
PairKernel pick_dirs(int dirs_mode, bool local, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_mode<LPT, sa::kDirsNone>(local, wildcard);
    case sa::kDirsFull:
      return pick_mode<LPT, sa::kDirsFull>(local, wildcard);
    default:
      return nullptr;
  }
}

}  // namespace

// The current device's SMs (nw_banded_diag.cu).
extern "C" int sa_sm_count();

// The per-pair modes fill's launch shape for B pairs of P lanes on the
// current device (stream_ring.cuh::pair_launch_shape; 0 takes the default):
// shape[0..4] = lanes a thread, threads a CTA, CTAs a pair, chunk steps,
// slots.  Returns 0, or -1 when out of range.
extern "C" int sa_modes_plan(int P, int B, int cta_lanes, int lpt, int chunk,
                             int slots, int* shape) {
  return sa::pair_launch_shape(P, B, sa_sm_count(), cta_lanes, lpt, chunk,
                               slots, shape);
}

// query: (B, L1) int32 codes; s2v: (B, P) int32 (db at lanes 1..L2); n1/n2:
// (B,) int32 lengths; out: bv then bd, each (B, P) int32; dirs:
// (ceil(D_total/4), B, P) u32 full bytes, unused for dirs_mode 0.  dirs_mode:
// 0 (none) or 2 (full); local != 0: local, else semi-global; cta_lanes: 0,
// or the forced CTA width of the split; status: one int32, zeroed, set when
// a wait stalls; lpt, chunk, slots: 0, or the forced lanes a thread and
// rings (stream_ring.cuh::pair_plan, ring_shape).  Returns the
// cudaGetLastError() of the launch, -1 for an unsupported shape or mode, -3
// for a cluster the card cannot schedule.
extern "C" int sa_modes_fill(const int32_t* query, const int32_t* s2v,
                             const int32_t* n1, const int32_t* n2,
                             int32_t* out, uint32_t* dirs, int B, int L1,
                             int P, int D_total, int match, int mismatch,
                             int gap_open, int gap_extend, int dirs_mode,
                             int local, int wildcard, int cta_lanes,
                             int32_t* status, int lpt, int chunk, int slots,
                             void* stream) {
  sa::Split sp = sa::pair_plan(P, B, sa_sm_count(), cta_lanes, lpt);
  Ring rg = sa::ring_shape(chunk, slots, 0, true);
  if (sp.nctas == 0 || B <= 0 || L1 <= 0 || D_total <= 0 ||
      status == nullptr || !sa::ring_ok(rg)) {
    return -1;
  }
  PairKernel fn = nullptr;
  switch (sp.lpt) {
    case 2: fn = pick_dirs<2>(dirs_mode, local != 0, wildcard != 0); break;
    case 4: fn = pick_dirs<4>(dirs_mode, local != 0, wildcard != 0); break;
    case 8: fn = pick_dirs<8>(dirs_mode, local != 0, wildcard != 0); break;
    case 16: fn = pick_dirs<16>(dirs_mode, local != 0, wildcard != 0); break;
  }
  if (fn == nullptr) return -1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  void* args[] = {&query, &s2v, &n1, &n2,      &out, &dirs, &status,
                  &B,     &L1,  &P,  &D_total, &sc,  &sp,   &rg};
  return sa::launch_split(reinterpret_cast<const void*>(fn), sp, B, args,
                          stream);
}

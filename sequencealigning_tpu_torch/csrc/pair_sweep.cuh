// The per-pair warp-ring sweep of the per-pair fills (device code, its
// arguments shared with the host build):
// kernel #6 (nw_affine_modes.cu), kernel #7 (nw_affine.cu) and the linear
// fill (nw_linear.cu) are this sweep with their own cell.
//
// Each pair keeps its db on P lanes (s2v[b, 1..L2]) and sweeps the
// anti-diagonal steps t of its matrix, lane x of step t being cell (x,
// t - x); lane 0 and lane t are the boundaries.  A pair's lanes are split
// over a cluster of a few CTAs on distinct SMs (stream_ring.cuh::pair_plan),
// LPT consecutive lanes a thread in registers, and each warp sweeps at its
// own pace: its first lane's left neighbour arrives through a ring in
// shared memory (the next CTA's, through distributed shared memory, for a
// CTA's last warp), one acquire and one release a chunk of steps, no block
// barrier a step.  A warp sweeps only the steps that hold cells of the
// pair's matrix on its lanes: from its first lane's row-0 cell to its last
// lane's row-n1 cell, plus one step that feeds the next warp; a warp wholly
// past the pair's db sweeps none.  Lane 0 takes the step's query code and
// nothing from the left (no torus: lane 0's D bits are 0).  Every byte of a
// cell outside the pair's matrix is written 0, so every dirs word is
// written: no walker reads those bytes.  A wait that stalls sets the
// launch's status word and the wrapper raises.
//
// A cell policy Pol gives the sweep its lanes and its cell:
//   kDirs                       whether the launch writes dirs words;
//   Lanes<LPT>                  a thread's lanes: their state, acc[LPT]
//                               (the dirs words being built) and lim[LPT]
//                               (the steps t with (unsigned)(t - x) <
//                               lim[i] hold a cell of the pair's matrix);
//   start(L, a, b, base, real, wb, n1, n2)
//                               a warp's lanes before its first step wb;
//   Hand hand(L, sc)            what the thread's last lane hands the next
//                               lane before a step (.h, .d, .s: the ring
//                               entry), computed once;
//   step<LPT, PHASE>(L, hand, lH, lD, lS, t, base, qc, n1, n2, shift, sc)
//                               one step of the thread's lanes, lane 0 of
//                               them taking (lH, lD, lS) from the left, each
//                               code shifted by `shift` into acc; past
//                               kPhaseHead no lane is at its row-0 cell
//                               (lane t), so the cell drops that boundary,
//                               and in kPhaseFull every lane's cell lies in
//                               the matrix, so no code is masked;
//   kPhases                     whether the steps run in the three phases
//                               (else every step as kPhaseHead: three
//                               copies of the step made #6's one-pair
//                               latency grow);
//   finish(L, a, b, base, real, active, n1, n2, t_end)
//                               the thread's results, once the warp has
//                               swept (warp-uniform, not after a stall).
//
// The arguments (PairArgs) are shared with the serial host build
// (host_check.cpp), which runs the same schedule warp by warp.
#pragma once

#include <stdint.h>

#include "cluster_split.cuh"
#include "nw_affine_stream.cuh"
#include "nw_linear.cuh"
#include "stream_ring.cuh"

namespace sa {

// A per-pair fill's inputs and outputs.  out / out2 / maxv are the cell
// policy's (the argmax buffers, the finals, the corner and maxima).
struct PairArgs {
  const int32_t* query;  // (B, L1) query codes
  const int32_t* s2v;    // (B, P) db codes at lanes 1..L2
  const int32_t* n1s;    // (B,) the pairs' lengths
  const int32_t* n2s;
  const int32_t* maxv;
  int32_t* out;
  int32_t* out2;
  uint32_t* dirs;        // (ceil(D_total / 4), B, P), or null
  int32_t* status;       // set when a wait stalls
  int B, L1, P, D_total;
  Scheme sc;
};

}  // namespace sa

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace sa {

constexpr unsigned kWarpFull = 0xffffffffu;

// A step's phase for the cell policy (pair_sweep_kernel's steps): a lane
// may hold its row-0 cell; every lane's cell lies in the pair's matrix; or
// neither.
enum { kPhaseHead = 0, kPhaseFull = 1, kPhaseMasked = 2 };

// A per-pair CTA's rings (at most 512 threads, 16 warps): entry[w] is warp
// w's input ring, full[w] counts the chunks published into it, freed[w] the
// chunks of warp w's output ring its consumer has read.
constexpr int kPairMaxWarps = 16;
struct PairRingSmem {
  int4 entry[kPairMaxWarps][kRingMaxEntries];
  int32_t full[kPairMaxWarps];
  int32_t freed[kPairMaxWarps];
};

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
__device__ __forceinline__ void store_words(uint32_t (&acc)[LPT],
                                            uint32_t* dst0, size_t stride,
                                            int w, bool real) {
  if (real) {
    uint32_t* dst = dst0 + static_cast<size_t>(w) * stride;
    if constexpr (LPT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < LPT; i += 4) {
        *reinterpret_cast<uint4*>(dst + i) =
            make_uint4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
      }
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(acc[0], acc[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < LPT; ++i) acc[i] = 0;
}

// The sweep.  sp: the pair's split (stream_ring.cuh::pair_plan); block i
// holds CTA i % nctas of pair i / nctas.
template <class Pol, int LPT>
__global__ void __launch_bounds__(pair_max_threads(LPT))
    pair_sweep_kernel(const int32_t* __restrict__ query,
                      const int32_t* __restrict__ s2v,
                      const int32_t* __restrict__ n1s,
                      const int32_t* __restrict__ n2s, const int32_t* maxv,
                      int32_t* out, int32_t* out2, uint32_t* dirs,
                      int32_t* status, int B, int L1, int P, int D_total,
                      Scheme sc, Split sp, RingShape rg) {
  namespace cg = cooperative_groups;
  // The arguments one by one: as one struct, #6's one-pair latency grew.
  const PairArgs a{query, s2v, n1s,   n2s, maxv, out,     out2,
                   dirs,  status, B, L1,  P,    D_total, sc};
  constexpr bool kDirs = Pol::kDirs;
  constexpr int kWarpLanes = 32 * LPT;
  __shared__ PairRingSmem sm;

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
  const int cta_lanes = cta_real_lanes(rank, sp, P);
  const int nreal = cta_lanes / LPT;
  const int nwarps = (nreal + 31) >> 5;
  const int cta0 = cta_first_lane(rank, sp);
  const int C = rg.chunk;
  const int32_t n1 = a.n1s[b];
  const int32_t n2 = a.n2s[b];

  // A warp's lanes [wb, we); the next warp starts at we (in the next CTA
  // for the CTA's last warp).
  auto warp_end = [&](int u) {
    const int e = cta0 + (u + 1) * kWarpLanes;
    return e < cta0 + cta_lanes ? e : cta0 + cta_lanes;
  };
  if (j < kPairMaxWarps) {
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
  const int W = (a.D_total + 3) >> 2;
  const size_t stride = static_cast<size_t>(a.B) * P;
  uint32_t* dst0 = a.dirs + static_cast<size_t>(b) * P + base;
  // The warp sweeps steps [wb, t_end]: its first lane's row-0 cell to its
  // last lane's row-n1 cell, and one more step when the next warp holds
  // lanes of the pair's db (its first lane needs the state after t_end);
  // never past the launch's last step.
  const bool active = warp < nwarps && n1 >= 0 && n2 >= 0 && wb <= n2;
  const bool has_next = active && we <= n2;
  int t_end = (we - 1 < n2 ? we - 1 : n2) + n1 + (has_next ? 1 : 0);
  if (t_end > a.D_total - 1) t_end = a.D_total - 1;

  typename Pol::template Lanes<LPT> L;
  bool stalled = false;
  if (active) {
    Pol::template start<LPT>(L, a, b, base, real, wb, n1, n2);
    // The words before the warp's first step hold no cell of its lanes.
    if (kDirs && real) zero_words<LPT>(dst0, stride, 0, wb >> 2);

    const bool head_warp = wb == 0;  // holds lane 0
    const bool lane0 = head_warp && j == 0;
    const bool consumer = wl == 0 && !head_warp;
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
    // The last step of kPhaseFull (none when the warp holds lanes past n2).
    const int full_end = we - 1 <= n2 ? wb + n1 : -1;
    const size_t qrow = static_cast<size_t>(b) * a.L1;
    const int L1 = a.L1;
    auto qcode = [&](int t) {
      const int q = t - 1 < 0 ? 0 : (t - 1 > L1 - 1 ? L1 - 1 : t - 1);
      return a.query[qrow + q];
    };
    const int k0 = wb / C;
    int32_t next = head_warp && wl < C ? qcode(k0 * C + wl) : 0;
    for (int k = k0; k * C <= t_end; ++k) {
      const uint32_t in_full = smem_addr(&sm.full[warp]);
      const uint32_t out_freed = smem_addr(&sm.freed[warp]);
      bool bad = false;
      if (consumer && k * C <= need_end) {
        bad = !ring_wait(in_full, ring_full_need(k), in_remote, a.status);
      }
      if (producer) {
        bad |= !ring_wait(out_freed, ring_free_need(k, rg.slots), out_remote,
                          a.status);
      }
      if (__any_sync(kWarpFull, bad)) {
        stalled = true;
        break;
      }
      // What the first thread acquired, for the rest of the warp.
      __syncwarp();
      const int32_t codes = next;
      if (head_warp && wl < C) next = qcode((k + 1) * C + wl);
      const uint32_t at = 16 * (k % rg.slots) * C;
      const uint32_t rin = smem_addr(sm.entry[warp]) + at;
      uint32_t rout = smem_addr(sm.entry[nxt_w]) + at;
      if (out_remote) rout = cluster_addr(rout, rank + 1);
      const int t_lo = k * C > wb ? k * C : wb;
      const int t_hi = k * C + C - 1 < t_end ? k * C + C - 1 : t_end;
      // The words the chunk's last step completes are stored after its
      // releases, so a release does not wait for a store just issued.
      bool deferred = false;
      // One step in PHASE: kPhaseHead while a lane of the warp may hold its
      // row-0 cell (lane t), the warp's first 32 x LPT steps; then
      // kPhaseFull while every lane's cell lies in the pair's matrix
      // (steps up to wb + n1, for a warp wholly within the pair's db);
      // kPhaseMasked for the rest.
      auto one_step = [&](int t, auto phase) {
        const int e = t - k * C;
        int4 left = make_int4(0, 0, 0, 0);
        if (consumer) left = ring_get(rin + 16 * e);
        const auto hand = Pol::template hand<LPT>(L, a.sc);
        if (producer) ring_put(rout + 16 * e, out_remote, hand.h, hand.d,
                               hand.s);
        int32_t lH = __shfl_up_sync(kWarpFull, hand.h, 1);
        int32_t lD = __shfl_up_sync(kWarpFull, hand.d, 1);
        int32_t lS = __shfl_up_sync(kWarpFull, hand.s, 1);
        if (consumer) {
          lH = left.x;
          lD = left.y;
          lS = left.z;
        }
        int32_t qc = 0;
        if (head_warp) {
          qc = __shfl_sync(kWarpFull, codes, e);
          // Lane 0 takes nothing from the left (a fixed 0).
          if (lane0) lS = 0;
        }
        Pol::template step<LPT, decltype(phase)::value>(
            L, hand, lH, lD, lS, t, base, qc, n1, n2, 8u * (t & 3), a.sc);
        if (kDirs && ((t & 3) == 3 || t == t_end)) {
          if (t == t_hi) {
            deferred = true;
          } else {
            store_words<LPT>(L.acc, dst0, stride, t >> 2, real);
          }
        }
      };
      using Head = std::integral_constant<int, kPhaseHead>;
      using Full = std::integral_constant<int, kPhaseFull>;
      using Masked = std::integral_constant<int, kPhaseMasked>;
      if constexpr (Pol::kPhases) {
        const int h_hi = t_hi < we - 1 ? t_hi : we - 1;
        for (int t = t_lo; t <= h_hi; ++t) one_step(t, Head());
        int t = h_hi + 1 > t_lo ? h_hi + 1 : t_lo;
        const int f_hi = t_hi < full_end ? t_hi : full_end;
        for (; t <= f_hi; ++t) one_step(t, Full());
        for (; t <= t_hi; ++t) one_step(t, Masked());
      } else {
        for (int t = t_lo; t <= t_hi; ++t) one_step(t, Head());
      }
      __syncwarp();
      if (consumer) {
        // The producer's count: the warp to the left, or the previous
        // CTA's last warp.
        uint32_t in_freed = smem_addr(&sm.freed[warp > 0 ? warp - 1 : 0]);
        if (warp == 0) {
          in_freed = cluster_addr(
              smem_addr(&sm.freed[ring_warps(rank - 1, sp, P) - 1]),
              rank - 1);
        }
        ring_release(in_freed, k + 1, in_remote);
      }
      if (producer) {
        uint32_t out_full = smem_addr(&sm.full[nxt_w]);
        if (last_warp) out_full = cluster_addr(out_full, rank + 1);
        ring_release(out_full, k + 1, out_remote);
      }
      if (deferred) store_words<LPT>(L.acc, dst0, stride, t_hi >> 2, real);
    }
    if (kDirs && real && !stalled) {
      zero_words<LPT>(dst0, stride, (t_end >> 2) + 1, W);
    }
  } else if (kDirs && real && warp < nwarps) {
    // No cell of the pair on these lanes.
    zero_words<LPT>(dst0, stride, 0, W);
  }
  if (warp < nwarps && !stalled) {
    Pol::template finish<LPT>(L, a, b, base, real, active, n1, n2, t_end);
  }
  // Keep this CTA's shared memory alive until its neighbours are done.
  if (cluster) cg::this_cluster().sync();
}

// Launches pair_sweep_kernel<Pol, LPT> with sp.lpt == LPT for B pairs.
// Returns the launch's cudaGetLastError(), -1 for an unsupported LPT, -3
// for a cluster the card cannot schedule.
template <class Pol>
int launch_pair_sweep(PairArgs a, Split sp, RingShape rg, void* stream) {
  const void* fn = nullptr;
  switch (sp.lpt) {
    case 2: fn = reinterpret_cast<const void*>(pair_sweep_kernel<Pol, 2>);
            break;
    case 4: fn = reinterpret_cast<const void*>(pair_sweep_kernel<Pol, 4>);
            break;
    case 8: fn = reinterpret_cast<const void*>(pair_sweep_kernel<Pol, 8>);
            break;
    case 16: fn = reinterpret_cast<const void*>(pair_sweep_kernel<Pol, 16>);
             break;
  }
  if (fn == nullptr) return -1;
  void* args[] = {&a.query, &a.s2v, &a.n1s,    &a.n2s, &a.maxv, &a.out,
                  &a.out2,  &a.dirs, &a.status, &a.B,   &a.L1,   &a.P,
                  &a.D_total, &a.sc, &sp,       &rg};
  return launch_split(fn, sp, a.B, args, stream);
}

// ---------------------------------------------------------------------------
// The cell policies
// ---------------------------------------------------------------------------

// The Gotoh cell (stream_cell) in MODE: kernel #7 in global mode (the
// corner's M/I/D into out, (B, 3)), kernel #6 in the semi-global and local
// modes (each lane's running argmax, best score then its step, into out,
// (2, B, P)).  The lanes start from the state the skipped triangle above the
// matrix leaves them in (triangle_state); only the IEXT / IOPEN bits of the
// row-0 cells read it.
template <int DIRS, int MODE, bool COMPAT, bool WILDCARD>
struct GotohCells {
  static constexpr bool kDirs = DIRS != kDirsNone;
  static constexpr bool kModes = MODE != kModeGlobal;
  static constexpr bool kPhases = !kModes;

  template <int LPT>
  struct Lanes {
    Cell c[LPT];
    uint32_t acc[LPT];
    int32_t bv[LPT], bd[LPT];
    uint32_t lim[LPT];
  };
  // The last lane's stream_pre, kept for its own cell.
  struct Hand {
    Pre pre;
    int32_t h, d, s;
  };

  template <int LPT>
  __device__ __forceinline__ static void start(Lanes<LPT>& L,
                                               const PairArgs& a, int b,
                                               int base, bool real, int wb,
                                               int32_t n1, int32_t n2) {
    const Cell tri = triangle_state<MODE>(wb - 1, a.sc);
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int x = base + i;
      L.c[i] = tri;
      L.c[i].s1d = 0;
      L.c[i].s2v = real ? a.s2v[static_cast<size_t>(b) * a.P + x] : 0;
      L.acc[i] = 0;
      L.bv[i] = kNegBig;
      L.bd[i] = 0;
      L.lim[i] = x <= n2 ? static_cast<uint32_t>(n1 + 1) : 0u;
    }
  }

  template <int LPT>
  __device__ __forceinline__ static Hand hand(const Lanes<LPT>& L,
                                              const Scheme& sc) {
    Hand r;
    r.pre = stream_pre<DIRS>(L.c[LPT - 1], sc);
    r.h = L.c[LPT - 1].H2;
    r.d = r.pre.dsel;
    r.s = L.c[LPT - 1].s1d | r.pre.dflag << 8;
    return r;
  }

  // Lane I of one step t of a thread's lanes, then lanes I-1 .. 0: right to
  // left, so lane i-1 still holds its pre-step state for lane i (a
  // recursion rather than a loop, so the lanes stay in registers).  mine:
  // lane I's stream_pre, computed by the lane to its right; (lH, lD, lS):
  // what the lane left of lane 0 handed over (H2, merged D source, query
  // code | D bits << 8); qc: the step's query code (lane 0 of the pair
  // only).
  template <int I, int LPT, int PHASE>
  __device__ __forceinline__ static void lanes(
      Lanes<LPT>& L, const Pre& mine, int32_t lH, int32_t lD, int32_t lS,
      int t, int base, int32_t qc, int32_t n1, int32_t n2, uint32_t shift,
      const Scheme& sc) {
    const int x = base + I;
    int32_t lh2, ls1d;
    Pre left;
    if constexpr (I == 0) {
      lh2 = lH;
      left.t0 = 0;
      left.dsel = lD;
      left.dflag = lS >> 8;
      ls1d = lS & 0xff;
    } else {
      left = stream_pre<DIRS>(L.c[I - 1], sc);
      lh2 = L.c[I - 1].H2;
      ls1d = L.c[I - 1].s1d;
    }
    // Only lane I = 0 can be lane 0, and only a kPhaseHead step lane t.
    // The modes keep x == 0 on every lane: told that lanes I > 0 are not
    // lane 0, their local instance spilled in its step loop and one pair
    // took longer.
    int32_t code = stream_cell<DIRS, MODE, COMPAT, WILDCARD>(
        L.c[I], mine, lh2, left, ls1d, (I == 0 || kModes) && x == 0,
        PHASE == kPhaseHead && x == t, t, qc, L.c[I].s2v, sc);
    if constexpr (kDirs) {
      if (PHASE != kPhaseFull &&
          static_cast<uint32_t>(t - x) >= L.lim[I]) {
        code = 0;
      }
      L.acc[I] |= static_cast<uint32_t>(code) << shift;
    }
    if constexpr (kModes) {
      modes_update<MODE>(x, t - x, t, n1, n2, L.c[I].M1, L.c[I].H1, L.bv[I],
                         L.bd[I]);
    }
    if constexpr (I > 0) {
      lanes<I - 1, LPT, PHASE>(L, left, lH, lD, lS, t, base, qc, n1, n2,
                              shift, sc);
    }
  }

  template <int LPT, int PHASE>
  __device__ __forceinline__ static void step(
      Lanes<LPT>& L, const Hand& h, int32_t lH, int32_t lD, int32_t lS,
      int t, int base, int32_t qc, int32_t n1, int32_t n2, uint32_t shift,
      const Scheme& sc) {
    lanes<LPT - 1, LPT, PHASE>(L, h.pre, lH, lD, lS, t, base, qc, n1, n2,
                              shift, sc);
  }

  template <int LPT>
  __device__ __forceinline__ static void finish(Lanes<LPT>& L,
                                                const PairArgs& a, int b,
                                                int base, bool real,
                                                bool active, int32_t n1,
                                                int32_t n2, int t_end) {
    if (!real) return;
    if constexpr (kModes) {
      const size_t at = static_cast<size_t>(b) * a.P + base;
      const size_t stride = static_cast<size_t>(a.B) * a.P;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        a.out[at + i] = active ? L.bv[i] : kNegBig;
        a.out[stride + at + i] = active ? L.bd[i] : 0;
      }
    } else if (active && n1 + n2 <= t_end && base <= n2 && n2 < base + LPT) {
      // The corner: lane n2 has just swept its row-n1 cell.
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if (base + i == n2) {
          a.out[static_cast<size_t>(b) * 3 + 0] = L.c[i].M1;
          a.out[static_cast<size_t>(b) * 3 + 1] = L.c[i].I1;
          a.out[static_cast<size_t>(b) * 3 + 2] = L.c[i].D1;
        }
      }
    }
  }
};

// The linear cell (nw_linear.cuh::linear_cell): the corner's score into
// out[b], the maximum over the pair's cells into out2[b] (one atomicMax a
// warp), maxv[b] the ISMAX target of local mode's second pass.  The cells
// above the matrix feed nothing: a row-0 cell's score, gap flag and bits
// are the boundary's, and only its query code comes from the left, from a
// cell of row 0; so the lanes start from lin_init.
template <bool DIRS, bool COMPAT, bool LOCAL>
struct LinearCells {
  static constexpr bool kDirs = DIRS;
  static constexpr bool kPhases = true;

  template <int LPT>
  struct Lanes {
    LinCell c[LPT];
    uint32_t acc[LPT];
    uint32_t lim[LPT];
    int32_t mv;
  };
  struct Hand {
    int32_t h, d, s;
  };

  template <int LPT>
  __device__ __forceinline__ static void start(Lanes<LPT>& L,
                                               const PairArgs& a, int b,
                                               int base, bool real, int wb,
                                               int32_t n1, int32_t n2) {
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int x = base + i;
      L.c[i] = lin_init();
      L.c[i].s2v = real ? a.s2v[static_cast<size_t>(b) * a.P + x] : 0;
      L.acc[i] = 0;
      L.lim[i] = x <= n2 ? static_cast<uint32_t>(n1 + 1) : 0u;
    }
    L.mv = LOCAL && DIRS ? a.maxv[b] : 0;
  }

  // S2, S1, query code | gap flag << 8.
  template <int LPT>
  __device__ __forceinline__ static Hand hand(const Lanes<LPT>& L,
                                              const Scheme&) {
    const LinCell& c = L.c[LPT - 1];
    return Hand{c.S2, c.S1, c.s1d | c.G1 << 8};
  }

  // Lane I, then lanes I-1 .. 0 (as GotohCells::lanes).
  template <int I, int LPT, int PHASE>
  __device__ __forceinline__ static void lanes(Lanes<LPT>& L, int32_t lH,
                                               int32_t lD, int32_t lS, int t,
                                               int base, int32_t qc,
                                               uint32_t shift,
                                               const Scheme& sc) {
    const int x = base + I;
    int32_t lS2, lS1, lG1, ls1d;
    if constexpr (I == 0) {
      lS2 = lH;
      lS1 = lD;
      lG1 = lS >> 8;
      ls1d = lS & 0xff;
    } else {
      lS2 = L.c[I - 1].S2;
      lS1 = L.c[I - 1].S1;
      lG1 = L.c[I - 1].G1;
      ls1d = L.c[I - 1].s1d;
    }
    const bool valid = PHASE == kPhaseFull ||
                       static_cast<uint32_t>(t - x) < L.lim[I];
    // Only lane I = 0 can be lane 0, and only a kPhaseHead step lane t.
    const int32_t code = linear_cell<COMPAT, LOCAL, DIRS>(
        L.c[I], lS2, lS1, lG1, ls1d, I == 0 && x == 0,
        PHASE == kPhaseHead && x == t, t, qc, valid, L.mv, sc);
    if constexpr (DIRS) {
      L.acc[I] |= static_cast<uint32_t>(valid ? code : 0) << shift;
    }
    if constexpr (I > 0) {
      lanes<I - 1, LPT, PHASE>(L, lH, lD, lS, t, base, qc, shift, sc);
    }
  }

  template <int LPT, int PHASE>
  __device__ __forceinline__ static void step(
      Lanes<LPT>& L, const Hand&, int32_t lH, int32_t lD, int32_t lS, int t,
      int base, int32_t qc, int32_t, int32_t, uint32_t shift,
      const Scheme& sc) {
    lanes<LPT - 1, LPT, PHASE>(L, lH, lD, lS, t, base, qc, shift, sc);
  }

  template <int LPT>
  __device__ __forceinline__ static void finish(Lanes<LPT>& L,
                                                const PairArgs& a, int b,
                                                int base, bool real,
                                                bool active, int32_t n1,
                                                int32_t n2, int t_end) {
    if (!active) return;
    int32_t best = kLinNegBig;
    if (real) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        best = imax(best, L.c[i].best);
        // The corner: lane n2 has just swept its row-n1 cell.
        if (base + i == n2 && n1 + n2 <= t_end) a.out[b] = L.c[i].S1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      best = imax(best, __shfl_xor_sync(kWarpFull, best, off));
    }
    if ((threadIdx.x & 31) == 0) atomicMax(a.out2 + b, best);
  }
};

}  // namespace sa
#endif

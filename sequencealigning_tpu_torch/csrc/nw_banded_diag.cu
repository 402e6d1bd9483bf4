// Banded Gotoh fill over anti-diagonal wavefronts for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/nw_banded_diag.py::_diag_kernel (launched by
// banded_diag_fill_pallas).  Same contract as _banded_diag_lax: lane l of
// wavefront a holds diagonal k = k_lo_even + 2l + (a & 1); each iteration
// runs wavefronts 2i+1 (odd: D and the query window read lane l+1) and 2i+2
// (even: I and the db window read lane l-1), with the entering characters
// c1s[b, i] / c2s[b, i]; the per-cell work is nw_banded_diag.cuh::band_cell.
// Each pair's M/I/D at its corner (n2, n1) is written by the lane that holds
// it (zero when the corner is never reached, as the lax capture's sum over a
// hit mask gives).  Direction codes keyed by aidx = a - 1: fast4 nibble
// aidx & 7 of word dirs[aidx >> 3, b, l], full byte aidx & 3 of word
// dirs[aidx >> 2, b, l]; ceil(2 n_iters / upack) words.
//
// Design: up to 8192 lanes one thread block per pair, LPT consecutive lanes
// a thread in registers (2 for the 256-lane band of the main shape: 128
// threads; 16 for 8192 lanes, whose state spills past the 128 registers a
// thread of a 512-thread block).  Past 8192 lanes (or at a forced CTA width)
// a pair's band is split over a thread-block cluster as the streamed fills'
// rows are (cluster_split.cuh: CTAs of 4096 lanes, 8192 past 32768, at most
// 16, so up to 131072 lanes).  The lane shift alternates direction with the
// wavefront parity: shift_lanes (x-1 -> x) on even wavefronts, shift_down
// (x+1 -> x) on odd ones, both in lane_shift.cuh, one barrier a wavefront;
// across CTA edges an even wavefront's first lane reads the previous CTA's
// last lane and an odd wavefront's last lane the next CTA's first lane
// through distributed shared memory, one cluster barrier a wavefront, with no
// torus wrap (the band's edge lanes are masked).  Within a thread the
// neighbours are registers, read before any lane moves.  Entering characters
// are staged in shared memory 128 iterations at a time, by every CTA.  Each
// thread packs 8 (fast4) or 4 (full) wavefronts of its lanes in registers and
// stores them as one coalesced 8- or 16-byte store into its CTA's lane slice
// of the (Aw, B, L) dirs.  The TPU kernel's steady-state variant (no boundary
// selects past the x = 0 / y = 0 cells) and its masked lane-reduce gather of
// the characters have no counterpart here.
//
// Past the largest cluster (16 CTAs of 8192 lanes, 131072 lanes) the band
// takes the wide route (sa_banded_wide_fill): one launch a wavefront, each
// lane's state (nw_banded_diag.cuh::BandCell) in global memory,
// double-buffered by wavefront parity, one thread a lane reading its
// neighbour's pre-step state from the other buffer (band_wide_lane); the
// kernel boundary is the wavefront's grid-wide barrier.  It needs no CTAs to
// be co-resident, so its only limit is device memory: 2 x 28 bytes of state
// a lane plus the direction codes.  The route can be forced at any band
// width, so it is checked at small ones too.
//
// What bounds it on this card: the integer ALU work of the recurrence and
// its masks (~45 operations a lane-step, all lanes of the band on every
// wavefront) and the per-wavefront block (or cluster) barrier; the direction
// stores (0.5 B a lane-step in fast4, 1 B in full) are a few percent of HBM
// time.  The wide route is bound by moving its state (56 bytes a lane-step,
// through L2 where the band's state fits) and by a launch a wavefront.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_split.cuh"
#include "lane_shift.cuh"
#include "nw_banded_diag.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCharChunk = 128;  // iterations of entering chars staged

// s1w0/s2w0: (B, L) int32 windows; c1s/c2s: (B, n_iters) int32 entering
// characters; n1v/n2v: (B,) lengths; finals: (B, 3) int32, zeroed by the
// caller; dirs: (W, B, L) u32.  lim1/lim0: the last lane inside the
// effective band on odd / even wavefronts.  sp: the band's split
// (cluster_split.cuh); CLUSTER: block b holds CTA b % nctas of pair
// b / nctas, else one block holds a pair (sp unused).
template <int LPT, int DIRS, bool WILDCARD, bool STD, bool CLUSTER>
__global__ void __launch_bounds__(sa::kMaxThreads)
    banded_fill_kernel(const int32_t* __restrict__ s1w0,
                       const int32_t* __restrict__ s2w0,
                       const int32_t* __restrict__ c1s,
                       const int32_t* __restrict__ c2s,
                       const int32_t* __restrict__ n1v,
                       const int32_t* __restrict__ n2v,
                       int32_t* __restrict__ finals,
                       uint32_t* __restrict__ dirs, int B, int L,
                       int n_iters, int he, int lim1, int lim0, int compat,
                       sa::Scheme sc, sa::Split sp) {
  constexpr int kUp = DIRS == sa::kDirsFast4 ? 8 : 4;  // wavefronts a word
  __shared__ int32_t cs1[kCharChunk];
  __shared__ int32_t cs2[kCharChunk];
  __shared__ sa::ShiftSmem sm;

  int b = blockIdx.x;
  int rank = 0;
  // The neighbouring CTAs' shared memory (this CTA's own at the band's ends
  // and for a pair held by one block).
  const sa::ShiftSmem* prev = &sm;
  const sa::ShiftSmem* next = &sm;
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    rank = static_cast<int>(cl.block_rank());
    b = blockIdx.x / sp.nctas;
    if (rank > 0) prev = cl.map_shared_rank(&sm, rank - 1);
    if (rank + 1 < sp.nctas) next = cl.map_shared_rank(&sm, rank + 1);
  }
  const int j = threadIdx.x;
  // Threads at or past nreal own no real lane.
  const int nreal = CLUSTER ? sa::cta_real_lanes(rank, sp, L) / LPT : L / LPT;
  const bool real = j < nreal;
  const int base = (CLUSTER ? sa::cta_first_lane(rank, sp) : 0) + j * LPT;
  const int32_t n1 = n1v[b];
  const int32_t n2 = n2v[b];
  const bool cmp = compat != 0;
  const int last_aidx = 2 * n_iters - 1;

  sa::BandCell c[LPT];
  uint32_t acc[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const size_t at = static_cast<size_t>(b) * L + base + i;
    c[i] = sa::band_init(base + i, he, real ? s1w0[at] : -1,
                         real ? s2w0[at] : -1);
    acc[i] = 0;
  }

  // One wavefront a of parity PAR.
  auto step = [&](auto par_tag, int a, int32_t enter) {
    constexpr int PAR = decltype(par_tag)::value;
    int32_t nb_open[LPT], nb_gap[LPT], nb_char[LPT];
    if constexpr (PAR == 1) {
      // Lane l reads lane l+1: this thread's first lane goes to the
      // previous thread, the next thread's first lane comes in.
      int32_t h = sa::band_open<STD>(c[0], sc);
      int32_t g = sa::band_gap_src<PAR>(c[0]);
      int32_t ch = sa::band_char_src<PAR>(c[0]);
      if constexpr (CLUSTER) {
        sa::shift_down_cluster(sm, next, j, nreal, a & 1, h, g, ch);
      } else {
        sa::shift_down(sm, j, a & 1, h, g, ch);
      }
#pragma unroll
      for (int i = 0; i < LPT - 1; ++i) {
        nb_open[i] = sa::band_open<STD>(c[i + 1], sc);
        nb_gap[i] = sa::band_gap_src<PAR>(c[i + 1]);
        nb_char[i] = sa::band_char_src<PAR>(c[i + 1]);
      }
      nb_open[LPT - 1] = h;
      nb_gap[LPT - 1] = g;
      nb_char[LPT - 1] = ch;
    } else {
      // Lane l reads lane l-1.
      int32_t h = sa::band_open<STD>(c[LPT - 1], sc);
      int32_t g = sa::band_gap_src<PAR>(c[LPT - 1]);
      int32_t ch = sa::band_char_src<PAR>(c[LPT - 1]);
      sa::shift_lanes(sm, prev, CLUSTER, j, nreal, a & 1, h, g, ch);
#pragma unroll
      for (int i = 1; i < LPT; ++i) {
        nb_open[i] = sa::band_open<STD>(c[i - 1], sc);
        nb_gap[i] = sa::band_gap_src<PAR>(c[i - 1]);
        nb_char[i] = sa::band_char_src<PAR>(c[i - 1]);
      }
      nb_open[0] = h;
      nb_gap[0] = g;
      nb_char[0] = ch;
    }
    const int32_t q = (a - PAR) / 2 - he;
    const int lim = PAR == 1 ? lim1 : lim0;
    const int aidx = a - 1;
    const uint32_t shift = DIRS == sa::kDirsFast4 ? 4u * (aidx & 7)
                                                  : 8u * (aidx & 3);
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int lane = base + i;
      const int32_t xv = q - lane;
      const int32_t yv = a - xv;
      const bool edge = PAR == 1 ? lane == L - 1 : lane == 0;
      const int32_t code = sa::band_cell<PAR, DIRS, WILDCARD, STD>(
          c[i], nb_open[i], nb_gap[i], nb_char[i], edge, enter, xv, yv,
          lane <= lim, n1, n2, cmp, sc);
      if (DIRS != sa::kDirsNone) acc[i] |= static_cast<uint32_t>(code) << shift;
      if (xv == n2 && yv == n1 && real) {
        finals[static_cast<size_t>(b) * 3 + 0] = c[i].M1;
        finals[static_cast<size_t>(b) * 3 + 1] = c[i].I1;
        finals[static_cast<size_t>(b) * 3 + 2] = c[i].D1;
      }
    }
    if (DIRS != sa::kDirsNone &&
        ((aidx & (kUp - 1)) == kUp - 1 || aidx == last_aidx)) {
      if (real) {
        uint32_t* dst =
            dirs + (static_cast<size_t>(aidx / kUp) * B + b) * L + base;
        if constexpr (LPT % 4 == 0) {
#pragma unroll
          for (int i = 0; i < LPT; i += 4) {
            *reinterpret_cast<uint4*>(dst + i) =
                make_uint4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < LPT; i += 2) {
            *reinterpret_cast<uint2*>(dst + i) = make_uint2(acc[i], acc[i + 1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < LPT; ++i) acc[i] = 0;
    }
  };

  const size_t crow = static_cast<size_t>(b) * n_iters;
  for (int it = 0; it < n_iters; ++it) {
    const int ic = it % kCharChunk;
    if (ic == 0) {
      __syncthreads();
      for (int i = j; i < kCharChunk; i += blockDim.x) {
        const bool in = it + i < n_iters;
        cs1[i] = in ? c1s[crow + it + i] : -1;
        cs2[i] = in ? c2s[crow + it + i] : -1;
      }
      __syncthreads();
    }
    step(std::integral_constant<int, 1>(), 2 * it + 1, cs1[ic]);
    step(std::integral_constant<int, 0>(), 2 * it + 2, cs2[ic]);
  }
  // Keep this CTA's shared memory alive until its neighbours have read it.
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

typedef void (*BandKernel)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, const int32_t*, const int32_t*,
                           int32_t*, uint32_t*, int, int, int, int, int, int,
                           int, sa::Scheme, sa::Split);

template <int LPT, int DIRS, bool STD, bool CL>
BandKernel pick_wild(bool wildcard) {
  return wildcard ? banded_fill_kernel<LPT, DIRS, true, STD, CL>
                  : banded_fill_kernel<LPT, DIRS, false, STD, CL>;
}

// The reference model takes every dirs mode; std none or fast4.
template <int LPT, bool CL>
BandKernel pick(int dirs_mode, bool wildcard, bool std_model) {
  if (std_model) {
    switch (dirs_mode) {
      case sa::kDirsNone:
        return pick_wild<LPT, sa::kDirsNone, true, CL>(wildcard);
      case sa::kDirsFast4:
        return pick_wild<LPT, sa::kDirsFast4, true, CL>(wildcard);
      default:
        return nullptr;
    }
  }
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_wild<LPT, sa::kDirsNone, false, CL>(wildcard);
    case sa::kDirsFast4:
      return pick_wild<LPT, sa::kDirsFast4, false, CL>(wildcard);
    case sa::kDirsFull:
      return pick_wild<LPT, sa::kDirsFull, false, CL>(wildcard);
    default:
      return nullptr;
  }
}

}  // namespace

// Lanes per thread for a band of L lanes (a multiple of 128): 2 up to 256
// lanes, 4 up to 2048, 8 up to 4096, 16 up to 8192; 0 if L is out of range.
extern "C" int sa_banded_lanes_per_thread(int L) {
  if (L <= 0 || L % 128 != 0) return 0;
  if (L <= 256) return 2;
  if (L <= 2048) return 4;
  if (L <= 4096) return 8;
  if (L <= 8192) return 16;
  return 0;
}

// s1w0/s2w0: (B, L) int32; c1s/c2s: (B, n_iters) int32; n1v/n2v: (B,) int32;
// finals: (B, 3) int32, zeroed; dirs: (ceil(2 n_iters / upack), B, L) u32,
// unused for dirs_mode 0.  he = k_lo_even / 2; lim1/lim0: the last lane of
// the effective band on odd / even wavefronts.  dirs_mode 0/1/2 (none,
// fast4, full); std_model != 0: gaps open from H (dirs none or fast4).
// cta_lanes: 0 (one block up to 8192 lanes, a cluster past it), or the
// forced CTA width of the split.  Returns the cudaGetLastError() of the
// launch, -1 for an unsupported shape or mode, -3 for a cluster the card
// cannot schedule.
extern "C" int sa_banded_fill(const int32_t* s1w0, const int32_t* s2w0,
                              const int32_t* c1s, const int32_t* c2s,
                              const int32_t* n1v, const int32_t* n2v,
                              int32_t* finals, uint32_t* dirs, int B, int L,
                              int n_iters, int he, int lim1, int lim0,
                              int match, int mismatch, int gap_open,
                              int gap_extend, int dirs_mode, int compat,
                              int wildcard, int std_model, int cta_lanes,
                              void* stream) {
  const sa::Split sp = sa::plan_split(L, cta_lanes);
  if (sp.nctas == 0 || B <= 0 || n_iters <= 0) return -1;
  const bool w = wildcard != 0, st = std_model != 0;
  BandKernel fn = nullptr;
  sa::Split launch = sp;
  if (sp.nctas == 1) {
    // One block a pair, at its own lanes a thread.
    launch.lpt = sa_banded_lanes_per_thread(L);
    launch.cta_lanes = L;
    switch (launch.lpt) {
      case 2: fn = pick<2, false>(dirs_mode, w, st); break;
      case 4: fn = pick<4, false>(dirs_mode, w, st); break;
      case 8: fn = pick<8, false>(dirs_mode, w, st); break;
      case 16: fn = pick<16, false>(dirs_mode, w, st); break;
    }
  } else {
    switch (sp.lpt) {
      case 4: fn = pick<4, true>(dirs_mode, w, st); break;
      case 8: fn = pick<8, true>(dirs_mode, w, st); break;
      case 16: fn = pick<16, true>(dirs_mode, w, st); break;
    }
  }
  if (fn == nullptr) return -1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  void* args[] = {&s1w0, &s2w0, &c1s,  &c2s,    &n1v, &n2v,
                  &finals, &dirs, &B,  &L,      &n_iters, &he,
                  &lim1, &lim0, &compat, &sc,   &launch};
  return sa::launch_split(reinterpret_cast<const void*>(fn), launch, B, args,
                          stream);
}

namespace {

constexpr int kWideThreads = 256;  // threads a block of the wide route

__global__ void __launch_bounds__(kWideThreads)
    band_wide_init(const int32_t* __restrict__ s1w0,
                   const int32_t* __restrict__ s2w0,
                   sa::BandCell* __restrict__ state, size_t n, int L, int he) {
  const size_t at = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (at >= n) return;
  state[at] = sa::band_init(static_cast<int32_t>(at % L), he, s1w0[at],
                            s2w0[at]);
}

// One wavefront a of parity PAR over every lane of every pair (one thread a
// lane): nw_banded_diag.cuh::band_wide_lane.
template <int PAR, int DIRS, bool WILDCARD, bool STD>
__global__ void __launch_bounds__(kWideThreads)
    band_wide_step(const sa::BandCell* __restrict__ in,
                   sa::BandCell* __restrict__ out,
                   const int32_t* __restrict__ enter,
                   const int32_t* __restrict__ n1v,
                   const int32_t* __restrict__ n2v,
                   int32_t* __restrict__ finals, uint32_t* __restrict__ dirs,
                   int B, int L, int n_iters, int a, int he, int lim,
                   int compat, sa::Scheme sc) {
  const size_t at = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (at >= static_cast<size_t>(B) * L) return;
  const int b = static_cast<int>(at / L);
  const int l = static_cast<int>(at % L);
  sa::band_wide_lane<PAR, DIRS, WILDCARD, STD>(
      in, out, enter + static_cast<size_t>(b) * n_iters, n1v, n2v, finals,
      dirs, B, L, a, he, lim, compat != 0, sc, b, l);
}

typedef void (*WideStep)(const sa::BandCell*, sa::BandCell*, const int32_t*,
                         const int32_t*, const int32_t*, int32_t*, uint32_t*,
                         int, int, int, int, int, int, int, sa::Scheme);

template <int PAR, int DIRS, bool STD>
WideStep wide_wild(bool wildcard) {
  return wildcard ? band_wide_step<PAR, DIRS, true, STD>
                  : band_wide_step<PAR, DIRS, false, STD>;
}

// The same modes as the one-block and cluster instances.
template <int PAR>
WideStep wide_pick(int dirs_mode, bool wildcard, bool std_model) {
  if (std_model) {
    switch (dirs_mode) {
      case sa::kDirsNone: return wide_wild<PAR, sa::kDirsNone, true>(wildcard);
      case sa::kDirsFast4:
        return wide_wild<PAR, sa::kDirsFast4, true>(wildcard);
      default: return nullptr;
    }
  }
  switch (dirs_mode) {
    case sa::kDirsNone: return wide_wild<PAR, sa::kDirsNone, false>(wildcard);
    case sa::kDirsFast4:
      return wide_wild<PAR, sa::kDirsFast4, false>(wildcard);
    case sa::kDirsFull: return wide_wild<PAR, sa::kDirsFull, false>(wildcard);
    default: return nullptr;
  }
}

}  // namespace

// The wide route: sa_banded_fill's arguments minus cta_lanes, plus state:
// (2, B, L) BandCell scratch (7 int32 a lane), allocated by the caller.
// Launches one init and 2 n_iters wavefront kernels on the stream.  Returns
// the cudaGetLastError() after the last launch (or the first that failed),
// -1 for an unsupported shape or mode.
extern "C" int sa_banded_wide_fill(
    const int32_t* s1w0, const int32_t* s2w0, const int32_t* c1s,
    const int32_t* c2s, const int32_t* n1v, const int32_t* n2v,
    int32_t* finals, uint32_t* dirs, void* state, int B, int L, int n_iters,
    int he, int lim1, int lim0, int match, int mismatch, int gap_open,
    int gap_extend, int dirs_mode, int compat, int wildcard, int std_model,
    void* stream) {
  if (B <= 0 || L <= 0 || n_iters <= 0) return -1;
  const bool w = wildcard != 0, st = std_model != 0;
  WideStep odd = wide_pick<1>(dirs_mode, w, st);
  WideStep even = wide_pick<0>(dirs_mode, w, st);
  if (odd == nullptr || even == nullptr) return -1;
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(B) * L;
  const unsigned blocks =
      static_cast<unsigned>((n + kWideThreads - 1) / kWideThreads);
  sa::BandCell* buf0 = static_cast<sa::BandCell*>(state);
  sa::BandCell* buf1 = buf0 + n;
  band_wide_init<<<blocks, kWideThreads, 0, s>>>(s1w0, s2w0, buf0, n, L, he);
  int err = static_cast<int>(cudaGetLastError());
  for (int it = 0; it < n_iters && err == 0; ++it) {
    odd<<<blocks, kWideThreads, 0, s>>>(buf0, buf1, c1s, n1v, n2v, finals,
                                        dirs, B, L, n_iters, 2 * it + 1, he,
                                        lim1, compat, sc);
    even<<<blocks, kWideThreads, 0, s>>>(buf1, buf0, c2s, n1v, n2v, finals,
                                         dirs, B, L, n_iters, 2 * it + 2, he,
                                         lim0, compat, sc);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

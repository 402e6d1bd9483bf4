// Streamed batched global Gotoh fill for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/nw_affine_stream.py::_stream_kernel
// (launched by gotoh_fill_stream_pallas).  Same contract as
// gotoh_fill_stream_lax: each stream row pipelines np_slots pairs along the
// P lanes, a new pair entering every S steps; the kernel writes each pair's
// M/I/D corner finals and the direction words in the reference layout (the
// code of cell (x, y) of slot k at step d = k*S + x + y sits in word
// dirs[d >> 3, row, x], nibble d & 7, for fast4; byte d & 3 of word
// dirs[d >> 2, row, x] for full).
//
// Design: one thread block per stream row; each thread owns LPT consecutive
// lanes and keeps their state (H2, H1, M1, I1, D1, s1d, s2v) in registers.
// The one-lane shift of the anti-diagonal recurrence is register moves inside
// a thread, __shfl_up_sync between threads of a warp, and shared memory at
// warp edges and for the torus wrap (lane 0 receives lane P-1, as jnp.roll
// does), with one __syncthreads() per step.  Query/db codes are staged in
// shared memory 128 steps at a time.  A pair's finals are written once, by
// the thread owning lane n2 at step k*S + n1 + n2; direction codes are packed
// in registers and stored as one coalesced u32 per lane every 8 (fast4) or 4
// (full) steps.
//
// What bounds it on this card: the per-step block barrier and the integer ALU
// work of the recurrence (~30 operations a cell), then the direction store
// bandwidth, 0.5 B a cell in fast4 and 1 B in full.  The TPU kernel's
// even/odd parity accumulators, its masked lane-reduce gather of the codes
// and its sequential (rows, slots, chunks) grid have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "nw_affine_stream.cuh"

namespace {

constexpr int kCodeChunk = 128;  // steps of query/db codes staged at a time
constexpr unsigned kFullMask = 0xffffffffu;
// Threads per block at most; with up to 16 lanes a thread this keeps the
// lanes' state in registers (up to 128 a thread) for P <= 8192.
constexpr int kMaxThreads = 512;

template <int LPT, int DIRS, bool COMPAT, bool WILDCARD>
__global__ void __launch_bounds__(kMaxThreads)
    stream_fill_kernel(const int32_t* __restrict__ qstream,
                       const int32_t* __restrict__ dstream,
                       const int32_t* __restrict__ dsum,
                       const int32_t* __restrict__ n2s,
                       int32_t* __restrict__ finals,
                       uint32_t* __restrict__ dirs, int R, int T, int P,
                       int S, int NP, sa::Scheme sc) {
  __shared__ int32_t qs[kCodeChunk];
  __shared__ int32_t ds[kCodeChunk];
  __shared__ int32_t edge[2][3][32];  // last lane of each warp, double-buffered
  __shared__ int32_t torus[2][3];     // lane P-1, for lane 0

  const int row = blockIdx.x;
  const int j = threadIdx.x;
  const int nreal = P / LPT;  // threads at or past nreal own no real lane
  const bool real = j < nreal;
  const int base = j * LPT;
  const int warp = j >> 5;
  const int wl = j & 31;

  sa::Cell c[LPT];
  uint32_t acc[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    c[i] = sa::cell_init();
    acc[i] = 0;
  }

  // Next step (after `after`) at which a pair's corner lies on one of this
  // thread's lanes; INT_MAX if none.
  auto next_capture = [&](int after) {
    int best = INT_MAX;
    if (!real) return best;
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

    sa::Pre pre[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) pre[i] = sa::stream_pre<DIRS>(c[i], sc);

    // Hand this thread's last lane to the next thread.
    const int32_t eH = c[LPT - 1].H2;
    const int32_t eD = pre[LPT - 1].dsel;
    const int32_t eS = c[LPT - 1].s1d | (pre[LPT - 1].dflag << 8);
    int32_t nH = __shfl_up_sync(kFullMask, eH, 1);
    int32_t nD = __shfl_up_sync(kFullMask, eD, 1);
    int32_t nS = __shfl_up_sync(kFullMask, eS, 1);
    const int buf = t & 1;
    if (wl == 31) {
      edge[buf][0][warp] = eH;
      edge[buf][1][warp] = eD;
      edge[buf][2][warp] = eS;
    }
    if (j == nreal - 1) {
      torus[buf][0] = eH;
      torus[buf][1] = eD;
      torus[buf][2] = eS;
    }
    __syncthreads();
    if (wl == 0) {
      const int32_t* src0 = j == 0 ? &torus[buf][0] : &edge[buf][0][warp - 1];
      const int stride = j == 0 ? 1 : 32;
      nH = src0[0];
      nD = src0[stride];
      nS = src0[2 * stride];
    }
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
      const int32_t code = sa::stream_cell<DIRS, COMPAT, WILDCARD>(
          c[i], pre[i], lH2, lpre, ls1d, x == 0, x == p, p, qc, dc, sc);
      if (DIRS != sa::kDirsNone) acc[i] |= static_cast<uint32_t>(code) << shift;
    }

    if (t == cap_next) {
      for (int k = 0; k < NP; ++k) {
        const int x = n2s[k * R + row];
        if (k * S + dsum[k * R + row] != t || x < base || x >= base + LPT)
          continue;
        int32_t* f = finals + (static_cast<size_t>(row) * NP + k) * 3;
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
}

typedef void (*FillKernel)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, int32_t*, uint32_t*, int, int, int,
                           int, int, sa::Scheme);

template <int LPT, int DIRS>
FillKernel pick_flags(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? stream_fill_kernel<LPT, DIRS, true, true>
                    : stream_fill_kernel<LPT, DIRS, true, false>;
  }
  return wildcard ? stream_fill_kernel<LPT, DIRS, false, true>
                  : stream_fill_kernel<LPT, DIRS, false, false>;
}

template <int LPT>
FillKernel pick_dirs(int dirs_mode, bool compat, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_flags<LPT, sa::kDirsNone>(compat, wildcard);
    case sa::kDirsFast4:
      return pick_flags<LPT, sa::kDirsFast4>(compat, wildcard);
    case sa::kDirsFull:
      return pick_flags<LPT, sa::kDirsFull>(compat, wildcard);
    default:
      return nullptr;
  }
}

}  // namespace

// Lanes per thread for a lane width P: the smallest of 4, 8, 16 that keeps
// the block at or under kMaxThreads threads; 0 if P is out of range.
extern "C" int sa_stream_lanes_per_thread(int P) {
  if (P <= 0 || P % 128 != 0) return 0;
  for (int lpt = 4; lpt <= 16; lpt *= 2) {
    if (P / lpt <= kMaxThreads) return lpt;
  }
  return 0;
}

// qstream/dstream: (R, T) int32 codes; dsum/n2: (NP, R) int32; finals:
// (R*NP, 3) int32, pair b = row b / NP, slot b % NP; dirs: (T/8, R, P) u32
// for fast4, (T/4, R, P) for full, unused for none.  Returns the
// cudaGetLastError() of the launch, or -1 for an unsupported shape or mode.
extern "C" int sa_stream_fill(const int32_t* qstream, const int32_t* dstream,
                              const int32_t* dsum, const int32_t* n2,
                              int32_t* finals, uint32_t* dirs, int R, int T,
                              int P, int S, int NP, int match, int mismatch,
                              int gap_open, int gap_extend, int dirs_mode,
                              int compat, int wildcard, void* stream) {
  const int lpt = sa_stream_lanes_per_thread(P);
  if (lpt == 0 || R <= 0 || T <= 0 || S <= 0 || NP <= 0) return -1;
  FillKernel fn = nullptr;
  switch (lpt) {
    case 4: fn = pick_dirs<4>(dirs_mode, compat != 0, wildcard != 0); break;
    case 8: fn = pick_dirs<8>(dirs_mode, compat != 0, wildcard != 0); break;
    case 16: fn = pick_dirs<16>(dirs_mode, compat != 0, wildcard != 0); break;
  }
  if (fn == nullptr) return -1;
  const int threads = (P / lpt + 31) / 32 * 32;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  void* args[] = {&qstream, &dstream, &dsum, &n2, &finals, &dirs,
                  &R,       &T,       &P,    &S,  &NP,     &sc};
  cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(R), dim3(threads),
                   args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

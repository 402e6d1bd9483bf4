// Kernel #8's warp route (sm_90a): the banded row sweep of bands of up to
// kRowWarpMaxLanes (512) lanes, a warp a pair.
//
// Replaces, with nw_banded.cu's block route for wider bands, the TPU
// kernel ops/nw_banded.py::_banded_kernel (launched by banded_fill_pallas);
// same contract as nw_banded.cu (sa_banded_row_fill, which launches this
// route for bands of at most 512 lanes unless a chunk width is forced).
//
// What bounds it on this card: the integer work of the recurrence (~20
// operations a lane-step in fast4, every lane of the band on every row)
// and the row's dependency chain (the in-row I chain, a shuffle scan).
//
// Design: thread t holds the band's lanes k0 = t * LPT .. k0 + LPT - 1
// (LPT = K / 32: 4, 8, 12 or 16) in registers: the previous row's M, D and
// H, the query window and the direction-code accumulator (and, between the
// row's two passes, each lane's scan input and D bits).  A row takes no
// barrier and no shared memory: lane k0 + LPT's M, D and query code of the
// row before come from thread t+1 by shuffle, lane k0 - 1's H from thread
// t-1 (the thread recomputes that lane's M), and the I chain is a thread's
// fold (one add-max a lane), a 5-step shuffle max-scan of the threads' keys
// and the thread's chain again (nw_banded.cuh).  Each thread works out
// once a row whether all its lanes hold cells of the pair's matrix (the
// common case away from the matrix's edges) and then skips every mask.
// The entering query codes and the db codes are loaded by the warp 32 rows
// at a time (a lane a row) and broadcast by shuffle; the 8 (fast4) or 4
// (full) rows of codes of a lane stay in a register and each thread writes
// its LPT words with 16-byte stores, coalesced across the warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nw_banded.cuh"

namespace {

constexpr int kWarpRouteWarps = 4;  // pairs (warps) a block
constexpr unsigned kFull = 0xffffffffu;

// Arguments as nw_banded.cu's banded_row_kernel, K = 32 * LPT.
template <int LPT, int DIRS, bool WILDCARD>
__global__ void __launch_bounds__(32 * kWarpRouteWarps)
    banded_row_warp_kernel(const int32_t* __restrict__ s1w0,
                           const int32_t* __restrict__ qin,
                           const int32_t* __restrict__ dcs,
                           const int32_t* __restrict__ n1v,
                           const int32_t* __restrict__ n2v,
                           int32_t* __restrict__ finals,
                           uint32_t* __restrict__ dirs, int B, int Xp,
                           int l2, int k_lo, bool compat, sa::Scheme sc) {
  constexpr int K = 32 * LPT;
  constexpr int kUp = DIRS == sa::kDirsFast4 ? 8 : 4;  // rows a word
  constexpr uint32_t kBits = 32 / kUp;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpRouteWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int k0 = lane * LPT;
  const int32_t n1 = n1v[b];
  const int32_t n2 = n2v[b];
  const int32_t kc = n1 - n2 - k_lo;  // the corner's lane
  int32_t* fin = finals + static_cast<size_t>(b) * 3;
  int32_t M[LPT], D[LPT], Hp[LPT], S1[LPT], C[LPT];
  uint32_t acc[LPT], bits[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int k = k0 + i;
    int32_t I;
    acc[i] = static_cast<uint32_t>(
        sa::row0_cell<DIRS>(k, k_lo, n1, compat, sc, M[i], I, D[i], Hp[i]));
    S1[i] = s1w0[static_cast<size_t>(b) * K + k];
    if (n2 == 0 && k == kc) {
      fin[0] = M[i];
      fin[1] = I;
      fin[2] = D[i];
    }
  }
  if (DIRS != sa::kDirsNone && l2 == 0) {
    uint32_t* dst = dirs + static_cast<size_t>(b) * K + k0;
#pragma unroll
    for (int i = 0; i < LPT; i += 4) {
      *reinterpret_cast<uint4*>(dst + i) =
          make_uint4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
  }
  int32_t qv = -1, dv = -1;  // rows x0 + lane's entering and db codes
  for (int x = 1; x <= l2; ++x) {
    const int xr = (x - 1) & 31;
    if (xr == 0) {
      const int at = x + lane;
      const size_t row = static_cast<size_t>(b) * Xp;
      qv = at < Xp ? __ldg(qin + row + at) : -1;
      dv = at < Xp ? __ldg(dcs + row + at) : -1;
    }
    const int32_t qc = __shfl_sync(kFull, qv, xr);
    const int32_t dc = __shfl_sync(kFull, dv, xr);
    int32_t m_r = __shfl_down_sync(kFull, M[0], 1);
    int32_t d_r = __shfl_down_sync(kFull, D[0], 1);
    int32_t s_r = __shfl_down_sync(kFull, S1[0], 1);
    const int32_t hp_l = __shfl_up_sync(kFull, Hp[LPT - 1], 1);
    if (lane == 31) {
      m_r = sa::kRowNegBig;
      d_r = sa::kRowNegBig;
      s_r = qc;
    }
    const sa::RowCtx r = sa::row_ctx(x, k_lo, n1, n2, compat, sc);
    // Lane k0 - 1's M on row x: its H of row x-1 and its query code on
    // row x (lane k0's on row x-1).
    const int32_t M_left =
        lane > 0 ? sa::row_m<WILDCARD>(r, k0 - 1, hp_l, S1[0], dc, sc)
                 : sa::kRowNegBig;
    const uint32_t shift = kBits * (x & (kUp - 1));
    const sa::RowSpan sp = sa::row_span(r, k0, LPT);
    int32_t A;
    if (sp.plain) {
      A = sa::row_warp_pre<LPT, DIRS, WILDCARD, true>(
          r, k0, M, D, Hp, S1, C, bits, m_r, d_r, s_r, M_left, dc, sc);
    } else {
      A = sa::row_warp_pre<LPT, DIRS, WILDCARD, false>(
          r, k0, M, D, Hp, S1, C, bits, m_r, d_r, s_r, M_left, dc, sc);
    }
    int32_t inc = sa::row_key(A, lane, LPT, sc);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t v = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc = sa::imax(inc, v);
    }
    const int32_t R_in =
        sa::row_r_in(__shfl_up_sync(kFull, inc, 1), lane, LPT, sc);
    if (x == n2) {
      sa::row_warp_post<LPT, DIRS, false, true>(
          r, k0, M, D, C, bits, Hp, acc, shift, M_left, R_in, sc, fin, kc);
    } else if (sp.plain) {
      sa::row_warp_post<LPT, DIRS, true, false>(
          r, k0, M, D, C, bits, Hp, acc, shift, M_left, R_in, sc, nullptr,
          kc);
    } else {
      sa::row_warp_post<LPT, DIRS, false, false>(
          r, k0, M, D, C, bits, Hp, acc, shift, M_left, R_in, sc, nullptr,
          kc);
    }
    if (DIRS != sa::kDirsNone &&
        ((x & (kUp - 1)) == kUp - 1 || x == l2)) {
      uint32_t* dst =
          dirs + (static_cast<size_t>(x / kUp) * B + b) * K + k0;
#pragma unroll
      for (int i = 0; i < LPT; i += 4) {
        *reinterpret_cast<uint4*>(dst + i) =
            make_uint4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
      }
#pragma unroll
      for (int i = 0; i < LPT; ++i) acc[i] = 0;
    }
  }
}

typedef void (*WarpKernel)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, const int32_t*, int32_t*,
                           uint32_t*, int, int, int, int, bool, sa::Scheme);

template <int LPT, int DIRS>
WarpKernel pick_wild(bool wildcard) {
  return wildcard ? banded_row_warp_kernel<LPT, DIRS, true>
                  : banded_row_warp_kernel<LPT, DIRS, false>;
}

template <int LPT>
WarpKernel pick_dirs(int dirs_mode, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone: return pick_wild<LPT, sa::kDirsNone>(wildcard);
    case sa::kDirsFast4: return pick_wild<LPT, sa::kDirsFast4>(wildcard);
    case sa::kDirsFull: return pick_wild<LPT, sa::kDirsFull>(wildcard);
    default: return nullptr;
  }
}

WarpKernel pick(int K, int dirs_mode, bool wildcard) {
  switch (K) {
    case 128: return pick_dirs<4>(dirs_mode, wildcard);
    case 256: return pick_dirs<8>(dirs_mode, wildcard);
    case 384: return pick_dirs<12>(dirs_mode, wildcard);
    case 512: return pick_dirs<16>(dirs_mode, wildcard);
    default: return nullptr;
  }
}

}  // namespace

// sa_banded_row_fill's warp route (its arguments minus the scratch and the
// chunk width): K one of 128, 256, 384, 512.  Returns the
// cudaGetLastError() of the launch, -1 for an unsupported shape or mode.
extern "C" int sa_banded_row_warp_fill(
    const int32_t* s1w0, const int32_t* qin, const int32_t* dcs,
    const int32_t* n1v, const int32_t* n2v, int32_t* finals, uint32_t* dirs,
    int B, int K, int Xp, int l2, int k_lo, int match, int mismatch,
    int gap_open, int gap_extend, int dirs_mode, int compat, int wildcard,
    void* stream) {
  WarpKernel fn = pick(K, dirs_mode, wildcard != 0);
  if (fn == nullptr || B <= 0 || l2 < 0 || Xp < l2 + 1) return -1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  bool cp = compat != 0;
  void* args[] = {&s1w0, &qin, &dcs, &n1v, &n2v, &finals, &dirs,
                  &B,    &Xp,  &l2,  &k_lo, &cp,  &sc};
  const int blocks = (B + kWarpRouteWarps - 1) / kWarpRouteWarps;
  cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(blocks),
                   dim3(32 * kWarpRouteWarps), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

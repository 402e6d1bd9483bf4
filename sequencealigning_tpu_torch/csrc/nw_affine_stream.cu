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
// Design: one thread block per stream row; each thread owns LPT consecutive
// lanes and keeps their state (H2, H1, M1, I1, D1, s1d, s2v) in registers.
// The one-lane shift of the anti-diagonal recurrence is lane_shift.cuh: one
// __syncthreads() a step.  Query/db codes are staged in shared memory 128
// steps at a time.  A pair's finals are written once, by the thread owning
// lane n2 at step k*S + n1 + n2; direction codes are packed in registers and
// stored as one coalesced u32 per lane every 8 (fast4) or 4 (full) steps.
//
// The modes' running argmax: lane x holds the younger pair (slot t / S) from
// step p == x of its slot and the older one before, so one (best, diagonal)
// register pair a lane suffices.  At p == x the lane writes its older pair's
// argmax to bv/bd[slot, row, x] and starts the younger's; the TPU kernel's
// even/odd parity accumulators and per-group merges have no counterpart.
//
// What bounds it on this card: the per-step block barrier and the integer ALU
// work of the recurrence (~30 operations a cell, ~10 more for the modes'
// argmax), then the direction store bandwidth, 0.5 B a cell in fast4 and 1 B
// in full.  The modes' 8-lane variants sit at the 128-register cap, which
// leaves one block a SM where the global 4-lane variant fits two.  The TPU
// kernel's masked lane-reduce gather of the codes and its sequential (rows,
// slots, chunks) grid have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "lane_shift.cuh"
#include "nw_affine_stream.cuh"

namespace {

constexpr int kCodeChunk = 128;  // steps of query/db codes staged at a time
// Threads per block at most; with up to 16 lanes a thread this keeps the
// lanes' state in registers (up to 128 a thread) for P <= 8192.
constexpr int kMaxThreads = 512;

// out: global mode, the (R*NP, 3) finals; the modes, bv then bd, each
// (NP, R, P).
template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD>
__global__ void __launch_bounds__(kMaxThreads)
    stream_fill_kernel(const int32_t* __restrict__ qstream,
                       const int32_t* __restrict__ dstream,
                       const int32_t* __restrict__ dsum,
                       const int32_t* __restrict__ n2s,
                       int32_t* __restrict__ out,
                       uint32_t* __restrict__ dirs, int R, int T, int P,
                       int S, int NP, sa::Scheme sc) {
  constexpr bool kModes = MODE != sa::kModeGlobal;
  __shared__ int32_t qs[kCodeChunk];
  __shared__ int32_t ds[kCodeChunk];
  __shared__ sa::ShiftSmem sm;

  const int row = blockIdx.x;
  const int j = threadIdx.x;
  const int nreal = P / LPT;  // threads at or past nreal own no real lane
  const bool real = j < nreal;
  const int base = j * LPT;

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
    sa::shift_lanes(sm, j, nreal, t & 1, nH, nD, nS);
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
}

typedef void (*FillKernel)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, int32_t*, uint32_t*, int, int, int,
                           int, int, sa::Scheme);

template <int LPT, int DIRS, int MODE>
FillKernel pick_flags(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? stream_fill_kernel<LPT, DIRS, MODE, true, true>
                    : stream_fill_kernel<LPT, DIRS, MODE, true, false>;
  }
  return wildcard ? stream_fill_kernel<LPT, DIRS, MODE, false, true>
                  : stream_fill_kernel<LPT, DIRS, MODE, false, false>;
}

template <int LPT>
FillKernel pick_dirs(int dirs_mode, bool compat, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_flags<LPT, sa::kDirsNone, sa::kModeGlobal>(compat, wildcard);
    case sa::kDirsFast4:
      return pick_flags<LPT, sa::kDirsFast4, sa::kModeGlobal>(compat,
                                                              wildcard);
    case sa::kDirsFull:
      return pick_flags<LPT, sa::kDirsFull, sa::kModeGlobal>(compat, wildcard);
    default:
      return nullptr;
  }
}

// The textbook modes: textbook scoring (compat false), dirs none or full.
template <int LPT, int MODE>
FillKernel pick_modes_dirs(int dirs_mode, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return wildcard ? stream_fill_kernel<LPT, sa::kDirsNone, MODE, false, true>
                      : stream_fill_kernel<LPT, sa::kDirsNone, MODE, false, false>;
    case sa::kDirsFull:
      return wildcard ? stream_fill_kernel<LPT, sa::kDirsFull, MODE, false, true>
                      : stream_fill_kernel<LPT, sa::kDirsFull, MODE, false, false>;
    default:
      return nullptr;
  }
}

template <int LPT>
FillKernel pick_modes(int dirs_mode, bool local, bool wildcard) {
  return local ? pick_modes_dirs<LPT, sa::kModeLocal>(dirs_mode, wildcard)
               : pick_modes_dirs<LPT, sa::kModeSemi>(dirs_mode, wildcard);
}

int launch(FillKernel fn, int lpt, const int32_t* qstream,
           const int32_t* dstream, const int32_t* dsum, const int32_t* n2,
           int32_t* out, uint32_t* dirs, int R, int T, int P, int S, int NP,
           sa::Scheme sc, void* stream) {
  if (fn == nullptr) return -1;
  const int threads = (P / lpt + 31) / 32 * 32;
  void* args[] = {&qstream, &dstream, &dsum, &n2, &out, &dirs,
                  &R,       &T,       &P,    &S,  &NP,  &sc};
  cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(R), dim3(threads),
                   args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
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
  return launch(fn, lpt, qstream, dstream, dsum, n2, finals, dirs, R, T, P, S,
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
                                    int wildcard, void* stream) {
  const int lpt = sa_stream_lanes_per_thread(P);
  if (lpt == 0 || R <= 0 || T <= 0 || S <= 0 || NP <= 0) return -1;
  FillKernel fn = nullptr;
  switch (lpt) {
    case 4: fn = pick_modes<4>(dirs_mode, local != 0, wildcard != 0); break;
    case 8: fn = pick_modes<8>(dirs_mode, local != 0, wildcard != 0); break;
    case 16: fn = pick_modes<16>(dirs_mode, local != 0, wildcard != 0); break;
  }
  return launch(fn, lpt, qstream, dstream, dsum, n2, out, dirs, R, T, P, S,
                NP, sa::Scheme{match, mismatch, gap_open, gap_extend}, stream);
}

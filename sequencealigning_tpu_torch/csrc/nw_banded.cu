// Banded Gotoh row sweep for Hopper (sm_90a): kernel #8, its entry point
// and its block route (bands past 512 lanes, or a forced chunk width);
// bands of up to 512 lanes take the warp route, nw_banded_warp.cu.
//
// Replaces the TPU kernel ops/nw_banded.py::_banded_kernel (launched by
// banded_fill_pallas).  Same contract as _banded_fill_lax: band
// coordinates (x, k = y - x), K lanes from k_lo; rows x = 0 .. l2 (the
// padded db width), row x reading the query window s1w (shifted one lane a
// row, qin[b, x] entering at lane K-1) and the db code dcs[b, x].  Per row
// M and D are lane-local reads of row x-1 (lanes k and k+1), and the
// in-row I chain is the linearised first-order recurrence
// I[k] = k*e + prefixmax_{j<=k}(M[j-1] + o + e - j*e), solved with one
// inclusive max-scan a row.  Each pair's M/I/D at its corner
// (x = n2, k = n1 - n2 - k_lo) is written by the lane that holds it (zero
// when the corner is outside the band, as the lax capture's sum gives).
// Direction codes of row x: fast4 nibble x & 7 of word dirs[x >> 3, b, k],
// full byte x & 3 of word dirs[x >> 2, b, k], ceil((l2 + 1) / upack)
// words (the lax twin's length; the TPU kernel pads rows to whole chunks);
// row 0 carries its H-argmax code.  The per-lane arithmetic is
// nw_banded.cuh.
//
// Design of the block route: one thread block a pair; the band is swept a
// row at a time in chunks of 4 lanes a thread (up to 512 threads, 2048
// lanes a chunk), so no band width is refused: a row wider than a chunk is
// swept chunk after chunk, the scan's running maximum carried from one
// chunk to the next (a plain maximum: the recurrence is linear in k).  Two rows of M, D, H and
// the query window, plus the dirs accumulator of each lane, live in shared
// memory (36 bytes a lane, up to 4480 lanes), past that in a device scratch
// buffer the wrapper allocates.  A row costs two block barriers: one for
// the scan's warp totals (a 5-step __shfl_up_sync scan inside each warp,
// the warp totals through shared memory) and one before the next row reads
// its neighbours.  A lane's left neighbour's M is recomputed by the thread
// itself (it reads the neighbour's H of the previous row), and its left
// neighbour's I follows from the exclusive scan, so no other exchange is
// needed.  Each lane ORs its code into its accumulator and stores one word
// every 8 (fast4) or 4 (full) rows, coalesced along k.  The entering
// characters are staged in shared memory 128 rows at a time.  The TPU
// kernel's (batch tile, row chunk) grid, its log2(K) roll-and-max scan and
// its masked lane-reduce gather of the characters have no counterpart here.
//
// What bounds it on this card: the integer work of the recurrence and its
// masks (~60 operations a lane-step, every lane of the band on every row)
// and the row's two barriers, which serialise a pair's rows; the direction
// stores (0.5 B a lane-step in fast4, 1 B in full) are a few percent of
// HBM time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nw_banded.cuh"

namespace {

constexpr int kRowThreads = 512;  // threads a block at most
constexpr int kRowLpt = 4;        // lanes a thread in a chunk
constexpr int kRowChars = 128;    // rows of entering characters staged
constexpr int kRowWarps = kRowThreads / 32;
// Shared memory a pair's state may take (36 bytes a lane).
constexpr int kRowSmemMax = 160 * 1024;

// Words of a pair's state: rows r = 0, 1 of M, D, H and s1w at
// st[(4r + a) K ...], then the dirs accumulator at st[8K ...].
__host__ __device__ inline size_t row_state_words(int K) {
  return static_cast<size_t>(9) * K;
}

// s1w0: (B, K) int32 row-0 window; qin/dcs: (B, Xp) int32 entering query
// code and db code of each row; n1v/n2v: (B,) lengths; finals: (B, 3),
// zeroed by the caller; dirs: (ceil((l2+1)/upack), B, K) u32; scratch:
// (B, 9K) int32 or null (the state in dynamic shared memory).
template <int DIRS, bool COMPAT, bool WILDCARD>
__global__ void __launch_bounds__(kRowThreads)
    banded_row_kernel(const int32_t* __restrict__ s1w0,
                      const int32_t* __restrict__ qin,
                      const int32_t* __restrict__ dcs,
                      const int32_t* __restrict__ n1v,
                      const int32_t* __restrict__ n2v,
                      int32_t* __restrict__ finals,
                      uint32_t* __restrict__ dirs, int32_t* scratch, int B,
                      int K, int Xp, int l2, int k_lo, sa::Scheme sc) {
  constexpr int kUp = DIRS == sa::kDirsFast4 ? 8 : 4;  // rows a word
  constexpr uint32_t kBits = 32 / kUp;
  extern __shared__ int32_t dyn[];
  __shared__ int32_t qs[kRowChars];
  __shared__ int32_t dsm[kRowChars];
  __shared__ int32_t wtot[2][kRowWarps];

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int T = blockDim.x;
  const int W = T * kRowLpt;
  const int nch = (K + W - 1) / W;
  const int nwarps = T >> 5;
  const int wl = j & 31;
  const int warp = j >> 5;
  int32_t* st = scratch != nullptr
                    ? scratch + static_cast<size_t>(b) * row_state_words(K)
                    : dyn;
  uint32_t* acc = reinterpret_cast<uint32_t*>(st + 8 * static_cast<size_t>(K));
  const int32_t n1 = n1v[b];
  const int32_t n2 = n2v[b];
  const int32_t kc = n1 - n2 - k_lo;  // the corner's lane
  int32_t* fin = finals + static_cast<size_t>(b) * 3;

  // Row 0.
  for (int c = 0; c < nch; ++c) {
#pragma unroll
    for (int i = 0; i < kRowLpt; ++i) {
      const int k = c * W + j * kRowLpt + i;
      if (k >= K) continue;
      int32_t M, I, D, H;
      const int32_t code =
          sa::row0_cell<DIRS>(k, k_lo, n1, COMPAT, sc, M, I, D, H);
      st[k] = M;
      st[K + k] = D;
      st[2 * K + k] = H;
      st[3 * K + k] = s1w0[static_cast<size_t>(b) * K + k];
      if (n2 == 0 && k == kc) {
        fin[0] = M;
        fin[1] = I;
        fin[2] = D;
      }
      if (DIRS != sa::kDirsNone) {
        if (l2 == 0) {
          dirs[static_cast<size_t>(b) * K + k] = static_cast<uint32_t>(code);
        } else {
          acc[k] = static_cast<uint32_t>(code);
        }
      }
    }
  }
  __syncthreads();

  int step = 0;  // chunk counter: the parity of the warp-total buffer
  for (int x = 1; x <= l2; ++x) {
    const int xc = (x - 1) % kRowChars;
    if (xc == 0) {
      const size_t row = static_cast<size_t>(b) * Xp;
      for (int i = j; i < kRowChars; i += T) {
        const bool in = x + i < Xp;
        qs[i] = in ? qin[row + x + i] : -1;
        dsm[i] = in ? dcs[row + x + i] : -1;
      }
      __syncthreads();
    }
    const int32_t qc = qs[xc];
    const int32_t dc = dsm[xc];
    const int32_t* pM = st + static_cast<size_t>((x - 1) & 1) * 4 * K;
    const int32_t* pD = pM + K;
    const int32_t* pH = pD + K;
    const int32_t* pS = pH + K;
    int32_t* cM = st + static_cast<size_t>(x & 1) * 4 * K;
    int32_t* cD = cM + K;
    int32_t* cH = cD + K;
    int32_t* cS = cH + K;
    const sa::RowCtx r = sa::row_ctx(x, k_lo, n1, n2, COMPAT, sc);
    const uint32_t shift = kBits * (x & (kUp - 1));
    const bool flush = (x & (kUp - 1)) == kUp - 1 || x == l2;
    int32_t carry = sa::kScanFill;

    for (int c = 0; c < nch; ++c, ++step) {
      const int k0 = c * W + j * kRowLpt;
      // Lane k0-1's M on this row (its query code is lane k0's of row x-1).
      int32_t M_left = sa::kRowNegBig;
      if (k0 > 0 && k0 <= K - 1) {
        M_left = sa::row_m<WILDCARD>(r, k0 - 1, pH[k0 - 1], pS[k0], dc, sc);
      }
      int32_t M[kRowLpt], D[kRowLpt], dd[kRowLpt], Dpr[kRowLpt], v[kRowLpt],
          s1[kRowLpt];
      int32_t ml = M_left;
      int32_t tot = sa::kScanFill;
#pragma unroll
      for (int i = 0; i < kRowLpt; ++i) {
        const int k = k0 + i;
        if (k < K) {
          const bool last = k == K - 1;
          s1[i] = last ? qc : pS[k + 1];
          M[i] = sa::row_m<WILDCARD>(r, k, pH[k], s1[i], dc, sc);
          D[i] = sa::row_d(r, k, K, last ? 0 : pM[k + 1],
                           last ? 0 : pD[k + 1], sc, dd[i], Dpr[i]);
          v[i] = sa::row_v(r, k, ml, sc);
          ml = M[i];
        } else {
          v[i] = sa::kScanFill;
        }
        tot = sa::imax(tot, v[i]);
      }
      // Block-wide exclusive maximum of the thread totals, plus the carry.
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t t = __shfl_up_sync(0xffffffffu, tot, off);
        if (wl >= off) tot = sa::imax(tot, t);
      }
      int32_t excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (wl == 0) excl = sa::kScanFill;
      if (wl == 31) wtot[step & 1][warp] = tot;
      __syncthreads();
      int32_t next = carry;
      for (int w = 0; w < nwarps; ++w) {
        const int32_t t = wtot[step & 1][w];
        if (w < warp) excl = sa::imax(excl, t);
        next = sa::imax(next, t);
      }
      excl = sa::imax(excl, carry);
      carry = next;

      // I of lane k0-1 from the exclusive scan; then each lane's I, H, code.
      int32_t I_l = k0 > 0 && k0 <= K ? sa::row_i_masked(r, k0 - 1, excl, sc)
                                      : sa::kRowNegBig;
      int32_t M_l = M_left;
      int32_t run = excl;
#pragma unroll
      for (int i = 0; i < kRowLpt; ++i) {
        const int k = k0 + i;
        if (k >= K) break;
        run = sa::imax(run, v[i]);
        int32_t I, H;
        const int32_t code = sa::row_post<DIRS>(r, k, M[i], D[i], dd[i],
                                                Dpr[i], M_l, I_l, run, sc, I,
                                                H);
        cM[k] = M[i];
        cD[k] = D[i];
        cH[k] = H;
        cS[k] = s1[i];
        if (x == n2 && k == kc) {
          fin[0] = M[i];
          fin[1] = I;
          fin[2] = D[i];
        }
        if (DIRS != sa::kDirsNone) {
          const uint32_t w = acc[k] | (static_cast<uint32_t>(code) << shift);
          if (flush) {
            dirs[(static_cast<size_t>(x / kUp) * B + b) * K + k] = w;
            acc[k] = 0;
          } else {
            acc[k] = w;
          }
        }
        I_l = I;
        M_l = M[i];
      }
    }
    __syncthreads();
  }
}

typedef void (*RowKernel)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, int32_t*,
                          uint32_t*, int32_t*, int, int, int, int, int,
                          sa::Scheme);

template <int DIRS>
RowKernel pick_flags(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? banded_row_kernel<DIRS, true, true>
                    : banded_row_kernel<DIRS, true, false>;
  }
  return wildcard ? banded_row_kernel<DIRS, false, true>
                  : banded_row_kernel<DIRS, false, false>;
}

RowKernel pick(int dirs_mode, bool compat, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone: return pick_flags<sa::kDirsNone>(compat, wildcard);
    case sa::kDirsFast4: return pick_flags<sa::kDirsFast4>(compat, wildcard);
    case sa::kDirsFull: return pick_flags<sa::kDirsFull>(compat, wildcard);
    default: return nullptr;
  }
}

}  // namespace

extern "C" int sa_banded_row_warp_fill(
    const int32_t* s1w0, const int32_t* qin, const int32_t* dcs,
    const int32_t* n1v, const int32_t* n2v, int32_t* finals, uint32_t* dirs,
    int B, int K, int Xp, int l2, int k_lo, int match, int mismatch,
    int gap_open, int gap_extend, int dirs_mode, int compat, int wildcard,
    void* stream);

// The warp route's lanes a thread for a band of K lanes and a chunk width
// (nw_banded.cuh's rule), 0 when the block route takes it.
extern "C" int sa_banded_row_warp_lanes(int K, int chunk_lanes) {
  return sa::row_warp_lpt(K, chunk_lanes);
}

// Threads a block of the block route for a band of K lanes: chunk_lanes /
// 4, or (chunk_lanes == 0) K / 4 up to 512; 0 for a K or a chunk width
// that is not a positive multiple of 128 (a chunk at most 2048 lanes).
extern "C" int sa_banded_row_threads(int K, int chunk_lanes) {
  if (K <= 0 || K % 128 != 0 || chunk_lanes < 0 || chunk_lanes % 128 != 0 ||
      chunk_lanes > kRowThreads * kRowLpt) {
    return 0;
  }
  const int lanes = chunk_lanes ? chunk_lanes : K;
  const int t = lanes / kRowLpt;
  return t < kRowThreads ? t : kRowThreads;
}

// Int32 words of device scratch a pair of the block route needs: 0 while
// its state fits in shared memory, else 9 K.
extern "C" long sa_banded_row_scratch_words(int K) {
  const size_t bytes = row_state_words(K) * sizeof(int32_t);
  return bytes <= static_cast<size_t>(kRowSmemMax)
             ? 0
             : static_cast<long>(row_state_words(K));
}

// s1w0: (B, K) int32; qin/dcs: (B, Xp) int32 (Xp >= l2 + 1); n1v/n2v: (B,)
// int32; finals: (B, 3) int32, zeroed; dirs: (ceil((l2+1)/upack), B, K) u32,
// unused for dirs_mode 0; scratch: (B, 9K) int32 when
// sa_banded_row_scratch_words(K) > 0 on the block route, else unused.
// dirs_mode 0/1/2 (none, fast4, full); chunk_lanes: 0 (the warp route up
// to 512 lanes, else the block route's own chunks), or the block route's
// forced chunk width.  Returns the cudaGetLastError() of the launch, -1
// for an unsupported shape or mode.
extern "C" int sa_banded_row_fill(const int32_t* s1w0, const int32_t* qin,
                                  const int32_t* dcs, const int32_t* n1v,
                                  const int32_t* n2v, int32_t* finals,
                                  uint32_t* dirs, int32_t* scratch, int B,
                                  int K, int Xp, int l2, int k_lo, int match,
                                  int mismatch, int gap_open, int gap_extend,
                                  int dirs_mode, int compat, int wildcard,
                                  int chunk_lanes, void* stream) {
  const int threads = sa_banded_row_threads(K, chunk_lanes);
  if (threads == 0 || B <= 0 || l2 < 0 || Xp < l2 + 1) return -1;
  if (sa::row_warp_lpt(K, chunk_lanes) > 0) {
    return sa_banded_row_warp_fill(s1w0, qin, dcs, n1v, n2v, finals, dirs, B,
                                   K, Xp, l2, k_lo, match, mismatch,
                                   gap_open, gap_extend, dirs_mode, compat,
                                   wildcard, stream);
  }
  RowKernel fn = pick(dirs_mode, compat != 0, wildcard != 0);
  if (fn == nullptr) return -1;
  const bool in_smem = sa_banded_row_scratch_words(K) == 0;
  if (!in_smem && scratch == nullptr) return -1;
  int32_t* sp = in_smem ? nullptr : scratch;
  const size_t smem =
      in_smem ? row_state_words(K) * sizeof(int32_t) : static_cast<size_t>(0);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  void* args[] = {&s1w0, &qin, &dcs, &n1v, &n2v, &finals, &dirs,
                  &sp,   &B,   &K,   &Xp,  &l2,  &k_lo,   &sc};
  cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(B), dim3(threads),
                   args, smem, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

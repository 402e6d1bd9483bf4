// Device traceback walks for Hopper (sm_90a): the fast4 first-path walk of
// the global fill, the walk of the textbook semi-global / local modes and
// the banded fill's fast4 walk.
//
// fast4 walk:
// Replaces the device walk ops/traceback_device.py::_walk_fast4_impl (a
// lax.while_loop over lax.scan chunks on the TPU, not a Pallas kernel).  Each
// pair walks from its corner (x, y) = (n2, n1) on the seed plane, reading one
// fast4 nibble a step from the streamed fill's direction words
// (dirs[(x+y+off) >> 3, row, x]), and emits 2-bit op codes packed 16 to a u32
// in walk order (end to start), zero past the walk.
//
// Design: one thread per pair, looping until the origin or n1 + n2 steps;
// 16 ops are gathered in a register before each store.  This replaces the
// TPU walk's 512-step early-exit chunks, which exist only because an XLA scan
// cannot stop per pair.
//
// What bounds it on this card: the latency of the dependent global loads,
// one 4-byte load a step whose address depends on the previous step, from a
// direction tensor far larger than the L2 cache.  The work is tiny; blocks of
// 32 threads spread the pairs over as many SMs as possible.
//
// Modes walk: replaces ops/traceback_device.py::_walk_modes_impl (also a
// lax.while_loop over lax.scan chunks on the TPU).  Each pair walks from its
// end cell over the full direction bytes (dirs[(x+y+off) >> 2, row, x], the
// per-pair layout with row = b, off = 0 or the streamed one with the plan's
// row and slot * S) until its stop rule, one thread a pair, with the step of
// traceback_device.cuh::walk_modes_pair; it writes the packed op codes, the
// stop cell and a status (1 stopped cleanly, 2 broken).  Bound like the fast4
// walk by dependent-load latency, with a 1-byte code a step instead of 4 bits.
//
// Banded walk: replaces ops/traceback_device.py::_walk_banded_diag_msub (a
// lax.while_loop over lax.scan chunks on the TPU, up to 4 sub-steps a
// gather, compacted by a device sort).  One thread a pair walks the banded
// fill's wavefront-packed fast4 codes with the host walker's semantics
// (traceback_device.cuh::walk_banded_pair; std as a flag) and emits one op
// code a step, densely, so the TPU walk's sub-steps and compaction have
// nothing to do here.  A read outside the band gives code 0 and the walk
// advances; the TPU walk freezes there (a known fault of the reference),
// which this kernel does not copy.  Bound by dependent-load latency like
// the others.
#include <cuda_runtime.h>
#include <stdint.h>

#include "traceback_device.cuh"

namespace {

constexpr int kWalkThreads = 32;

__global__ void walk_fast4_kernel(const uint32_t* __restrict__ dirs, int R,
                                  int P, const int32_t* __restrict__ x0,
                                  const int32_t* __restrict__ y0,
                                  const int32_t* __restrict__ plane0,
                                  const int32_t* __restrict__ rowp,
                                  const int32_t* __restrict__ off, int B,
                                  int W, uint32_t* __restrict__ packed,
                                  int32_t* __restrict__ xf,
                                  int32_t* __restrict__ yf,
                                  int32_t* __restrict__ n_ops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t x = x0[b];
  int32_t y = y0[b];
  int32_t plane = plane0[b];
  const size_t row = static_cast<size_t>(rowp[b]);
  const int32_t o = off[b];
  const int steps = x + y;
  uint32_t* out = packed + static_cast<size_t>(b) * W;
  uint32_t word = 0;
  int i = 0;
  int w = 0;
  while (i < steps && (x != 0 || y != 0)) {
    const int32_t d = x + y + o;
    const uint32_t v = __ldg(dirs + ((static_cast<size_t>(d >> 3) * R + row) * P + x));
    const uint32_t nib = (v >> (4 * (d & 7))) & 0xFu;
    word |= sa::walk_step(nib, x, y, plane) << (2 * (i & 15));
    ++i;
    if ((i & 15) == 0) {
      out[w++] = word;
      word = 0;
    }
  }
  if (i & 15) out[w++] = word;
  for (; w < W; ++w) out[w] = 0;
  xf[b] = x;
  yf[b] = y;
  n_ops[b] = i;
}

template <bool LOCAL>
__global__ void walk_modes_kernel(const uint32_t* __restrict__ dirs, int W,
                                  int R, int P,
                                  const int32_t* __restrict__ x0,
                                  const int32_t* __restrict__ y0,
                                  const int32_t* __restrict__ rowp,
                                  const int32_t* __restrict__ off, int B,
                                  int WP, uint32_t* __restrict__ packed,
                                  int32_t* __restrict__ xf,
                                  int32_t* __restrict__ yf,
                                  int32_t* __restrict__ st,
                                  int32_t* __restrict__ n_ops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t x = x0[b];
  int32_t y = y0[b];
  int32_t s, n;
  sa::walk_modes_pair<LOCAL>(dirs, W, R, P, static_cast<size_t>(rowp[b]),
                             off[b], x, y, s, n,
                             packed + static_cast<size_t>(b) * WP, WP);
  xf[b] = x;
  yf[b] = y;
  st[b] = s;
  n_ops[b] = n;
}

template <bool STD>
__global__ void walk_banded_kernel(const uint32_t* __restrict__ dirs, int W,
                                   int NB, int L,
                                   const int32_t* __restrict__ x0,
                                   const int32_t* __restrict__ y0,
                                   const int32_t* __restrict__ plane0,
                                   const int32_t* __restrict__ bidx,
                                   int k_lo_even, int B, int WP,
                                   uint32_t* __restrict__ packed,
                                   int32_t* __restrict__ xf,
                                   int32_t* __restrict__ yf,
                                   int32_t* __restrict__ n_ops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t x = x0[b];
  int32_t y = y0[b];
  int32_t n;
  sa::walk_banded_pair<STD>(dirs, W, NB, L, static_cast<size_t>(bidx[b]),
                            k_lo_even, x, y, plane0[b], n,
                            packed + static_cast<size_t>(b) * WP, WP);
  xf[b] = x;
  yf[b] = y;
  n_ops[b] = n;
}

}  // namespace

// dirs: (T/8, R, P) u32 fast4 words; x0/y0/plane0/rowp/off: (B,) int32 walk
// seeds; packed: (B, W) u32 with W*16 >= the longest walk; xf/yf/n_ops: (B,)
// int32.  Returns the cudaGetLastError() of the launch, or -1 for a bad
// shape.
extern "C" int sa_walk_fast4(const uint32_t* dirs, int R, int P,
                             const int32_t* x0, const int32_t* y0,
                             const int32_t* plane0, const int32_t* rowp,
                             const int32_t* off, int B, int W,
                             uint32_t* packed, int32_t* xf, int32_t* yf,
                             int32_t* n_ops, void* stream) {
  if (R <= 0 || P <= 0 || B <= 0 || W <= 0) return -1;
  const int blocks = (B + kWalkThreads - 1) / kWalkThreads;
  walk_fast4_kernel<<<blocks, kWalkThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      dirs, R, P, x0, y0, plane0, rowp, off, B, W, packed, xf, yf, n_ops);
  return static_cast<int>(cudaGetLastError());
}

// dirs: (W, R, P) u32 full direction bytes; x0/y0/rowp/off: (B,) int32 end
// cells, rows and diagonal offsets; packed: (B, WP) u32, the walk taking at
// most WP*16 steps; xf/yf/st/n_ops: (B,) int32.  local != 0: local, else
// semi-global.  Returns the cudaGetLastError() of the launch, or -1 for a bad
// shape.
extern "C" int sa_walk_modes(const uint32_t* dirs, int W, int R, int P,
                             const int32_t* x0, const int32_t* y0,
                             const int32_t* rowp, const int32_t* off, int B,
                             int WP, int local, uint32_t* packed, int32_t* xf,
                             int32_t* yf, int32_t* st, int32_t* n_ops,
                             void* stream) {
  if (W <= 0 || R <= 0 || P <= 0 || B <= 0 || WP <= 0) return -1;
  const int blocks = (B + kWalkThreads - 1) / kWalkThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (local) {
    walk_modes_kernel<true><<<blocks, kWalkThreads, 0, s>>>(
        dirs, W, R, P, x0, y0, rowp, off, B, WP, packed, xf, yf, st, n_ops);
  } else {
    walk_modes_kernel<false><<<blocks, kWalkThreads, 0, s>>>(
        dirs, W, R, P, x0, y0, rowp, off, B, WP, packed, xf, yf, st, n_ops);
  }
  return static_cast<int>(cudaGetLastError());
}

// dirs: (W, NB, L) u32 banded fast4 words (ops/nw_banded_diag layout);
// x0/y0/plane0/bidx: (B,) int32 corners, seed planes and dirs batch slots;
// packed: (B, WP) u32 with WP*16 >= the longest walk; xf/yf/n_ops: (B,)
// int32.  std != 0 walks the any-state-open model.  Returns the
// cudaGetLastError() of the launch, or -1 for a bad shape.
extern "C" int sa_walk_banded(const uint32_t* dirs, int W, int NB, int L,
                              const int32_t* x0, const int32_t* y0,
                              const int32_t* plane0, const int32_t* bidx,
                              int k_lo_even, int B, int WP, int std_model,
                              uint32_t* packed, int32_t* xf, int32_t* yf,
                              int32_t* n_ops, void* stream) {
  if (W <= 0 || NB <= 0 || L <= 0 || B <= 0 || WP <= 0) return -1;
  const int blocks = (B + kWalkThreads - 1) / kWalkThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (std_model) {
    walk_banded_kernel<true><<<blocks, kWalkThreads, 0, s>>>(
        dirs, W, NB, L, x0, y0, plane0, bidx, k_lo_even, B, WP, packed, xf,
        yf, n_ops);
  } else {
    walk_banded_kernel<false><<<blocks, kWalkThreads, 0, s>>>(
        dirs, W, NB, L, x0, y0, plane0, bidx, k_lo_even, B, WP, packed, xf,
        yf, n_ops);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// Modes walk: replaces ops/traceback_device.py::_walk_modes_impl (also a
// lax.while_loop over lax.scan chunks on the TPU).  Each pair walks from its
// end cell over the full direction bytes (dirs[(x+y+off) >> 2, row, x], the
// per-pair layout with row = b, off = 0 or the streamed one with the plan's
// row and slot * S) until its stop rule, with walk_modes_step; it writes the
// packed op codes, the stop cell and a status (1 stopped cleanly, 2 broken).
//
// Design of both (traceback_device.cuh's staged schedule): a warp a pair,
// kWalkWarps pairs a block, over rows staged ahead of the walk in shared
// memory by the Tensor Memory Accelerator: batches of 64 anti-diagonals
// (8 fast4 / 16 modes word-rows), each row the 32 lanes (128 bytes) around
// where the walk's DP diagonal crosses it (a sheared window, a bulk copy a
// row, cp.async.bulk completing the slot's mbarrier), in a ring of 3
// batch slots.  An M move lowers the lane by one and the anti-diagonal by
// two, so in this layout every M move reads another lane's word: the warp's
// 32 lanes read the next 32 cells of the M diagonal from the stage at once,
// and a ballot gives the run of M moves, a whole run an iteration (up to 32
// moves); other moves are one step an iteration.  Where a gap takes the
// walk off the windows' diagonal the ring is restaged from the walk's cell;
// another word outside the stage is a direct load (the slow path; both
// counted when the caller asks).  What
// bounds it: at many pairs the staged bytes (128 a word-row: ~0.27 GB for
// fast4, ~0.54 GB for modes at 4096 x 2046 bp, against the function's
// ~38 MB); at few pairs one walk's chain of iterations (the probe's shared
// loads, a ballot, the emit) and the waits for the ring's copies.
//
// Banded walk: replaces ops/traceback_device.py::_walk_banded_diag_msub (a
// lax.while_loop over lax.scan chunks on the TPU, up to 4 sub-steps a
// gather, compacted by a device sort).  It walks the banded fill's
// wavefront-packed fast4 codes with the host walker's semantics (walk_step
// on banded_word's nibbles; std as a flag) and emits one op code a step, densely,
// so the TPU walk's sub-steps and compaction have nothing to do here.  A
// read outside the band gives code 0 and the walk advances; the TPU walk
// freezes there (a known fault of the reference), which this kernel does
// not copy.
//
// Design: a pair a warp, its walk run by the warp's first thread over
// direction words staged ahead of it in shared memory (traceback_device.cuh's
// window) by the Tensor Memory Accelerator: the rows of 8 anti-diagonals
// the walk will enter are copied a batch of kWalkDepth rows at a time, 32
// band lanes (128 bytes) a row around the walk's lane, by bulk copies
// (cp.async.bulk) completing the batch's mbarrier, into a ring of two
// batches: while the walk reads one batch the next is in flight, and the
// walk waits only when it enters a batch.  The word read is kept while the
// walk stays in its row and lane (an M run reads one word for four steps);
// a word outside the row's window is a direct load (the slow path, counted
// when the caller asks).  A run of M moves is taken from the word in hand
// at once (walk_banded_moves: up to 4, the rest of the lane's cells in the
// row), other moves one at a time by walk_step's interior form, and the
// forced moves once x or y is 0 are written a word at a time, so the loop
// carries no border test.  What bounds it: the dependent chain of an
// iteration, ~45 instructions and 4-5 branches for one thread (a few
// hundred cycles); taking a row's M moves in one iteration divides the
// iterations of a near-identical pair by about 4.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "traceback_device.cuh"

namespace {

constexpr int kBandWarps = 4;  // pairs (warps) a block of the banded walk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the phase `parity` of the mbarrier at a (shared::cta).
__device__ __forceinline__ void bar_wait(uint32_t a, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// slow: null, or a counter of the words read by the slow path.
template <bool STD>
__global__ void __launch_bounds__(kBandWarps * 32)
    walk_banded_kernel(const uint32_t* __restrict__ dirs, int W, int NB,
                       int L, const int32_t* __restrict__ x0,
                       const int32_t* __restrict__ y0,
                       const int32_t* __restrict__ plane0,
                       const int32_t* __restrict__ bidx, int k_lo_even, int B,
                       int WP, int win, uint32_t* __restrict__ packed,
                       int32_t* __restrict__ xf, int32_t* __restrict__ yf,
                       int32_t* __restrict__ n_ops,
                       unsigned long long* slow) {
  constexpr int D = sa::kWalkDepth;
  __shared__ alignas(128) uint32_t
      stage[kBandWarps][2 * D][sa::kWalkWindow];
  __shared__ alignas(8) uint64_t bars[kBandWarps][2];
  const int wid = threadIdx.x >> 5;
  const int b = blockIdx.x * kBandWarps + wid;
  if (b >= B || (threadIdx.x & 31) != 0) return;
  uint32_t(*st)[sa::kWalkWindow] = stage[wid];  // row r in st[r % (2 * D)]
  const uint32_t bar0 = smem_u32(&bars[wid][0]);
  int32_t x = x0[b];
  int32_t y = y0[b];
  int32_t plane = plane0[b];
  const size_t nb = static_cast<size_t>(bidx[b]);
  uint32_t* out = packed + static_cast<size_t>(b) * WP;
  uint32_t word = 0;
  int i = 0;
  int w = 0;
  if (x > 0 && y > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    int32_t lo_of0 = 0, lo_of1 = 0;  // the ring halves' first lanes
    uint32_t phase = 0;  // bit q: the parity of half q's next wait
    uint32_t pending = 0;  // bit q: half q staged and not yet waited on
    // Stages batch m (m >= 0) around band lane `center` into ring half m & 1:
    // rows past the tensor written as zeros, the others copied, completing
    // the half's barrier once all have landed.
    auto stage_batch = [&](int32_t m, int32_t center) {
      const int q = m & 1;
      const int32_t lo_q = sa::window_at(center, win, L);
      if (q) {
        lo_of1 = lo_q;
      } else {
        lo_of0 = lo_q;
      }
      const int32_t r0 = m * D;
      const int rows = max(0, min(D, W - r0));
      for (int j = rows; j < D; ++j) {
        for (int l = 0; l < sa::kWalkWindow; ++l) st[q * D + j][l] = 0;
      }
      // The half's earlier reads (and the zeros just written) come before
      // the copies into it.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const uint32_t ba = bar0 + 8 * q;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(ba),
          "r"(128 * rows)
          : "memory");
      const uint32_t* src =
          dirs + (static_cast<size_t>(r0) * NB + nb) * L + lo_q;
      for (int j = 0; j < rows; ++j) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], 128, [%2];" ::"r"(smem_u32(st[q * D + j])),
            "l"(src + static_cast<size_t>(j) * NB * L), "r"(ba)
            : "memory");
      }
      pending |= 1u << q;
    };
    auto wait_batch = [&](int32_t m) {
      const int q = m & 1;
      bar_wait(bar0 + 8 * q, (phase >> q) & 1u);
      phase ^= 1u << q;
      pending &= ~(1u << q);
    };
    int32_t a = x + y - 1;
    int32_t lane = sa::band_lane(x, y, k_lo_even);
    // Rows and batches are >= 0 here (x, y > 0): unsigned shifts and masks.
    int32_t row = a >> 3;
    int32_t m = static_cast<uint32_t>(row) / D;
    stage_batch(m, lane);
    if (m > 0) stage_batch(m - 1, lane);
    int32_t lane_in = lane;  // the walk's lane on entering batch m
    wait_batch(m);
    int32_t lo = (m & 1) ? lo_of1 : lo_of0;
    const uint32_t* srow = st[static_cast<uint32_t>(row) % (2 * D)];
    int32_t held = INT_MIN;  // the band lane of the word in hand (v)
    uint32_t v = 0;
    unsigned nslow = 0;
    for (;;) {
      if (lane != held) {
        held = lane;
        const int32_t li = lane - lo;
        if (static_cast<uint32_t>(li) < static_cast<uint32_t>(win)) {
          v = srow[li];
        } else if (lane < 0 || lane >= L || row >= W) {
          v = 0;
        } else {
          v = sa::banded_word(dirs, W, NB, L, nb, row, lane);
          ++nslow;
        }
      }
      uint32_t bits;
      const int k = sa::walk_banded_moves<STD>(v, a, x, y, plane, bits);
      sa::emit_ops(bits, k, i, w, word, out);
      if (x == 0 || y == 0) break;
      a = x + y - 1;
      lane = sa::band_lane(x, y, k_lo_even);
      if ((a >> 3) != row) {
        // The walk entered the next row down.
        row = a >> 3;
        if (static_cast<int32_t>(static_cast<uint32_t>(row) / D) != m) {
          // ... and batch m - 1: batch m - 2 takes the ring half of batch
          // m, whose words the walk has read.
          m = static_cast<uint32_t>(row) / D;
          const int32_t drift = lane - lane_in;
          lane_in = lane;
          if (m > 0) stage_batch(m - 1, lane + drift + drift / 2);
          wait_batch(m);
          lo = (m & 1) ? lo_of1 : lo_of0;
        }
        srow = st[static_cast<uint32_t>(row) % (2 * D)];
        held = INT_MIN;
      }
    }
    if (slow != nullptr && nslow != 0) atomicAdd(slow, nslow);
    // No copy may land in the block's shared memory after it exits.
    if (pending & 1u) wait_batch(0);
    if (pending & 2u) wait_batch(1);
  }
  // Forced moves to the origin: I at x == 0, D at y == 0.
  sa::emit_run(x == 0 ? 2u : 3u, x + y, i, w, word, out);
  if (i & 15) out[w++] = word;
  for (; w < WP; ++w) out[w] = 0;
  xf[b] = 0;
  yf[b] = 0;
  n_ops[b] = i;
}

typedef void (*BandWalk)(const uint32_t*, int, int, int, const int32_t*,
                         const int32_t*, const int32_t*, const int32_t*, int,
                         int, int, int, uint32_t*, int32_t*, int32_t*,
                         int32_t*, unsigned long long*);

// The staged walks' warp (traceback_device.cuh's Ops): the ring of kSlots
// batch slots in this warp's part of the block's shared memory, a barrier
// and a window offset a slot; every lane holds the walk's state, lane j
// probes the j-th cell.  Its methods are __host__ __device__ as the
// schedule's templates that call them, with device bodies only.
struct WarpOps {
  uint32_t* ring;     // kSlots * rows staged rows of kStagePitch words
  uint32_t bar0;      // the slots' mbarriers (shared::cta addresses)
  int32_t* offs;      // the slots' window offsets
  int me;             // this thread's lane
  uint32_t phase;     // bit q: the parity of slot q's next wait
  uint32_t pending;   // bit q: slot q copied and not yet waited on
  unsigned restarts;  // the ring's restagings (StageRing::restart)

  __device__ __forceinline__ WarpOps(uint32_t* ring_, uint64_t* bars,
                                     int32_t* offs_)
      : ring(ring_),
        bar0(smem_u32(bars)),
        offs(offs_),
        me(static_cast<int>(threadIdx.x & 31)),
        phase(0),
        pending(0),
        restarts(0) {}

  SA_HDM int lane() const { return me; }
  SA_HDM int lanes() const { return 32; }

  SA_HDM void init() {
#if defined(__CUDA_ARCH__)
    if (me == 0) {
      for (int q = 0; q < sa::kSlots; ++q) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 +
                                                                    8 * q));
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
#endif
  }

  template <class F>
  SA_HDM void probe(F f, uint32_t& mm, uint32_t& okm, uint32_t& v0) {
#if defined(__CUDA_ARCH__)
    uint32_t v;
    bool ok, mv;
    f(me, v, ok, mv);
    mm = __ballot_sync(0xFFFFFFFFu, mv);
    okm = __ballot_sync(0xFFFFFFFFu, ok);
    v0 = __shfl_sync(0xFFFFFFFFu, v, 0);
#endif
  }

  SA_HDM uint32_t word(int r, int li) const {
    return ring[r * sa::kStagePitch + li];
  }

  // Rows r0 .. r0 + n - 1 of the ring from src(0 .. n - 1), a lane a row,
  // completing slot q's barrier.  The caller has synced the warp since its
  // last reads of those rows.
  template <class Src>
  SA_HDM void copy(int r0, int n, int q, Src src) {
#if defined(__CUDA_ARCH__)
    const uint32_t ba = bar0 + 8 * q;
    // No proxy fence before the copies: nothing writes the ring but the
    // copies, and the slot's earlier reads have returned their words (the
    // warp synced after using them), so a copy cannot overtake them.
    if (me < n) {
      const uint32_t* from = src(me);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], 128, [%2];" ::"r"(
              smem_u32(ring + (r0 + me) * sa::kStagePitch)),
          "l"(from), "r"(ba)
          : "memory");
    }
    if (me == 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(ba),
          "r"(128 * n)
          : "memory");
    }
    pending |= 1u << q;
#endif
  }

  SA_HDM void wait(int q) {
#if defined(__CUDA_ARCH__)
    bar_wait(bar0 + 8 * q, (phase >> q) & 1u);
    phase ^= 1u << q;
    pending &= ~(1u << q);
#endif
  }

  SA_HDM void sync() {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }

  // Every copy in flight landed: before a restaging, and before the warp
  // exits (no copy may land in the block's shared memory after that).
  SA_HDM void drain() {
#if defined(__CUDA_ARCH__)
    while (pending) wait(__ffs(pending) - 1);
#endif
  }

  SA_HDM void count_restart() { ++restarts; }

  SA_HDM void set_offset(int q, int32_t e) {
    if (me == 0) offs[q] = e;
  }
  SA_HDM int32_t offset(int q) const { return offs[q]; }
};

// This warp's part of a staged walk kernel's shared memory, for a ring of
// ROWS rows a batch slot.
template <int ROWS>
struct WalkStage {
  alignas(128) uint32_t ring[sa::kWalkWarps][sa::kSlots * ROWS *
                                             sa::kStagePitch];
  alignas(8) uint64_t bars[sa::kWalkWarps][sa::kSlots];
  int32_t offs[sa::kWalkWarps][sa::kSlots];
};

// slow: null, or two counters: the words read by the slow path and the
// ring's restagings.
__global__ void __launch_bounds__(sa::kWalkWarps * 32)
    walk_fast4_kernel(const uint32_t* __restrict__ dirs, int NW, int R, int P,
                      const int32_t* __restrict__ x0,
                      const int32_t* __restrict__ y0,
                      const int32_t* __restrict__ plane0,
                      const int32_t* __restrict__ rowp,
                      const int32_t* __restrict__ off, int B, int WP,
                      uint32_t* __restrict__ packed,
                      int32_t* __restrict__ xf, int32_t* __restrict__ yf,
                      int32_t* __restrict__ n_ops, unsigned long long* slow) {
  __shared__ WalkStage<sa::StageRing<3, WarpOps>::kRows> sm;
  const int wid = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= B) return;
  WarpOps ops(sm.ring[wid], sm.bars[wid], sm.offs[wid]);
  int32_t x = x0[b];
  int32_t y = y0[b];
  int32_t n;
  unsigned nslow = 0;
  sa::walk_fast4_staged(ops, dirs, NW, R, P, static_cast<size_t>(rowp[b]),
                        off[b], x, y, plane0[b],
                        packed + static_cast<size_t>(b) * WP, WP, n, nslow);
  if (ops.me == 0) {
    xf[b] = x;
    yf[b] = y;
    n_ops[b] = n;
    if (slow != nullptr) {
      if (nslow != 0) atomicAdd(slow, nslow);
      if (ops.restarts != 0) atomicAdd(slow + 1, ops.restarts);
    }
  }
}

template <bool LOCAL>
__global__ void __launch_bounds__(sa::kWalkWarps * 32)
    walk_modes_kernel(const uint32_t* __restrict__ dirs, int NW, int R, int P,
                      const int32_t* __restrict__ x0,
                      const int32_t* __restrict__ y0,
                      const int32_t* __restrict__ rowp,
                      const int32_t* __restrict__ off, int B, int WP,
                      uint32_t* __restrict__ packed,
                      int32_t* __restrict__ xf, int32_t* __restrict__ yf,
                      int32_t* __restrict__ st, int32_t* __restrict__ n_ops,
                      unsigned long long* slow) {
  __shared__ WalkStage<sa::StageRing<2, WarpOps>::kRows> sm;
  const int wid = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= B) return;
  WarpOps ops(sm.ring[wid], sm.bars[wid], sm.offs[wid]);
  int32_t x = x0[b];
  int32_t y = y0[b];
  int32_t s, n;
  unsigned nslow = 0;
  sa::walk_modes_staged<LOCAL>(ops, dirs, NW, R, P,
                               static_cast<size_t>(rowp[b]), off[b], x, y, s,
                               n, packed + static_cast<size_t>(b) * WP, WP,
                               nslow);
  if (ops.me == 0) {
    xf[b] = x;
    yf[b] = y;
    st[b] = s;
    n_ops[b] = n;
    if (slow != nullptr) {
      if (nslow != 0) atomicAdd(slow, nslow);
      if (ops.restarts != 0) atomicAdd(slow + 1, ops.restarts);
    }
  }
}

}  // namespace

// dirs: (NW, R, P) u32 fast4 words, P >= 32 a multiple of 4;
// x0/y0/plane0/rowp/off: (B,) int32 walk seeds; packed: (B, WP) u32 with
// WP*16 >= the longest walk; xf/yf/n_ops: (B,) int32.  slow: null, or two
// u64 the slow path's word reads and the ring's restagings are added to.
// Returns the cudaGetLastError() of the launch, or -1 for a bad shape.
extern "C" int sa_walk_fast4(const uint32_t* dirs, int NW, int R, int P,
                             const int32_t* x0, const int32_t* y0,
                             const int32_t* plane0, const int32_t* rowp,
                             const int32_t* off, int B, int WP,
                             uint32_t* packed, int32_t* xf, int32_t* yf,
                             int32_t* n_ops, unsigned long long* slow,
                             void* stream) {
  if (NW <= 0 || R <= 0 || P < sa::kWalkWindow || P % 4 != 0 || B <= 0 ||
      WP <= 0) {
    return -1;
  }
  const int warps = B < sa::kWalkWarps ? B : sa::kWalkWarps;
  walk_fast4_kernel<<<(B + warps - 1) / warps, warps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      dirs, NW, R, P, x0, y0, plane0, rowp, off, B, WP, packed, xf, yf,
      n_ops, slow);
  return static_cast<int>(cudaGetLastError());
}

// dirs: (NW, R, P) u32 full direction bytes, P >= 32 a multiple of 4;
// x0/y0/rowp/off: (B,) int32 end cells, rows and diagonal offsets; packed:
// (B, WP) u32, the walk taking at most WP*16 steps; xf/yf/st/n_ops: (B,)
// int32.  local != 0: local, else semi-global.  slow as sa_walk_fast4's.
// Returns the cudaGetLastError() of the launch, or -1 for a bad shape.
extern "C" int sa_walk_modes(const uint32_t* dirs, int NW, int R, int P,
                             const int32_t* x0, const int32_t* y0,
                             const int32_t* rowp, const int32_t* off, int B,
                             int WP, int local, uint32_t* packed, int32_t* xf,
                             int32_t* yf, int32_t* st, int32_t* n_ops,
                             unsigned long long* slow, void* stream) {
  if (NW <= 0 || R <= 0 || P < sa::kWalkWindow || P % 4 != 0 || B <= 0 ||
      WP <= 0) {
    return -1;
  }
  const auto fn = local ? walk_modes_kernel<true> : walk_modes_kernel<false>;
  const int warps = B < sa::kWalkWarps ? B : sa::kWalkWarps;
  fn<<<(B + warps - 1) / warps, warps * 32, 0,
       static_cast<cudaStream_t>(stream)>>>(dirs, NW, R, P, x0, y0, rowp, off,
                                            B, WP, packed, xf, yf, st, n_ops,
                                            slow);
  return static_cast<int>(cudaGetLastError());
}

// dirs: (W, NB, L) u32 banded fast4 words (ops/nw_banded_diag layout);
// x0/y0/plane0/bidx: (B,) int32 corners, seed planes and dirs batch slots;
// packed: (B, WP) u32 with WP*16 >= the longest walk; xf/yf/n_ops: (B,)
// int32.  std != 0 walks the any-state-open model.  win: the staged
// window's lanes read from the stage (traceback_device.cuh::walk_window, 0
// the default); slow: null, or a u64 the slow path's word reads are added
// to.  Returns the cudaGetLastError() of the launch, or -1 for a bad shape.
extern "C" int sa_walk_banded(const uint32_t* dirs, int W, int NB, int L,
                              const int32_t* x0, const int32_t* y0,
                              const int32_t* plane0, const int32_t* bidx,
                              int k_lo_even, int B, int WP, int std_model,
                              uint32_t* packed, int32_t* xf, int32_t* yf,
                              int32_t* n_ops, int win,
                              unsigned long long* slow, void* stream) {
  if (W <= 0 || NB <= 0 || L < sa::kWalkWindow || L % 4 != 0 || B <= 0 ||
      WP <= 0 || !sa::walk_window(win)) {
    return -1;
  }
  const BandWalk fn = std_model ? walk_banded_kernel<true>
                                : walk_banded_kernel<false>;
  const int blocks = (B + kBandWarps - 1) / kBandWarps;
  fn<<<blocks, kBandWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      dirs, W, NB, L, x0, y0, plane0, bidx, k_lo_even, B, WP, win, packed, xf,
      yf, n_ops, slow);
  return static_cast<int>(cudaGetLastError());
}

// Textbook WFA for Hopper (sm_90a): the wavefront fill and the walk over
// its offset log.
//
// Fill (sa_wfa_chunk): replaces ops/wfa.py::_wfa_chunk_jax, a
// lax.while_loop on the TPU (the JAX package has no Pallas kernel for it),
// and at lattice step u = 0 its seed _wfa_seed2_jax.  It advances
// n_steps lattice steps from u0, writing each step's M/I/D offsets into the
// pair's (R, B, K) int32 rings (the carry between launches, as the JAX
// carry) and every row of the chunk's (n_steps, 3, B, K) int16 log: a
// pair's rows after its convergence, and all of a pair converged before
// the launch, NEG, as the JAX while_loop leaves them.  A pair converges at
// the first step where a lane reaches its end target; its score is u * g
// and its end diagonal the lowest such lane (an atomicMin in shared
// memory, as the JAX argmax takes the first).
//
// Design: a CTA a pair, a thread a diagonal lane (ceil(K / threads) lanes
// a thread past 1024 lanes), one barrier a step (__syncthreads_or, which
// also carries the convergence test): no step reads the ring slot it
// writes, so a step's reads need no barrier of their own.  The seed launch
// packs the pair's codes to bytes (ChunkArgs::codes, read once a fill);
// each later launch stages them in shared memory with one bulk copy
// (cp.async.bulk on an mbarrier).  The rings live in shared memory for the
// launch (SHARED: loaded at its start, written back at its end, lanes -1
// and K guard cells of NEG, a step's slots computed once), or, where R x K
// passes the shared-memory budget (sa_wfa_chunk decides by shape,
// wfa.cuh::wfa_ring_in_shared), stay in device memory.  A batch far below
// the SMs gets spare CTAs a pair (the grid's y, wfa.cuh::wfa_neg_ctas)
// that share the NEG rows of a pair converged before the launch, which one
// CTA alone writes at ~50 GB/s.  The extension compares a word (4 codes)
// at once: each lane its run's first word, then every run that goes on is
// taken by its warp, 32 words an iteration, the first mismatch by a ballot
// (wfa.cuh::wfa_span_lane).  What bounded the earlier design (a thread a
// diagonal over device-memory rings, a code compared at a time), measured
// by csrc/stream_sweep.py --wfa with its stamped build (NVIDIA H100 80GB
// HBM3, 700.00 W): the longest run of a step, compared a code at a time
// (~115 cycles a code, ~85% of a 10.5 us step at BASELINE config 3) while
// the other warps waited at the barrier; the ring loads from device memory
// (~1,300 cycles a step); the codes re-staged from int32 at every launch
// (~32 us).  What bounds this one: the step's dependent chain of one CTA
// (shared loads, the recurrence, the spans of its longest runs, the
// barrier), ~100-600 steps a fill.
//
// Walk (sa_wfa_walk): replaces ops/wfa.py::_wfa_walk_device_jit, a lax.scan
// on the TPU.  A warp a pair, 1-4 warps a block so that a batch spreads
// over the SMs, follows the JAX state machine (ties mismatch > I > D),
// every lane in step, its log row kept beside its score (no division a
// read); the log rows below the walk are staged in shared memory, one
// tensor copy a batch (cp.async.bulk.tensor through a tensor map of the
// log: 8 rows x 3 planes x 64 lanes, 128 bytes a row-plane, around the
// walk's diagonal), in a ring of 3 batch slots (wfa.cuh::WfaStage; a read
// outside the stage loads the log directly), so the three reads of a step
// are shared loads issued together.  It writes one 2-bit op code a column
// in the port's packed walk layout (ops/traceback_device.py), 16 a word, a
// run's whole words by the warp's lanes at once; the JAX walk emits
// run-length pairs whose uint16 cast wraps past 65535, which this kernel
// does not copy.  The earlier thread-a-pair walk spent ~80% of a step in
// its emit loop and its warp's divergence, the rest in three dependent log
// loads; 24 copies a batch issued a lane each and a division by g a read
// held this design's first version at ~3,600 cycles a step (~1,500 now).
// What bounds it: one walk's chain of steps (~50-250), each a few shared
// loads, the state update and the emit.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "wfa.cuh"

namespace {

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

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing the mbarrier at bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

struct ChunkArgs {
  const int32_t* seq1;
  const int32_t* seq2;
  const int32_t* n1v;
  const int32_t* n2v;
  uint8_t* codes;  // (B, pitch(L1) + pitch(L2)) bytes: written at u0 == 0
  int32_t* ring[3];
  int32_t* done;
  int32_t* score;
  int32_t* end_k;
  int16_t* hist;
  int B, L1, L2, K, R, k_lo, u0, n_steps, g, x_off, oe_off, e_off;
  int lead1, lead2, trail1, trail2;
};

constexpr uint32_t kFull = 0xFFFFFFFFu;

// The fill's stamps policy: csrc/wfa_stamps.cu instantiates the kernels
// with clock64() stamps between their parts (mark(part, v) ends a part
// once v is ready); the package's kernels take this one, which is empty.
struct NoStamps {
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int, int32_t = 0) {}
  __device__ __forceinline__ void finish(int) {}
};

// Stages pair b's packed codes into smem: at the seed launch packed from
// the int32 codes (and written to a.codes for the launches after it),
// else one bulk copy of the packed row.
__device__ __forceinline__ void stage_codes(const ChunkArgs& a, int b,
                                            uint8_t* smem, int P1, int CP,
                                            uint64_t* bar) {
  uint8_t* row = a.codes + static_cast<size_t>(b) * CP;
  if (a.u0 == 0) {
    const int32_t* q1 = a.seq1 + static_cast<size_t>(b) * a.L1;
    const int32_t* q2 = a.seq2 + static_cast<size_t>(b) * a.L2;
    constexpr int kUnroll = 4;
    const int words = CP / 4;
    for (int w0 = threadIdx.x; w0 < words; w0 += kUnroll * blockDim.x) {
      int32_t c[kUnroll][4];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * (w0 + r * blockDim.x) + j;
          const int p2 = p - P1;
          c[r][j] = p < a.L1 ? __ldg(q1 + p)
                             : (p2 >= 0 && p2 < a.L2 ? __ldg(q2 + p2) : 0);
        }
      }
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int w = w0 + r * blockDim.x;
        if (w < words) {
          const uint32_t v = (c[r][0] & 0xFFu) | (c[r][1] & 0xFFu) << 8 |
                             (c[r][2] & 0xFFu) << 16 |
                             static_cast<uint32_t>(c[r][3] & 0xFFu) << 24;
          reinterpret_cast<uint32_t*>(smem)[w] = v;
          reinterpret_cast<uint32_t*>(row)[w] = v;
        }
      }
    }
    return;
  }
  const uint32_t ba = smem_u32(bar);
  if (threadIdx.x == 0) {
    bar_init(ba);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_expect(ba, CP);
    bulk_copy(smem, row, CP, ba);
  }
  __syncthreads();
  bar_wait(ba, 0);
}

// Row-planes [rp0, rp1) (row * 3 + plane) of pair b's log: NEG, 8 lanes a
// 16-byte store, the threads striding over (row-plane, store) without a
// division a store.
__device__ __forceinline__ void neg_rows(const ChunkArgs& a, int b, int rp0,
                                         int rp1) {
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int per = a.K / 8;  // stores a row-plane
  const uint4 neg4 = make_uint4(0xC000C000u, 0xC000C000u, 0xC000C000u,
                                0xC000C000u);
  const size_t stride = static_cast<size_t>(a.B) * per;  // between row-planes
  uint4* const base =
      reinterpret_cast<uint4*>(a.hist) + static_cast<size_t>(b) * per;
  const uint4* const end = base + static_cast<size_t>(rp1) * stride;
  const int dseg = T / per, doff = T % per;
  uint4* seg = base + (static_cast<size_t>(rp0) + tid / per) * stride;
  for (int off = tid % per; seg < end;) {
    seg[off] = neg4;
    seg += dseg * stride;
    off += doff;
    if (off >= per) {
      off -= per;
      seg += stride;
    }
  }
}

// SPARE: the grid has spare CTAs a pair (gridDim.y > 1); the instances
// without them are the kernel as it runs at batches near the SMs, with
// nothing of the spare CTAs' in their code.
template <bool SHARED, bool SPARE, class Stamps = NoStamps>
__global__ void __launch_bounds__(1024)
    wfa_chunk_kernel(ChunkArgs a, Stamps stamps) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int b = blockIdx.x;
  const int n_rp = 3 * a.n_steps;
  if (SPARE && blockIdx.y > 0) {
    // A spare CTA of pair b (wfa.cuh::wfa_neg_ctas): its part of the NEG
    // rows if the pair converged before the launch.
    const int32_t sc = *reinterpret_cast<volatile int32_t*>(a.score + b);
    if (!sa::wfa_done_before(sc, a.u0, a.g)) return;
    int lo, hi;
    sa::wfa_neg_part(blockIdx.y, gridDim.y, n_rp, lo, hi);
    neg_rows(a, b, lo, hi);
    return;
  }
  Stamps st = stamps;
  st.begin();
  __shared__ int hit_lane;
  __shared__ alignas(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int me = tid & 31;
  const int P1 = sa::wfa_code_pitch(a.L1);
  const int CP = P1 + sa::wfa_code_pitch(a.L2);
  const int K = a.K;
  int i_neg = 0;  // the log rows from here on are NEG
  if (!a.done[b]) {
    stage_codes(a, b, smem, P1, CP, &bar);
    const sa::WfaSharedRing sring{reinterpret_cast<int32_t*>(smem + CP), a.R,
                                  K};
    const sa::WfaDeviceRing dring{{a.ring[0], a.ring[1], a.ring[2]}, a.B, K,
                                  b};
    if (SHARED) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        for (int j = tid; j < a.R * K; j += T) {
          sring.put(p, j / K, j % K, dring.at(p, j / K, j % K));
        }
      }
      for (int j = tid; j < 3 * a.R; j += T) {
        sring.row(j / a.R, j % a.R)[-1] = sa::kWfaNeg;
        sring.row(j / a.R, j % a.R)[K] = sa::kWfaNeg;
      }
    }
    if (tid == 0) hit_lane = INT_MAX;
    __syncthreads();
    st.mark(5);
    const uint32_t* w1 = reinterpret_cast<const uint32_t*>(smem);
    const uint32_t* w2 = w1 + P1 / 4;
    const int32_t n1 = a.n1v[b], n2 = a.n2v[b];
    i_neg = a.n_steps;
    int w = a.u0 % a.R;  // u % R, kept without a division
    for (int i = 0; i < a.n_steps; ++i, w = w + 1 == a.R ? 0 : w + 1) {
      const int u = a.u0 + i;
      const sa::WfaSlots q = sa::wfa_slots(u, w, a.R, a.x_off, a.oe_off,
                                           a.e_off);
      bool hit = false;
      // Warp-uniform: K and the threads are multiples of 32.
      for (int lane = tid; lane < K; lane += T) {
        const int32_t k = a.k_lo + lane;
        int32_t iv = sa::kWfaNeg, dv = sa::kWfaNeg, t;
        if (u == 0) {
          t = sa::wfa_seed_start(k, n1, n2, a.lead1, a.lead2);
        } else if (SHARED) {
          t = sa::wfa_candidate(sring, q, lane, k, n1, n2, iv, dv);
        } else {
          t = sa::wfa_candidate(dring, q, lane, k, n1, n2, iv, dv);
        }
        st.mark(0, t);
        const int32_t lim = n2 < n1 - k ? n2 : n1 - k;
        bool more = false;
        int32_t m = t > sa::kWfaNeg
                        ? sa::wfa_first_word(w1, w2, k, t, lim, more)
                        : sa::kWfaNeg;
        st.mark(1, m);
        // The runs that go on past their first word, the warp's at once.
        for (uint32_t pend = __ballot_sync(kFull, more); pend;
             pend &= pend - 1) {
          const int src = __ffs(pend) - 1;
          const int32_t ks = __shfl_sync(kFull, k, src);
          const int32_t ls = __shfl_sync(kFull, lim, src);
          int32_t ts = __shfl_sync(kFull, m, src);
          for (;; ts += 4 * sa::kWfaSpan) {
            int32_t end;
            const uint32_t stop = __ballot_sync(
                kFull, sa::wfa_span_lane(w1, w2, ks, ts, ls, me, end));
            if (stop) {
              ts = __shfl_sync(kFull, end, __ffs(stop) - 1);
              break;
            }
          }
          if (me == src) m = ts;
        }
        st.mark(2, m);
        if (SHARED) {
          sring.put(0, q.w, lane, m);
          sring.put(1, q.w, lane, iv);
          sring.put(2, q.w, lane, dv);
        } else {
          dring.put(0, q.w, lane, m);
          dring.put(1, q.w, lane, iv);
          dring.put(2, q.w, lane, dv);
        }
        int16_t* h = a.hist + sa::wfa_log_index(i, 0, a.B, b, K, lane);
        const size_t plane = static_cast<size_t>(a.B) * K;
        h[0] = static_cast<int16_t>(m);
        h[plane] = static_cast<int16_t>(iv);
        h[2 * plane] = static_cast<int16_t>(dv);
        bool mask;
        const int32_t end_t =
            sa::wfa_end_t(k, n1, n2, a.trail1, a.trail2, mask);
        if (mask && m >= end_t) {
          hit = true;
          atomicMin(&hit_lane, lane);
        }
        st.mark(3);
      }
      const bool any = __syncthreads_or(hit);
      st.mark(4);
      if (any) {
        if (tid == 0) {
          a.done[b] = 1;
          a.score[b] = u * a.g;
          a.end_k[b] = a.k_lo + hit_lane;
        }
        i_neg = i + 1;
        break;
      }
    }
    if (SHARED) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        for (int j = tid; j < a.R * K; j += T) {
          dring.put(p, j / K, j % K, sring.at(p, j / K, j % K));
        }
      }
    }
  }
  // The rows this pair did not compute; of a pair converged before the
  // launch (none computed), the first part where it has spare CTAs.
  int rp_neg = 3 * i_neg, rp_end = n_rp;
  if (SPARE && i_neg == 0 && sa::wfa_done_before(a.score[b], a.u0, a.g)) {
    sa::wfa_neg_part(0, gridDim.y, n_rp, rp_neg, rp_end);
  }
  neg_rows(a, b, rp_neg, rp_end);
  st.finish(i_neg);
}

// The walk's warp (wfa.cuh::WfaStage's Ops): its kWfaSlots batch slots and
// their mbarriers in its part of the block's shared memory; a batch is one
// tensor copy through the log's tensor map (walk_map).
struct WalkWarp {
  int16_t* slots;
  uint32_t bar0;
  const CUtensorMap* tmap;
  int b;
  int me;
  uint32_t phase = 0;  // bit q: the parity of slot q's next wait

  __device__ __forceinline__ WalkWarp(int16_t* s, uint64_t* bars,
                                      const CUtensorMap* map, int pair)
      : slots(s),
        bar0(smem_u32(bars)),
        tmap(map),
        b(pair),
        me(static_cast<int>(threadIdx.x & 31)) {}

  SA_HDM int lane() const { return me; }
  SA_HDM int lanes() const { return 32; }

  SA_HDM void init() {
#if defined(__CUDA_ARCH__)
    if (me == 0) {
      for (int q = 0; q < sa::kWfaSlots; ++q) bar_init(bar0 + 8 * q);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
#endif
  }

  // The batch of rows r0 .. r0 + kWfaRows - 1, 3 planes, lanes l0 ..
  // l0 + win - 1 of pair b, into slot q: one tensor copy (rows past the
  // log come as zeros, which no read reaches), completing slot q's barrier
  // with the whole box.  The warp synced since its last reads of the
  // slot, and no copy into it is in flight.
  template <class Src>
  SA_HDM void copy(int q, int r0, int l0, int, int win, Src) {
#if defined(__CUDA_ARCH__)
    if (me == 0) {
      const uint32_t ba = bar0 + 8 * q;
      bar_expect(ba, 2 * win * 3 * sa::kWfaRows);
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(
              smem_u32(slots + q * sa::kWfaSlotCells)),
          "l"(reinterpret_cast<uint64_t>(tmap)), "r"(l0), "r"(b), "r"(0),
          "r"(r0), "r"(ba)
          : "memory");
    }
#endif
  }

  SA_HDM void wait(int q) {
#if defined(__CUDA_ARCH__)
    bar_wait(bar0 + 8 * q, (phase >> q) & 1u);
    phase ^= 1u << q;
#endif
  }

  SA_HDM void sync() {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }

  SA_HDM int32_t cell(int q, int idx) const {
    return slots[q * sa::kWfaSlotCells + idx];
  }

  // wfa_stamps.cu's stamps; none here.
  SA_HDM void mark(int, int32_t = 0) {}
};

struct WalkArgs {
  const int16_t* hist;
  const int32_t* s0;
  const int32_t* k0;
  const int32_t* t0;
  const int32_t* live;
  const int32_t* budget;
  uint32_t* packed;
  int32_t* n_ops;
  int32_t* ok;
  int S, Bh, K, k_lo, g, B, x_pen, o_pen, e_pen, W;
};

// Shared memory of one walk: its slots, then (after every warp's slots)
// its barriers.
constexpr int kWalkSlotBytes = sa::kWfaSlots * sa::kWfaSlotCells * 2;

__global__ void __launch_bounds__(sa::kWfaWalkWarps * 32)
    wfa_walk_kernel(WalkArgs a, const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warps = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5;
  const int b = blockIdx.x * warps + wid;
  if (b >= a.B) return;
  WalkWarp ops(reinterpret_cast<int16_t*>(smem + wid * kWalkSlotBytes),
               reinterpret_cast<uint64_t*>(smem + warps * kWalkSlotBytes) +
                   wid * sa::kWfaSlots,
               &tmap, b);
  const int ok = sa::wfa_walk_staged(
      ops, a.hist, a.S, a.Bh, a.K, b, a.k_lo, a.g, a.s0[b], a.k0[b], a.t0[b],
      a.live[b] != 0, a.budget[b], a.x_pen, a.o_pen, a.e_pen,
      a.packed + static_cast<size_t>(b) * a.W, &a.n_ops[b]);
  if (ops.me == 0) a.ok[b] = ok;
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// the driver library); null where the driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The walk's tensor map of the (S, 3, Bh, K) int16 log: boxes of `win`
// lanes x 1 pair x 3 planes x kWfaRows rows.  False if it cannot be made.
bool walk_map(CUtensorMap* map, const int16_t* hist, int S, int Bh, int K,
              int win) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t k = static_cast<cuuint64_t>(K);
  const cuuint64_t dims[4] = {k, static_cast<cuuint64_t>(Bh), 3,
                              static_cast<cuuint64_t>(S)};
  const cuuint64_t strides[3] = {2 * k, 2 * k * Bh, 6 * k * Bh};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(win), 1, 3,
                             sa::kWfaRows};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4,
            const_cast<int16_t*>(hist), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opts the fill kernel in to kWfaSharedMax bytes of dynamic shared memory
// on the current device, once a device (past 48 KB a block's static and
// dynamic shared memory together need it).  Returns the cudaError_t of a
// failure, else 0.
template <bool SHARED, bool SPARE>
int fill_opt_in() {
  static std::atomic<unsigned long long> opted{0};  // bit d: device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (opted.load(std::memory_order_relaxed) & bit) return 0;
  e = cudaFuncSetAttribute(wfa_chunk_kernel<SHARED, SPARE, NoStamps>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sa::kWfaSharedMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  opted.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

}  // namespace

// seq1/seq2: (B, L1) / (B, L2) int32 codes; n1v/n2v: (B,) int32 lengths
// (< 2^14, at most L1 / L2); codes: (B, pitch(L1) + pitch(L2)) uint8, the
// packed codes, written by the launch at u0 == 0 and read by the later
// launches of the fill (wfa.cuh::wfa_code_pitch); ring_m/i/d: (R, B, K)
// int32; done, score, end_k: (B,) int32, updated in place; hist:
// (n_steps, 3, B, K) int16, every row written.  x_off/oe_off/e_off: the
// penalties in lattice steps, each in [1, R - 1]; lpt: lanes a thread
// (K <= 1024 * lpt); sms: the card's SMs.  The rings' route is the shape's
// (wfa.cuh::wfa_ring_in_shared).  Returns the cudaGetLastError() of the
// launch, or -1 for an unsupported shape.
extern "C" int sa_wfa_chunk(const int32_t* seq1, const int32_t* seq2,
                            const int32_t* n1v, const int32_t* n2v,
                            uint8_t* codes, int32_t* ring_m, int32_t* ring_i,
                            int32_t* ring_d, int32_t* done, int32_t* score,
                            int32_t* end_k, int16_t* hist, int B, int L1,
                            int L2, int K, int R, int k_lo, int u0,
                            int n_steps, int g, int x_off, int oe_off,
                            int e_off, int lead1, int lead2, int trail1,
                            int trail2, int lpt, int sms, void* stream) {
  if (B <= 0 || K <= 0 || K % 32 || n_steps <= 0 || lpt <= 0 ||
      K > 1024 * lpt || L1 < 0 || L2 < 0 || L1 + L2 > 2 * (1 << 14) ||
      x_off < 1 || oe_off < 1 || e_off < 1 || x_off >= R || oe_off >= R ||
      e_off >= R || g < 1 || sms <= 0) {
    return -1;
  }
  const bool shared = sa::wfa_ring_in_shared(L1, L2, K, R);
  const long long smem = sa::wfa_fill_smem(L1, L2, K, R, shared);
  if (smem > sa::kWfaSharedMax) return -1;
  int threads = (K + lpt - 1) / lpt;
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const ChunkArgs a{seq1,   seq2,   n1v,     n2v,    codes,
                    {ring_m, ring_i, ring_d}, done,   score,  end_k,
                    hist,   B,      L1,      L2,     K,      R,
                    k_lo,   u0,     n_steps, g,      x_off,  oe_off,
                    e_off,  lead1,  lead2,   trail1, trail2};
  const int spare = sa::wfa_neg_ctas(B, sms, u0, n_steps);
  const int rc = shared ? (spare > 1 ? fill_opt_in<true, true>()
                                     : fill_opt_in<true, false>())
                        : (spare > 1 ? fill_opt_in<false, true>()
                                     : fill_opt_in<false, false>());
  if (rc != 0) return rc;
  auto kernel = shared ? (spare > 1 ? wfa_chunk_kernel<true, true, NoStamps>
                                    : wfa_chunk_kernel<true, false, NoStamps>)
                       : (spare > 1 ? wfa_chunk_kernel<false, true, NoStamps>
                                    : wfa_chunk_kernel<false, false, NoStamps>);
  const dim3 grid(B, spare);
  kernel<<<grid, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(a, NoStamps());
  return static_cast<int>(cudaGetLastError());
}

// 1 if a fill of this shape keeps its rings in shared memory, else 0.
extern "C" int sa_wfa_ring_in_shared(int L1, int L2, int K, int R) {
  return sa::wfa_ring_in_shared(L1, L2, K, R) ? 1 : 0;
}

// hist: (S, 3, Bh, K) int16 log, 16-byte aligned, K >= 32 a multiple of
// 8; s0/k0/t0/live/budget: (B,) int32 walk seeds, B <= Bh; packed: (B, W)
// u32, zeroed by the caller, 16 * W >= each budget; n_ops, ok: (B,) int32
// outputs; sms: the card's SMs.  Returns the cudaGetLastError() of the
// launch, -1 for an unsupported shape, or -4 if the log's tensor map
// cannot be made.
extern "C" int sa_wfa_walk(const int16_t* hist, int S, int Bh, int K,
                           int k_lo, int g, const int32_t* s0,
                           const int32_t* k0, const int32_t* t0,
                           const int32_t* live, const int32_t* budget, int B,
                           int x_pen, int o_pen, int e_pen, int W,
                           uint32_t* packed, int32_t* n_ops, int32_t* ok,
                           int sms, void* stream) {
  if (B <= 0 || B > Bh || S <= 0 || K < 32 || K % 8 || W <= 0 || g <= 0 ||
      sms <= 0 || reinterpret_cast<uintptr_t>(hist) % 16) {
    return -1;
  }
  CUtensorMap map;
  if (!walk_map(&map, hist, S, Bh, K, K < sa::kWfaWindow ? K
                                                          : sa::kWfaWindow)) {
    return -4;
  }
  const WalkArgs a{hist, s0, k0, t0, live, budget, packed, n_ops, ok,
                   S,    Bh, K,  k_lo, g,  B,      x_pen,  o_pen, e_pen, W};
  // Warps a block: one a pair up to a pair an SM, at most kWfaWalkWarps.
  int warps = (B + sms - 1) / sms;
  warps = warps > sa::kWfaWalkWarps ? sa::kWfaWalkWarps : warps;
  const size_t smem = static_cast<size_t>(warps) *
                      (kWalkSlotBytes + 8 * sa::kWfaSlots);
  wfa_walk_kernel<<<(B + warps - 1) / warps, warps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(a, map);
  return static_cast<int>(cudaGetLastError());
}

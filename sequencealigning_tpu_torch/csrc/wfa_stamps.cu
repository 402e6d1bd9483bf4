// Clock stamps of the WFA kernels' parts, for csrc/stream_sweep.py --wfa:
// the sweep builds this file with nvcc into a library of its own; the
// package never builds it.  It instantiates wfa.cu's fill kernel with a
// stamps policy and runs wfa.cuh's walk schedule with a stamping warp:
// clock64() between the parts, a part ending once the value it produced
// is ready (a branch on it waits for its loads), summed a warp (its lane
// 0) into stamps[] (u64, added to):
//
//   fill (st_wfa_chunk): 0 the candidate (ring reads, recurrence), 1 the
//   run's first word, 2 the warp's spans, 3 the stores and the end test,
//   4 the barrier, 5 staging the codes and rings, 6 the ring write-back
//   and the NEG rows; 7 warp-steps; 8 the CTAs' cycles (thread 0), 9
//   their lattice steps, 10 CTAs that ran a step;
//   walk (st_wfa_walk): 0 the log reads, 1 the state machine and the
//   emit, 2 the staging of the batches below, 3 walk steps, 4 the warps'
//   cycles, 5 walks.
//
// The stamps add a few instructions a part: the parts' sum is near, not
// equal to, a step of the kernel without them.
#include "wfa.cu"

namespace {

__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// Waits until v is ready (a branch on it) without changing anything.
__device__ __forceinline__ void use(int32_t v) {
  if (v == INT_MIN + 7) asm volatile("trap;");
}

struct ClockStamps {
  unsigned long long* out;
  long long t0, last;
  unsigned long long acc[7];
  unsigned long long steps;

  __device__ void begin() {
    t0 = last = stamp();
    for (int p = 0; p < 7; ++p) acc[p] = 0;
    steps = 0;
  }
  __device__ void mark(int part, int32_t v = 0) {
    use(v);
    const long long t = stamp();
    acc[part] += t - last;
    last = t;
    if (part == 4) ++steps;
  }
  __device__ void finish(int ran) {
    mark(6);
    if ((threadIdx.x & 31) == 0) {
      for (int p = 0; p < 7; ++p) atomicAdd(&out[p], acc[p]);
      atomicAdd(&out[7], steps);
    }
    if (threadIdx.x == 0 && ran > 0) {
      atomicAdd(&out[8], static_cast<unsigned long long>(last - t0));
      atomicAdd(&out[9], static_cast<unsigned long long>(ran));
      atomicAdd(&out[10], 1ull);
    }
  }
};

struct StampedWalkWarp : WalkWarp {
  long long last = 0;
  unsigned long long acc[4] = {0, 0, 0, 0};

  __device__ StampedWalkWarp(int16_t* s, uint64_t* bars,
                             const CUtensorMap* map, int pair)
      : WalkWarp(s, bars, map, pair), last(stamp()) {}

  __device__ void mark(int part, int32_t v = 0) {
    use(v);
    const long long t = stamp();
    acc[part] += t - last;
    last = t;
    if (part == 1) ++acc[3];
  }
};

__global__ void __launch_bounds__(sa::kWfaWalkWarps * 32)
    walk_stamped(WalkArgs a, const __grid_constant__ CUtensorMap tmap,
                 unsigned long long* out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warps = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5;
  const int b = blockIdx.x * warps + wid;
  if (b >= a.B) return;
  const long long t_begin = stamp();
  StampedWalkWarp ops(
      reinterpret_cast<int16_t*>(smem + wid * kWalkSlotBytes),
      reinterpret_cast<uint64_t*>(smem + warps * kWalkSlotBytes) +
          wid * sa::kWfaSlots,
      &tmap, b);
  const int ok = sa::wfa_walk_staged(
      ops, a.hist, a.S, a.Bh, a.K, b, a.k_lo, a.g, a.s0[b], a.k0[b], a.t0[b],
      a.live[b] != 0, a.budget[b], a.x_pen, a.o_pen, a.e_pen,
      a.packed + static_cast<size_t>(b) * a.W, &a.n_ops[b]);
  if (ops.me == 0) {
    a.ok[b] = ok;
    for (int p = 0; p < 4; ++p) atomicAdd(&out[p], ops.acc[p]);
    atomicAdd(&out[4], static_cast<unsigned long long>(stamp() - t_begin));
    atomicAdd(&out[5], 1ull);
  }
}

}  // namespace

// sa_wfa_chunk's arguments but the SMs (a CTA a pair: no spare CTAs), then
// the stamps (11 u64, added to).
extern "C" int st_wfa_chunk(const int32_t* seq1, const int32_t* seq2,
                            const int32_t* n1v, const int32_t* n2v,
                            uint8_t* codes, int32_t* ring_m, int32_t* ring_i,
                            int32_t* ring_d, int32_t* done, int32_t* score,
                            int32_t* end_k, int16_t* hist, int B, int L1,
                            int L2, int K, int R, int k_lo, int u0,
                            int n_steps, int g, int x_off, int oe_off,
                            int e_off, int lead1, int lead2, int trail1,
                            int trail2, int lpt,
                            unsigned long long* stamps, void* stream) {
  const bool shared = sa::wfa_ring_in_shared(L1, L2, K, R);
  const size_t smem =
      static_cast<size_t>(sa::wfa_fill_smem(L1, L2, K, R, shared));
  int threads = (K + lpt - 1) / lpt;
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const ChunkArgs a{seq1,   seq2,   n1v,     n2v,    codes,
                    {ring_m, ring_i, ring_d}, done,   score,  end_k,
                    hist,   B,      L1,      L2,     K,      R,
                    k_lo,   u0,     n_steps, g,      x_off,  oe_off,
                    e_off,  lead1,  lead2,   trail1, trail2};
  ClockStamps st{};
  st.out = stamps;
  auto kernel = shared ? wfa_chunk_kernel<true, false, ClockStamps>
                       : wfa_chunk_kernel<false, false, ClockStamps>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sa::kWfaSharedMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(a, st);
  return static_cast<int>(cudaGetLastError());
}

// sa_wfa_walk's arguments, then the stamps (6 u64, added to).
extern "C" int st_wfa_walk(const int16_t* hist, int S, int Bh, int K,
                           int k_lo, int g, const int32_t* s0,
                           const int32_t* k0, const int32_t* t0,
                           const int32_t* live, const int32_t* budget, int B,
                           int x_pen, int o_pen, int e_pen, int W,
                           uint32_t* packed, int32_t* n_ops, int32_t* ok,
                           int sms, unsigned long long* stamps,
                           void* stream) {
  CUtensorMap map;
  if (!walk_map(&map, hist, S, Bh, K, K < sa::kWfaWindow ? K
                                                          : sa::kWfaWindow)) {
    return -4;
  }
  const WalkArgs a{hist, s0, k0, t0, live, budget, packed, n_ops, ok,
                   S,    Bh, K,  k_lo, g,  B,      x_pen,  o_pen, e_pen, W};
  int warps = (B + sms - 1) / sms;
  warps = warps > sa::kWfaWalkWarps ? sa::kWfaWalkWarps : warps;
  const size_t smem = static_cast<size_t>(warps) *
                      (kWalkSlotBytes + 8 * sa::kWfaSlots);
  walk_stamped<<<(B + warps - 1) / warps, warps * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(a, map, stamps);
  return static_cast<int>(cudaGetLastError());
}

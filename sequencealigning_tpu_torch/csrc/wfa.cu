// Textbook WFA for Hopper (sm_90a): the wavefront fill and the walk over
// its offset log.
//
// Fill (sa_wfa_chunk): replaces ops/wfa.py::_wfa_chunk_jax, a
// lax.while_loop on the TPU (the JAX package has no Pallas kernel for it),
// and at lattice step u = 0 its seed _wfa_seed2_jax.  It advances
// n_steps lattice steps from u0, writing each step's M/I/D offsets into the
// pair's (R, B, K) int32 rings (kept in device memory between launches, as
// the JAX carry) and into the chunk's (n_steps, 3, B, K) int16 log, which
// the caller fills with NEG: the rows after a pair's convergence stay NEG,
// as the JAX while_loop leaves them.  A pair converges at the first step
// where a lane reaches its end target; its score is u * g and its end
// diagonal the lowest such lane (an atomicMin in shared memory, as the JAX
// argmax takes the first).
//
// Design: a CTA a pair, a thread a diagonal lane (ceil(K / threads) lanes
// a thread past 1024 lanes), one barrier a step (__syncthreads_or, which
// also carries the convergence test): no step reads the ring slot it
// writes, so a step's reads need no barrier of their own.  The pair's two
// code rows are staged in shared memory as bytes at launch (at most 16 kb
// each by the offset log's cap), and the extension compares them directly,
// one thread a diagonal: the TPU engine's (B, K, T) run-length table was a
// layout for its gathers and is not built.  A converged pair's CTA returns
// at once.  What bounds it: the dependent chain of a step (the ring reads,
// the recurrence, a barrier) times the steps, for few pairs a CTA each; the
// extension's byte compares, serial along a diagonal, where long matches
// remain; the log's stores (6 B a lane-step) at many pairs.
//
// Walk (sa_wfa_walk): replaces ops/wfa.py::_wfa_walk_device_jit, a lax.scan
// on the TPU.  A thread a pair follows the JAX state machine (three log
// reads a step, ties mismatch > I > D) and writes one 2-bit op code a
// column in the port's packed walk layout (ops/traceback_device.py), 16 a
// word, a run of 16 matches a word at once; the JAX walk emits run-length
// pairs whose uint16 cast wraps past 65535, which this kernel does not
// copy.  What bounds it: one pair's chain of dependent log reads (a few
// hundred cycles each), about three a mismatch or gap.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "wfa.cuh"

namespace {

struct ChunkArgs {
  const int32_t* seq1;
  const int32_t* seq2;
  const int32_t* n1v;
  const int32_t* n2v;
  int32_t* ring_m;
  int32_t* ring_i;
  int32_t* ring_d;
  int32_t* done;
  int32_t* score;
  int32_t* end_k;
  int16_t* hist;
  int B, L1, L2, K, R, k_lo, u0, n_steps, g, x_off, oe_off, e_off;
  int lead1, lead2, trail1, trail2;
};

__global__ void __launch_bounds__(1024) wfa_chunk_kernel(ChunkArgs a) {
  const int b = blockIdx.x;
  if (a.done[b]) return;
  extern __shared__ int8_t codes[];
  int8_t* s1 = codes;
  int8_t* s2 = codes + a.L1;
  __shared__ int hit_lane;
  const int n1 = a.n1v[b], n2 = a.n2v[b];
  const int32_t* q = a.seq1 + static_cast<int64_t>(b) * a.L1;
  const int32_t* d = a.seq2 + static_cast<int64_t>(b) * a.L2;
  for (int j = threadIdx.x; j < n1; j += blockDim.x) {
    s1[j] = static_cast<int8_t>(q[j]);
  }
  for (int j = threadIdx.x; j < n2; j += blockDim.x) {
    s2[j] = static_cast<int8_t>(d[j]);
  }
  if (threadIdx.x == 0) hit_lane = INT_MAX;
  __syncthreads();
  const sa::WfaRing ring{a.ring_m, a.ring_i, a.ring_d, a.R, a.B, a.K, b};
  for (int i = 0; i < a.n_steps; ++i) {
    const int u = a.u0 + i;
    const int slot = u % a.R;
    bool hit = false;
    for (int lane = threadIdx.x; lane < a.K; lane += blockDim.x) {
      const int32_t k = a.k_lo + lane;
      int32_t m, iv, dv;
      if (u == 0) {
        m = sa::wfa_seed(s1, s2, n1, n2, k, a.lead1, a.lead2);
        iv = dv = sa::kWfaNeg;
      } else {
        sa::wfa_step(ring, lane, k, u, a.x_off, a.oe_off, a.e_off, s1, s2,
                     n1, n2, m, iv, dv);
      }
      const int64_t r = (static_cast<int64_t>(slot) * a.B + b) * a.K + lane;
      a.ring_m[r] = m;
      a.ring_i[r] = iv;
      a.ring_d[r] = dv;
      a.hist[sa::wfa_log_index(i, 0, a.B, b, a.K, lane)] =
          static_cast<int16_t>(m);
      a.hist[sa::wfa_log_index(i, 1, a.B, b, a.K, lane)] =
          static_cast<int16_t>(iv);
      a.hist[sa::wfa_log_index(i, 2, a.B, b, a.K, lane)] =
          static_cast<int16_t>(dv);
      bool mask;
      const int32_t end_t = sa::wfa_end_t(k, n1, n2, a.trail1, a.trail2, mask);
      if (mask && m >= end_t) {
        hit = true;
        atomicMin(&hit_lane, lane);
      }
    }
    if (__syncthreads_or(hit)) {
      if (threadIdx.x == 0) {
        a.done[b] = 1;
        a.score[b] = u * a.g;
        a.end_k[b] = a.k_lo + hit_lane;
      }
      return;
    }
  }
}

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

__global__ void wfa_walk_kernel(WalkArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  a.ok[b] = sa::wfa_walk_pair(
      a.hist, a.S, a.Bh, a.K, b, a.k_lo, a.g, a.s0[b], a.k0[b], a.t0[b],
      a.live[b] != 0, a.budget[b], a.x_pen, a.o_pen, a.e_pen,
      a.packed + static_cast<int64_t>(b) * a.W, &a.n_ops[b]);
}

}  // namespace

// seq1/seq2: (B, L1) / (B, L2) int32 codes; n1v/n2v: (B,) int32 lengths
// (< 2^14, at most L1 / L2); ring_m/i/d: (R, B, K) int32; done, score,
// end_k: (B,) int32, updated in place; hist: (n_steps, 3, B, K) int16,
// filled with NEG by the caller.  x_off/oe_off/e_off: the penalties in
// lattice steps, each in [1, R - 1]; lpt: lanes a thread (K <= 1024 *
// lpt).  Returns the cudaGetLastError() of the launch, or -1
// for an unsupported shape.
extern "C" int sa_wfa_chunk(const int32_t* seq1, const int32_t* seq2,
                            const int32_t* n1v, const int32_t* n2v,
                            int32_t* ring_m, int32_t* ring_i, int32_t* ring_d,
                            int32_t* done, int32_t* score, int32_t* end_k,
                            int16_t* hist, int B, int L1, int L2, int K, int R,
                            int k_lo, int u0, int n_steps, int g, int x_off,
                            int oe_off, int e_off, int lead1, int lead2,
                            int trail1, int trail2, int lpt, void* stream) {
  if (B <= 0 || K <= 0 || n_steps <= 0 || lpt <= 0 || K > 1024 * lpt ||
      L1 + L2 > 2 * (1 << 14) || x_off < 1 || oe_off < 1 || e_off < 1 ||
      x_off >= R || oe_off >= R || e_off >= R) {
    return -1;
  }
  int threads = (K + lpt - 1) / lpt;
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const ChunkArgs a{seq1,  seq2,   n1v,     n2v,     ring_m, ring_i,
                    ring_d, done,  score,   end_k,   hist,   B,
                    L1,    L2,     K,       R,       k_lo,   u0,
                    n_steps, g,    x_off,   oe_off,  e_off,  lead1,
                    lead2, trail1, trail2};
  const size_t smem = static_cast<size_t>(L1) + L2;
  wfa_chunk_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// hist: (S, 3, Bh, K) int16 log; s0/k0/t0/live/budget: (B,) int32 walk
// seeds, B <= Bh; packed: (B, W) u32, zeroed by the caller, 16 * W >= each
// budget; n_ops, ok: (B,) int32 outputs.  Returns the cudaGetLastError()
// of the launch, or -1 for an unsupported shape.
extern "C" int sa_wfa_walk(const int16_t* hist, int S, int Bh, int K,
                           int k_lo, int g, const int32_t* s0,
                           const int32_t* k0, const int32_t* t0,
                           const int32_t* live, const int32_t* budget, int B,
                           int x_pen, int o_pen, int e_pen, int W,
                           uint32_t* packed, int32_t* n_ops, int32_t* ok,
                           void* stream) {
  if (B <= 0 || B > Bh || S <= 0 || K <= 0 || W <= 0 || g <= 0) return -1;
  const WalkArgs a{hist, s0, k0, t0, live, budget, packed, n_ops, ok,
                   S,    Bh, K,  k_lo, g,  B,      x_pen,  o_pen, e_pen, W};
  constexpr int kThreads = 128;
  wfa_walk_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

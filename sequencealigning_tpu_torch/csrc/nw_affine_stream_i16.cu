// Streamed batched Gotoh fill for Hopper (sm_90a) with int16 score state:
// global, semi-global and local modes, two lanes a 32-bit word.
//
// Replaces the int16 state of the TPU kernels
// ops/nw_affine_stream.py::_stream_kernel (gotoh_fill_stream_pallas with
// state_dtype int16; global mode, kernel #1) and
// ops/nw_affine_stream_modes.py::_stream_modes_kernel (gotoh_fill_stream_
// modes_pallas; textbook semi-global and local, kernel #2).  Same contracts
// and layouts as the int32 instances (nw_affine_stream.cu): the finals and
// the modes' running argmax are written as int32, the direction words keep
// their layout, and the results are those of gotoh_fill_stream_lax /
// gotoh_fill_stream_modes_lax with state_dtype int16, which for a
// certified scheme and shape (ops.nw_affine_stream.stream_i16_neg) equal
// the int32 fill's finals and walks.
//
// Design: the int32 instances' warp-ring schedule (stream_ring.cuh) and
// kernel body (stream_ring_kernel.cuh), with each thread's LPT lanes held
// as LPT / 2 words of two int16 lanes (stream_cell16.cuh): H2, H1, M1, I1
// and D1 one register for two lanes, each add-max, max3 and max of the
// recurrence one DPX instruction for both (__viaddmax_s16x2,
// __vimax3_s16x2, and __viaddmax_s16x2_relu for local's clamp at zero), a
// word's left neighbours one PRMT (its own low lane and the previous
// word's high lane), and a thread's hand-over to the next lane -- its last
// lane's H2 and merged D source -- one word, so a step takes two shuffles
// instead of three.  The direction codes are built a word for both lanes:
// each flag an XOR and a VIMNMX.U16x2 (min(a ^ b, 1), no borrow across the
// halves), weighed into both codes by multiply-adds, both lanes' codes
// shifted into one accumulator a pair, which holds half a direction word,
// and split into the lanes' words with two PRMTs once a word.  No flag is
// read from a DPX predicate (ptxas for sm_90a was seen to build a wrong
// half for one and to drop them from another).  The modes' running argmax
// stays int32 a lane.  The sentinel is the kernel argument `neg` (the
// certification's), to which I and D are floored each step.  Lanes a
// thread and threads a block follow the int32 instances' rule
// (stream_ring.cuh::stream_plan, ring_max_regs).
//
// What bounds it on this card: as the int32 instances, the integer ALU
// work of the recurrence and its direction code, then the direction store
// bandwidth; the packed state halves the instructions of the max chains
// and the registers of the scores, and the word-at-a-time codes and
// substitution scores move much of the rest to multiply-adds (the FMA
// pipe); the modes' argmax (int32 a lane) and the step's hand-over,
// shuffles and ring (per thread) remain.  On an H100 at 4096 x 2046 bp
// each instance runs at 21-41% of its packed bound and 11-23% faster than
// its int32 twin (PERF.md, PR 20).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_split.cuh"
#include "nw_affine_stream.cuh"
#include "stream_cell16.cuh"
#include "stream_ring.cuh"
#include "stream_ring_kernel.cuh"

namespace {

template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD>
__global__ void __maxnreg__(sa::ring_max_regs(LPT, MODE != sa::kModeGlobal))
    stream_ring16_kernel(const int32_t* __restrict__ qstream,
                         const int32_t* __restrict__ dstream,
                         const int32_t* __restrict__ dsum,
                         const int32_t* __restrict__ n2s,
                         int32_t* __restrict__ out,
                         uint32_t* __restrict__ dirs, int32_t* status, int R,
                         int T, int P, int S, int NP, sa::Scheme sc,
                         int32_t neg, sa::Split sp, sa::RingShape rg) {
  sa::ring::stream_ring_body<LPT, DIRS, MODE, COMPAT, WILDCARD, true>(
      qstream, dstream, dsum, n2s, out, dirs, status, R, T, P, S, NP, sc,
      neg, sp, rg);
}

template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD>
struct Int16Fill {
  static sa::ring::FillKernel fn() {
    return stream_ring16_kernel<LPT, DIRS, MODE, COMPAT, WILDCARD>;
  }
};

}  // namespace

// sa_stream_fill's arguments and layouts, plus neg: the int16 state's
// sentinel (ops.nw_affine_stream.stream_i16_neg of the scheme and the
// plan; the caller certifies the shape).  Returns as sa_stream_fill.
extern "C" int sa_stream_fill_i16(
    const int32_t* qstream, const int32_t* dstream, const int32_t* dsum,
    const int32_t* n2, int32_t* finals, uint32_t* dirs, int32_t* status,
    int R, int T, int P, int S, int NP, int match, int mismatch, int gap_open,
    int gap_extend, int dirs_mode, int compat, int wildcard, int cta_lanes,
    int lpt, int chunk, int slots, int wrap, int neg, void* stream) {
  return sa::ring::launch_fill<Int16Fill>(
      sa::kModeGlobal, qstream, dstream, dsum, n2, finals, dirs, status, R,
      T, P, S, NP, sa::Scheme{match, mismatch, gap_open, gap_extend}, neg,
      dirs_mode, compat != 0, wildcard != 0, cta_lanes, lpt, chunk, slots,
      wrap, stream);
}

// sa_stream_modes_fill's arguments and layouts, plus neg (as
// sa_stream_fill_i16).  dirs_mode: 0 (none) or 2 (full).
extern "C" int sa_stream_modes_fill_i16(
    const int32_t* qstream, const int32_t* dstream, const int32_t* dsum,
    const int32_t* n2, int32_t* out, uint32_t* dirs, int32_t* status, int R,
    int T, int P, int S, int NP, int match, int mismatch, int gap_open,
    int gap_extend, int dirs_mode, int local, int wildcard, int cta_lanes,
    int lpt, int chunk, int slots, int wrap, int neg, void* stream) {
  if (dirs_mode == sa::kDirsFast4) return -1;
  return sa::ring::launch_fill<Int16Fill>(
      local ? sa::kModeLocal : sa::kModeSemi, qstream, dstream, dsum, n2, out,
      dirs, status, R, T, P, S, NP,
      sa::Scheme{match, mismatch, gap_open, gap_extend}, neg, dirs_mode,
      false, wildcard != 0, cta_lanes, lpt, chunk, slots, wrap, stream);
}

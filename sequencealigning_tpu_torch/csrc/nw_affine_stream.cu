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
// This source holds the int32 instances; the int16 ones are
// nw_affine_stream_i16.cu, and both are the kernel body of
// stream_ring_kernel.cuh.
//
// Design (stream_ring.cuh): one thread block per stream row up to 8192
// lanes, past that one thread-block cluster per row (cluster_split.cuh's
// CTAs of 4096 or 8192 lanes); each thread owns LPT consecutive lanes and
// keeps their scores (H2, H1, M1, I1, D1) in registers and their query and
// db codes packed 4 bits a lane, the lane shift inside a warp is a
// shuffle, and each warp sweeps the row at its own pace: its first lane's
// left neighbour arrives through a ring in shared memory that the warp to
// its left fills, a chunk of steps a slot, with one acquire and one release
// a chunk instead of a block barrier a step.  Lane 0's words wait in a wrap
// ring for lane P-1's D bits (the torus of jnp.roll), added by the thread
// holding lane P-1.  The query code enters at lane 0 and the db code at
// lane p: each warp loads the codes of its own chunks (one a lane), no
// block-wide staging.  A pair's finals are written once, by the thread
// owning lane n2 at step k*S + n1 + n2; direction codes are shifted into a
// register a lane (one funnel shift) and stored as one coalesced u32 per
// lane every 8 (fast4) or 4 (full) steps.  The cluster instances are the
// same kernel: the ring of a CTA's first warp and the wrap ring live in
// distributed shared memory, the counters acquired and released at the
// cluster scope.  A wait that stalls sets the launch's status word and the
// wrapper raises.
//
// The cell (nw_affine_stream.cuh::ring_cell) writes each max with its
// compare (__vibmax_s32, which ptxas lowers to a compare and a select: the
// DPX forms save no instruction here), and only the thread holding lane 0
// and the warp holding lane p (p = t mod S) run boundary code.  The modes'
// running argmax: lane x holds the younger pair (slot t / S) from step
// p == x of its slot and the older one before; at p == x it writes its
// older pair's argmax to bv/bd[slot, row, x] and sets the window of steps
// in which the younger pair's cells are eligible, so each step costs one
// range test and one max a lane.
//
// What bounds it on this card: the integer ALU work of the recurrence and
// its direction code (compares and selects, the ALU pipe's 64 lanes a SM a
// clock), then the direction store bandwidth, 0.5 B a cell in fast4 and
// 1 B in full.  The block shape is fitted to the register file
// (stream_ring.cuh): the global fill two 256-thread blocks a SM at 8 lanes
// a thread and 128 registers, the modes one 544-thread block (a 2176-lane
// row) at 4 lanes a thread and 96 registers; two steps an iteration (not
// local's) so the scores' registers trade roles instead of being copied.
// The TPU kernel's masked lane-reduce gather of the codes and its
// sequential (rows, slots, chunks) grid have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_split.cuh"
#include "nw_affine_stream.cuh"
#include "stream_ring.cuh"
#include "stream_ring_kernel.cuh"

namespace {

template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD>
__global__ void __maxnreg__(sa::ring_max_regs(LPT, MODE != sa::kModeGlobal))
    stream_ring_kernel(const int32_t* __restrict__ qstream,
                       const int32_t* __restrict__ dstream,
                       const int32_t* __restrict__ dsum,
                       const int32_t* __restrict__ n2s,
                       int32_t* __restrict__ out,
                       uint32_t* __restrict__ dirs, int32_t* status, int R,
                       int T, int P, int S, int NP, sa::Scheme sc,
                       int32_t neg, sa::Split sp, sa::RingShape rg) {
  sa::ring::stream_ring_body<LPT, DIRS, MODE, COMPAT, WILDCARD, false>(
      qstream, dstream, dsum, n2s, out, dirs, status, R, T, P, S, NP, sc,
      neg, sp, rg);
}

template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD>
struct Int32Fill {
  static sa::ring::FillKernel fn() {
    return stream_ring_kernel<LPT, DIRS, MODE, COMPAT, WILDCARD>;
  }
};

int launch(int mode, const int32_t* qstream, const int32_t* dstream,
           const int32_t* dsum, const int32_t* n2, int32_t* out,
           uint32_t* dirs, int32_t* status, int R, int T, int P, int S,
           int NP, int match, int mismatch, int gap_open, int gap_extend,
           int dirs_mode, bool compat, bool wildcard, int cta_lanes, int lpt,
           int chunk, int slots, int wrap, void* stream) {
  return sa::ring::launch_fill<Int32Fill>(
      mode, qstream, dstream, dsum, n2, out, dirs, status, R, T, P, S, NP,
      sa::Scheme{match, mismatch, gap_open, gap_extend}, sa::kNegInf,
      dirs_mode, compat, wildcard, cta_lanes, lpt, chunk, slots, wrap,
      stream);
}

}  // namespace

// CTAs a row of P lanes takes (cluster_split.cuh::plan_split; cta_lanes 0
// for the automatic split), 0 if P or cta_lanes is out of range.
extern "C" int sa_fill_ctas(int P, int cta_lanes) {
  return sa::plan_split(P, cta_lanes).nctas;
}

// The streamed fills' launch shape (stream_ring.cuh::stream_plan and
// ring_shape; 0 takes the default): shape[0..5] = lanes a thread, threads a
// CTA, CTAs a row, chunk steps, slots, wrap words.  Returns 0, or -1 when
// out of range.
extern "C" int sa_stream_plan(int P, int cta_lanes, int modes, int lpt,
                              int chunk, int slots, int wrap, int* shape) {
  return sa::stream_launch_shape(P, cta_lanes, modes != 0, lpt, chunk, slots,
                                 wrap, shape);
}

// qstream/dstream: (R, T) int32 codes; dsum/n2: (NP, R) int32; finals:
// (R*NP, 3) int32, pair b = row b / NP, slot b % NP; dirs: (T/8, R, P) u32
// for fast4, (T/4, R, P) for full, unused for none; status: one int32,
// zeroed, set when a wait stalls.  cta_lanes: 0, or the forced CTA width
// of the split; lpt: 0, or the forced lanes a thread (2, 4, 8, 16); chunk,
// slots, wrap: the rings (stream_ring.cuh::ring_shape, 0 the default).
// Returns the cudaGetLastError() of the launch, -1 for an unsupported shape
// or mode, -3 for a cluster the card cannot schedule.
extern "C" int sa_stream_fill(const int32_t* qstream, const int32_t* dstream,
                              const int32_t* dsum, const int32_t* n2,
                              int32_t* finals, uint32_t* dirs,
                              int32_t* status, int R, int T, int P, int S,
                              int NP, int match, int mismatch, int gap_open,
                              int gap_extend, int dirs_mode, int compat,
                              int wildcard, int cta_lanes, int lpt, int chunk,
                              int slots, int wrap, void* stream) {
  return launch(sa::kModeGlobal, qstream, dstream, dsum, n2, finals, dirs,
                status, R, T, P, S, NP, match, mismatch, gap_open,
                gap_extend, dirs_mode, compat != 0, wildcard != 0, cta_lanes,
                lpt, chunk, slots, wrap, stream);
}

// The textbook modes (local != 0: local, else semi-global), same layout but
// out: bv then bd, each (NP, R, P) int32, pre-filled with (NEGBIG, 0): the
// kernel writes lanes below S only.  dirs_mode: 0 (none) or 2 (full).
extern "C" int sa_stream_modes_fill(
    const int32_t* qstream, const int32_t* dstream, const int32_t* dsum,
    const int32_t* n2, int32_t* out, uint32_t* dirs, int32_t* status, int R,
    int T, int P, int S, int NP, int match, int mismatch, int gap_open,
    int gap_extend, int dirs_mode, int local, int wildcard, int cta_lanes,
    int lpt, int chunk, int slots, int wrap, void* stream) {
  if (dirs_mode == sa::kDirsFast4) return -1;
  return launch(local ? sa::kModeLocal : sa::kModeSemi, qstream, dstream,
                dsum, n2, out, dirs, status, R, T, P, S, NP, match, mismatch,
                gap_open, gap_extend, dirs_mode, false, wildcard != 0,
                cta_lanes, lpt, chunk, slots, wrap, stream);
}

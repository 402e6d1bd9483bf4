// Per-pair semi-global and local Gotoh fill for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/nw_affine_modes.py::_modes_kernel (launched by
// modes_fill_pallas).  Same contract as _fill_modes_lax: each pair sweeps its
// D_total = L1 + L2 + 1 anti-diagonals with its db preloaded on P lanes
// (s2v[b, 1..L2]); lane 0 and lane d are the free-end-gap boundaries, local
// mode clamps M at 0 and marks restarts LSTART.  Each lane keeps a running
// argmax (best score, its diagonal) over the mode's eligible cells; the
// kernel writes the (B, P) per-lane buffers and the full direction bytes,
// byte d & 3 of word dirs[d >> 2, b, x], in ceil(D_total / 4) words.
//
// Design: the per-pair warp-ring sweep of pair_sweep.cuh (a pair's lanes
// over a cluster of a few CTAs, stream_ring.cuh::pair_plan: about SMs / B
// CTAs a pair, so the small batches this kernel serves fill the card; each
// warp at its own pace over only its own cells' steps, from the state the
// skipped triangle above the matrix leaves its lanes in), with the cell
// policy GotohCells in the semi-global or local mode: stream_cell with
// modes_update, each lane in increasing y, so the earliest diagonal wins.
// Every byte of a cell outside the pair's matrix is written 0, and so are
// lane 0's D bits (the plain version takes them from lane P-1 through the
// torus roll; no walker reads them): every dirs word is written.  A wait
// that stalls sets the launch's status word and the wrapper raises.
//
// What bounds it on this card: the serial chain of a pair's D_total steps,
// each a warp's step of LPT cells (its compares and selects); the skipped
// triangles halve the lane-steps of the old one-block-a-pair kernel, and the
// split puts a small batch on most of the SMs instead of one a pair.  The
// TPU kernel's (batch tiles, diagonal chunks) grid and its masked
// lane-reduce gather of the query column have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_sweep.cuh"

namespace {

template <int DIRS>
int launch_mode(const sa::PairArgs& a, const sa::Split& sp,
                const sa::RingShape& rg, bool local, bool wildcard,
                void* stream) {
  using sa::GotohCells;
  using sa::launch_pair_sweep;
  if (local) {
    return wildcard ? launch_pair_sweep<
                          GotohCells<DIRS, sa::kModeLocal, false, true>>(
                          a, sp, rg, stream)
                    : launch_pair_sweep<
                          GotohCells<DIRS, sa::kModeLocal, false, false>>(
                          a, sp, rg, stream);
  }
  return wildcard ? launch_pair_sweep<
                        GotohCells<DIRS, sa::kModeSemi, false, true>>(
                        a, sp, rg, stream)
                  : launch_pair_sweep<
                        GotohCells<DIRS, sa::kModeSemi, false, false>>(
                        a, sp, rg, stream);
}

}  // namespace

// The current device's SMs (nw_banded_diag.cu).
extern "C" int sa_sm_count();

// The per-pair fills' launch shape for B pairs of P lanes on the current
// device (stream_ring.cuh::pair_launch_shape; 0 takes the default):
// shape[0..4] = lanes a thread, threads a CTA, CTAs a pair, chunk steps,
// slots.  Returns 0, or -1 when out of range.
extern "C" int sa_pair_plan(int P, int B, int cta_lanes, int lpt, int chunk,
                            int slots, int* shape) {
  return sa::pair_launch_shape(P, B, sa_sm_count(), cta_lanes, lpt, chunk,
                               slots, shape);
}

// query: (B, L1) int32 codes; s2v: (B, P) int32 (db at lanes 1..L2); n1/n2:
// (B,) int32 lengths; out: bv then bd, each (B, P) int32; dirs:
// (ceil(D_total/4), B, P) u32 full bytes, unused for dirs_mode 0.  dirs_mode:
// 0 (none) or 2 (full); local != 0: local, else semi-global; cta_lanes: 0,
// or the forced CTA width of the split; status: one int32, zeroed, set when
// a wait stalls; lpt, chunk, slots: 0, or the forced lanes a thread and
// rings (stream_ring.cuh::pair_plan, ring_shape).  Returns the
// cudaGetLastError() of the launch, -1 for an unsupported shape or mode, -3
// for a cluster the card cannot schedule.
extern "C" int sa_modes_fill(const int32_t* query, const int32_t* s2v,
                             const int32_t* n1, const int32_t* n2,
                             int32_t* out, uint32_t* dirs, int B, int L1,
                             int P, int D_total, int match, int mismatch,
                             int gap_open, int gap_extend, int dirs_mode,
                             int local, int wildcard, int cta_lanes,
                             int32_t* status, int lpt, int chunk, int slots,
                             void* stream) {
  const sa::Split sp = sa::pair_plan(P, B, sa_sm_count(), cta_lanes, lpt);
  const sa::RingShape rg = sa::ring_shape(chunk, slots, 0, true);
  if (sp.nctas == 0 || B <= 0 || L1 <= 0 || D_total <= 0 ||
      status == nullptr || !sa::ring_ok(rg)) {
    return -1;
  }
  const sa::PairArgs a{query, s2v, n1,     n2, nullptr, out, nullptr,
                       dirs,  status, B, L1, P,       D_total,
                       {match, mismatch, gap_open, gap_extend}};
  switch (dirs_mode) {
    case sa::kDirsNone:
      return launch_mode<sa::kDirsNone>(a, sp, rg, local != 0, wildcard != 0,
                                        stream);
    case sa::kDirsFull:
      return launch_mode<sa::kDirsFull>(a, sp, rg, local != 0, wildcard != 0,
                                        stream);
    default:
      return -1;
  }
}

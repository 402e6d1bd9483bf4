// Per-pair global Gotoh fill for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/nw_affine.py::_gotoh_kernel (launched by
// gotoh_fill_pallas).  Same contract as _gotoh_fill_lax on every cell of
// each pair's matrix: each pair sweeps the anti-diagonals of its matrix with
// its db preloaded on P lanes (s2v[b, 1..L2]); lane 0 and lane d are the
// boundaries, whose compat or textbook gap chains the global mode of
// stream_cell writes.  Each pair's corner finals are M/I/D at lane n2 on
// diagonal n1 + n2 (the lax twin sums them over the lanes of n2mask on
// diagonal dsum: one lane, n2, in every layout the callers build; the
// wrapper passes n2 and n1 = dsum - n2).  Optional full direction bytes,
// byte d & 3 of word dirs[d >> 2, b, x], in ceil(D_total / 4) words (the lax
// twin's length; the TPU kernel pads to whole 64-diagonal chunks).
//
// Design: the per-pair warp-ring sweep of pair_sweep.cuh (a pair's lanes
// over a cluster of CTAs sized to the batch, stream_ring.cuh::pair_plan;
// each warp at its own pace over only its own cells' steps, no block
// barrier a diagonal, its lanes starting from the state the skipped
// triangle above the matrix leaves them in), with the cell policy
// GotohCells in global mode: stream_cell<DIRS, kModeGlobal, COMPAT,
// WILDCARD>, and a corner capture instead of the modes' argmax (the thread
// holding lane n2 stores its M/I/D after its warp's last step, n1 + n2).
// Every byte of a cell outside the pair's matrix is written 0, and so are
// lane 0's D bits (the plain version takes them from lane P-1 through the
// torus roll; no walker reads them).  A wait that stalls sets the launch's
// status word and the wrapper raises.
//
// What bounds it on this card: the integer work of the recurrence (10
// operations a true cell score-only, 26 with the full codes) over the
// lane-steps of each pair's matrix plus a warp's width of each triangle,
// and the serial chain of a pair's steps, which the split spreads over a
// small batch's SMs.  The direction stores (1 B a lane-step) are a few
// percent of HBM time.  The TPU kernel's (batch tiles, diagonal chunks)
// grid, its gated capture and its masked lane-reduce gather of the query
// column have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_sweep.cuh"

namespace {

template <int DIRS, bool COMPAT>
int launch_flags(const sa::PairArgs& a, const sa::Split& sp,
                 const sa::RingShape& rg, bool wildcard, void* stream) {
  using sa::GotohCells;
  using sa::launch_pair_sweep;
  return wildcard ? launch_pair_sweep<
                        GotohCells<DIRS, sa::kModeGlobal, COMPAT, true>>(
                        a, sp, rg, stream)
                  : launch_pair_sweep<
                        GotohCells<DIRS, sa::kModeGlobal, COMPAT, false>>(
                        a, sp, rg, stream);
}

// The two dirs modes of the TPU kernel: score-only and full 7-bit bytes.
template <int DIRS>
int launch_dirs(const sa::PairArgs& a, const sa::Split& sp,
                const sa::RingShape& rg, bool compat, bool wildcard,
                void* stream) {
  return compat ? launch_flags<DIRS, true>(a, sp, rg, wildcard, stream)
                : launch_flags<DIRS, false>(a, sp, rg, wildcard, stream);
}

}  // namespace

// The current device's SMs (nw_banded_diag.cu).
extern "C" int sa_sm_count();

// query: (B, L1p) int32 codes; s2v: (B, P) int32 (db at lanes 1..L2);
// n1/n2: (B,) int32, the corner (lane n2, row n1; n2 = -1: no pair); finals:
// (B, 3) int32, zeroed by the caller; dirs: (ceil(D_total/4), B, P) u32 full
// bytes, unused for dirs_mode 0.  dirs_mode: 0 (none) or 2 (full);
// cta_lanes: 0, or the forced CTA width of the split; status: one int32,
// zeroed, set when a wait stalls; lpt, chunk, slots: 0, or the forced lanes
// a thread and rings (stream_ring.cuh::pair_plan, ring_shape).  Returns the
// cudaGetLastError() of the launch, -1 for an unsupported shape or mode, -3
// for a cluster the card cannot schedule.
extern "C" int sa_gotoh_fill(const int32_t* query, const int32_t* s2v,
                             const int32_t* n1, const int32_t* n2,
                             int32_t* finals, uint32_t* dirs, int B, int L1p,
                             int P, int D_total, int match, int mismatch,
                             int gap_open, int gap_extend, int dirs_mode,
                             int compat, int wildcard, int cta_lanes,
                             int32_t* status, int lpt, int chunk, int slots,
                             void* stream) {
  const sa::Split sp = sa::pair_plan(P, B, sa_sm_count(), cta_lanes, lpt);
  const sa::RingShape rg = sa::ring_shape(chunk, slots, 0, true);
  if (sp.nctas == 0 || B <= 0 || L1p <= 0 || D_total <= 0 ||
      status == nullptr || !sa::ring_ok(rg)) {
    return -1;
  }
  const sa::PairArgs a{query,  s2v, n1,  n2, nullptr, finals, nullptr,
                       dirs,   status, B, L1p, P,     D_total,
                       {match, mismatch, gap_open, gap_extend}};
  const bool c = compat != 0, w = wildcard != 0;
  switch (dirs_mode) {
    case sa::kDirsNone:
      return launch_dirs<sa::kDirsNone>(a, sp, rg, c, w, stream);
    case sa::kDirsFull:
      return launch_dirs<sa::kDirsFull>(a, sp, rg, c, w, stream);
    default:
      return -1;
  }
}

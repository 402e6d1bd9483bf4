// Per-pair linear-gap NW fill for Hopper (sm_90a).
//
// Replaces ops/nw_linear.py::_linear_fill_lax, a lax.scan on the TPU (the
// JAX package has no Pallas kernel for it).  Same contract on every cell of
// each pair's matrix: each pair sweeps the anti-diagonals of its matrix with
// its db preloaded on P lanes (s2v[b, 1..L2]), lane x of diagonal d being
// cell (x, d - x); lanes 0 and d are the boundaries.  Outputs per pair: the
// corner score (the score at lane n2 on diagonal n1 + n2, stored into the
// caller-zeroed corner[b]) and the maximum over the pair's valid cells
// (atomicMax into runmax[b], which the caller fills with NEGBIG), plus on
// request the 4 path bits of each cell (nw_linear.cuh), byte d & 3 of word
// dirs[d >> 2, b, x], in ceil(D_total / 4) words.  Local mode is two
// launches, as in the JAX package: the first (no dirs) gives each pair's
// maximum, which the second reads as maxv to set the ISMAX bits.
//
// Design: the per-pair warp-ring sweep of pair_sweep.cuh (a pair's lanes
// over a cluster of CTAs sized to the batch, stream_ring.cuh::pair_plan, up
// to 16 CTAs of 8192 lanes; each warp at its own pace over only its own
// cells' steps, no block barrier a diagonal), with the cell policy
// LinearCells: nw_linear.cuh::linear_cell, the ring entry carrying the left
// lane's score two and one diagonals back and its query code with its gap
// flag packed into one word, the lanes' running maxima reduced in each warp
// at the end, one atomicMax a warp.  Every byte of a cell outside the
// pair's matrix is written 0 (the plain version writes the bits it computes
// there; no walker reads them).  A wait that stalls sets the launch's
// status word and the wrapper raises.
//
// What bounds it on this card: the integer work of the recurrence (~14
// operations a cell, ~22 with its bits) over the lane-steps of each pair's
// matrix plus a warp's width of each triangle, and the serial chain of a
// pair's steps, which the split spreads over a small batch's SMs.  The byte
// stores (1 B a lane-step) are a few percent of HBM time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_sweep.cuh"

namespace {

template <bool DIRS>
int launch_mode(const sa::PairArgs& a, const sa::Split& sp,
                const sa::RingShape& rg, bool compat, bool local,
                void* stream) {
  using sa::LinearCells;
  using sa::launch_pair_sweep;
  if (local) {
    return compat ? launch_pair_sweep<LinearCells<DIRS, true, true>>(
                        a, sp, rg, stream)
                  : launch_pair_sweep<LinearCells<DIRS, false, true>>(
                        a, sp, rg, stream);
  }
  return compat ? launch_pair_sweep<LinearCells<DIRS, true, false>>(
                      a, sp, rg, stream)
                : launch_pair_sweep<LinearCells<DIRS, false, false>>(
                      a, sp, rg, stream);
}

}  // namespace

// The current device's SMs (nw_banded_diag.cu).
extern "C" int sa_sm_count();

// query: (B, L1p) int32 codes; s2v: (B, P) int32 (db at lanes 1..L2);
// n1v/n2v: (B,) int32 lengths; maxv: (B,) int32 (pass 1's maxima for local
// with dirs, else unused); corner: (B,) int32, zeroed; runmax: (B,) int32,
// filled with -2^30; dirs: (ceil(D_total/4), B, P) u32, unused without
// dirs.  cta_lanes: 0, or the forced CTA width of the split; status: one
// int32, zeroed, set when a wait stalls; lpt, chunk, slots: 0, or the
// forced lanes a thread and rings (stream_ring.cuh::pair_plan, ring_shape).
// Returns the cudaGetLastError() of the launch, -1 for an unsupported
// shape, -3 for a cluster the card cannot schedule.
extern "C" int sa_linear_fill(const int32_t* query, const int32_t* s2v,
                              const int32_t* n1v, const int32_t* n2v,
                              const int32_t* maxv, int32_t* corner,
                              int32_t* runmax, uint32_t* dirs, int B, int L1p,
                              int P, int D_total, int match, int mismatch,
                              int gap_open, int gap_extend, int with_dirs,
                              int compat, int local, int cta_lanes,
                              int32_t* status, int lpt, int chunk, int slots,
                              void* stream) {
  const sa::Split sp = sa::pair_plan(P, B, sa_sm_count(), cta_lanes, lpt);
  const sa::RingShape rg = sa::ring_shape(chunk, slots, 0, true);
  if (sp.nctas == 0 || B <= 0 || L1p <= 0 || D_total <= 0 ||
      status == nullptr || !sa::ring_ok(rg)) {
    return -1;
  }
  const sa::PairArgs a{query, s2v,    n1v, n2v, maxv, corner, runmax,
                       dirs,  status, B,   L1p, P,    D_total,
                       {match, mismatch, gap_open, gap_extend}};
  const bool c = compat != 0, l = local != 0;
  return with_dirs ? launch_mode<true>(a, sp, rg, c, l, stream)
                   : launch_mode<false>(a, sp, rg, c, l, stream);
}

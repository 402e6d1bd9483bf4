// Myers-Miller score rows for Hopper (sm_90a).
//
// Replaces the TPU loop sequencealigning_tpu/ops/mm_align.py::_rows_fn (a
// lax.fori_loop, a row a step, the in-row E chain a cummax).  Same contract
// as its torch twin ops/mm_align.py::rows_torch: after m query rows from
// row 0 (CC = o + j*e, 0 at column 0; DD = NEG), the H and I rows (CC, DD)
// of a subproblem addressed by offsets into the whole padded sequences, for
// columns 0 .. n.  One launch computes a whole level of the Myers-Miller
// recursion: both sweeps of every node of the level (the forward rows of
// its top half and the reverse rows of its bottom half), from a node table
// whose plan mm_rows.cuh lays out.  The per-lane arithmetic and the step
// are mm_rows.cuh.
//
// What bounds it on this card: the rows' dependency chain and the integer
// work.  Row i needs row i-1 in full, and inside a row the E chain runs
// across every column; ~11 operations a cell.
//
// Design: a wavefront inside each strip, strips pipelined.  A sweep's
// columns are cut into strips of 32 x LPT lanes (LPT = 16 lanes a thread,
// mm_rows.cuh's kMmLanesPerThread, in registers), one warp a strip.  At step
// g thread t computes row g - t: its left neighbour computed, on its
// previous steps, E at the thread's first lane on that row and CC at the
// lane left of it on the row before, and the row's query code; they come
// over one shuffle each, and the thread's lanes then take one add-max a
// lane for the E chain.  No scan, no broadcast of a row's values, no
// barrier.  The strip's first thread takes those values from strip s-1:
// its last thread stores each row's CC and E, each in a 64-bit word with
// the row's tag (mm_rows.cuh), into a hand-over column zeroed before the
// launch, and the consumer's warp loads the words it needs kMmAhead steps
// ahead (every lane the same address, one request) and checks the tags at
// the step that needs them, reloading until they hold (spin limit: the
// launch's status word is set and the wrapper raises).  No fence and no
// counter: strip s runs ~45 steps behind strip s-1 (the wavefront's 31
// plus the stores' and loads' latency), and a level's rows spread over as
// many SMs as its nodes' widths allow.  The columns are kept whole (16
// bytes a row), so a producer never waits.  Strips are handed out by a
// global atomic ticket over a grid of at most kMmWarpsPerSm warps an SM,
// node by node, strip s of a sweep after strip s-1, so a warp only ever
// waits on a strip a running warp holds.  Steps come kMmAhead at a time
// (the loads' ring), without the row guards once every thread is inside
// the sweep's rows.  Columns past n in a node's last strip are computed
// with a pad code and never written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_rows.cuh"
#include "nw_affine_tiled.cuh"

namespace {

constexpr int kMmThreads = 128;  // 4 warps a block, each on its own strips
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v));
}

// One warp's strip: its lanes, what each thread hands its right neighbour,
// and the ring of the first thread's loads (a slot a step, kMmAhead steps
// ahead).
template <int LPT>
struct MmWarp {
  int32_t CC[LPT], DD[LPT], dc[LPT];
  int32_t cc_out, e_out, qc, cc_prev;
  int32_t rq[sa::kMmAhead];
  uint64_t ra[sa::kMmAhead], rb[sa::kMmAhead];
};

// Slot u's loads for step g: the query code of row g and, from the left
// strip's column, row g-1's CC and row g's E (rows clamped into the sweep:
// a slot past it is never read).
template <int LPT>
__device__ __forceinline__ void mm_fetch(MmWarp<LPT>& st, int u,
                                         const sa::MmSweep& w,
                                         const uint64_t* left, int g) {
  const int r = max(1, min(g, w.m));
  st.rq[u] = w.q[w.q_off + r - 1];
  if (left != nullptr) {
    st.ra[u] = ld_relaxed(left + 2 * (r - 1));
    st.rb[u] = ld_relaxed(left + 2 * r + 1);
  }
}

// kMmAhead steps from g0 (g0 - 1 a multiple of kMmAhead, so slot u is step
// g0 + u's).  GUARD: some thread is outside the sweep's rows (the
// wavefront's first and last 31 steps).  False when a hand-over stalled.
template <int LPT, bool GUARD>
__device__ __forceinline__ bool mm_steps(MmWarp<LPT>& st,
                                         const sa::MmStrip& sp,
                                         uint64_t* my, const uint64_t* left,
                                         int g0, int lane,
                                         const sa::Scheme& sc,
                                         int32_t* status) {
  const sa::MmSweep& w = sp.w;
#pragma unroll
  for (int u = 0; u < sa::kMmAhead; ++u) {
    const int g = g0 + u;
    if (GUARD && g > w.m + 31) break;
    const bool take = left != nullptr && (!GUARD || g <= w.m);
    bool bad = take && (!sa::mm_holds(st.ra[u], g - 1) ||
                        !sa::mm_holds(st.rb[u], g));
    // A row the left strip has not stored yet: reload until it holds.
    unsigned spins = 0;
    while (__any_sync(kFull, bad)) {
      if (*reinterpret_cast<volatile int32_t*>(status) != 0 ||
          ++spins > sa::kSpinLimit) {
        atomicCAS(status, 0, sa::kErrStalled);
        return false;
      }
      st.ra[u] = ld_relaxed(left + 2 * (g - 1));
      st.rb[u] = ld_relaxed(left + 2 * g + 1);
      bad = !sa::mm_holds(st.ra[u], g - 1) || !sa::mm_holds(st.rb[u], g);
    }
    const int32_t q0 = st.rq[u];
    const int32_t x = take ? sa::mm_value(st.rb[u]) : sa::kNegInf;
    const int32_t c = take ? sa::mm_value(st.ra[u]) : 0;
    mm_fetch(st, u, w, left, g + sa::kMmAhead);
    int32_t e_in = __shfl_up_sync(kFull, st.e_out, 1);
    const int32_t cc_in = __shfl_up_sync(kFull, st.cc_out, 1);
    const int32_t q_in = __shfl_up_sync(kFull, st.qc, 1);
    int32_t cc_left = st.cc_prev;
    st.cc_prev = cc_in;
    st.qc = lane == 0 ? q0 : q_in;
    if (lane == 0) {
      e_in = x;
      cc_left = c;
    }
    const int i = sa::mm_row_at(g, lane);
    if (!GUARD || (i >= 1 && i <= w.m)) {
      st.e_out = sa::mm_step<LPT>(st.CC, st.DD, st.dc, st.qc, cc_left, e_in,
                                  sp.strip == 0 && lane == 0,
                                  w.tb + i * sc.gap_extend, sc);
      st.cc_out = st.CC[LPT - 1];
      if (lane == 31) {
        st_relaxed(my + 2 * i, sa::mm_pack(st.cc_out, i));
        st_relaxed(my + 2 * i + 1, sa::mm_pack(st.e_out, i));
      }
    }
  }
  return true;
}

// ctr: [0] the ticket, [1] the status word.  bnd: the hand-over columns,
// zeroed.  out: a node's CC, DD (sweep 0), CC, DD (sweep 1) from its
// kMmOut0.
template <int LPT>
__global__ void __launch_bounds__(kMmThreads)
    mm_rows_kernel(const int32_t* __restrict__ qf,
                   const int32_t* __restrict__ qr,
                   const int32_t* __restrict__ df,
                   const int32_t* __restrict__ dr,
                   const int64_t* __restrict__ table, int count, int tickets,
                   sa::Scheme sc, int32_t* __restrict__ out,
                   uint64_t* __restrict__ bnd, int32_t* ctr) {
  constexpr int W = sa::kMmWarpLanes * LPT;
  const int lane = threadIdx.x & 31;
  int32_t* status = ctr + 1;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(ctr, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= tickets) return;
    const sa::MmStrip sp = sa::mm_strip_at(table, count, t, qf, qr, df, dr);
    const int jf = sp.strip * W + lane * LPT;
    MmWarp<LPT> st;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      st.CC[k] = sa::mm_cc0(jf + k, sc);
      st.DD[k] = sa::kNegInf;
      st.dc[k] = sa::mm_dcode(sp.w, jf + k, sp.n);
    }
    uint64_t* my = bnd + sp.my;
    const uint64_t* left = sp.left >= 0 ? bnd + sp.left : nullptr;
    if (lane == 31) st_relaxed(my, sa::mm_pack(st.CC[LPT - 1], 0));
    st.cc_out = st.CC[LPT - 1];
    st.e_out = sa::kNegInf;
    st.qc = 0;
    st.cc_prev = 0;
#pragma unroll
    for (int u = 0; u < sa::kMmAhead; ++u) {
      mm_fetch(st, u, sp.w, left, 1 + u);
    }
    bool ok = true;
    for (int g0 = 1; ok && g0 <= sp.w.m + 31; g0 += sa::kMmAhead) {
      if (g0 > 31 && g0 + sa::kMmAhead - 1 <= sp.w.m) {
        ok = mm_steps<LPT, false>(st, sp, my, left, g0, lane, sc, status);
      } else {
        ok = mm_steps<LPT, true>(st, sp, my, left, g0, lane, sc, status);
      }
    }
    if (!ok) return;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = jf + k;
      if (j <= sp.n) {
        out[sp.out + j] = st.CC[k];
        out[sp.out + sp.n + 1 + j] = st.DD[k];
      }
    }
  }
}

}  // namespace

extern "C" int sa_sm_count();

// The node table's columns (mm_rows.cuh's mm_table_cols), six int64.
extern "C" void sa_mm_table_cols(int64_t* cols) { sa::mm_table_cols(cols); }

// A level's plan: table (count x kMmCols int64, host memory) gets its plan
// columns at the kernel's lanes a thread, words the int32 words of ctr,
// bnd and out and the tickets (mm_plan_level).  Returns the lanes a
// thread, -1 for an unsupported shape.
extern "C" int sa_mm_rows_plan(int64_t* table, int count, int64_t* words) {
  if (count <= 0) return -1;
  return sa::mm_plan_level(table, count, sa::kMmLanesPerThread, words)
             ? sa::kMmLanesPerThread
             : -1;
}

// Both sweeps of every node of a level.  qf/df, qr/dr: the forward and
// reversed padded sequences (int32 codes; d left-padded by one).  table:
// the planned node table on the device; lpt and tickets as the plan gave
// them.  out, bnd, ctr: int32 of the plan's sizes, bnd and ctr zeroed but
// for the first ticket in ctr[0] (0; 2 leaves the first node's strips 0
// unrun, a schedule that cannot be met, for tests).  Returns the
// cudaGetLastError() of the launch, -1 for an unsupported shape.  A
// stalled hand-over sets ctr[1] (the wrapper raises).
extern "C" int sa_mm_rows(const int32_t* qf, const int32_t* qr,
                          const int32_t* df, const int32_t* dr,
                          const int64_t* table, int count, int lpt,
                          int tickets, int32_t* out, int32_t* bnd,
                          int32_t* ctr, int match, int mismatch, int gap_open,
                          int gap_extend, void* stream) {
  const int sms = sa_sm_count();
  if (sms <= 0 || lpt != sa::kMmLanesPerThread || count <= 0 ||
      tickets <= 0) {
    return -1;
  }
  const int warps_cap = sa::kMmWarpsPerSm * sms;
  const int warps = tickets < warps_cap ? tickets : warps_cap;
  const int blocks = (warps * 32 + kMmThreads - 1) / kMmThreads;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  uint64_t* b64 = reinterpret_cast<uint64_t*>(bnd);
  void* args[] = {&qf, &qr, &df, &dr, &table, &count, &tickets,
                  &sc, &out, &b64, &ctr};
  cudaLaunchKernel(
      reinterpret_cast<const void*>(mm_rows_kernel<sa::kMmLanesPerThread>),
      dim3(blocks), dim3(kMmThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

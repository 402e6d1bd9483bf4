// Myers-Miller score rows for Hopper (sm_90a).
//
// Replaces the TPU loop sequencealigning_tpu/ops/mm_align.py::_rows_fn (a
// lax.fori_loop, a row a step, the in-row E chain a cummax).  Same contract
// as its torch twin ops/mm_align.py::rows_torch: after m query rows from
// row 0 (CC = o + j*e, 0 at column 0; DD = NEG), the H and I rows (CC, DD)
// of a subproblem addressed by offsets into the whole padded sequences, for
// columns 0 .. n.  One launch computes both sweeps of a Myers-Miller node:
// the forward rows of its top half and the reverse rows of its bottom half.
// The per-lane arithmetic is mm_rows.cuh.
//
// What bounds it on this card: the rows' dependency chain.  Row i needs
// row i-1 in full, and inside a row the E chain runs across every column,
// so a sweep is m rows in sequence; the integer work (~12 operations a
// cell) is small beside the latency of a row at the widths a node has.
//
// Design: a strip pipeline.  A sweep's columns are cut into strips of
// 32 x LPT lanes (LPT = 4, 8 or 16 lanes a thread, in registers), one warp
// a strip.  A warp sweeps its strip row after row with no barrier: the
// previous row's CC at a thread's first lane comes from its left neighbour
// by a shuffle, the E chain is a 5-step shuffle max-scan over the threads'
// keys (mm_rows.cuh).  Strip s takes from strip s-1, for each row i, the
// CC of its last lane on row i-1 and E at its own first lane on row i
// (the hand-over column in global memory, written by the left strip's last
// thread); rows are handed over 32 at a time: the producer publishes its
// row count with a release store after every 32 rows, the consumer waits
// for it with acquire loads (spin limit: the launch's status word is set
// and the wrapper raises) and reads the 32 rows' pairs with one
// L1-bypassing load a lane.  So strip s runs about 32 rows behind strip
// s-1 and a node's rows spread over as many SMs as its width allows.  The
// columns are kept whole (8 bytes a row a strip), so a producer never
// waits.  Strips are handed out by a global atomic ticket over a grid of at
// most 8 warps an SM, strip s of a sweep after strip s-1, so a warp only
// ever waits on a strip a running warp holds.  Columns past n in the last
// strip are computed with a pad code and never written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_rows.cuh"
#include "nw_affine_tiled.cuh"

namespace {

constexpr int kMmThreads = 128;  // 4 warps a block, each on its own strips
constexpr int kMmWarpsPerSm = 8;
constexpr unsigned kFull = 0xffffffffu;

// ctr: [0] the ticket, [1] the status word, [2 + sweep * S + strip] the
// rows strip has published.  out: (4, n + 1) CC, DD, RR, SS.
template <int LPT>
__global__ void __launch_bounds__(kMmThreads)
    mm_rows_kernel(sa::MmSweep s0, sa::MmSweep s1, int n, int S, int rows,
                   sa::Scheme sc, int32_t* __restrict__ out,
                   int32_t* __restrict__ bnd, int32_t* ctr) {
  constexpr int W = sa::kMmWarpLanes * LPT;
  const int lane = threadIdx.x & 31;
  int32_t* status = ctr + 1;
  int32_t* prog = ctr + 2;
  const int32_t e = sc.gap_extend;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(ctr, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= 2 * S) return;
    const int sweep = sa::mm_ticket_sweep(t);
    const int strip = sa::mm_ticket_strip(t);
    const sa::MmSweep w = sweep ? s1 : s0;
    const int jf = strip * W + lane * LPT;
    const bool col0 = strip == 0 && lane == 0;
    int32_t CC[LPT], DD[LPT], B[LPT], dc[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      CC[k] = sa::mm_cc0(jf + k, sc);
      DD[k] = sa::kNegInf;
      dc[k] = sa::mm_dcode(w, jf + k, n);
    }
    int32_t* my = bnd + sa::mm_bnd_offset(sweep, strip, S, rows);
    const int32_t* left =
        strip > 0 ? bnd + sa::mm_bnd_offset(sweep, strip - 1, S, rows)
                  : nullptr;
    int32_t* my_prog = prog + sweep * S + strip;
    if (lane == 31) my[0] = CC[LPT - 1];
    bool ok = true;
    for (int i0 = 1; i0 <= w.m && ok; i0 += sa::kMmGroup) {
      const int cnt = min(sa::kMmGroup, w.m - i0 + 1);
      const int32_t qv = lane < cnt ? w.q[w.q_off + i0 - 1 + lane] : 0;
      int32_t ccv = 0, xv = sa::kNegInf;
      if (left != nullptr) {
        bool got = true;
        if (lane == 0) {
          got = sa::wait_at_least(prog + sweep * S + strip - 1,
                                  i0 + cnt - 1, status, 64);
        }
        ok = __shfl_sync(kFull, got, 0);
        if (!ok) break;
        __syncwarp();
        if (lane < cnt) {
          ccv = __ldcg(left + i0 - 1 + lane);
          xv = __ldcg(left + rows + i0 + lane);
        }
      }
      for (int r = 0; r < cnt; ++r) {
        const int i = i0 + r;
        const int32_t qc = __shfl_sync(kFull, qv, r);
        const int32_t X = __shfl_sync(kFull, xv, r);
        const int32_t ccl = __shfl_sync(kFull, ccv, r);
        int32_t cc_left = __shfl_up_sync(kFull, CC[LPT - 1], 1);
        if (lane == 0) cc_left = ccl;
        const int32_t chain = w.tb + i * e;
        const int32_t A =
            sa::mm_pre<LPT>(CC, DD, B, dc, qc, cc_left, col0, chain, sc);
        // Inclusive max-scan of the keys over the warp.
        int32_t inc = sa::mm_key(A, lane, LPT, sc);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int32_t v = __shfl_up_sync(kFull, inc, off);
          if (lane >= off) inc = sa::imax(inc, v);
        }
        int32_t excl = __shfl_up_sync(kFull, inc, 1);
        excl = lane == 0 ? X : sa::imax(X, excl);
        sa::mm_post<LPT>(CC, B, sa::mm_e_first(excl, lane, LPT, sc), col0,
                         chain, sc);
        if (lane == 31) {
          my[i] = CC[LPT - 1];
          my[rows + i] = sa::imax(X, inc) + W * e;
        }
      }
      if (lane == 31) {
        __threadfence();
        sa::st_release(my_prog, i0 + cnt - 1);
      }
    }
    if (!ok) return;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = jf + k;
      if (j <= n) {
        out[static_cast<size_t>(2 * sweep) * (n + 1) + j] = CC[k];
        out[static_cast<size_t>(2 * sweep + 1) * (n + 1) + j] = DD[k];
      }
    }
  }
}

typedef void (*MmKernel)(sa::MmSweep, sa::MmSweep, int, int, int,
                         sa::Scheme, int32_t*, int32_t*, int32_t*);

MmKernel pick(int lpt) {
  switch (lpt) {
    case 4: return mm_rows_kernel<4>;
    case 8: return mm_rows_kernel<8>;
    case 16: return mm_rows_kernel<16>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" int sa_sm_count();

// The lanes a thread sa_mm_rows takes for n columns (mm_rows.cuh's rule
// on this card's SM count), and its scratch: words[0] the int32 words of
// ctr, words[1] those of bnd.  -1 for an unsupported shape.
extern "C" int sa_mm_rows_scratch(int n, int m_f, int m_r, int64_t* words) {
  const int sms = sa_sm_count();
  if (sms <= 0 || n < 0 || m_f < 0 || m_r < 0) return -1;
  const int lpt = sa::mm_lanes_per_thread(n, sms);
  words[0] = sa::mm_ctr_words(n, lpt);
  words[1] = sa::mm_bnd_words(n, m_f, m_r, lpt);
  return lpt;
}

// Both sweeps of a node.  qf/df, qr/dr: the forward and reversed padded
// sequences (int32 codes; d left-padded by one).  Sweep 0 reads qf/df from
// (q_off_f, d_off_f), m_f rows, column-0 chain from tb_f; sweep 1 reads
// qr/dr.  out: (4, n + 1) int32 (CC, DD of sweep 0, then of sweep 1).
// bnd and ctr: int32 scratch of the sizes sa_mm_rows_scratch gives, ctr
// zeroed but for the first ticket in ctr[0] (0; 2 leaves both sweeps'
// strip 0 unrun, a schedule that cannot be met, for tests).  Returns the
// cudaGetLastError() of the launch, -1 for an unsupported shape.  A stalled
// hand-over sets ctr[1] (the wrapper raises).
extern "C" int sa_mm_rows(const int32_t* qf, const int32_t* qr,
                          const int32_t* df, const int32_t* dr, int32_t* out,
                          int32_t* bnd, int32_t* ctr, int q_off_f, int m_f,
                          int d_off_f, int tb_f, int q_off_r, int m_r,
                          int d_off_r, int tb_r, int n, int match,
                          int mismatch, int gap_open, int gap_extend,
                          void* stream) {
  const int sms = sa_sm_count();
  if (sms <= 0 || n < 0 || m_f < 0 || m_r < 0) return -1;
  const int lpt = sa::mm_lanes_per_thread(n, sms);
  MmKernel fn = pick(lpt);
  int S = sa::mm_strips(n, lpt);
  int rows = sa::mm_bnd_rows(m_f, m_r);
  const int warps_cap = kMmWarpsPerSm * sms;
  const int warps = 2 * S < warps_cap ? 2 * S : warps_cap;
  const int blocks = (warps * 32 + kMmThreads - 1) / kMmThreads;
  sa::MmSweep s0{qf, df, q_off_f, m_f, d_off_f, tb_f};
  sa::MmSweep s1{qr, dr, q_off_r, m_r, d_off_r, tb_r};
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  void* args[] = {&s0, &s1, &n, &S, &rows, &sc, &out, &bnd, &ctr};
  cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(blocks),
                   dim3(kMmThreads), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

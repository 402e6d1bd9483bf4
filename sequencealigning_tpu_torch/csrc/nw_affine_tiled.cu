// Tiled score-only Gotoh fill for pairs of any length, for Hopper (sm_90a).
//
// Replaces the TPU kernels ops/nw_affine_tiled.py::_tile_kernel (launched by
// _tile_fill_pallas; the batched fill, kernel #4 here: sa_tiled_fill) and
// ::_folded_kernel (launched by _tile_fill_folded_pallas; 1-4 pairs, each
// folded over sublanes, kernel #5 here: sa_tiled_fold_fill).  Same contract
// as the lax fills: each pair's M/I/D corner values at (n2, n1), exact
// Gotoh whatever the tiling, so the kernels choose their own strip widths.
//
// What bounds it on this card: the integer work of the recurrence (10
// operations a cell as the function's least), and how many of the 132 SMs
// a few long pairs can keep busy.  A pair's cells depend on each other
// along both axes: swept tile after tile by one CTA, a batch of B pairs
// keeps B SMs busy; split over a cluster, a pair pays a cluster barrier
// every anti-diagonal step.
//
// Design: a pair's db axis is cut into strips of W lanes (4 or 8 lanes a
// thread in registers; W = 1024 for #4, 512 for #5 by default).  One CTA
// sweeps one strip anti-diagonal by anti-diagonal (lane l holds x = x0 + l,
// step g holds y = g - l) with one block barrier a step (shift_strip); its
// lane 0 takes the previous strip's last-lane column (H and max(M + o, D)
// for every row y, nw_affine_tiled.cuh), staged R rows at a time (a power
// of two, 2-128) in shared memory with the query codes, and its last lane
// writes the column for the next strip.  So strip s + 1 can run while
// strip s is still sweeping, about W + R steps behind it, and a pair
// spreads over as many CTAs as its rows allow.  CTAs couple only through
// global memory, once every R rows:
//
//   * producer: the last lane's thread writes rows [kR, (k+1)R) of its ring
//     slot, then publishes the row count with a release store;
//   * consumer: one thread waits with acquire loads until the count covers
//     the R rows it stages (never rows past n1, which are -inf), a block
//     barrier, then the rows are read with L1-bypassing loads;
//   * ring: K slots a pair (K >= CTAs a pair in flight + 1, at least 2); a
//     producer about to overwrite a slot first waits until the slot's last
//     reader (strip s - K + 1) has staged past the rows it writes, and a
//     reader publishes what it has staged, and kStripDone at its end.
//
// No barrier spans CTAs.  Work is handed out by a global atomic ticket over
// a persistent grid (at most what is co-resident): the items (pair, strip)
// are sorted strip-major, so a strip's producer and its slot's last reader
// hold earlier tickets, claimed by CTAs that are already running; a wait
// never depends on a CTA that is not resident.  Every wait gives up after
// kSpinLimit polls without progress (seconds): it sets the launch's
// status word, every CTA stops at its next wait or ticket, and the wrapper
// raises.  The cell keeps its instructions few: the DPX instructions
// (VIADDMAX for I and for max(M + o, D), VIMNMX3 for H), a thread's query
// and db codes packed 4 bits a lane (one LOP3 a lane compares them, one
// shift a step moves the query codes along), the H arrays of two steps
// back and one step back swapping roles every step instead of being
// copied, and the y = 0 check only in a strip's first W steps.
//
// The shard fill (sa_tiled_shard_fill) replaces the per-device shard of
// parallel/seqpar.py::_jitted_seqpar (a lax.scan of _tile_step phases whose
// last lane goes to the next device by ppermute every chunk): one pair's
// db axis in segments of W lanes dealt round-robin to a mesh's devices,
// one launch a device, all launches running at once.  The same strips,
// cell and staging; a strip's column comes from a whole column (no ring,
// so no wait on a reader), and the column between two segments from a
// boundary buffer in the consumer's memory, published with system-scope
// release stores that the consumer's acquire loads read -- the same
// protocol whether the launches share one card or the producer writes
// into another card's memory through peer access.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_split.cuh"
#include "nw_affine_tiled.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxChunk = 128;         // rows staged at a time, at most
constexpr int kMaxStripLanes = 4096;   // lanes a CTA at most
using sa::kSmWords;
using sa::ld_acquire;
using sa::st_release;
using sa::wait_at_least;

// The launch's counters (one zeroed int32 tensor): [0] the ticket, [1] the
// status word, [2, 2 + 8B) the SMs that ran each pair's strips (bitmaps),
// then per strip (gs) the rows it published and the rows it consumed.
struct Counters {
  int32_t* ticket;
  int32_t* status;
  uint32_t* sms;
  int32_t* prog;
  int32_t* cons;
};

__device__ __forceinline__ Counters counters(int32_t* ctr, int B,
                                             int nstrips) {
  Counters c;
  c.ticket = ctr;
  c.status = ctr + 1;
  c.sms = reinterpret_cast<uint32_t*>(ctr + 2);
  c.prog = ctr + 2 + B * kSmWords;
  c.cons = c.prog + nstrips;
  return c;
}

// Stages the R rows from step g of a strip's lane 0 in shared memory (the
// query codes, and the carried column: the closed form for strip 0, else
// io.cin), after thread 0 has waited for the producer's rows (io.cin_rows)
// and, when kernel #4's strip will overwrite a ring slot, for the slot's
// last reader; then publishes what it has read.  A shard launch (SHARD)
// writes whole columns, never a ring slot, so it waits for its producers
// only.  Returns false (for every thread) when a wait gave up.
template <bool COMPAT, bool SHARD>
__device__ __forceinline__ bool stage_chunk(
    int g, int R, int W, int32_t n1, int L1, const int32_t* q,
    const sa::StripIO& io, const sa::StripItem& it, int K,
    const Counters& ct, const sa::Scheme& sc, int32_t* qsm, int32_t* hsm,
    int32_t* osm, int* ok_sm) {
  const int j = threadIdx.x;
  __syncthreads();  // lane 0 has read the previous chunk
  if (j == 0) {
    bool ok = true;
    if (io.cin != nullptr && g <= n1) {
      const int rows = sa::chunk_rows_needed(g, R, n1);
      ok = SHARD && io.cin_peer
               ? wait_at_least<true>(io.cin_rows, rows, ct.status)
               : wait_at_least(io.cin_rows, rows, ct.status);
    }
    const int need = !SHARD && io.cout != nullptr
                         ? sa::ring_rows_needed(g, R, W, n1, it.s, K)
                         : 0;
    if (ok && need > 0) {
      ok = wait_at_least(ct.cons + it.gs - K + 1, need, ct.status);
    }
    *ok_sm = ok;
  }
  __syncthreads();
  if (!*ok_sm) return false;
  for (int i = j; i < R; i += blockDim.x) {
    sa::tile_stage_row(g + i, n1, L1, q, io.cin, COMPAT, sc, qsm[i], hsm[i],
                       osm[i]);
  }
  __syncthreads();
  if (j == 0 && io.cin != nullptr) {
    __threadfence();
    st_release(ct.cons + it.gs, sa::chunk_consumed(g, R));
  }
  return true;
}

// The strip's last lane (its new H, M, D) writes row y of the next strip's
// column (H and max(M + o, D)), and publishes every R rows and at row n1:
// at system scope where the column is a boundary buffer (peer).
template <bool SHARD>
__device__ __forceinline__ void produce_row(int32_t H, int32_t M, int32_t D,
                                            int y, int R, int32_t n1,
                                            int32_t* cout, int32_t* rows,
                                            bool peer, const sa::Scheme& sc) {
  cout[2 * y] = H;
  cout[2 * y + 1] = sa::add_max(M, sc.gap_open, D);
  const int pub = sa::chunk_publish(y, R, n1);
  if (pub >= 0) {
    if (SHARD && peer) {
      sa::st_release_sys(rows, pub);
    } else {
      st_release(rows, pub);
    }
  }
}

// A thread's LPT lanes from lane0: H two steps back and one step back (the
// kernel swaps the two arrays every step instead of moving them), M, I, D
// one step back, and the query codes flowing along the lanes and the db
// codes packed 4 bits a lane (lane i in bits 4i..4i+3).
template <int LPT>
struct Lanes {
  int32_t Ha[LPT], Hb[LPT], M1[LPT], I1[LPT], D1[LPT];
  uint32_t q, d;
};

// Moves each thread's last-lane values (h, d, s) to the next thread's
// first lane: a shuffle inside a warp, shared memory at warp edges
// (double-buffered by step parity: one barrier a step).  Thread 0 receives
// nothing (its lane 0 reads the staged column).
__device__ __forceinline__ void shift_strip(int32_t (&edge)[2][3][32], int j,
                                            int buf, int32_t& h, int32_t& d,
                                            int32_t& s) {
  const int warp = j >> 5;
  const int wl = j & 31;
  const int32_t eH = h, eD = d, eS = s;
  h = __shfl_up_sync(kFullMask, eH, 1);
  d = __shfl_up_sync(kFullMask, eD, 1);
  s = __shfl_up_sync(kFullMask, eS, 1);
  if (wl == 31) {
    edge[buf][0][warp] = eH;
    edge[buf][1][warp] = eD;
    edge[buf][2][warp] = eS;
  }
  __syncthreads();
  if (wl == 0 && warp > 0) {
    h = edge[buf][0][warp - 1];
    d = edge[buf][1][warp - 1];
    s = edge[buf][2][warp - 1];
  }
}

// One anti-diagonal step g of a strip for this thread's lanes: H2 holds H
// two steps back (what the right neighbours read) and receives the step's
// H; the other H array, one step back, is H2 of the next step.  Lane 0 of the strip is fed by the staged row gc.  RAMP: a
// step g < W, where a lane may hold the y = 0 chain cell (lane == g); past
// the ramp no lane does, and the check goes.
template <int LPT, bool COMPAT, bool WILDCARD, bool RAMP>
__device__ __forceinline__ void strip_step(
    int32_t (&H2)[LPT], Lanes<LPT>& L,
    int32_t (&edge)[2][3][32], int lane0, int g, int gc, int x0,
    const int32_t* qsm, const int32_t* hsm, const int32_t* osm,
    const sa::Scheme& sc) {
  const int j = threadIdx.x;
  int32_t ds[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) ds[i] = sa::tile_dsel(L.M1[i], L.D1[i], sc);
  int32_t nH = H2[LPT - 1];
  int32_t nD = ds[LPT - 1];
  int32_t nS = static_cast<int32_t>((L.q >> (4 * (LPT - 1))) & 0xfu);
  shift_strip(edge, j, g & 1, nH, nD, nS);
  if (j == 0) {
    // The strip's lane 0 reads the carried boundary column.
    nH = hsm[gc];
    nD = osm[gc];
    nS = qsm[gc];
  }
  // Every lane takes its left neighbour's query code.
  L.q = (L.q << 4) | (static_cast<uint32_t>(nS) & 0xfu);
  // Right to left, so lane i-1 still holds its pre-step H2 for lane i.
#pragma unroll
  for (int i = LPT - 1; i >= 0; --i) {
    const bool eq = sa::tile_eq<WILDCARD>(L.q, L.d, 0xfu << (4 * i));
    const int32_t lH2 = i == 0 ? nH : H2[i - 1];
    const int32_t ldsel = i == 0 ? nD : ds[i - 1];
    H2[i] = sa::tile_cell<COMPAT>(eq, lH2, ldsel, RAMP && lane0 + i == g,
                                  x0 + lane0 + i, L.M1[i], L.I1[i], L.D1[i],
                                  sc);
  }
}

// query: (B, L1) int32 codes; db: (B, L2) int32 codes; n1v/n2v: (B,)
// lengths; items: (nitems, 3) int32 (pair, strip, gs) in ticket order
// (nw_affine_tiled.cuh::strip_item); finals: (B, 3) int32, zeroed (a pair
// with n2 = 0 is left untouched); col: B * K ring slots of 2 * nrow int32
// (nrow >= n1 + 1); ctr: the zeroed counters.  blockDim.x = W / LPT; R a
// power of two, 2-128 (the steps go two at a time, H1 and H2 swapping).
// SHARD (sa_tiled_shard_fill): the launch holds some segments of each
// pair (nw_affine_tiled.cuh::shard_strip_io), col a whole column a strip
// by gs, bufs the boundary buffers' addresses (seg_strips strips a
// segment, nseg segments a pair in the table); finals receive the corners
// of the pairs whose last strip this launch holds.
template <int LPT, bool COMPAT, bool WILDCARD, bool SHARD>
__global__ void __launch_bounds__(sa::kMaxThreads)
    strip_fill_kernel(const int32_t* __restrict__ query,
                      const int32_t* __restrict__ db,
                      const int32_t* __restrict__ n1v,
                      const int32_t* __restrict__ n2v,
                      const int32_t* __restrict__ items, int nitems,
                      int32_t* finals, int32_t* col, int32_t* ctr, int B,
                      int L1, int L2, int nrow, int nstrips, int R, int K,
                      const int64_t* __restrict__ bufs, int seg_strips,
                      int nseg, sa::Scheme sc) {
  static_assert(LPT * 4 <= 32, "a thread's query codes fill one register");
  __shared__ int32_t qsm[kMaxChunk];  // query code y - 1 of lane 0
  __shared__ int32_t hsm[kMaxChunk];  // boundary H(y - 1)
  __shared__ int32_t osm[kMaxChunk];  // boundary max(M(y) + o, D(y))
  __shared__ int32_t edge[2][3][32];  // warp edges' lanes, by step parity
  __shared__ int ticket_sm;
  __shared__ int ok_sm;

  const Counters ct = counters(ctr, B, nstrips);
  const int j = threadIdx.x;
  const int nthr = blockDim.x;
  const int W = nthr * LPT;
  const int lane0 = j * LPT;
  const bool edge_owner = j == nthr - 1;  // owns the strip's last lane

  for (;;) {
    if (j == 0) {
      const bool stop = *reinterpret_cast<volatile int32_t*>(ct.status);
      ticket_sm = stop ? nitems : atomicAdd(ct.ticket, 1);
    }
    __syncthreads();
    const int ticket = ticket_sm;
    if (ticket >= nitems) return;
    const sa::StripItem it = sa::strip_item(items, ticket);
    if (j == 0) {
      sa::mark_sm(ct.sms + it.b * kSmWords);
    }
    const int32_t n1 = n1v[it.b];
    const int32_t n2 = n2v[it.b];
    const int x0 = it.s * W + 1;
    const bool last = it.s == sa::strip_count(n2, W) - 1;
    // The last strip ends at the corner's step, n2 - x0 + n1.
    const int g_end = sa::strip_steps(n1, n2, x0, W, last);
    const int32_t* q = query + static_cast<size_t>(it.b) * L1;
    sa::StripIO io;
    if (SHARD) {
      io = sa::shard_strip_io(it, last, seg_strips, nseg, bufs, col,
                              ct.prog, nrow);
    } else {
      io.cin = it.s > 0 ? col + sa::strip_slot(it.b, it.s - 1, K, nrow)
                        : nullptr;
      io.cin_rows = ct.prog + it.gs - 1;
      io.cin_peer = false;
      io.cout = last ? nullptr : col + sa::strip_slot(it.b, it.s, K, nrow);
      io.cout_rows = ct.prog + it.gs;
      io.cout_peer = false;
    }
    int32_t* cout = io.cout;
    Lanes<LPT> L;
    L.q = 0;
    L.d = 0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      L.Ha[i] = L.Hb[i] = L.M1[i] = L.I1[i] = L.D1[i] = sa::kNegInf;
      const int x = x0 + lane0 + i;  // db code x - 1
      const int32_t code =
          x <= n2 ? db[static_cast<size_t>(it.b) * L2 + x - 1] : 0;
      L.d |= (static_cast<uint32_t>(code) & 0xfu) << (4 * i);
    }
    // Steps two at a time (chunks start at even steps): the first writes
    // its H into Ha, the second into Hb.  The ramp (g < W, an even count)
    // first, then the rest; an odd last step alone.
    const int g_ramp = g_end < W ? g_end : W;
    int g = 0;
    for (; g + 1 < g_ramp; g += 2) {
      const int gc = g & (R - 1);
      if (gc == 0 && !stage_chunk<COMPAT, SHARD>(g, R, W, n1, L1, q, io, it,
                                                 K, ct, sc, qsm, hsm, osm,
                                                 &ok_sm)) {
        return;
      }
      strip_step<LPT, COMPAT, WILDCARD, true>(L.Ha, L, edge, lane0, g,
                                              gc, x0, qsm, hsm, osm, sc);
      if (edge_owner && cout != nullptr && g >= W - 1) {
        produce_row<SHARD>(L.Ha[LPT - 1], L.M1[LPT - 1], L.D1[LPT - 1],
                           g - W + 1, R, n1, cout, io.cout_rows,
                           io.cout_peer, sc);
      }
      strip_step<LPT, COMPAT, WILDCARD, true>(L.Hb, L, edge, lane0,
                                              g + 1, gc + 1, x0, qsm, hsm,
                                              osm, sc);
      if (edge_owner && cout != nullptr && g + 1 >= W - 1) {
        produce_row<SHARD>(L.Hb[LPT - 1], L.M1[LPT - 1], L.D1[LPT - 1],
                           g + 2 - W, R, n1, cout, io.cout_rows,
                           io.cout_peer, sc);
      }
    }
    for (; g + 1 < g_end; g += 2) {
      const int gc = g & (R - 1);
      if (gc == 0 && !stage_chunk<COMPAT, SHARD>(g, R, W, n1, L1, q, io, it,
                                                 K, ct, sc, qsm, hsm, osm,
                                                 &ok_sm)) {
        return;
      }
      strip_step<LPT, COMPAT, WILDCARD, false>(L.Ha, L, edge, lane0, g,
                                               gc, x0, qsm, hsm, osm, sc);
      if (edge_owner && cout != nullptr) {
        produce_row<SHARD>(L.Ha[LPT - 1], L.M1[LPT - 1], L.D1[LPT - 1],
                           g - W + 1, R, n1, cout, io.cout_rows,
                           io.cout_peer, sc);
      }
      strip_step<LPT, COMPAT, WILDCARD, false>(L.Hb, L, edge, lane0,
                                               g + 1, gc + 1, x0, qsm, hsm,
                                               osm, sc);
      if (edge_owner && cout != nullptr) {
        produce_row<SHARD>(L.Hb[LPT - 1], L.M1[LPT - 1], L.D1[LPT - 1],
                           g + 2 - W, R, n1, cout, io.cout_rows,
                           io.cout_peer, sc);
      }
    }
    if (g < g_end) {
      // An odd step count: the last step alone, its H into Ha.
      const int gc = g & (R - 1);
      if (gc == 0 && !stage_chunk<COMPAT, SHARD>(g, R, W, n1, L1, q, io, it,
                                                 K, ct, sc, qsm, hsm, osm,
                                                 &ok_sm)) {
        return;
      }
      if (g < W) {
        strip_step<LPT, COMPAT, WILDCARD, true>(L.Ha, L, edge, lane0,
                                                g, gc, x0, qsm, hsm, osm, sc);
      } else {
        strip_step<LPT, COMPAT, WILDCARD, false>(L.Ha, L, edge, lane0,
                                                 g, gc, x0, qsm, hsm, osm,
                                                 sc);
      }
      if (edge_owner && cout != nullptr && g >= W - 1) {
        produce_row<SHARD>(L.Ha[LPT - 1], L.M1[LPT - 1], L.D1[LPT - 1],
                           g - W + 1, R, n1, cout, io.cout_rows,
                           io.cout_peer, sc);
      }
    }
    // The corner: the last strip's last step, at lane n2 - x0.
    const int cap = n2 - x0 - lane0;
    if (last && cap >= 0 && cap < LPT) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if (i == cap) {
          int32_t* f = finals + static_cast<size_t>(it.b) * 3;
          f[0] = L.M1[i];
          f[1] = L.I1[i];
          f[2] = L.D1[i];
        }
      }
    }
    if (j == 0 && io.cin != nullptr) {
      st_release(ct.cons + it.gs, sa::kStripDone);
    }
    __syncthreads();  // ticket_sm is rewritten next
  }
}

typedef void (*StripKernel)(const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, const int32_t*, int, int32_t*,
                            int32_t*, int32_t*, int, int, int, int, int, int,
                            int, const int64_t*, int, int, sa::Scheme);

template <int LPT, bool SHARD>
StripKernel pick(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? strip_fill_kernel<LPT, true, true, SHARD>
                    : strip_fill_kernel<LPT, true, false, SHARD>;
  }
  return wildcard ? strip_fill_kernel<LPT, false, true, SHARD>
                  : strip_fill_kernel<LPT, false, false, SHARD>;
}

// The launch's kind: kernel #4, kernel #5, or the shard fill (#4's strips
// over one device's segments).
enum Kind { kTiled = 0, kFold = 1, kShard = 2 };

// Lanes a thread for strips of W lanes: #4 and the shard fill take 8 where
// W allows (a whole number of warps), #5 always 4 (twice the threads for
// the few pairs it takes).  0 for a width out of range.
int strip_lpt(int W, int kind) {
  if (W <= 0 || W % 128 != 0 || W > kMaxStripLanes) return 0;
  if (kind != kFold && W % 256 == 0) return 8;
  return W / 4 <= sa::kMaxThreads ? 4 : 0;
}

StripKernel strip_kernel(int lpt, int kind, bool compat, bool wildcard) {
  const bool shard = kind == kShard;
  switch (lpt) {
    case 4:
      return shard ? pick<4, true>(compat, wildcard)
                   : pick<4, false>(compat, wildcard);
    case 8:
      return shard ? pick<8, true>(compat, wildcard)
                   : pick<8, false>(compat, wildcard);
  }
  return nullptr;
}

int resident_ctas(int W, int kind, int compat, int wildcard) {
  if (kind < kTiled || kind > kShard) return 0;
  const int lpt = strip_lpt(W, kind);
  const StripKernel fn = strip_kernel(lpt, kind, compat != 0, wildcard != 0);
  if (fn == nullptr) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(fn), W / lpt, 0) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return per_sm * sms;
}

int launch(int kind, const int32_t* query, const int32_t* db,
           const int32_t* n1v, const int32_t* n2v, int32_t* finals,
           int32_t* col, int32_t* ctr, const int32_t* items,
           const int64_t* bufs, int B, int L1, int L2, int nitems,
           int nstrips, int match, int mismatch, int gap_open,
           int gap_extend, int compat, int wildcard, int W, int R, int K,
           int seg_strips, int nseg, int ctas, void* stream) {
  const int lpt = strip_lpt(W, kind);
  const StripKernel fn = strip_kernel(lpt, kind, compat != 0, wildcard != 0);
  if (fn == nullptr || B <= 0 || L1 <= 0 || L2 <= 0 || nitems <= 0 ||
      R < 2 || R > kMaxChunk || (R & (R - 1)) != 0 || K < 2 || ctas < 1 ||
      (kind == kShard && (bufs == nullptr || seg_strips < 1 || nseg < 1))) {
    return -1;
  }
  int nrow = L1 + 1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  void* args[] = {&query,  &db,      &n1v,  &n2v,   &items, &nitems,
                  &finals, &col,     &ctr,  &B,     &L1,    &L2,
                  &nrow,   &nstrips, &R,    &K,     &bufs,  &seg_strips,
                  &nseg,   &sc};
  cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(ctas),
                   dim3(W / lpt), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// CTAs of the strip kernel the card holds at once (occupancy x SMs) for
// strips of strip_lanes lanes: #4's instance (kind 0), #5's (kind 1) or
// the shard fill's (kind 2); 0 for a width or kind out of range.
extern "C" int sa_tiled_resident_ctas(int strip_lanes, int kind, int compat,
                                      int wildcard) {
  return resident_ctas(strip_lanes, kind, compat, wildcard);
}

// Kernel #4: strips of strip_lanes lanes (a multiple of 128, at most 4096;
// 2048 for kernel #5)
// over a persistent grid of `ctas` CTAs.  query: (B, L1) int32; db: (B, L2)
// int32; n1v/n2v: (B,) int32; finals: (B, 3) int32, zeroed; col: B * ring
// slots of 2 * (L1 + 1) int32; ctr: 2 + 8B + 2 * nstrips int32, zeroed;
// items: (nitems, 3) int32, strip-major; chunk_rows: rows staged at a time
// (a power of two, 2-128); ring: slots a pair (>= 2).  Returns the
// cudaGetLastError() of the launch, -1 for an unsupported shape.  After the launch ctr[1] is non-zero
// if a wait stalled (the finals are then incomplete).
extern "C" int sa_tiled_fill(const int32_t* query, const int32_t* db,
                             const int32_t* n1v, const int32_t* n2v,
                             int32_t* finals, int32_t* col, int32_t* ctr,
                             const int32_t* items, int B, int L1, int L2,
                             int nitems, int nstrips, int match,
                             int mismatch, int gap_open, int gap_extend,
                             int compat, int wildcard, int strip_lanes,
                             int chunk_rows, int ring, int ctas,
                             void* stream) {
  return launch(kTiled, query, db, n1v, n2v, finals, col, ctr, items,
                nullptr, B, L1, L2, nitems, nstrips, match, mismatch,
                gap_open, gap_extend, compat, wildcard, strip_lanes,
                chunk_rows, ring, 0, 0, ctas, stream);
}

// Kernel #5: the same for 1-4 pairs, 4 lanes a thread.
extern "C" int sa_tiled_fold_fill(const int32_t* query, const int32_t* db,
                                  const int32_t* n1v, const int32_t* n2v,
                                  int32_t* finals, int32_t* col, int32_t* ctr,
                                  const int32_t* items, int B, int L1,
                                  int L2, int nitems, int nstrips, int match,
                                  int mismatch, int gap_open, int gap_extend,
                                  int compat, int wildcard, int strip_lanes,
                                  int chunk_rows, int ring, int ctas,
                                  void* stream) {
  return launch(kFold, query, db, n1v, n2v, finals, col, ctr, items, nullptr,
                B, L1, L2, nitems, nstrips, match, mismatch, gap_open,
                gap_extend, compat, wildcard, strip_lanes, chunk_rows, ring,
                0, 0, ctas, stream);
}

// The shard fill (parallel/seqpar.py on a CUDA mesh): one device's launch
// of kernel #4's strips over the segments it owns (seg_strips strips of
// strip_lanes lanes a segment; segment k in launch k % D), every launch of
// the mesh running at once.  As sa_tiled_fill, except: items (pair, strip,
// gs) sorted segment-major, then strip-major, then by pair, gs numbering a
// pair's strips of one segment consecutively; col nstrips whole columns of
// 2 * (L1 + 1) int32; bufs (B * nseg) int64 addresses of the boundary
// buffers entering each segment (nw_affine_tiled.cuh::shard_strip_io),
// each on its consumer's card with its row count zeroed, the next
// segment's written by this launch through peer access where it lies on
// another card; finals: this device's corners (the host adds the
// devices').  Every wait then points at a lower segment or an earlier
// ticket of the same launch, so the launches cannot wait on each other in
// a cycle.
extern "C" int sa_tiled_shard_fill(const int32_t* query, const int32_t* db,
                                   const int32_t* n1v, const int32_t* n2v,
                                   int32_t* finals, int32_t* col,
                                   int32_t* ctr, const int32_t* items,
                                   const int64_t* bufs, int B, int L1,
                                   int L2, int nitems, int nstrips,
                                   int match, int mismatch, int gap_open,
                                   int gap_extend, int compat, int wildcard,
                                   int strip_lanes, int seg_strips, int nseg,
                                   int chunk_rows, int ctas, void* stream) {
  return launch(kShard, query, db, n1v, n2v, finals, col, ctr, items, bufs,
                B, L1, L2, nitems, nstrips, match, mismatch, gap_open,
                gap_extend, compat, wildcard, strip_lanes, chunk_rows, 2,
                seg_strips, nseg, ctas, stream);
}

// Lets kernels on card `dev` write into card `peer`'s memory (the shard
// fill's boundary buffers); the current card is restored.  0 when access
// is on (also when it was already), else the CUDA error.
extern "C" int sa_enable_peer(int dev, int peer) {
  int prev = 0;
  if (cudaGetDevice(&prev) != cudaSuccess) return -1;
  cudaError_t rc = cudaSetDevice(dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceEnablePeerAccess(peer, 0);
    if (rc == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      rc = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return static_cast<int>(rc);
}

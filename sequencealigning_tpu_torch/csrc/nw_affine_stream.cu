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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "cluster_split.cuh"
#include "nw_affine_stream.cuh"
#include "stream_ring.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;

using Ring = sa::RingShape;
using sa::cluster_addr;
using sa::ring_get;
using sa::ring_put;
using sa::RingSmem;
using sa::smem_addr;

// A thread's lanes: their scores (c[i]; c[i].s1d and c[i].s2v are unused),
// query and db codes packed 4 bits a lane (lane i in word i / 8, bits
// 4 (i % 8): the query codes move a lane a step with one shift a word),
// direction words, and (the modes) running argmax and window of eligible
// steps.
template <int LPT>
struct Lanes {
  static constexpr int kWords = (LPT + 7) / 8;
  sa::Cell c[LPT];
  uint32_t s1d[kWords], s2v[kWords];
  uint32_t acc[LPT];
  int32_t bv[LPT], bd[LPT];   // best score, its step
  int32_t lo[LPT], len[LPT];  // eligible steps: (unsigned)(t - lo) < len
};

// The query codes move a lane to the right; `in` enters at lane 0.
template <int LPT>
__device__ __forceinline__ void shift_codes(uint32_t (&w)[(LPT + 7) / 8],
                                            int32_t in) {
  if constexpr (LPT > 8) w[1] = w[1] << 4 | w[0] >> 28;
  w[0] = w[0] << 4 | static_cast<uint32_t>(in);
  if constexpr (LPT < 8) w[0] &= (1u << 4 * LPT) - 1;
}

// Lane li's code (0 <= li < LPT) set to v.
template <int LPT>
__device__ __forceinline__ void set_code(uint32_t (&w)[(LPT + 7) / 8],
                                         int li, int32_t v) {
  const int at = 4 * (li & 7);
  const uint32_t put = static_cast<uint32_t>(v) << at;
  const uint32_t keep = ~(15u << at);
  if constexpr (LPT > 8) {
    if (li >= 8) {
      w[1] = (w[1] & keep) | put;
      return;
    }
  }
  w[0] = (w[0] & keep) | put;
}

// Writes lane i's argmax into at[i] (bv) and at[plane + i] (bd, its steps
// counted from slot0); at is null when the slot holds no pair.
template <int LPT>
__device__ __forceinline__ void flush_argmax(const Lanes<LPT>& L,
                                             int32_t* at, size_t plane, int i,
                                             int32_t slot0) {
  if (at == nullptr) return;
  at[i] = L.bv[i];
  at[plane + i] = L.bd[i] - slot0;
}

// A thread's place in the modes' argmax planes (bv then bd, each (NP, R,
// P)) at slot k, or null when k holds no pair.
__device__ __forceinline__ int32_t* argmax_at(int32_t* out, int k, int R,
                                              int row, int P, int NP,
                                              int base) {
  if (k < 0 || k >= NP) return nullptr;
  return out + (static_cast<size_t>(k) * R + row) * P + base;
}

// The pair a lane at p turns over to (the modes): its slot and lengths
// (n2 = -1: none), and where the older slot's argmax goes.
struct Turnover {
  int slot;
  int32_t n1, n2;
  int32_t* out;
  int R, row, P, NP, S;
};

// Lane I of one step of a thread's lanes, then lanes I-1 .. 0: right to
// left, so lane i-1 still holds its pre-step state for lane i (a recursion
// rather than a loop, so the lanes stay in registers: the compiler does not
// always unroll that loop).  mine: lane I's ring_pre, computed by the lane
// to its right; lane I computes lane I-1's.  mx: the lanes' codes matched
// (the step's, in place).  lH / lD / lflag: what the lane left of lane 0
// handed over.  EP: this thread's warp holds lane p; lane0: this thread
// holds lane 0.
template <int I, int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD,
          bool EP>
__device__ __forceinline__ void ring_lanes(
    Lanes<LPT>& L, const sa::Pre& mine, const uint32_t (&mx)[(LPT + 7) / 8],
    int32_t lH, int32_t lD, int32_t lflag, int t, int p, int base, bool real,
    bool lane0, const Turnover& tv, const sa::Scheme& sc) {
  const int x = base + I;
  int32_t lh, ld, lf;
  sa::Pre left;
  if constexpr (I == 0) {
    lh = lH;
    ld = lD;
    lf = lflag;
  } else {
    left = sa::ring_pre<DIRS>(L.c[I - 1], sc);
    lh = L.c[I - 1].H2;
    ld = left.dsel;
    lf = left.dflag;
  }
  // mx: the codes' AND (wildcard: they intersect where non-zero) or XOR
  // (they are equal where zero).
  const uint32_t m = mx[I / 8] >> 4 * (I % 8) & 15;
  const bool eq = WILDCARD ? m != 0 : m == 0;
  const int32_t code = sa::ring_cell<DIRS, MODE, COMPAT, EP, I == 0>(
      L.c[I], mine, lh, ld, lf, eq, lane0, x == p, p, sc);
  if constexpr (DIRS != sa::kDirsNone) {
    L.acc[I] = sa::push_code<DIRS>(L.acc[I], code);
  }
  if constexpr (MODE != sa::kModeGlobal) {
    if (EP && x == p && real) {
      // Lane x turns over from the older pair to the younger.
      flush_argmax(L,
                   argmax_at(tv.out, tv.slot - 1, tv.R, tv.row, tv.P, tv.NP,
                             x - I),
                   static_cast<size_t>(tv.NP) * tv.R * tv.P, I,
                   (tv.slot - 1) * tv.S);
      L.bv[I] = sa::kNegBig;
      L.bd[I] = t - x;
      sa::modes_window<MODE>(x, t, tv.n1, tv.n2, L.lo[I], L.len[I]);
    }
    sa::modes_track<MODE>(t, L.lo[I], L.len[I], L.c[I].M1, L.c[I].H1,
                          L.bv[I], L.bd[I]);
  }
  if constexpr (I > 0) {
    ring_lanes<I - 1, LPT, DIRS, MODE, COMPAT, WILDCARD, EP>(
        L, left, mx, lH, lD, lflag, t, p, base, real, lane0, tv, sc);
  }
}

// Next step (after `after`) at which a pair's corner lies on one of the
// thread's lanes [base, base + lpt); INT_MAX if none.
__device__ __forceinline__ int next_capture(const int32_t* dsum,
                                            const int32_t* n2s, int R,
                                            int row, int S, int NP, int base,
                                            int lpt, int after) {
  int best = INT_MAX;
  for (int k = 0; k < NP; ++k) {
    const int x = n2s[k * R + row];
    const int tc = k * S + dsum[k * R + row];
    if (x >= base && x < base + lpt && tc > after && tc < best) best = tc;
  }
  return best;
}

__device__ __forceinline__ void wrap_put(uint32_t a, bool remote, uint32_t v) {
  if (remote) {
    asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v));
  } else {
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v));
  }
}
__device__ __forceinline__ uint32_t wrap_get(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// One thread's sweep: the launch's inputs and its place in the row, then
// what changes from step to step (p, the modes' slots, the next finals
// capture, lane P-1's D bits) and from chunk to chunk (the codes, the ring
// entries' addresses).
struct Sweep {
  const int32_t* dsum;
  const int32_t* n2s;
  int32_t* out;
  uint32_t wrap_out;  // lane 0's words (in the CTA holding lane P-1)
  uint32_t wrap_in;
  int R, P, S, NP, row, base, wbase, wrap;
  bool real, head, tail, lane0, producer, consumer, out_remote, one_warp;
  bool wrap_remote;  // lane 0's words go to another CTA
  sa::Scheme sc;
  uint32_t* dst;  // this thread's lanes in the next direction word
  int p, cap_next;
  uint32_t wacc;
  Turnover tv;
  int32_t codes;      // the chunk's db code | query code << 8, a step a lane
  uint32_t rin, rout; // the chunk's ring entries (16 bytes a step)
};

// Step t (entry e of its chunk) of a thread's lanes.
template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD>
__device__ __forceinline__ void sweep_step(Sweep& w, Lanes<LPT>& L, int t,
                                           int e) {
  constexpr bool kModes = MODE != sa::kModeGlobal;
  constexpr bool kDirs = DIRS != sa::kDirsNone;
  constexpr int kPer = DIRS == sa::kDirsFast4 ? 8 : 4;  // steps a word
  if (kModes && w.p == 0) {
    const int k = t / w.S;
    w.tv.slot = k;
    w.tv.n2 = k < w.NP ? w.n2s[k * w.R + w.row] : -1;
    w.tv.n1 = k < w.NP ? w.dsum[k * w.R + w.row] - w.tv.n2 : -1;
  }
  int4 left = make_int4(0, 0, 0, 0);
  if (w.consumer) left = ring_get(w.rin + 16 * e);
  // Hand this thread's last lane to the next thread and warp.
  constexpr int kI = LPT - 1;
  const sa::Pre last = sa::ring_pre<DIRS>(L.c[kI], w.sc);
  const int32_t nH = L.c[kI].H2;
  const int32_t nD = last.dsel;
  const int32_t nS = sa::ring_pack(
      static_cast<int32_t>(L.s1d[kI / 8] >> 4 * (kI % 8) & 15), last.dflag);
  if (w.producer) ring_put(w.rout + 16 * e, w.out_remote, nH, nD, nS);
  if (kDirs) w.wacc = sa::push_code<DIRS>(w.wacc, last.dflag);
  int32_t lH = __shfl_up_sync(kFull, nH, 1);
  int32_t lD = __shfl_up_sync(kFull, nD, 1);
  int32_t lS = __shfl_up_sync(kFull, nS, 1);
  if (w.consumer) {
    lH = left.x;
    lD = left.y;
    lS = left.z;
  }
  // Lane 0 takes the step's query code and no D bits from the left (lane
  // P-1's are added to its word by the tail thread).
  if (w.head) {
    const int32_t qc = __shfl_sync(kFull, w.codes, e) >> 8;
    if (w.lane0) lS = qc;
  }
  shift_codes<LPT>(L.s1d, sa::ring_s1d(lS));
  // Lane p takes the step's db code.
  const int p = w.p;
  const bool has_p =
      static_cast<unsigned>(p - w.wbase) < static_cast<unsigned>(32 * LPT);
  if (has_p) {
    const int32_t dc = __shfl_sync(kFull, w.codes, e) & 0xff;
    const int li = p - w.base;
    if (static_cast<unsigned>(li) < static_cast<unsigned>(LPT)) {
      set_code<LPT>(L.s2v, li, dc);
    }
  }
  uint32_t mx[Lanes<LPT>::kWords];
#pragma unroll
  for (int i = 0; i < Lanes<LPT>::kWords; ++i) {
    mx[i] = WILDCARD ? L.s1d[i] & L.s2v[i] : L.s1d[i] ^ L.s2v[i];
  }
  const int32_t lflag = sa::ring_dflag(lS);
  if (has_p) {
    ring_lanes<kI, LPT, DIRS, MODE, COMPAT, WILDCARD, true>(
        L, last, mx, lH, lD, lflag, t, p, w.base, w.real, w.lane0, w.tv,
        w.sc);
  } else {
    ring_lanes<kI, LPT, DIRS, MODE, COMPAT, WILDCARD, false>(
        L, last, mx, lH, lD, lflag, t, p, w.base, w.real, w.lane0, w.tv,
        w.sc);
  }

  if (!kModes && t == w.cap_next) {
    for (int k = 0; k < w.NP; ++k) {
      const int x = w.n2s[k * w.R + w.row];
      if (k * w.S + w.dsum[k * w.R + w.row] != t || x < w.base ||
          x >= w.base + LPT) {
        continue;
      }
      int32_t* f = w.out + (static_cast<size_t>(w.row) * w.NP + k) * 3;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if (w.base + i == x) {
          f[0] = L.c[i].M1;
          f[1] = L.c[i].I1;
          f[2] = L.c[i].D1;
        }
      }
    }
    w.cap_next = next_capture(w.dsum, w.n2s, w.R, w.row, w.S, w.NP, w.base,
                              LPT, t);
  }

  if (kDirs && (static_cast<unsigned>(t) & (kPer - 1)) == kPer - 1) {
    const int wd = t / kPer;
    uint32_t* dst = w.dst;
    if (w.lane0) {
      // Lane 0's word without lane P-1's D bits, into the wrap ring.
      wrap_put(w.wrap_out + 4 * (wd & (w.wrap - 1)), w.wrap_remote,
               L.acc[0]);
#pragma unroll
      for (int i = 1; i < LPT; ++i) dst[i] = L.acc[i];
    } else if (w.real) {
      if constexpr (LPT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < LPT; i += 4) {
          *reinterpret_cast<uint4*>(dst + i) =
              make_uint4(L.acc[i], L.acc[i + 1], L.acc[i + 2], L.acc[i + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < LPT; i += 2) {
          *reinterpret_cast<uint2*>(dst + i) =
              make_uint2(L.acc[i], L.acc[i + 1]);
        }
      }
    }
    w.dst += static_cast<size_t>(w.R) * w.P;
    // In a row of one warp lane 0's word was written in this step.
    if (w.one_warp) __syncwarp();
    if (w.tail) {
      dst[-w.base] = wrap_get(w.wrap_in + 4 * (wd & (w.wrap - 1))) | w.wacc;
    }
  }
  if (++w.p == w.S) w.p = 0;
}

// out: global mode, the (R*NP, 3) finals; the modes, bv then bd, each
// (NP, R, P).  sp: the row's split (stream_ring.cuh::stream_plan); block b
// holds CTA b % nctas of row b / nctas.  status: set when a wait stalls.
template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD>
__global__ void __maxnreg__(sa::ring_max_regs(LPT, MODE != sa::kModeGlobal))
    stream_ring_kernel(const int32_t* __restrict__ qstream,
                       const int32_t* __restrict__ dstream,
                       const int32_t* __restrict__ dsum,
                       const int32_t* __restrict__ n2s,
                       int32_t* __restrict__ out,
                       uint32_t* __restrict__ dirs, int32_t* status, int R,
                       int T, int P, int S, int NP, sa::Scheme sc,
                       sa::Split sp, Ring rg) {
  constexpr bool kModes = MODE != sa::kModeGlobal;
  constexpr bool kDirs = DIRS != sa::kDirsNone;
  constexpr int kPer = DIRS == sa::kDirsFast4 ? 8 : 4;  // steps a word
  __shared__ RingSmem sm;

  const bool cluster = sp.nctas > 1;
  int rank = 0;
  int row = blockIdx.x;
  if (cluster) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    row = blockIdx.x / sp.nctas;
  }
  const int j = threadIdx.x;
  const int warp = j >> 5;
  const int wl = j & 31;
  // Threads at or past nreal own no real lane; warps at or past nwarps
  // none at all.
  const int nreal = sa::cta_real_lanes(rank, sp, P) / LPT;
  const int nwarps = (nreal + 31) >> 5;
  const int cta0 = sa::cta_first_lane(rank, sp);
  const bool last_cta = rank == sp.nctas - 1;
  const bool last_warp = warp == nwarps - 1;

  if (j < sa::kRingMaxWarps) {
    sm.full[j] = 0;
    sm.freed[j] = 0;
  }
  if (j == 0) sm.wrap_freed = 0;
  if (cluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  if (warp < nwarps) {
    Sweep w;
    w.dsum = dsum;
    w.n2s = n2s;
    w.out = out;
    w.R = R;
    w.P = P;
    w.S = S;
    w.NP = NP;
    w.row = row;
    w.base = cta0 + j * LPT;
    w.wbase = cta0 + warp * 32 * LPT;
    w.wrap = rg.wrap;
    w.real = j < nreal;
    w.head = rank == 0 && warp == 0;  // holds lane 0
    w.tail = last_cta && j == nreal - 1;  // holds lane P-1
    w.lane0 = w.head && j == 0;
    w.one_warp = w.head && last_cta && last_warp;
    // The warp's last real thread feeds the next warp's ring (none after
    // the row's last warp), in the next CTA for the CTA's last warp; its
    // first thread reads its own (none at lane 0).
    w.producer = (last_warp ? j == nreal - 1 : wl == 31) &&
                 !(last_cta && last_warp);
    w.consumer = wl == 0 && !w.head;
    w.out_remote = last_warp && cluster;
    w.sc = sc;
    w.dst = dirs + static_cast<size_t>(row) * P + w.base;
    w.wrap_remote = cluster && !last_cta;
    w.wrap_in = smem_addr(sm.wrap);
    w.wrap_out = w.wrap_remote ? cluster_addr(w.wrap_in, sp.nctas - 1)
                               : w.wrap_in;
    w.p = 0;
    w.wacc = 0;
    w.tv = Turnover{0, -1, -1, out, R, row, P, NP, S};
    w.cap_next = kModes || !w.real
                     ? INT_MAX
                     : next_capture(dsum, n2s, R, row, S, NP, w.base, LPT,
                                    -1);

    Lanes<LPT> L;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      L.c[i] = sa::cell_init(kModes ? sa::kNegBig : sa::kNegInf);
      L.acc[i] = 0;
      L.bv[i] = sa::kNegBig;
      L.bd[i] = -S;  // a step of slot -1: diagonal 0 of the pair held first
      L.lo[i] = 0;
      L.len[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < Lanes<LPT>::kWords; ++i) L.s1d[i] = L.s2v[i] = 0;

    const size_t code_row = static_cast<size_t>(row) * T;
    const int C = rg.chunk;
    // The codes of the next chunk, one step a lane: the db code, and for
    // the warp holding lane 0 the query code above it.
    auto codes_at = [&](int t) {
      int32_t v = dstream[code_row + t];
      if (w.head) v |= qstream[code_row + t] << 8;
      return v;
    };
    int32_t next = wl < C && wl < T ? codes_at(wl) : 0;
    const int nxt_w = last_warp ? 0 : warp + 1;
    bool stalled = false;
    for (int t0 = 0, k = 0; t0 < T; t0 += C, ++k) {
      const int n = T - t0 < C ? T - t0 : C;
      const int words_end = (t0 + n) / kPer;  // words complete after it
      // The rings' counters (this warp's input: chunks published into it;
      // its output: chunks its consumer has read; lane 0's words read
      // back), named here rather than kept in registers across the chunk.
      const uint32_t in_full = smem_addr(&sm.full[warp]);
      const uint32_t out_freed = smem_addr(&sm.freed[warp]);
      const uint32_t wrap_freed_at = smem_addr(&sm.wrap_freed);
      bool bad = false;
      if (w.consumer) {
        bad = !sa::ring_wait(in_full, sa::ring_full_need(k), cluster, status);
      }
      if (w.producer) {
        bad |= !sa::ring_wait(out_freed, sa::ring_free_need(k, rg.slots),
                              cluster, status);
      }
      if (kDirs && w.lane0) {
        bad |= !sa::ring_wait(wrap_freed_at,
                              sa::wrap_free_need(words_end, rg.wrap),
                              cluster, status);
      }
      if (__any_sync(kFull, bad)) {
        stalled = true;
        break;
      }
      // What the first thread acquired (the ring, and through the chain
      // of rings lane 0's words in the wrap ring) for the rest of the warp.
      __syncwarp();
      w.codes = next;
      if (wl < C && t0 + C + wl < T) next = codes_at(t0 + C + wl);
      const uint32_t at = 16 * (k % rg.slots) * C;
      w.rin = smem_addr(sm.entry[warp]) + at;
      w.rout = smem_addr(sm.entry[nxt_w]) + at;
      if (w.out_remote && !last_cta) w.rout = cluster_addr(w.rout, rank + 1);
      // Two steps an iteration, so the state's registers trade roles
      // instead of being copied; local's larger cell leaves no registers
      // for that (measured slower).
      int e = 0;
      if constexpr (MODE != sa::kModeLocal) {
        for (; e + 1 < n; e += 2) {
          sweep_step<LPT, DIRS, MODE, COMPAT, WILDCARD>(w, L, t0 + e, e);
          sweep_step<LPT, DIRS, MODE, COMPAT, WILDCARD>(w, L, t0 + e + 1,
                                                        e + 1);
        }
      }
      for (; e < n; ++e) {
        sweep_step<LPT, DIRS, MODE, COMPAT, WILDCARD>(w, L, t0 + e, e);
      }
      // Order this chunk's wrap words (written by thread 0) before the
      // release of the producer thread.
      __syncwarp();
      if (w.consumer) {
        // The producer's count: the warp to the left, or the previous
        // CTA's last warp.
        uint32_t in_freed = smem_addr(&sm.freed[warp > 0 ? warp - 1 : 0]);
        if (warp == 0) {
          in_freed = cluster_addr(
              smem_addr(&sm.freed[sa::ring_warps(rank - 1, sp, P) - 1]),
              rank - 1);
        }
        sa::ring_release(in_freed, k + 1, cluster);
      }
      if (w.producer) {
        uint32_t out_full = smem_addr(&sm.full[nxt_w]);
        if (last_warp) out_full = cluster_addr(out_full, rank + 1);
        sa::ring_release(out_full, k + 1, cluster);
      }
      if (kDirs && w.tail) {
        const uint32_t at0 = smem_addr(&sm.wrap_freed);
        sa::ring_release(cluster ? cluster_addr(at0, 0) : at0, words_end,
                         cluster);
      }
    }
    if (kModes && w.real && !stalled) {
      // The last slot's pair, when it is real (T may end within its
      // window): lanes below S hold it, lanes at or past S never held an
      // eligible cell.  A lane right of the last step's p still holds the
      // older pair, whose steps count from the slot before.
      const int p_end = (T - 1) % S;
      const int slot = w.tv.slot;
      int32_t* at = argmax_at(out, slot, R, row, P, NP, w.base);
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        const int x = w.base + i;
        if (x < S) {
          flush_argmax(L, at, static_cast<size_t>(NP) * R * P, i,
                       (x <= p_end ? slot : slot - 1) * S);
        }
      }
    }
  }
  // Keep this CTA's shared memory alive until its neighbours are done.
  if (cluster) cg::this_cluster().sync();
}

typedef void (*FillKernel)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, int32_t*, uint32_t*, int32_t*, int,
                           int, int, int, int, sa::Scheme, sa::Split, Ring);

template <int LPT, int DIRS, int MODE>
FillKernel pick_flags(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? stream_ring_kernel<LPT, DIRS, MODE, true, true>
                    : stream_ring_kernel<LPT, DIRS, MODE, true, false>;
  }
  return wildcard ? stream_ring_kernel<LPT, DIRS, MODE, false, true>
                  : stream_ring_kernel<LPT, DIRS, MODE, false, false>;
}

template <int LPT>
FillKernel pick_global(int dirs_mode, bool compat, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_flags<LPT, sa::kDirsNone, sa::kModeGlobal>(compat,
                                                             wildcard);
    case sa::kDirsFast4:
      return pick_flags<LPT, sa::kDirsFast4, sa::kModeGlobal>(compat,
                                                              wildcard);
    case sa::kDirsFull:
      return pick_flags<LPT, sa::kDirsFull, sa::kModeGlobal>(compat,
                                                             wildcard);
    default:
      return nullptr;
  }
}

// The textbook modes: textbook scoring (compat false), dirs none or full.
template <int LPT, int MODE>
FillKernel pick_modes_dirs(int dirs_mode, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return wildcard ? stream_ring_kernel<LPT, sa::kDirsNone, MODE, false,
                                           true>
                      : stream_ring_kernel<LPT, sa::kDirsNone, MODE, false,
                                           false>;
    case sa::kDirsFull:
      return wildcard ? stream_ring_kernel<LPT, sa::kDirsFull, MODE, false,
                                           true>
                      : stream_ring_kernel<LPT, sa::kDirsFull, MODE, false,
                                           false>;
    default:
      return nullptr;
  }
}

template <int LPT>
FillKernel pick_textbook(int dirs_mode, bool local, bool wildcard) {
  return local ? pick_modes_dirs<LPT, sa::kModeLocal>(dirs_mode, wildcard)
               : pick_modes_dirs<LPT, sa::kModeSemi>(dirs_mode, wildcard);
}

// The instance for (lanes a thread, dirs, mode, flags); mode 0 global.
FillKernel pick(int lpt, int dirs_mode, int mode, bool compat,
                bool wildcard) {
  if (mode == sa::kModeGlobal) {
    switch (lpt) {
      case 2: return pick_global<2>(dirs_mode, compat, wildcard);
      case 4: return pick_global<4>(dirs_mode, compat, wildcard);
      case 8: return pick_global<8>(dirs_mode, compat, wildcard);
      case 16: return pick_global<16>(dirs_mode, compat, wildcard);
    }
    return nullptr;
  }
  const bool local = mode == sa::kModeLocal;
  switch (lpt) {
    case 2: return pick_textbook<2>(dirs_mode, local, wildcard);
    case 4: return pick_textbook<4>(dirs_mode, local, wildcard);
    case 8: return pick_textbook<8>(dirs_mode, local, wildcard);
    case 16: return pick_textbook<16>(dirs_mode, local, wildcard);
  }
  return nullptr;
}

int launch(int mode, const int32_t* qstream, const int32_t* dstream,
           const int32_t* dsum, const int32_t* n2, int32_t* out,
           uint32_t* dirs, int32_t* status, int R, int T, int P, int S,
           int NP, int match, int mismatch, int gap_open, int gap_extend,
           int dirs_mode, bool compat, bool wildcard, int cta_lanes, int lpt,
           int chunk, int slots, int wrap, void* stream) {
  sa::Split sp = sa::stream_plan(P, cta_lanes, mode != sa::kModeGlobal, lpt);
  Ring rg = sa::ring_shape(chunk, slots, wrap, mode != sa::kModeGlobal);
  if (sp.nctas == 0 || R <= 0 || T <= 0 || S <= 0 || NP <= 0 ||
      status == nullptr || !sa::ring_ok(rg)) {
    return -1;
  }
  FillKernel fn = pick(sp.lpt, dirs_mode, mode, compat, wildcard);
  if (fn == nullptr) return -1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  void* args[] = {&qstream, &dstream, &dsum, &n2, &out, &dirs, &status, &R,
                  &T,       &P,       &S,    &NP, &sc,  &sp,   &rg};
  return sa::launch_split(reinterpret_cast<const void*>(fn), sp, R, args,
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

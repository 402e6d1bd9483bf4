// The streamed fills' warp-ring kernel (device code), shared by the int32
// instances (nw_affine_stream.cu) and the int16 ones
// (nw_affine_stream_i16.cu): each source instantiates its own.
//
// One thread block per stream row up to 8192 lanes, past that one
// thread-block cluster per row (cluster_split.cuh's CTAs of 4096 or 8192
// lanes); each thread owns LPT consecutive lanes and keeps their scores in
// registers -- int32 state one lane a Cell, int16 state two lanes a Cell16
// word (stream_cell16.cuh) -- and their query and db codes packed 4 bits a
// lane; the lane shift inside a warp is a shuffle, and each warp sweeps the
// row at its own pace (stream_ring.cuh): its first lane's left neighbour
// arrives through a ring in shared memory that the warp to its left fills,
// a chunk of steps a slot.  Lane 0's words wait in a wrap ring for lane
// P-1's D bits (the torus of jnp.roll), added by the thread holding lane
// P-1.  See nw_affine_stream.cu for the contract and the design.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "cluster_split.cuh"
#include "nw_affine_stream.cuh"
#include "stream_cell16.cuh"
#include "stream_ring.cuh"

namespace sa {
namespace ring {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;

// A thread's lanes: their scores (int32: c[i] is lane i, its s1d and s2v
// unused; int16: c[j] holds lanes 2j and 2j + 1), query and db codes packed
// 4 bits a lane (lane i in word i / 8, bits 4 (i % 8): the query codes move
// a lane a step with one shift a word), direction words, and (the modes)
// running argmax and window of eligible steps.  acc[i] is lane i's
// direction word, but for int16 fast4: acc[j] holds pair j's codes of the
// word's current half of steps (push_code2) and acc[kCells + j] its first
// half, and at a word's end acc[i] is lane i's word until it is stored.
template <int LPT, bool I16>
struct Lanes {
  static constexpr int kWords = (LPT + 7) / 8;
  static constexpr int kCells = I16 ? LPT / 2 : LPT;
  std::conditional_t<I16, Cell16, Cell> c[kCells];
  uint32_t s1d[kWords], s2v[kWords];
  uint32_t acc[LPT];
  int32_t bv[LPT], bd[LPT];   // best score, its step
  int32_t lo[LPT], len[LPT];  // eligible steps: (unsigned)(t - lo) < len
};

// Lane i's M1, I1, D1 and H1 (int32 whatever the state).
template <int LPT>
__device__ __forceinline__ void lane_scores(const Lanes<LPT, false>& L, int i,
                                            int32_t& m, int32_t& ii,
                                            int32_t& d, int32_t& h) {
  m = L.c[i].M1;
  ii = L.c[i].I1;
  d = L.c[i].D1;
  h = L.c[i].H1;
}
template <int LPT>
__device__ __forceinline__ void lane_scores(const Lanes<LPT, true>& L, int i,
                                            int32_t& m, int32_t& ii,
                                            int32_t& d, int32_t& h) {
  const Cell16& c = L.c[i / 2];
  m = h2_get(c.M1, i & 1);
  ii = h2_get(c.I1, i & 1);
  d = h2_get(c.D1, i & 1);
  h = h2_get(c.H1, i & 1);
}

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
template <class L>
__device__ __forceinline__ void flush_argmax(const L& lanes, int32_t* at,
                                             size_t plane, int i,
                                             int32_t slot0) {
  if (at == nullptr) return;
  at[i] = lanes.bv[i];
  at[plane + i] = lanes.bd[i] - slot0;
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

// The modes' per-lane work after lane I's step: at x == p the lane turns
// over from the older pair to the younger (its argmax written out), then
// its running argmax takes the step's cell.
template <int I, int MODE, bool EP, class L>
__device__ __forceinline__ void lane_modes(L& lanes, int x, int t, int p,
                                           bool real, const Turnover& tv,
                                           int32_t m, int32_t h) {
  if constexpr (MODE != kModeGlobal) {
    if (EP && x == p && real) {
      flush_argmax(lanes,
                   argmax_at(tv.out, tv.slot - 1, tv.R, tv.row, tv.P, tv.NP,
                             x - I),
                   static_cast<size_t>(tv.NP) * tv.R * tv.P, I,
                   (tv.slot - 1) * tv.S);
      lanes.bv[I] = kNegBig;
      lanes.bd[I] = t - x;
      modes_window<MODE>(x, t, tv.n1, tv.n2, lanes.lo[I], lanes.len[I]);
    }
    modes_track<MODE>(t, lanes.lo[I], lanes.len[I], m, h, lanes.bv[I],
                      lanes.bd[I]);
  }
}

// Whether lane I's codes match: mx holds the codes' AND (wildcard: they
// intersect where non-zero) or XOR (they are equal where zero).
template <int I, int LPT, bool WILDCARD>
__device__ __forceinline__ bool lane_eq(const uint32_t (&mx)[(LPT + 7) / 8]) {
  const uint32_t m = mx[I / 8] >> 4 * (I % 8) & 15;
  return WILDCARD ? m != 0 : m == 0;
}

// Lane I of one step of a thread's int32 lanes, then lanes I-1 .. 0: right
// to left, so lane i-1 still holds its pre-step state for lane i (a
// recursion rather than a loop, so the lanes stay in registers: the
// compiler does not always unroll that loop).  mine: lane I's ring_pre,
// computed by the lane to its right; lane I computes lane I-1's.  mx: the
// lanes' codes matched (the step's, in place).  lH / lD / lflag: what the
// lane left of lane 0 handed over.  EP: this thread's warp holds lane p;
// lane0: this thread holds lane 0.
template <int I, int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD,
          bool EP>
__device__ __forceinline__ void ring_lanes(
    Lanes<LPT, false>& L, const Pre& mine,
    const uint32_t (&mx)[(LPT + 7) / 8], int32_t lH, int32_t lD,
    int32_t lflag, int t, int p, int base, bool real, bool lane0,
    const Turnover& tv, const Scheme& sc) {
  const int x = base + I;
  int32_t lh, ld, lf;
  Pre left;
  if constexpr (I == 0) {
    lh = lH;
    ld = lD;
    lf = lflag;
  } else {
    left = ring_pre<DIRS>(L.c[I - 1], sc);
    lh = L.c[I - 1].H2;
    ld = left.dsel;
    lf = left.dflag;
  }
  const int32_t code = ring_cell<DIRS, MODE, COMPAT, EP, I == 0>(
      L.c[I], mine, lh, ld, lf, lane_eq<I, LPT, WILDCARD>(mx), lane0,
      x == p, p, sc);
  if constexpr (DIRS != kDirsNone) {
    L.acc[I] = push_code<DIRS>(L.acc[I], code);
  }
  lane_modes<I, MODE, EP>(L, x, t, p, real, tv, L.c[I].M1, L.c[I].H1);
  if constexpr (I > 0) {
    ring_lanes<I - 1, LPT, DIRS, MODE, COMPAT, WILDCARD, EP>(
        L, left, mx, lH, lD, lflag, t, p, base, real, lane0, tv, sc);
  }
}

// Word J (lanes 2J, 2J + 1) of one step of a thread's int16 lanes, then
// words J-1 .. 0, as ring_lanes.  mine: word J's ring_pre16; lHD: the H2
// (low half) and merged D source (high half) of the lane left of lane 0,
// lcode its D bits as the high half of a dcode (dflag_word).  The word's
// codes go into its pair's accumulator acc[J] (fast4) or its lanes' words
// acc[I], acc[I + 1] (full).
template <int J, int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD,
          bool EP>
__device__ __forceinline__ void ring_words(
    Lanes<LPT, true>& L, const Pre16& mine,
    const uint32_t (&mx)[(LPT + 7) / 8], uint32_t lHD, uint32_t lcode, int t,
    int p, int base, bool real, bool lane0, const Turnover& tv,
    const Scheme16& sc) {
  constexpr int I = 2 * J;
  const int x = base + I;
  uint32_t lh, ld, lc;
  Pre16 left;
  if constexpr (J == 0) {
    lh = h2_los(lHD, L.c[0].H2);
    ld = h2_left(lHD, mine.dsel);
    lc = h2_left(lcode, mine.dcode);
  } else {
    left = ring_pre16<DIRS>(L.c[J - 1], sc);
    lh = h2_left(L.c[J - 1].H2, L.c[J].H2);
    ld = h2_left(left.dsel, mine.dsel);
    lc = h2_left(left.dcode, mine.dcode);
  }
  const uint32_t sub2 = h2_sub2<WILDCARD, (I % 8) / 2>(mx[I / 8], sc.s);
  const int ph = x == p ? 0 : x + 1 == p ? 1 : -1;
  const uint32_t code = ring_word16<DIRS, MODE, COMPAT, EP, J == 0>(
      L.c[J], mine, lh, ld, lc, sub2, lane0, ph, p, sc);
  if constexpr (DIRS == kDirsFast4) {
    L.acc[J] = push_code2(L.acc[J], code);
  } else if constexpr (DIRS == kDirsFull) {
    push_full2(L.acc[I], L.acc[I + 1], code);
  }
  if constexpr (MODE != kModeGlobal) {
    const Cell16& c = L.c[J];
    lane_modes<I + 1, MODE, EP>(L, x + 1, t, p, real, tv, h2_hi(c.M1),
                                h2_hi(c.H1));
    lane_modes<I, MODE, EP>(L, x, t, p, real, tv, h2_lo(c.M1), h2_lo(c.H1));
  }
  if constexpr (J > 0) {
    ring_words<J - 1, LPT, DIRS, MODE, COMPAT, WILDCARD, EP>(
        L, left, mx, lHD, lcode, t, p, base, real, lane0, tv, sc);
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
  Scheme16 sc;       // the scheme (sc.s), and for int16 state its packing
  uint32_t* dst;  // this thread's lanes in the next direction word
  int p, cap_next;
  uint32_t wacc;
  Turnover tv;
  int32_t codes;      // the chunk's db code | query code << 8, a step a lane
  uint32_t rin, rout; // the chunk's ring entries (16 bytes a step)
};

// An int16 fast4 thread's pairs at a direction word's middle step: each
// accumulator's half word set aside in acc[kCells + j], the accumulator
// cleared.
template <int LPT, bool I16>
__device__ __forceinline__ void stash_half(Lanes<LPT, I16>& L) {
  if constexpr (I16) {
    constexpr int kCells = Lanes<LPT, true>::kCells;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      L.acc[kCells + j] = L.acc[j];
      L.acc[j] = 0;
    }
  }
}

// The thread's lanes' direction words at a word's last step t: lane 0's
// into the wrap ring (the tail thread adds lane P-1's D bits and stores
// it), the others to dirs.  int16 fast4: first each pair's two half words
// split into its lanes' words, acc[i] lane i's until stored, and the
// accumulators cleared after.
template <int LPT, int DIRS, bool I16>
__device__ __forceinline__ void store_word(Sweep& w, Lanes<LPT, I16>& L,
                                           int t) {
  constexpr int kPer = DIRS == kDirsFast4 ? 8 : 4;  // steps a word
  constexpr bool kHalves = I16 && DIRS == kDirsFast4;
  const int wd = t / kPer;
  uint32_t* dst = w.dst;
  if constexpr (kHalves) {
    constexpr int kCells = Lanes<LPT, true>::kCells;
    uint32_t lo[kCells], hi[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      split_codes(L.acc[kCells + j], L.acc[j], lo[j], hi[j]);
    }
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      L.acc[2 * j] = lo[j];
      L.acc[2 * j + 1] = hi[j];
    }
  }
  if (w.lane0) {
    // Lane 0's word without lane P-1's D bits, into the wrap ring.
    wrap_put(w.wrap_out + 4 * (wd & (w.wrap - 1)), w.wrap_remote, L.acc[0]);
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
  if constexpr (kHalves) {
#pragma unroll
    for (int j = 0; j < Lanes<LPT, true>::kCells; ++j) L.acc[j] = 0;
  }
}

// Step t (entry e of its chunk) of a thread's lanes.
template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD, bool I16>
__device__ __forceinline__ void sweep_step(Sweep& w, Lanes<LPT, I16>& L,
                                           int t, int e) {
  constexpr bool kModes = MODE != kModeGlobal;
  constexpr bool kDirs = DIRS != kDirsNone;
  constexpr int kPer = DIRS == kDirsFast4 ? 8 : 4;  // steps a word
  if (kModes && w.p == 0) {
    const int k = t / w.S;
    w.tv.slot = k;
    w.tv.n2 = k < w.NP ? w.n2s[k * w.R + w.row] : -1;
    w.tv.n1 = k < w.NP ? w.dsum[k * w.R + w.row] - w.tv.n2 : -1;
  }
  int4 left = make_int4(0, 0, 0, 0);
  if (w.consumer) left = ring_get(w.rin + 16 * e);
  // Hand this thread's last lane to the next thread and warp: int32 its H2
  // and merged D source, int16 both in one word.
  constexpr int kI = LPT - 1;
  constexpr int kJ = LPT / 2 - 1;
  int32_t nH, nD = 0, lastflag;
  std::conditional_t<I16, Pre16, Pre> last;
  if constexpr (I16) {
    last = ring_pre16<DIRS>(L.c[kJ], w.sc);
    nH = static_cast<int32_t>(h2_his(L.c[kJ].H2, last.dsel));
    lastflag = dflag_hi<DIRS>(last.dcode);
  } else {
    last = ring_pre<DIRS>(L.c[kI], w.sc.s);
    nH = L.c[kI].H2;
    nD = last.dsel;
    lastflag = last.dflag;
  }
  const int32_t nS = ring_pack(
      static_cast<int32_t>(L.s1d[kI / 8] >> 4 * (kI % 8) & 15), lastflag);
  if (w.producer) ring_put(w.rout + 16 * e, w.out_remote, nH, nD, nS);
  if (kDirs) w.wacc = push_code<DIRS>(w.wacc, lastflag);
  int32_t lH = __shfl_up_sync(kFull, nH, 1);
  int32_t lD = 0;
  if constexpr (!I16) lD = __shfl_up_sync(kFull, nD, 1);
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
  shift_codes<LPT>(L.s1d, ring_s1d(lS));
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
  uint32_t mx[Lanes<LPT, I16>::kWords];
#pragma unroll
  for (int i = 0; i < Lanes<LPT, I16>::kWords; ++i) {
    mx[i] = WILDCARD ? L.s1d[i] & L.s2v[i] : L.s1d[i] ^ L.s2v[i];
  }
  const int32_t lflag = ring_dflag(lS);
  if constexpr (I16) {
    const uint32_t lHD = static_cast<uint32_t>(lH);
    const uint32_t lcode = dflag_word<DIRS>(lflag);
    if (has_p) {
      ring_words<kJ, LPT, DIRS, MODE, COMPAT, WILDCARD, true>(
          L, last, mx, lHD, lcode, t, p, w.base, w.real, w.lane0, w.tv,
          w.sc);
    } else {
      ring_words<kJ, LPT, DIRS, MODE, COMPAT, WILDCARD, false>(
          L, last, mx, lHD, lcode, t, p, w.base, w.real, w.lane0, w.tv,
          w.sc);
    }
  } else {
    if (has_p) {
      ring_lanes<kI, LPT, DIRS, MODE, COMPAT, WILDCARD, true>(
          L, last, mx, lH, lD, lflag, t, p, w.base, w.real, w.lane0, w.tv,
          w.sc.s);
    } else {
      ring_lanes<kI, LPT, DIRS, MODE, COMPAT, WILDCARD, false>(
          L, last, mx, lH, lD, lflag, t, p, w.base, w.real, w.lane0, w.tv,
          w.sc.s);
    }
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
          int32_t h;
          lane_scores(L, i, f[0], f[1], f[2], h);
        }
      }
    }
    w.cap_next = next_capture(w.dsum, w.n2s, w.R, w.row, w.S, w.NP, w.base,
                              LPT, t);
  }

  // The int16 fast4 pairs' accumulators hold half a direction word: the
  // branch below also runs at a word's middle step, where it sets the
  // first half aside (a branch every 4 steps, rather than selects every
  // step).
  constexpr bool kHalves = I16 && DIRS == kDirsFast4;
  constexpr unsigned kEnd = kHalves ? kPer / 2 - 1 : kPer - 1;
  if (kDirs && (static_cast<unsigned>(t) & kEnd) == kEnd) {
    if (kHalves && (static_cast<unsigned>(t) & (kPer / 2)) == 0) {
      stash_half(L);
    } else {
      store_word<LPT, DIRS, I16>(w, L, t);
    }
  }
  if (++w.p == w.S) w.p = 0;
}

// The kernel's body.  out: global mode, the (R*NP, 3) finals; the modes, bv
// then bd, each (NP, R, P).  sp: the row's split (stream_ring.cuh::
// stream_plan); block b holds CTA b % nctas of row b / nctas.  status: set
// when a wait stalls.  neg: the int16 state's sentinel (unused for int32).
template <int LPT, int DIRS, int MODE, bool COMPAT, bool WILDCARD, bool I16>
__device__ __forceinline__ void stream_ring_body(
    const int32_t* __restrict__ qstream, const int32_t* __restrict__ dstream,
    const int32_t* __restrict__ dsum, const int32_t* __restrict__ n2s,
    int32_t* __restrict__ out, uint32_t* __restrict__ dirs, int32_t* status,
    int R, int T, int P, int S, int NP, Scheme sc, int32_t neg, Split sp,
    RingShape rg) {
  constexpr bool kModes = MODE != kModeGlobal;
  constexpr bool kDirs = DIRS != kDirsNone;
  constexpr int kPer = DIRS == kDirsFast4 ? 8 : 4;  // steps a word
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
  const int nreal = cta_real_lanes(rank, sp, P) / LPT;
  const int nwarps = (nreal + 31) >> 5;
  const int cta0 = cta_first_lane(rank, sp);
  const bool last_cta = rank == sp.nctas - 1;
  const bool last_warp = warp == nwarps - 1;

  if (j < kRingMaxWarps) {
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
    w.sc = scheme16(sc, neg);
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

    Lanes<LPT, I16> L;
#pragma unroll
    for (int i = 0; i < Lanes<LPT, I16>::kCells; ++i) {
      if constexpr (I16) {
        L.c[i] = cell16_init(neg);
      } else {
        L.c[i] = cell_init(kModes ? kNegBig : kNegInf);
      }
    }
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      L.acc[i] = 0;
      L.bv[i] = kNegBig;
      L.bd[i] = -S;  // a step of slot -1: diagonal 0 of the pair held first
      L.lo[i] = 0;
      L.len[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < Lanes<LPT, I16>::kWords; ++i) L.s1d[i] = L.s2v[i] = 0;

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
        bad = !ring_wait(in_full, ring_full_need(k), cluster, status);
      }
      if (w.producer) {
        bad |= !ring_wait(out_freed, ring_free_need(k, rg.slots), cluster,
                          status);
      }
      if (kDirs && w.lane0) {
        bad |= !ring_wait(wrap_freed_at, wrap_free_need(words_end, rg.wrap),
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
      if constexpr (MODE != kModeLocal) {
        for (; e + 1 < n; e += 2) {
          sweep_step<LPT, DIRS, MODE, COMPAT, WILDCARD, I16>(w, L, t0 + e,
                                                             e);
          sweep_step<LPT, DIRS, MODE, COMPAT, WILDCARD, I16>(
              w, L, t0 + e + 1, e + 1);
        }
      }
      for (; e < n; ++e) {
        sweep_step<LPT, DIRS, MODE, COMPAT, WILDCARD, I16>(w, L, t0 + e, e);
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
              smem_addr(&sm.freed[ring_warps(rank - 1, sp, P) - 1]),
              rank - 1);
        }
        ring_release(in_freed, k + 1, cluster);
      }
      if (w.producer) {
        uint32_t out_full = smem_addr(&sm.full[nxt_w]);
        if (last_warp) out_full = cluster_addr(out_full, rank + 1);
        ring_release(out_full, k + 1, cluster);
      }
      if (kDirs && w.tail) {
        const uint32_t at0 = smem_addr(&sm.wrap_freed);
        ring_release(cluster ? cluster_addr(at0, 0) : at0, words_end,
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
                           int, int, int, int, Scheme, int32_t, Split,
                           RingShape);

// The instance for (lanes a thread, dirs, mode, flags) of a kernel family
// K<LPT, DIRS, MODE, COMPAT, WILDCARD>::fn() (the instance's address): the global
// fill takes dirs none, fast4 or full with compat either way; the textbook
// modes (compat false) none or full.  nullptr for anything else.
template <template <int, int, int, bool, bool> class K>
struct Pick {
  template <int LPT, int DIRS, int MODE>
  static FillKernel flags(bool compat, bool wildcard) {
    if (compat) {
      return wildcard ? K<LPT, DIRS, MODE, true, true>::fn()
                      : K<LPT, DIRS, MODE, true, false>::fn();
    }
    return wildcard ? K<LPT, DIRS, MODE, false, true>::fn()
                    : K<LPT, DIRS, MODE, false, false>::fn();
  }

  template <int LPT>
  static FillKernel global(int dirs_mode, bool compat, bool wildcard) {
    switch (dirs_mode) {
      case kDirsNone:
        return flags<LPT, kDirsNone, kModeGlobal>(compat, wildcard);
      case kDirsFast4:
        return flags<LPT, kDirsFast4, kModeGlobal>(compat, wildcard);
      case kDirsFull:
        return flags<LPT, kDirsFull, kModeGlobal>(compat, wildcard);
      default:
        return nullptr;
    }
  }

  template <int LPT, int MODE>
  static FillKernel modes(int dirs_mode, bool wildcard) {
    switch (dirs_mode) {
      case kDirsNone:
        return wildcard ? K<LPT, kDirsNone, MODE, false, true>::fn()
                        : K<LPT, kDirsNone, MODE, false, false>::fn();
      case kDirsFull:
        return wildcard ? K<LPT, kDirsFull, MODE, false, true>::fn()
                        : K<LPT, kDirsFull, MODE, false, false>::fn();
      default:
        return nullptr;
    }
  }

  template <int LPT>
  static FillKernel any(int dirs_mode, int mode, bool compat, bool wildcard) {
    if (mode == kModeGlobal) return global<LPT>(dirs_mode, compat, wildcard);
    return mode == kModeLocal ? modes<LPT, kModeLocal>(dirs_mode, wildcard)
                              : modes<LPT, kModeSemi>(dirs_mode, wildcard);
  }

  static FillKernel pick(int lpt, int dirs_mode, int mode, bool compat,
                         bool wildcard) {
    switch (lpt) {
      case 2: return any<2>(dirs_mode, mode, compat, wildcard);
      case 4: return any<4>(dirs_mode, mode, compat, wildcard);
      case 8: return any<8>(dirs_mode, mode, compat, wildcard);
      case 16: return any<16>(dirs_mode, mode, compat, wildcard);
    }
    return nullptr;
  }
};

// Launches instance K of the streamed fill (mode: kModeGlobal, kModeSemi or
// kModeLocal) on a row split and rings planned as the wrappers plan them;
// -1 for an unsupported shape or mode.
template <template <int, int, int, bool, bool> class K>
int launch_fill(int mode, const int32_t* qstream, const int32_t* dstream,
                const int32_t* dsum, const int32_t* n2, int32_t* out,
                uint32_t* dirs, int32_t* status, int R, int T, int P, int S,
                int NP, const Scheme& sc, int32_t neg, int dirs_mode,
                bool compat, bool wildcard, int cta_lanes, int lpt, int chunk,
                int slots, int wrap, void* stream) {
  Split sp = stream_plan(P, cta_lanes, mode != kModeGlobal, lpt);
  RingShape rg = ring_shape(chunk, slots, wrap, mode != kModeGlobal);
  if (sp.nctas == 0 || R <= 0 || T <= 0 || S <= 0 || NP <= 0 ||
      status == nullptr || !ring_ok(rg)) {
    return -1;
  }
  FillKernel fn = Pick<K>::pick(sp.lpt, dirs_mode, mode, compat, wildcard);
  if (fn == nullptr) return -1;
  Scheme s = sc;
  void* args[] = {&qstream, &dstream, &dsum, &n2, &out, &dirs, &status, &R,
                  &T,       &P,       &S,    &NP, &s,   &neg,  &sp,     &rg};
  return launch_split(reinterpret_cast<const void*>(fn), sp, R, args,
                      stream);
}

}  // namespace ring
}  // namespace sa

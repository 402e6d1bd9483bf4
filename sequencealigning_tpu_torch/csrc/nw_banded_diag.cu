// Banded Gotoh fill over anti-diagonal wavefronts for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/nw_banded_diag.py::_diag_kernel (launched by
// banded_diag_fill_pallas).  Same contract as _banded_diag_lax: lane l of
// wavefront a holds diagonal k = k_lo_even + 2l + (a & 1); each iteration
// runs wavefronts 2i+1 (odd: D and the query window read lane l+1) and 2i+2
// (even: I and the db window read lane l-1), with the entering characters
// c1s[b, i] / c2s[b, i].  Each pair's M/I/D at its corner (n2, n1) is
// written by the lane that holds it (zero when the corner is never reached,
// as the lax capture's sum over a hit mask gives).  Direction codes keyed by
// aidx = a - 1: fast4 nibble aidx & 7 of word dirs[aidx >> 3, b, l], full
// byte aidx & 3 of word dirs[aidx >> 2, b, l]; ceil(2 n_iters / upack)
// words.
//
// What bounds it on this card: the integer work of the recurrence (the
// function's least is 20 operations a band cell in fast4, 26 in full), and,
// for a few pairs, how many of the 132 SMs one pair's band can keep busy: a
// wavefront's lanes depend on both neighbours' previous wavefront, so one
// CTA a pair leaves the card idle for a batch of a few pairs, and a pair
// split over a cluster pays a cluster barrier every wavefront.
//
// Design: one tiled route for every band width and batch
// (nw_banded_diag.cuh, "The tile schedule").  A pair's lanes are cut into
// strips of W lanes and its iterations into blocks of T; tile (tau, b, s)
// computes strip s of pair b over block tau, plus a halo of T lanes (up to
// a multiple of 8) on each side, from the lanes' state at the block's start
// (global memory, two buffers by block parity, 16 bytes a lane: M, I, D and
// the H two wavefronts back; H one back is max(M, I, D) and the character
// windows are re-read from the inputs), and keeps only its own lanes' codes,
// finals and end state: the halo's cone of wrong values shrinks one lane a
// side an iteration and never reaches them.  Tiles are handed out by a
// global ticket, block-major, over a persistent grid; a tile waits (acquire
// loads by one thread) until strips s - 1 .. s + 1 of its pair have
// published block tau - 1 (a release store), so every wait is on an
// earlier ticket held by a running CTA and no barrier spans CTAs, however
// many tiles a launch has.  A wait that makes no progress for kSpinLimit
// polls sets the launch's status word and the wrapper raises.  A pair whose
// band fits one CTA in a batch that fills the card is one tile of all its
// iterations (no halo, no hand-over).  Inside a tile a CTA holds LPT
// consecutive lanes a thread in registers; a wavefront's neighbour values
// cross threads by shuffle and warps through shared memory (one barrier a
// wavefront, none for a one-warp CTA).  The cell (nw_banded_diag.cuh) takes
// the DPX instructions and the characters packed 4 bits a lane (one XOR or
// AND a thread, a mask and a compare a lane); band_cell's x = 0 / y = 0
// boundary tests and valid mask run only in the chunks of 4 iterations that
// can hold such cells (band_chunk_mode).  Each thread packs 8 (fast4) or 4
// (full) wavefronts of its lanes in registers and stores them as one
// coalesced store into its lanes of the (Aw, B, L) dirs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "nw_banded_diag.cuh"

namespace {

constexpr int kCharChunk = 128;  // iterations of entering characters staged
constexpr int kStage = kCharChunk / 32;  // staged a thread at most
constexpr unsigned kPollNs = 32;  // sleep between polls of a hand-over
constexpr int kMaxWarps = 16;

// Threads a CTA at most at LPT lanes a thread (8 lanes keep ~100 registers
// a thread).
template <int LPT>
constexpr int max_threads() {
  return LPT == 8 ? 256 : 512;
}

// The launch's counters (one zeroed int32 tensor): [0] the ticket, [1] the
// status word, [2, 2 + 8B) the SMs that ran each pair's tiles (bitmaps),
// then per strip (b * S + s) the blocks it has published.
struct Counters {
  int32_t* ticket;
  int32_t* status;
  uint32_t* sms;
  int32_t* done;
};

__device__ __forceinline__ Counters counters(int32_t* ctr, int B) {
  Counters c;
  c.ticket = ctr;
  c.status = ctr + 1;
  c.sms = reinterpret_cast<uint32_t*>(ctr + 2);
  c.done = ctr + 2 + B * sa::kSmWords;
  return c;
}

// A thread's LPT lanes: M/I/D one wavefront back, the H arrays of two and
// one wavefronts back (swapping roles every wavefront instead of being
// copied: an odd wavefront writes its H into Ha, an even one into Hb), the
// packed direction words, and the character windows packed 4 bits a lane.
template <int LPT>
struct Lanes {
  int32_t M1[LPT], I1[LPT], D1[LPT], Ha[LPT], Hb[LPT];
  uint32_t acc[LPT];
  uint32_t s1, s2;
};

// Hands the neighbouring thread this thread's values at its edge lane and
// returns the other neighbour's: on an odd wavefront (lane l reads l+1)
// the first lane's go to thread j-1, on an even one the last lane's to
// thread j+1.  A shuffle inside a warp, shared memory at warp edges
// (buffered by parity: one barrier a wavefront, none in a one-warp CTA).
template <int PAR>
__device__ __forceinline__ void band_shift(
    int32_t (&edge)[2][3][kMaxWarps], int j, int nwarps, int32_t& o,
    int32_t& g, int32_t& c) {
  const int warp = j >> 5;
  const int wl = j & 31;
  const int32_t eo = o, eg = g, ec = c;
  if (PAR == 1) {
    o = __shfl_down_sync(0xffffffffu, eo, 1);
    g = __shfl_down_sync(0xffffffffu, eg, 1);
    c = __shfl_down_sync(0xffffffffu, ec, 1);
  } else {
    o = __shfl_up_sync(0xffffffffu, eo, 1);
    g = __shfl_up_sync(0xffffffffu, eg, 1);
    c = __shfl_up_sync(0xffffffffu, ec, 1);
  }
  if (nwarps > 1) {
    if (wl == (PAR == 1 ? 0 : 31)) {
      edge[PAR][0][warp] = eo;
      edge[PAR][1][warp] = eg;
      edge[PAR][2][warp] = ec;
    }
    __syncthreads();
    const int from = PAR == 1 ? warp + 1 : warp - 1;
    if (wl == (PAR == 1 ? 31 : 0) && from >= 0 && from < nwarps) {
      o = edge[PAR][0][from];
      g = edge[PAR][1][from];
      c = edge[PAR][2][from];
    }
  }
}

// What a step needs beyond the thread's lanes.
struct StepArgs {
  int j, nwarps, lane0;
  bool left_end, right_end;  // the thread holds the tile's first / last lane
  int he, lim1, lim0;
  int32_t n1, n2;
  bool compat;
  sa::Scheme sc;
};

// Wavefront a of parity PAR for a thread's lanes, with the cell MODE
// (nw_banded_diag.cuh::band_chunk_mode); enter: the character entering the
// tile's end lane.  ORs each lane's direction code, shifted by `shift`,
// into its word.
template <int LPT, int PAR, int MODE, int DIRS, bool WILDCARD, bool STD>
__device__ __forceinline__ void band_step(Lanes<LPT>& st,
                                          int32_t (&edge)[2][3][kMaxWarps],
                                          const StepArgs& p, int a,
                                          int32_t enter, uint32_t shift) {
  int32_t(&H2)[LPT] = PAR == 1 ? st.Ha : st.Hb;
  const int32_t(&H1)[LPT] = PAR == 1 ? st.Hb : st.Ha;
  const sa::Scheme& sc = p.sc;
  int32_t op[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) op[i] = (STD ? H1[i] : st.M1[i]) + sc.gap_open;
  // The neighbour lane's pre-step values: the gap-open source, the gap
  // plane (D on odd wavefronts, I on even ones), the moving window.
  int32_t no = PAR == 1 ? op[0] : op[LPT - 1];
  int32_t ng = PAR == 1 ? st.D1[0] : st.I1[LPT - 1];
  int32_t nc = PAR == 1 ? static_cast<int32_t>(st.s1 & 0xfu)
                        : static_cast<int32_t>((st.s2 >> (4 * (LPT - 1))) &
                                               0xfu);
  band_shift<PAR>(edge, p.j, p.nwarps, no, ng, nc);
  if (PAR == 1 ? p.right_end : p.left_end) {
    // The tile's end lane: the band's edge rule (its halo's are discarded).
    no = sa::kNegBig;
    ng = sa::kNegBig;
    nc = enter & 0xf;
  }
  int32_t nbo[LPT], nbg[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    if (PAR == 1) {
      nbo[i] = i + 1 < LPT ? op[i + 1] : no;
      nbg[i] = i + 1 < LPT ? st.D1[i + 1] : ng;
    } else {
      nbo[i] = i > 0 ? op[i - 1] : no;
      nbg[i] = i > 0 ? st.I1[i - 1] : ng;
    }
  }
  if (PAR == 1) {
    st.s1 = (st.s1 >> 4) | (static_cast<uint32_t>(nc) << (4 * (LPT - 1)));
  } else {
    st.s2 = (st.s2 << 4) | static_cast<uint32_t>(nc);
  }
  const uint32_t cmp = sa::band_cmp<WILDCARD>(st.s1, st.s2);
  const int q = (a - PAR) / 2 - p.he;
  const int lim = PAR == 1 ? p.lim1 : p.lim0;
  int vlo = 0, vhi = 0;
  if (MODE == sa::kBandMasked) {
    sa::band_valid_lanes(a, q, p.n1, p.n2, lim, vlo, vhi);
  }
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int l = p.lane0 + i;
    int32_t code;
    if (MODE == sa::kBandRamp) {
      sa::BandCell c;
      c.M1 = st.M1[i];
      c.I1 = st.I1[i];
      c.D1 = st.D1[i];
      c.H1 = H1[i];
      c.H2 = H2[i];
      c.s1w = static_cast<int32_t>((st.s1 >> (4 * i)) & 0xfu);
      c.s2w = static_cast<int32_t>((st.s2 >> (4 * i)) & 0xfu);
      const int32_t xv = q - l;
      code = sa::band_cell<PAR, DIRS, WILDCARD, STD>(
          c, nbo[i], nbg[i], PAR == 1 ? c.s1w : c.s2w, xv, a - xv, l <= lim,
          p.n1, p.n2, p.compat, sc);
      st.M1[i] = c.M1;
      st.I1[i] = c.I1;
      st.D1[i] = c.D1;
      H2[i] = c.H1;
    } else {
      const bool eq = sa::band_eq<WILDCARD>(cmp, i);
      const bool valid = MODE == sa::kBandLean || (l >= vlo && l <= vhi);
      int32_t H;
      if (PAR == 1) {
        code = sa::lean_cell<DIRS, MODE == sa::kBandMasked>(
            H2[i], eq, op[i], st.I1[i], nbo[i], nbg[i], valid, sc, st.M1[i],
            st.I1[i], st.D1[i], H);
      } else {
        code = sa::lean_cell<DIRS, MODE == sa::kBandMasked>(
            H2[i], eq, nbo[i], nbg[i], op[i], st.D1[i], valid, sc, st.M1[i],
            st.I1[i], st.D1[i], H);
      }
      H2[i] = H;
    }
    if (DIRS != sa::kDirsNone) st.acc[i] |= static_cast<uint32_t>(code) << shift;
  }
}

// s1w0/s2w0: (B, L) int32 windows; c1s/c2s: (B, n_iters) int32 entering
// characters; n1v/n2v: (B,) lengths; finals: (B, 3) int32, zeroed by the
// caller; dirs: (Aw, B, L) u32; state: (2, B, L) lanes of 16 bytes (unused
// for one block); ctr: the zeroed counters.  lim1/lim0: the last lane
// inside the effective band on odd / even wavefronts; g: the tiles.
template <int LPT, int DIRS, bool WILDCARD, bool STD>
__global__ void __launch_bounds__(max_threads<LPT>())
    banded_tile_kernel(const int32_t* __restrict__ s1w0,
                       const int32_t* __restrict__ s2w0,
                       const int32_t* __restrict__ c1s,
                       const int32_t* __restrict__ c2s,
                       const int32_t* __restrict__ n1v,
                       const int32_t* __restrict__ n2v,
                       int32_t* __restrict__ finals,
                       uint32_t* __restrict__ dirs, int4* state,
                       int32_t* ctr, int B, int L, int n_iters, int he,
                       int lim1, int lim0, int compat, sa::Scheme sc,
                       sa::BandTiles g) {
  constexpr int kUp = DIRS == sa::kDirsFast4 ? 8 : 4;  // wavefronts a word
  __shared__ int32_t e1[kCharChunk];  // entering the tile's last lane
  __shared__ int32_t e2[kCharChunk];  // entering its first lane
  __shared__ int32_t edge[2][3][kMaxWarps];
  __shared__ int ticket_sm;

  const Counters ct = counters(ctr, B);
  const int j = threadIdx.x;
  const int nthr = blockDim.x;
  const int rows = sa::band_rows(g, n_iters);
  const int ntiles = rows * B * g.S;
  const int last_aidx = 2 * n_iters - 1;
  // A ticket, or ntiles (none) once the launch's status is set.
  auto take = [&]() {
    const bool stop = *reinterpret_cast<volatile int32_t*>(ct.status);
    return stop ? ntiles : atomicAdd(ct.ticket, 1);
  };
  if (j == 0) ticket_sm = take();
  __syncthreads();
  int ticket = ticket_sm;

  for (;;) {
    if (ticket >= ntiles) return;
    const sa::BandTile t = sa::band_tile(ticket, g, B, L, n_iters);
    const int32_t n1 = n1v[t.b];
    const int32_t n2 = n2v[t.b];
    int32_t* done = ct.done + t.b * g.S;
    const int32_t* s1r = s1w0 + static_cast<size_t>(t.b) * L;
    const int32_t* s2r = s2w0 + static_cast<size_t>(t.b) * L;
    const int32_t* c1r = c1s + static_cast<size_t>(t.b) * n_iters;
    const int32_t* c2r = c2s + static_cast<size_t>(t.b) * n_iters;
    // The characters entering the tile's end lanes over the chunk of
    // iterations from it: loaded into registers, then stored in e1 / e2
    // (up to kStage a thread).
    int32_t ch1[kStage], ch2[kStage];
    auto load_chars = [&](int it) {
#pragma unroll
      for (int r = 0; r < kStage; ++r) {
        const int k = j + r * nthr;
        const int i = t.i0 + it + k;
        const bool in = k < kCharChunk && it + k < t.nit;
        ch1[r] = in ? sa::band_s1(s1r, c1r, L, t.hi + i) : 0;
        ch2[r] = in ? sa::band_s2(s2r, c2r, t.lo - i - 1) : 0;
      }
    };
    auto store_chars = [&]() {
#pragma unroll
      for (int r = 0; r < kStage; ++r) {
        const int k = j + r * nthr;
        if (k < kCharChunk) {
          e1[k] = ch1[r];
          e2[k] = ch2[r];
        }
      }
    };
    load_chars(0);
    // The next ticket, taken while this tile runs.
    int next = 0;
    if (j == 0) {
      next = take();
      sa::mark_sm(ct.sms + t.b * sa::kSmWords);
    }
    // Threads 0-2 wait, at once, for strips s - 1 .. s + 1 of block tau - 1.
    bool ok = true;
    const int dep = t.s - 1 + j;
    if (t.tau > 0 && j < 3 && dep >= 0 && dep < g.S) {
      ok = sa::wait_at_least(done + dep, t.tau, ct.status, kPollNs);
    }
    store_chars();
    if (!__syncthreads_and(ok)) return;

    StepArgs p;
    p.j = j;
    p.nwarps = nthr >> 5;
    p.lane0 = t.lo + j * LPT;
    p.left_end = j == 0;
    p.right_end = p.lane0 + LPT == t.hi;
    p.he = he;
    p.lim1 = lim1;
    p.lim0 = lim0;
    p.n1 = n1;
    p.n2 = n2;
    p.compat = compat != 0;
    p.sc = sc;
    const bool real = p.lane0 < t.hi;
    const bool owned = p.lane0 >= t.own_lo && p.lane0 < t.own_hi;

    // The lanes' state at the block's start.
    Lanes<LPT> st;
    st.s1 = 0;
    st.s2 = 0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = p.lane0 + i;
      int32_t M = sa::kNegBig, I = sa::kNegBig, D = sa::kNegBig;
      int32_t H2 = sa::kNegBig;
      if (real) {
        if (t.tau == 0) {
          M = l == -he ? 0 : sa::kNegBig;  // the origin
        } else {
          const int4 v = __ldcg(
              state + (static_cast<size_t>(t.tau & 1) * B + t.b) * L + l);
          M = v.x;
          I = v.y;
          D = v.z;
          H2 = v.w;
        }
        st.s1 |= (static_cast<uint32_t>(sa::band_s1(s1r, c1r, L, l + t.i0)) &
                  0xfu) << (4 * i);
        st.s2 |= (static_cast<uint32_t>(sa::band_s2(s2r, c2r, l - t.i0)) &
                  0xfu) << (4 * i);
      }
      st.M1[i] = M;
      st.I1[i] = I;
      st.D1[i] = D;
      st.Ha[i] = H2;
      st.Hb[i] = sa::max3(M, I, D);
      st.acc[i] = 0;
    }
    int ca = 0, clane = 0;
    const bool corner = sa::band_corner(n1, n2, he, ca, clane) &&
                        clane >= t.own_lo && clane < t.own_hi &&
                        clane >= p.lane0 && clane < p.lane0 + LPT;

    // The direction words of wavefront aidx + 1, complete; the corner.
    auto store_words = [&](int aidx) {
      if (owned) {
        uint32_t* dst = dirs + (static_cast<size_t>(aidx / kUp) * B + t.b) * L +
                        p.lane0;
        if constexpr (LPT == 2) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(st.acc[0], st.acc[1]);
        } else {
#pragma unroll
          for (int i = 0; i < LPT; i += 4) {
            *reinterpret_cast<uint4*>(dst + i) = make_uint4(
                st.acc[i], st.acc[i + 1], st.acc[i + 2], st.acc[i + 3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < LPT; ++i) st.acc[i] = 0;
    };
    auto capture = [&]() {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if (p.lane0 + i == clane) {
          int32_t* f = finals + static_cast<size_t>(t.b) * 3;
          f[0] = st.M1[i];
          f[1] = st.I1[i];
          f[2] = st.D1[i];
        }
      }
    };
    // The code's shift for wavefront a0 + x of a chunk (aidx = a0 - 1 a
    // multiple of 8).
    auto shift_of = [](int x) {
      return DIRS == sa::kDirsFast4 ? 4u * x : 8u * (x & 3);
    };
    // A whole chunk of 4 iterations from wavefront a0: one fast4 word (two
    // full words) a lane.  At 2 lanes a thread the chunk is unrolled, so
    // its shifts and stores are fixed at compile time; at 4 and 8 the
    // unrolled chunk would outgrow the instruction cache.
    auto iteration = [&](auto mode_tag, int a0, int kc, bool cap, int k) {
      constexpr int MODE = decltype(mode_tag)::value;
      const int a = a0 + 2 * k;
      band_step<LPT, 1, MODE, DIRS, WILDCARD, STD>(st, edge, p, a,
                                                   e1[kc + k],
                                                   shift_of(2 * k));
      if (cap && a == ca) capture();
      band_step<LPT, 0, MODE, DIRS, WILDCARD, STD>(st, edge, p, a + 1,
                                                   e2[kc + k],
                                                   shift_of(2 * k + 1));
      if (cap && a + 1 == ca) capture();
      if (DIRS == sa::kDirsFull && (k & 1)) store_words(a);
      if (DIRS == sa::kDirsFast4 && k == 3) store_words(a);
    };
    auto run_chunk = [&](auto mode_tag, int a0, int kc, bool cap) {
      if constexpr (LPT <= 2) {
#pragma unroll
        for (int k = 0; k < 4; ++k) iteration(mode_tag, a0, kc, cap, k);
      } else {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) iteration(mode_tag, a0, kc, cap, k);
      }
    };

    for (int it = 0; it < t.nit; it += 4) {
      if (it > 0 && it % kCharChunk == 0) {
        load_chars(it);
        __syncthreads();  // the previous chunk's characters are read
        store_chars();
        __syncthreads();
      }
      const int n = t.nit - it < 4 ? t.nit - it : 4;
      const int a0 = 2 * (t.i0 + it) + 1;
      const int kc = it % kCharChunk;
      const bool cap = corner && ca >= a0 && ca < a0 + 2 * n;
      if (n == 4) {
        const int mode = sa::band_chunk_mode(t.i0 + it, n, t.lo, t.hi, he,
                                             n1, n2, lim1, lim0);
        if (mode == sa::kBandLean) {
          run_chunk(std::integral_constant<int, sa::kBandLean>(), a0, kc,
                    cap);
        } else if (mode == sa::kBandMasked) {
          run_chunk(std::integral_constant<int, sa::kBandMasked>(), a0, kc,
                    cap);
        } else {
          run_chunk(std::integral_constant<int, sa::kBandRamp>(), a0, kc,
                    cap);
        }
        continue;
      }
      // The band's last iterations (fewer than 4): band_cell, which takes
      // any cell, and the last words partial.
      for (int k = 0; k < n; ++k) {
        const int a = a0 + 2 * k;
        band_step<LPT, 1, sa::kBandRamp, DIRS, WILDCARD, STD>(
            st, edge, p, a, e1[kc + k], shift_of(2 * k));
        if (cap && a == ca) capture();
        band_step<LPT, 0, sa::kBandRamp, DIRS, WILDCARD, STD>(
            st, edge, p, a + 1, e2[kc + k], shift_of(2 * k + 1));
        if (cap && a + 1 == ca) capture();
        if (DIRS != sa::kDirsNone &&
            ((a & (kUp - 1)) == kUp - 1 || a == last_aidx)) {
          store_words(a);
        }
      }
    }

    // The owned lanes' end state for the next block, then "block tau done".
    const bool publish = t.tau + 1 < rows;
    if (publish && owned) {
      int4* dst = state +
                  (static_cast<size_t>((t.tau + 1) & 1) * B + t.b) * L +
                  p.lane0;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        dst[i] = make_int4(st.M1[i], st.I1[i], st.D1[i], st.Ha[i]);
      }
    }
    if (j == 0) ticket_sm = next;
    // The barrier orders every thread's stores before thread 0's fence and
    // release (and e1 / e2's last reads before the next tile's stores).
    __syncthreads();
    if (publish && j == 0) {
      __threadfence();
      sa::st_release(done + t.s, t.tau + 1);
    }
    ticket = ticket_sm;
  }
}

typedef void (*TileKernel)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, const int32_t*, const int32_t*,
                           int32_t*, uint32_t*, int4*, int32_t*, int, int, int,
                           int, int, int, int, sa::Scheme, sa::BandTiles);

template <int LPT, int DIRS, bool STD>
TileKernel pick_wild(bool wildcard) {
  return wildcard ? banded_tile_kernel<LPT, DIRS, true, STD>
                  : banded_tile_kernel<LPT, DIRS, false, STD>;
}

// The reference model takes every dirs mode; std none or fast4.
template <int LPT>
TileKernel pick_mode(int dirs_mode, bool wildcard, bool std_model) {
  if (std_model) {
    switch (dirs_mode) {
      case sa::kDirsNone:
        return pick_wild<LPT, sa::kDirsNone, true>(wildcard);
      case sa::kDirsFast4:
        return pick_wild<LPT, sa::kDirsFast4, true>(wildcard);
      default:
        return nullptr;
    }
  }
  switch (dirs_mode) {
    case sa::kDirsNone:
      return pick_wild<LPT, sa::kDirsNone, false>(wildcard);
    case sa::kDirsFast4:
      return pick_wild<LPT, sa::kDirsFast4, false>(wildcard);
    case sa::kDirsFull:
      return pick_wild<LPT, sa::kDirsFull, false>(wildcard);
    default:
      return nullptr;
  }
}

// The instance for lpt lanes a thread and threads a CTA (a multiple of 32,
// at most max_threads); nullptr if there is none.
TileKernel pick(int lpt, int threads, int dirs_mode, bool wildcard,
                bool std_model) {
  if (threads <= 0 || threads % 32 != 0) return nullptr;
  switch (lpt) {
    case 2:
      return threads <= max_threads<2>()
                 ? pick_mode<2>(dirs_mode, wildcard, std_model)
                 : nullptr;
    case 4:
      return threads <= max_threads<4>()
                 ? pick_mode<4>(dirs_mode, wildcard, std_model)
                 : nullptr;
    case 8:
      return threads <= max_threads<8>()
                 ? pick_mode<8>(dirs_mode, wildcard, std_model)
                 : nullptr;
  }
  return nullptr;
}

}  // namespace

// The card's SMs (0 without a device).
extern "C" int sa_sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms;
}

// CTAs of the banded instance the card holds at once (occupancy x SMs);
// 0 for a shape it has no instance for.
extern "C" int sa_banded_resident_ctas(int lpt, int threads, int dirs_mode,
                                       int wildcard, int std_model) {
  const TileKernel fn =
      pick(lpt, threads, dirs_mode, wildcard != 0, std_model != 0);
  if (fn == nullptr) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(fn), threads, 0) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return per_sm * sa_sm_count();
}

// s1w0/s2w0: (B, L) int32; c1s/c2s: (B, n_iters) int32; n1v/n2v: (B,) int32;
// finals: (B, 3) int32, zeroed; dirs: (ceil(2 n_iters / upack), B, L) u32,
// unused for dirs_mode 0; state: (2, B, L, 4) int32 when there are several
// blocks; ctr: 2 + 8B + B * strips int32, zeroed.  he = k_lo_even / 2;
// lim1/lim0: the last lane of the effective band on odd / even wavefronts.
// dirs_mode 0/1/2 (none, fast4, full); std_model != 0: gaps open from H
// (dirs none or fast4).  strip_lanes / block_iters / order: the tiles
// (nw_banded_diag.cuh::BandTiles; strips = ceil(L / strip_lanes)); lpt /
// threads: lanes a thread and threads a CTA, enough for a tile's lanes;
// ctas: the persistent grid.  Returns the cudaGetLastError() of the launch,
// -1 for an unsupported shape or mode.  After the launch ctr[1] is non-zero
// if a wait stalled (the results are then incomplete).
extern "C" int sa_banded_fill(
    const int32_t* s1w0, const int32_t* s2w0, const int32_t* c1s,
    const int32_t* c2s, const int32_t* n1v, const int32_t* n2v,
    int32_t* finals, uint32_t* dirs, void* state, int32_t* ctr, int B, int L,
    int n_iters, int he, int lim1, int lim0, int match, int mismatch,
    int gap_open, int gap_extend, int dirs_mode, int compat, int wildcard,
    int std_model, int strip_lanes, int block_iters, int order, int lpt,
    int threads, int ctas, void* stream) {
  const sa::BandTiles g{strip_lanes, block_iters,
                        strip_lanes > 0 ? (L + strip_lanes - 1) / strip_lanes
                                        : 0,
                        order};
  if (B <= 0 || ctas < 1 || !sa::band_tiles_ok(g, L, n_iters)) return -1;
  const int window = g.W + 2 * sa::band_halo(g, n_iters);
  if (threads * lpt < (window < L ? window : L)) return -1;
  if (sa::band_rows(g, n_iters) > 1 && state == nullptr) return -1;
  const TileKernel fn =
      pick(lpt, threads, dirs_mode, wildcard != 0, std_model != 0);
  if (fn == nullptr) return -1;
  sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  int4* st = static_cast<int4*>(state);
  sa::BandTiles ga = g;
  void* args[] = {&s1w0, &s2w0, &c1s, &c2s,  &n1v,  &n2v,    &finals,
                  &dirs, &st,   &ctr, &B,    &L,    &n_iters, &he,
                  &lim1, &lim0, &compat, &sc, &ga};
  cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(ctas),
                   dim3(threads), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

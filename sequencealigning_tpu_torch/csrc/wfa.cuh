// Per-diagonal arithmetic of the textbook WFA fill and the walk over its
// offset log (wfa.cu), shared with the serial host build (host_check.cpp).
//
// The fill is ops/wfa.py::_wfa_chunk_jax's step (and _wfa_seed2_jax's
// seed at u = 0) written for one diagonal lane: diagonal k = y - x, offset
// t = x (db chars consumed), a lattice step u holding score u * g.
//
//   I[u][k] = max(M[u-oe][k-1], I[u-e][k-1])          (consumes seq1)
//   D[u][k] = max(M[u-oe][k+1], D[u-e][k+1]) + 1      (consumes seq2)
//   M[u][k] = extend(max(M[u-x][k] + 1, I[u][k], D[u][k]))
//
// x, oe, e in lattice steps, each in [1, R - 1] for a ring of R rows (the
// wrapper maps a zero penalty to the JAX ring's length, which is what the
// JAX ring reads there), so a step never reads the ring slot it writes.
// The extension compares the pair's codes packed as bytes, four a u32
// word: a lane compares the first word of its run, and a run that goes on
// past it is taken by the whole warp, 32 words (128 codes) an iteration,
// the first mismatch found by a ballot (wfa_span_lane is one lane's part).
// The walk is ops/wfa.py::_wfa_walk_device_jit's state machine for one
// pair, run by a warp over log rows staged in shared memory (WfaStage),
// emitting one 2-bit op code a column (1 M, 2 I, 3 D), a run's whole words
// written by the warp's lanes at once.
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

#if defined(__CUDACC__)
#define SA_HDM __host__ __device__ __forceinline__
#else
#define SA_HDM inline
#endif

namespace sa {

constexpr int32_t kWfaNeg = -(1 << 14);  // absent offset (ops/wfa.py NEG)
constexpr int32_t kWfaBig = 1 << 14;     // end target outside the window
constexpr int kWfaSpan = 32;             // words (of 4 codes) a warp's span
// Dynamic shared memory a fill CTA may take: the SM's 227 KB less 1 KB for
// the static words beside it.
constexpr int kWfaSharedMax = 227 * 1024 - 1024;

// Offset t on diagonal k lies in the pair's matrix (the JAX ok()).
SA_HD bool wfa_ok(int32_t t, int32_t k, int32_t n1, int32_t n2) {
  const int32_t y = t + k;
  return t >= 0 && t <= n2 && y >= 0 && y <= n1;
}

// Diagonal k's end offset (ops/wfa.py::_end_targets): x = n2 on diagonals
// dtar - trail1 .. dtar, y = n1 on dtar + 1 .. dtar + trail2; `mask` says
// whether k is an end diagonal at all.
SA_HD int32_t wfa_end_t(int32_t k, int32_t n1, int32_t n2, int32_t trail1,
                        int32_t trail2, bool& mask) {
  const int32_t dtar = n1 - n2;
  const bool in_a = k >= dtar - trail1 && k <= dtar;
  const bool in_b = k > dtar && k <= dtar + trail2;
  mask = in_a || in_b;
  return in_a ? n2 : (in_b ? n1 - k : kWfaBig);
}

// A pair's packed codes: seq1 as bytes padded to P1 = code_pitch(L1), then
// seq2 padded to code_pitch(L2); every run read stays 8 bytes short of its
// sequence's padded end.
SA_HD int wfa_code_pitch(int L) { return (L + 8 + 15) / 16 * 16; }

// A fill CTA's dynamic shared memory: the pair's packed codes and, with the
// rings in shared memory, their three planes' R rows of K lanes and two
// guard lanes.
SA_HD long long wfa_fill_smem(int L1, int L2, int K, int R,
                              bool shared_ring) {
  return wfa_code_pitch(L1) + static_cast<long long>(wfa_code_pitch(L2)) +
         (shared_ring ? 12LL * R * (K + 2) : 0);
}

// The fill's route, by shape: the rings in shared memory where they fit
// kWfaSharedMax beside the codes, else in device memory.
SA_HD bool wfa_ring_in_shared(int L1, int L2, int K, int R) {
  return wfa_fill_smem(L1, L2, K, R, true) <= kWfaSharedMax;
}

// CTAs a pair (the fill grid's y).  The first computes the pair.  Where
// the batch leaves most SMs idle (B <= sms / 2) the NEG rows of a pair
// that converged before the launch are shared by sms / B CTAs, at most one
// a row-plane; the seed launch has no such pair.
SA_HD int wfa_neg_ctas(int B, int sms, int u0, int n_steps) {
  if (u0 == 0 || B <= 0 || sms / B < 2) return 1;
  return sms / B < 3 * n_steps ? sms / B : 3 * n_steps;
}

// Part y of Y of a pair's n_rp NEG row-planes (row * 3 + plane): [lo, hi).
SA_HD void wfa_neg_part(int y, int Y, int n_rp, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(n_rp) * y / Y);
  hi = static_cast<int>(static_cast<long long>(n_rp) * (y + 1) / Y);
}

// A pair converged before the launch at lattice step u0, told by its score
// alone: -1 until the pair converges, then u * g, written once (a pair
// that converges during the launch scores u0 * g or more), so a read
// racing that write needs no fence.
SA_HD bool wfa_done_before(int32_t score, int u0, int g) {
  return score >= 0 && score < u0 * g;
}

// The four codes at byte p of packed words w, little-endian (code p in the
// low byte).
SA_HD uint32_t wfa_window(const uint32_t* w, int32_t p) {
  const uint32_t lo = w[p >> 2];
  const uint32_t hi = w[(p >> 2) + 1];
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, 8 * (p & 3));
#else
  return static_cast<uint32_t>(
      ((static_cast<uint64_t>(hi) << 32) | lo) >> (8 * (p & 3)));
#endif
}

// Equal codes of diagonal k from offset t, at most 4: seq1 at t + k
// against seq2 at t, compared as plain equality.
SA_HD int32_t wfa_run4(const uint32_t* w1, const uint32_t* w2, int32_t k,
                       int32_t t) {
  const uint32_t x = wfa_window(w1, t + k) ^ wfa_window(w2, t);
#if defined(__CUDA_ARCH__)
  return x ? (__ffs(x) - 1) >> 3 : 4;
#else
  return x ? __builtin_ctz(x) >> 3 : 4;
#endif
}

// The run's first word from t (t <= lim, lim = min(n2, n1 - k)): the
// run's end, or t + 4 with `more` where it goes on past the word.
SA_HD int32_t wfa_first_word(const uint32_t* w1, const uint32_t* w2,
                             int32_t k, int32_t t, int32_t lim, bool& more) {
  const int32_t e = t + wfa_run4(w1, w2, k, t);
  more = e == t + 4 && e < lim;
  return e < lim ? e : lim;
}

// Lane j's part of a warp's span from t (t < lim): its word at t + 4j
// (clamped at lim).  True where the run ends in it, with the end in `end`;
// the run ends in the first such lane.
SA_HD bool wfa_span_lane(const uint32_t* w1, const uint32_t* w2, int32_t k,
                         int32_t t, int32_t lim, int j, int32_t& end) {
  int32_t p = t + 4 * j;
  p = p < lim ? p : lim;
  const int32_t e = p + wfa_run4(w1, w2, k, p);
  end = e < lim ? e : lim;
  return e < p + 4 || e >= lim;
}

// Step u = 0: diagonal k's start in the free-start window [-lead2, lead1]
// (global: diagonal 0), t0 = max(0, -k), NEG elsewhere; its leading run is
// extended from there as any other.
SA_HD int32_t wfa_seed_start(int32_t k, int32_t n1, int32_t n2,
                             int32_t lead1, int32_t lead2) {
  const int32_t t0 = k < 0 ? -k : 0;
  return (k < -lead2 || k > lead1 || t0 > n2 || k > n1) ? kWfaNeg : t0;
}

// A lattice step's ring slots: the one written (w = u % R) and the three
// read (u - x, u - oe, u - e), -1 for a step before 0 (NEG); 32-bit, once
// a step.
struct WfaSlots {
  int w, x, oe, e;
};

SA_HD WfaSlots wfa_slots(int u, int w, int R, int x_off, int oe_off,
                         int e_off) {
  auto back = [&](int off) {
    return u < off ? -1 : (w >= off ? w - off : w + R - off);
  };
  return WfaSlots{w, back(x_off), back(oe_off), back(e_off)};
}

// The rings of one pair in shared memory: plane p's slot q at
// base[(p * R + q) * (K + 2) + 1 ..], lanes -1 and K guard cells of NEG.
struct WfaSharedRing {
  int32_t* base;
  int R, K;
  SA_HDM int32_t* row(int p, int q) const {
    return base + (p * R + q) * (K + 2) + 1;
  }
  SA_HDM int32_t at(int p, int q, int lane) const {
    return q < 0 ? kWfaNeg : row(p, q)[lane];
  }
  SA_HDM void put(int p, int q, int lane, int32_t v) const {
    row(p, q)[lane] = v;
  }
};

// The (R, B, K) rings of pair b in device memory (the route past the
// shared-memory budget): NEG before step 0 or outside the band.
struct WfaDeviceRing {
  int32_t* plane[3];
  int B, K, b;
  SA_HDM int32_t at(int p, int q, int lane) const {
    if (q < 0 || lane < 0 || lane >= K) return kWfaNeg;
    return plane[p][(static_cast<int64_t>(q) * B + b) * K + lane];
  }
  SA_HDM void put(int p, int q, int lane, int32_t v) const {
    plane[p][(static_cast<int64_t>(q) * B + b) * K + lane] = v;
  }
};

// Step u > 0 of lane (diagonal k): the new I and D offsets, and the M
// candidate before its extension (NEG where absent), from the ring rows
// of earlier steps.
template <class Ring>
SA_HD int32_t wfa_candidate(const Ring& r, const WfaSlots& q, int lane,
                            int32_t k, int32_t n1, int32_t n2, int32_t& iv,
                            int32_t& dv) {
  const int32_t m_x = r.at(0, q.x, lane);
  iv = imax(r.at(0, q.oe, lane - 1), r.at(1, q.e, lane - 1));
  iv = (iv > kWfaNeg && wfa_ok(iv, k, n1, n2)) ? iv : kWfaNeg;
  const int32_t d_src = imax(r.at(0, q.oe, lane + 1), r.at(2, q.e, lane + 1));
  dv = d_src > kWfaNeg ? d_src + 1 : kWfaNeg;
  dv = wfa_ok(dv, k, n1, n2) ? dv : kWfaNeg;
  const int32_t mc = imax(m_x > kWfaNeg ? m_x + 1 : kWfaNeg, imax(iv, dv));
  return wfa_ok(mc, k, n1, n2) ? mc : kWfaNeg;
}

// Index of (row, plane, pair, lane) in an (S, 3, B, K) log.
SA_HD int64_t wfa_log_index(int64_t row, int plane, int B, int b, int K,
                            int lane) {
  return ((row * 3 + plane) * B + b) * static_cast<int64_t>(K) + lane;
}

// ---------------------------------------------------------------------------
// The walk: a warp a pair over log rows staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int kWfaRows = 8;    // log rows a staged batch
constexpr int kWfaSlots = 3;   // batch slots a walk
constexpr int kWfaWindow = 64; // lanes a staged row-plane (128 bytes)
constexpr int kWfaWalkWarps = 4;  // walks (warps) a block, at most

// A slot's staged rows: kWfaRows rows x 3 planes x the window's lanes.
constexpr int kWfaSlotCells = kWfaRows * 3 * kWfaWindow;

// One pair's staged batches of the log (S, 3, Bh, K): batch n is rows
// n * kWfaRows .., in slot n % kWfaSlots, each row-plane the `win` lanes
// from its slot's first lane (aligned to 8 lanes, around the walk's lane
// when it was staged).  The walk's batch m and the two below are staged;
// a read outside them, or outside a window, loads the log directly.  Ops
// is the warp (wfa.cu: one tensor copy a batch) or its serial host twin
// (host_check.cpp): copy, wait, sync and the slots' cells, and mark(part,
// v), which ends a part of a step for csrc/wfa_stamps.cu's stamps
// (nothing elsewhere).
template <class Ops>
struct WfaStage {
  Ops& ops;
  const int16_t* hist;
  int S, Bh, K, b, win;
  int32_t m = -1;                  // the walk's batch (-1: none)
  int32_t lo0 = 0, lo1 = 0, lo2 = 0;  // each slot's first lane
  uint32_t pend = 0;               // bit q: slot q not yet waited on

  SA_HDM int32_t lo(int q) const { return q == 0 ? lo0 : (q == 1 ? lo1 : lo2); }

  // Copies batch n into its slot, windows from the walk's lane.
  SA_HDM void stage(int32_t n, int lane) {
    const int q = n % kWfaSlots;
    if (pend >> q & 1u) wait(q);
    int32_t l0 = (lane - win / 2) & ~7;
    l0 = l0 < 0 ? 0 : (l0 > K - win ? K - win : l0);
    lo0 = q == 0 ? l0 : lo0;
    lo1 = q == 1 ? l0 : lo1;
    lo2 = q == 2 ? l0 : lo2;
    const int32_t r0 = n * kWfaRows;
    const int rows = S - r0 < kWfaRows ? S - r0 : kWfaRows;
    ops.copy(q, r0, l0, rows, win, [&](int j) {
      return hist + wfa_log_index(r0 + j / 3, j % 3, Bh, b, K, l0);
    });
    pend |= 1u << q;
  }

  SA_HDM void wait(int q) {
    ops.wait(q);
    pend &= ~(1u << q);
  }

  // Stages the batch of row r and the two below.
  SA_HDM void init(int32_t r, int lane) {
    if (r < 0 || r >= S) return;
    ops.init();
    m = r / kWfaRows;
    for (int32_t n = m; n >= 0 && n > m - kWfaSlots; --n) stage(n, lane);
  }

  // After a move to row r: each batch the walk left frees its slot for
  // the batch kWfaSlots below it.
  SA_HDM void advance(int32_t r, int lane) {
    while (m >= 0 && r >= 0 && r / kWfaRows < m) {
      ops.sync();  // the warp's reads of batch m are done
      if (m - kWfaSlots >= 0) stage(m - kWfaSlots, lane);
      --m;
    }
  }

  // The log at (row r, plane p, lane), r and lane inside the log: staged,
  // or loaded directly.
  SA_HDM int32_t at(int32_t r, int p, int lane) {
    const int32_t n = r / kWfaRows;
    if (m >= 0 && n <= m && n > m - kWfaSlots) {
      const int q = n % kWfaSlots;
      const int32_t li = lane - lo(q);
      if (li >= 0 && li < win) {
        if (pend >> q & 1u) wait(q);
        return ops.cell(q, ((r - n * kWfaRows) * 3 + p) * win + li);
      }
    }
    return hist[wfa_log_index(r, p, Bh, b, K, lane)];
  }

  // Every copy in flight landed (before the warp exits).
  SA_HDM void drain() {
    for (int q = 0; q < kWfaSlots; ++q) {
      if (pend >> q & 1u) wait(q);
    }
  }
};

// The packed op output of one walk, 16 codes a u32 little-endian in step:
// n codes so far, the word in progress held by every lane.
struct WfaEmit {
  uint32_t* out;
  int32_t n;
  uint32_t word;
};

// n codes of one kind: the word in progress filled, then the run's whole
// words written by the warp's lanes at once, its tail left in progress.
template <class Ops>
SA_HD void wfa_emit(Ops& ops, WfaEmit& e, uint32_t code, int32_t n) {
  const uint32_t pattern = code * 0x55555555u;
  const int pos = e.n & 15;
  const int32_t take = n < 16 - pos ? n : 16 - pos;
  if (take <= 0) return;
  e.word |= (take == 16 ? pattern : pattern & ((1u << (2 * take)) - 1u))
            << (2 * pos);
  e.n += take;
  n -= take;
  if ((e.n & 15) != 0) return;
  if (ops.lane() == 0) e.out[(e.n >> 4) - 1] = e.word;
  const int32_t whole = n >> 4;
  for (int32_t j = ops.lane(); j < whole; j += ops.lanes()) {
    e.out[(e.n >> 4) + j] = pattern;
  }
  e.n += 16 * whole;
  n -= 16 * whole;
  e.word = pattern & ((1u << (2 * n)) - 1u);
  e.n += n;
}

// One pair's walk from score s at (k, t) back to the s = 0 seed: ties
// mismatch > I > D, the open-vs-extend probe on the M plane at
// (s - o - e, k -+ 1).  Writes its ops into out (zeroed by the caller)
// and returns 1 when the walk is ok: it reached the seed on diagonal 0
// with no negative run, within `budget` ops and 2 * budget + 4
// iterations.  A walk that is not ok leaves its words 0 and n_ops 0.
// Every lane runs the state machine; the three reads of a step are
// issued together.  The walk keeps its log row r = s / g beside s (every
// penalty is a multiple of g, so a score off the lattice stays off it and
// reads NEG), so a read takes no division.
template <class Ops>
SA_HD int wfa_walk_staged(Ops& ops, const int16_t* hist, int S, int Bh,
                          int K, int b, int k_lo, int g, int32_t s, int32_t k,
                          int32_t t, bool live, int32_t budget, int x_pen,
                          int o_pen, int e_pen, uint32_t* out,
                          int32_t* n_ops) {
  if (!live) {
    if (ops.lane() == 0) *n_ops = 0;
    return 0;
  }
  const int32_t oe = o_pen + e_pen;
  const int32_t xr = x_pen / g, oer = oe / g, er = e_pen / g;
  const bool lattice = s % g == 0;
  int32_t r = lattice ? s / g : -1;
  WfaStage<Ops> stage{ops, hist, S, Bh, K, b, K < kWfaWindow ? K : kWfaWindow};
  // The log at row v, plane p, lane; NEG off the lattice, the log or the
  // band.
  auto log_at = [&](int32_t v, int p, int lane) -> int32_t {
    if (!lattice || v < 0 || v >= S || lane < 0 || lane >= K) {
      return kWfaNeg;
    }
    return stage.at(v, p, lane);
  };
  if (lattice) stage.init(r, k - k_lo);
  WfaEmit em{out, 0, 0};
  int st = 0;  // 0 M, 1 I, 2 D
  bool ok = false;
  for (int64_t it = 0; it <= 2 * static_cast<int64_t>(budget) + 3; ++it) {
    const int lane = k - k_lo;
    if (st == 0) {
      if (s == 0) {
        if (t >= 0 && k == 0 && em.n + t <= budget) {
          wfa_emit(ops, em, 1, t);
          ok = true;
        }
        break;
      }
      const int32_t mx = log_at(r - xr, 0, lane);
      const int32_t iv = log_at(r, 1, lane);
      const int32_t dv = log_at(r, 2, lane);
      ops.mark(0, mx ^ iv ^ dv);
      const int32_t mx1 = mx > kWfaNeg ? mx + 1 : kWfaNeg;
      const int32_t t_pre = imax(imax(mx1, iv), dv);
      const bool mis = mx > kWfaNeg && t_pre == mx1;
      const int32_t ln = t - t_pre + (mis ? 1 : 0);
      if (ln < 0 || em.n + ln > budget) break;
      wfa_emit(ops, em, 1, ln);
      if (mis) {
        s -= x_pen;
        r -= xr;
        t = t_pre - 1;
      } else {
        t = t_pre;
        st = t_pre == iv ? 1 : 2;
      }
    } else {
      const bool ins = st == 1;
      const int32_t mx = log_at(r - oer, 0, lane + (ins ? -1 : 1));
      ops.mark(0, mx);
      if (em.n + 1 > budget) break;
      wfa_emit(ops, em, ins ? 2u : 3u, 1);
      const bool opn = ins ? mx == t : mx == t - 1;
      s -= opn ? oe : e_pen;
      r -= opn ? oer : er;
      k += ins ? -1 : 1;
      if (!ins) t -= 1;
      if (opn) st = 0;
    }
    ops.mark(1, s ^ t ^ k);
    if (lattice) stage.advance(r, k - k_lo);
    ops.mark(2);
  }
  stage.drain();
  if (ops.lane() == 0) {
    if ((em.n & 15) != 0) out[em.n >> 4] = em.word;
    *n_ops = ok ? em.n : 0;
  }
  if (!ok) {
    ops.sync();
    for (int32_t w = ops.lane(); w < (em.n + 15) >> 4; w += ops.lanes()) {
      out[w] = 0;
    }
  }
  return ok ? 1 : 0;
}

}  // namespace sa

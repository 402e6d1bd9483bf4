// Per-diagonal arithmetic of the textbook WFA fill and the per-pair walk
// over its offset log (wfa.cu), shared with the serial host build
// (host_check.cpp).
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
// The walk is ops/wfa.py::_wfa_walk_device_jit's state machine for one
// pair, emitting one 2-bit op code a column (1 M, 2 I, 3 D).
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

constexpr int32_t kWfaNeg = -(1 << 14);  // absent offset (ops/wfa.py NEG)
constexpr int32_t kWfaBig = 1 << 14;     // end target outside the window

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

// The greedy match run from offset t (in the matrix) along diagonal k: the
// codes compared as plain equality, as the JAX engine does.
template <typename C>
SA_HD int32_t wfa_extend(const C* s1, const C* s2, int32_t n1, int32_t n2,
                         int32_t k, int32_t t) {
  while (t < n2 && t + k < n1 && s1[t + k] == s2[t]) ++t;
  return t;
}

// Step u = 0: diagonal k's seed in the free-start window [-lead2, lead1]
// (global: diagonal 0), its leading match run from t0 = max(0, -k).
template <typename C>
SA_HD int32_t wfa_seed(const C* s1, const C* s2, int32_t n1, int32_t n2,
                       int32_t k, int32_t lead1, int32_t lead2) {
  const int32_t t0 = k < 0 ? -k : 0;
  if (k < -lead2 || k > lead1 || t0 > n2 || k > n1) return kWfaNeg;
  const int32_t m = wfa_extend(s1, s2, n1, n2, k, t0);
  return wfa_ok(m, k, n1, n2) ? m : kWfaNeg;
}

// The (R, B, K) rings of one plane, pair b: offset of lattice step u at
// lane, NEG before step 0 or outside the band.
struct WfaRing {
  const int32_t* m;
  const int32_t* i;
  const int32_t* d;
  int R, B, K, b;
};

SA_HD int32_t wfa_ring_at(const int32_t* ring, const WfaRing& r, int u,
                          int lane) {
  if (u < 0 || lane < 0 || lane >= r.K) return kWfaNeg;
  return ring[((u % r.R) * r.B + r.b) * r.K + lane];
}

// Step u > 0 of lane (diagonal k): the new M, I and D offsets (NEG where
// absent), from the ring rows of earlier steps.
template <typename C>
SA_HD void wfa_step(const WfaRing& r, int lane, int32_t k, int u, int x_off,
                    int oe_off, int e_off, const C* s1, const C* s2,
                    int32_t n1, int32_t n2, int32_t& m, int32_t& iv,
                    int32_t& dv) {
  const int32_t m_x = wfa_ring_at(r.m, r, u - x_off, lane);
  iv = imax(wfa_ring_at(r.m, r, u - oe_off, lane - 1),
            wfa_ring_at(r.i, r, u - e_off, lane - 1));
  iv = (iv > kWfaNeg && wfa_ok(iv, k, n1, n2)) ? iv : kWfaNeg;
  const int32_t d_src = imax(wfa_ring_at(r.m, r, u - oe_off, lane + 1),
                             wfa_ring_at(r.d, r, u - e_off, lane + 1));
  dv = d_src > kWfaNeg ? d_src + 1 : kWfaNeg;
  dv = wfa_ok(dv, k, n1, n2) ? dv : kWfaNeg;
  int32_t mc = imax(m_x > kWfaNeg ? m_x + 1 : kWfaNeg, imax(iv, dv));
  mc = wfa_ok(mc, k, n1, n2) ? mc : kWfaNeg;
  m = mc > kWfaNeg ? wfa_extend(s1, s2, n1, n2, k, mc) : kWfaNeg;
}

// Index of (row, plane, pair, lane) in an (S, 3, B, K) log.
SA_HD int64_t wfa_log_index(int64_t row, int plane, int B, int b, int K,
                            int lane) {
  return ((row * 3 + plane) * B + b) * static_cast<int64_t>(K) + lane;
}

// The walk's log read: plane at score s (a multiple of g), lane; NEG off
// the lattice, the log or the band.
SA_HD int32_t wfa_log_at(const int16_t* hist, int S, int B, int K, int b,
                         int g, int plane, int32_t s, int lane) {
  if (s < 0 || s % g || s / g >= S || lane < 0 || lane >= K) {
    return kWfaNeg;
  }
  return hist[wfa_log_index(s / g, plane, B, b, K, lane)];
}

// Packed op output of one walk: 16 codes a u32, little-endian in step.
struct WfaEmit {
  uint32_t* out;
  int32_t n;
  uint32_t word;
};

SA_HD void wfa_emit(WfaEmit& e, uint32_t code, int32_t count) {
  const uint32_t pattern = code * 0x55555555u;
  while (count > 0) {
    if ((e.n & 15) == 0 && count >= 16) {
      e.out[e.n >> 4] = pattern;
      e.n += 16;
      count -= 16;
      continue;
    }
    e.word |= code << (2 * (e.n & 15));
    if ((e.n & 15) == 15) {
      e.out[e.n >> 4] = e.word;
      e.word = 0;
    }
    ++e.n;
    --count;
  }
}

// One pair's walk from score s at (k, t) back to the s = 0 seed: ties
// mismatch > I > D, the open-vs-extend probe on the M plane at
// (s - o - e, k -+ 1).  Writes its ops into out (zeroed by the caller)
// and returns 1 when the walk is ok: it reached the seed on diagonal 0
// with no negative run, within `budget` ops and 2 * budget + 4
// iterations.  A walk that is not ok leaves its words 0 and n_ops 0.
SA_HD int wfa_walk_pair(const int16_t* hist, int S, int B, int K, int b,
                        int k_lo, int g, int32_t s, int32_t k, int32_t t,
                        bool live, int32_t budget, int x_pen, int o_pen,
                        int e_pen, uint32_t* out, int32_t* n_ops) {
  *n_ops = 0;
  if (!live) return 0;
  const int32_t oe = o_pen + e_pen;
  WfaEmit em{out, 0, 0};
  int st = 0;  // 0 M, 1 I, 2 D
  bool ok = false;
  for (int64_t it = 0; it <= 2 * static_cast<int64_t>(budget) + 3; ++it) {
    const int lane = k - k_lo;
    if (st == 0) {
      if (s == 0) {
        if (t >= 0 && k == 0 && em.n + t <= budget) {
          wfa_emit(em, 1, t);
          ok = true;
        }
        break;
      }
      const int32_t mx = wfa_log_at(hist, S, B, K, b, g, 0, s - x_pen, lane);
      const int32_t iv = wfa_log_at(hist, S, B, K, b, g, 1, s, lane);
      const int32_t dv = wfa_log_at(hist, S, B, K, b, g, 2, s, lane);
      const int32_t mx1 = mx > kWfaNeg ? mx + 1 : kWfaNeg;
      const int32_t t_pre = imax(imax(mx1, iv), dv);
      const bool mis = mx > kWfaNeg && t_pre == mx1;
      const int32_t ln = t - t_pre + (mis ? 1 : 0);
      if (ln < 0 || em.n + ln > budget) break;
      wfa_emit(em, 1, ln);
      if (mis) {
        s -= x_pen;
        t = t_pre - 1;
      } else {
        t = t_pre;
        st = t_pre == iv ? 1 : 2;
      }
    } else {
      const bool ins = st == 1;
      const int32_t mx = wfa_log_at(hist, S, B, K, b, g, 0, s - oe,
                                    lane + (ins ? -1 : 1));
      if (em.n + 1 > budget) break;
      wfa_emit(em, ins ? 2u : 3u, 1);
      const bool opn = ins ? mx == t : mx == t - 1;
      s -= opn ? oe : e_pen;
      k += ins ? -1 : 1;
      if (!ins) t -= 1;
      if (opn) st = 0;
    }
  }
  if ((em.n & 15) != 0) out[em.n >> 4] = em.word;
  if (!ok) {
    for (int32_t w = 0; w < (em.n + 15) >> 4; ++w) out[w] = 0;
    return 0;
  }
  *n_ops = em.n;
  return 1;
}

}  // namespace sa

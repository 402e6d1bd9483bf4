// Serial host build of the CUDA kernels' loops, through the same per-cell
// and per-step functions (nw_affine_stream.cuh, nw_banded_diag.cuh,
// nw_affine_tiled.cuh, traceback_device.cuh) and the same row split
// (cluster_split.cuh, stream_ring.cuh).  It lets
// the kernels' arithmetic be compiled and checked against the plain PyTorch
// versions on a machine with no CUDA compiler:
//
//   c++ -O2 -std=c++17 -shared -fPIC -o libhost_check.so host_check.cpp
//
// The arguments and layouts are those of sa_stream_fill,
// sa_stream_modes_fill (and their int16 instances sa_stream_fill_i16 and
// sa_stream_modes_fill_i16), sa_modes_fill, sa_gotoh_fill, sa_linear_fill,
// sa_banded_fill, sa_banded_row_fill and sa_tiled_fill / sa_tiled_fold_fill
// (their tile and strip schedules run serially, tickets in order),
// sa_tiled_shard_fill (one launch a call, resumable, the launches of a mesh
// called in turn),
// sa_walk_fast4, sa_walk_modes and sa_walk_banded, sa_wfa_chunk and
// sa_wfa_walk, sa_mm_rows (its strip tickets run serially, in order, each
// strip's wavefront a step at a time), sa_mm_rows_plan and
// sa_mm_table_cols (minus the stream).  The
// streamed and per-pair fills run their warp-ring schedules serially, chunk
// by chunk and warp by warp.
#include <stddef.h>
#include <stdint.h>

#include <string.h>

#include <algorithm>
#include <vector>

#include "cluster_split.cuh"
#include "mm_rows.cuh"
#include "nw_affine_stream.cuh"
#include "stream_cell16.cuh"
#include "nw_affine_tiled.cuh"
#include "nw_banded.cuh"
#include "nw_banded_diag.cuh"
#include "nw_linear.cuh"
#include "pair_sweep.cuh"
#include "stream_ring.cuh"
#include "traceback_device.cuh"
#include "wfa.cuh"

namespace {

// The streamed fills (global, semi-global, local) in the kernels' warp-ring
// schedule (stream_ring.cuh), run serially: chunk by chunk, and in each
// chunk the row's warps in order (CTA by CTA), each over its lanes right to
// left a step at a time.  A warp's first lane takes the left lane's
// pre-step values from its ring slot, written by the warp to its left in
// this chunk's pass; lane 0 takes the step's query code, and its direction
// words go through the wrap ring to the warp holding lane P-1, which ORs in
// that lane's D bits.  Every wait is checked in that order: one that would
// not hold returns kRingUnmet.  Global mode writes the finals, the modes the
// running argmax (turnover at p == x, as the kernel).
template <int DIRS, int MODE, bool COMPAT, bool WILDCARD>
int stream_ring_host(const int32_t* qstream, const int32_t* dstream,
                     const int32_t* dsum, const int32_t* n2s, int32_t* out,
                     uint32_t* dirs, int R, int T, int P, int S, int NP,
                     const sa::Scheme& sc, const sa::Split& sp, int C,
                     int slots, int wrap) {
  constexpr bool kModes = MODE != sa::kModeGlobal;
  constexpr bool kDirs = DIRS != sa::kDirsNone;
  constexpr int kPer = DIRS == sa::kDirsFast4 ? 8 : 4;
  // The row's warps, in order: [first lane, end lane).
  std::vector<int> w0, w1;
  for (int rank = 0; rank < sp.nctas; ++rank) {
    const int lo = sa::cta_first_lane(rank, sp);
    const int hi = lo + sa::cta_real_lanes(rank, sp, P);
    for (int u = 0; u < sa::ring_warps(rank, sp, P); ++u) {
      w0.push_back(lo + 32 * u * sp.lpt);
      w1.push_back(lo + 32 * (u + 1) * sp.lpt < hi ? lo + 32 * (u + 1) * sp.lpt
                                                   : hi);
    }
  }
  const int G = static_cast<int>(w0.size());
  struct Entry {
    int32_t h, d, s;
  };
  std::vector<sa::Cell> c(P);
  std::vector<sa::Pre> pre(P);
  std::vector<uint32_t> acc(P);
  std::vector<int32_t> bv(P), bd(P), lo(P), len(P);
  std::vector<Entry> ring(static_cast<size_t>(G) * slots * C);
  std::vector<int32_t> full(G), freed(G);
  std::vector<uint32_t> wring(wrap);
  std::vector<int> wtag(wrap);  // the word each wrap slot holds
  const size_t plane = static_cast<size_t>(NP) * R * P;
  for (int row = 0; row < R; ++row) {
    for (int x = 0; x < P; ++x) {
      c[x] = sa::cell_init(kModes ? sa::kNegBig : sa::kNegInf);
      acc[x] = 0;
      bv[x] = sa::kNegBig;
      bd[x] = -S;
      lo[x] = len[x] = 0;
    }
    for (int g = 0; g < G; ++g) full[g] = freed[g] = 0;
    for (int i = 0; i < wrap; ++i) wtag[i] = -1;
    int32_t wrap_freed = 0;
    uint32_t wacc = 0;
    auto pair_of = [&](int k, int32_t& n1, int32_t& n2) {
      n2 = k < NP ? n2s[k * R + row] : -1;
      n1 = k < NP ? dsum[k * R + row] - n2 : -1;
    };
    auto flush_argmax = [&](int k, int x, int32_t slot0) {
      if (k < 0 || k >= NP) return;
      const size_t at = (static_cast<size_t>(k) * R + row) * P + x;
      out[at] = bv[x];
      out[plane + at] = bd[x] - slot0;
    };
    for (int t0 = 0, k = 0; t0 < T; t0 += C, ++k) {
      const int n = T - t0 < C ? T - t0 : C;
      const int words_end = (t0 + n) / kPer;
      for (int g = 0; g < G; ++g) {
        if (g > 0 && full[g] < sa::ring_full_need(k)) return sa::kRingUnmet;
        if (g + 1 < G && freed[g] < sa::ring_free_need(k, slots)) {
          return sa::kRingUnmet;
        }
        if (kDirs && g == 0 &&
            wrap_freed < sa::wrap_free_need(words_end, wrap)) {
          return sa::kRingUnmet;
        }
        Entry* rin = &ring[(static_cast<size_t>(g) * slots + k % slots) * C];
        Entry* rout =
            g + 1 < G
                ? &ring[(static_cast<size_t>(g + 1) * slots + k % slots) * C]
                : nullptr;
        const int a = w0[g], b = w1[g];
        for (int e = 0; e < n; ++e) {
          const int t = t0 + e;
          const int p = t % S;
          const int slot = t / S;
          int32_t n1y, n2y;
          pair_of(slot, n1y, n2y);
          const size_t at_t = static_cast<size_t>(row) * T + t;
          for (int x = a; x < b; ++x) pre[x] = sa::ring_pre<DIRS>(c[x], sc);
          if (rout != nullptr) {
            rout[e] = {c[b - 1].H2, pre[b - 1].dsel,
                       sa::ring_pack(c[b - 1].s1d, pre[b - 1].dflag)};
          }
          if (kDirs && b == P) {
            wacc = sa::push_code<DIRS>(wacc, pre[P - 1].dflag);
          }
          Entry left = g == 0 ? Entry{0, 0, qstream[at_t]} : rin[e];
          const bool edge = a == 0 || (p >= a && p < b);
          for (int x = b - 1; x >= a; --x) {
            int32_t lh, ld, lf, ls;
            if (x == a) {
              lh = left.h;
              ld = left.d;
              lf = sa::ring_dflag(left.s);
              ls = sa::ring_s1d(left.s);
            } else {
              lh = c[x - 1].H2;
              ld = pre[x - 1].dsel;
              lf = pre[x - 1].dflag;
              ls = c[x - 1].s1d;
            }
            if (x == p) c[x].s2v = dstream[at_t];
            const bool eq = sa::codes_match<WILDCARD>(ls, c[x].s2v);
            c[x].s1d = ls;
            const int32_t code =
                edge ? sa::ring_cell<DIRS, MODE, COMPAT, true, true>(
                           c[x], pre[x], lh, ld, lf, eq, x == 0, x == p, p,
                           sc)
                     : sa::ring_cell<DIRS, MODE, COMPAT, false, false>(
                           c[x], pre[x], lh, ld, lf, eq, false, false, p, sc);
            if (kDirs) acc[x] = sa::push_code<DIRS>(acc[x], code);
            if (kModes) {
              if (x == p) {
                flush_argmax(slot - 1, x, (slot - 1) * S);
                bv[x] = sa::kNegBig;
                bd[x] = t - x;
                sa::modes_window<MODE>(x, t, n1y, n2y, lo[x], len[x]);
              }
              sa::modes_track<MODE>(t, lo[x], len[x], c[x].M1, c[x].H1,
                                    bv[x], bd[x]);
            }
          }
          if (!kModes) {
            for (int kk = 0; kk < NP; ++kk) {
              const int x = n2s[kk * R + row];
              if (kk * S + dsum[kk * R + row] != t || x < a || x >= b) {
                continue;
              }
              int32_t* f = out + (static_cast<size_t>(row) * NP + kk) * 3;
              f[0] = c[x].M1;
              f[1] = c[x].I1;
              f[2] = c[x].D1;
            }
          }
          if (kDirs && t % kPer == kPer - 1) {
            const int w = t / kPer;
            uint32_t* dst = dirs + (static_cast<size_t>(w) * R + row) * P;
            for (int x = a; x < b; ++x) {
              if (x != 0) dst[x] = acc[x];
            }
            if (a == 0) {
              wring[w % wrap] = acc[0];
              wtag[w % wrap] = w;
            }
            if (b == P) {
              // The word must still be in its slot (not overwritten).
              if (wtag[w % wrap] != w) return sa::kRingUnmet;
              dst[0] = wring[w % wrap] | wacc;
            }
          }
        }
        if (g > 0) freed[g - 1] = k + 1;
        if (g + 1 < G) full[g + 1] = k + 1;
        if (b == P) wrap_freed = words_end;
      }
    }
    if (kModes) {
      const int slot = (T - 1) / S;
      const int p_end = (T - 1) % S;
      for (int x = 0; x < P && x < S; ++x) {
        flush_argmax(slot, x, (x <= p_end ? slot : slot - 1) * S);
      }
    }
  }
  return 0;
}

// stream_ring_host with int16 state (nw_affine_stream_i16.cu): the same
// serial schedule, each warp's lanes a word of two at a time
// (stream_cell16.cuh::ring_word16), right to left; a warp's first word
// takes its low lane's left neighbour from the ring entry, whose H2 and
// merged D source share one word (h2_his), as the kernel hands them over.
// As the kernel, each word's fast4 codes go into its pair's accumulator
// (push_code2), the first half of a direction word's steps set aside and
// the two lanes' words split out at its end (split_codes); full codes go
// into the lanes' words (push_full2).
template <int DIRS, int MODE, bool COMPAT, bool WILDCARD>
int stream_ring_host16(const int32_t* qstream, const int32_t* dstream,
                       const int32_t* dsum, const int32_t* n2s, int32_t* out,
                       uint32_t* dirs, int R, int T, int P, int S, int NP,
                       const sa::Scheme& sc0, int32_t neg,
                       const sa::Split& sp, int C, int slots, int wrap) {
  constexpr bool kModes = MODE != sa::kModeGlobal;
  constexpr bool kDirs = DIRS != sa::kDirsNone;
  constexpr int kPer = DIRS == sa::kDirsFast4 ? 8 : 4;
  const sa::Scheme16 sc = sa::scheme16(sc0, neg);
  std::vector<int> w0, w1;
  for (int rank = 0; rank < sp.nctas; ++rank) {
    const int lo = sa::cta_first_lane(rank, sp);
    const int hi = lo + sa::cta_real_lanes(rank, sp, P);
    for (int u = 0; u < sa::ring_warps(rank, sp, P); ++u) {
      w0.push_back(lo + 32 * u * sp.lpt);
      w1.push_back(lo + 32 * (u + 1) * sp.lpt < hi ? lo + 32 * (u + 1) * sp.lpt
                                                   : hi);
    }
  }
  const int G = static_cast<int>(w0.size());
  struct Entry {
    int32_t h, s;  // h: H2 (low half) and merged D source (high half)
  };
  const int PW = P / 2;
  std::vector<sa::Cell16> c(PW);
  std::vector<sa::Pre16> pre(PW);
  std::vector<int32_t> s1d(P), s2v(P);
  std::vector<uint32_t> acc(PW), first(PW), words(P);
  std::vector<int32_t> bv(P), bd(P), lo(P), len(P);
  std::vector<Entry> ring(static_cast<size_t>(G) * slots * C);
  std::vector<int32_t> full(G), freed(G);
  std::vector<uint32_t> wring(wrap);
  std::vector<int> wtag(wrap);
  const size_t plane = static_cast<size_t>(NP) * R * P;
  for (int row = 0; row < R; ++row) {
    for (int j = 0; j < PW; ++j) {
      c[j] = sa::cell16_init(neg);
      acc[j] = 0;
    }
    for (int x = 0; x < P; ++x) {
      s1d[x] = s2v[x] = 0;
      bv[x] = sa::kNegBig;
      bd[x] = -S;
      lo[x] = len[x] = 0;
    }
    for (int g = 0; g < G; ++g) full[g] = freed[g] = 0;
    for (int i = 0; i < wrap; ++i) wtag[i] = -1;
    int32_t wrap_freed = 0;
    uint32_t wacc = 0;
    auto pair_of = [&](int k, int32_t& n1, int32_t& n2) {
      n2 = k < NP ? n2s[k * R + row] : -1;
      n1 = k < NP ? dsum[k * R + row] - n2 : -1;
    };
    auto flush_argmax = [&](int k, int x, int32_t slot0) {
      if (k < 0 || k >= NP) return;
      const size_t at = (static_cast<size_t>(k) * R + row) * P + x;
      out[at] = bv[x];
      out[plane + at] = bd[x] - slot0;
    };
    for (int t0 = 0, k = 0; t0 < T; t0 += C, ++k) {
      const int n = T - t0 < C ? T - t0 : C;
      const int words_end = (t0 + n) / kPer;
      for (int g = 0; g < G; ++g) {
        if (g > 0 && full[g] < sa::ring_full_need(k)) return sa::kRingUnmet;
        if (g + 1 < G && freed[g] < sa::ring_free_need(k, slots)) {
          return sa::kRingUnmet;
        }
        if (kDirs && g == 0 &&
            wrap_freed < sa::wrap_free_need(words_end, wrap)) {
          return sa::kRingUnmet;
        }
        Entry* rin = &ring[(static_cast<size_t>(g) * slots + k % slots) * C];
        Entry* rout =
            g + 1 < G
                ? &ring[(static_cast<size_t>(g + 1) * slots + k % slots) * C]
                : nullptr;
        const int a = w0[g], b = w1[g];
        for (int e = 0; e < n; ++e) {
          const int t = t0 + e;
          const int p = t % S;
          const int slot = t / S;
          int32_t n1y, n2y;
          pair_of(slot, n1y, n2y);
          const size_t at_t = static_cast<size_t>(row) * T + t;
          for (int j = a / 2; j < b / 2; ++j) {
            pre[j] = sa::ring_pre16<DIRS>(c[j], sc);
          }
          const int jb = b / 2 - 1;
          if (rout != nullptr) {
            rout[e] = {static_cast<int32_t>(sa::h2_his(c[jb].H2, pre[jb].dsel)),
                       sa::ring_pack(s1d[b - 1],
                                     sa::dflag_hi<DIRS>(pre[jb].dcode))};
          }
          if (kDirs && b == P) {
            wacc = sa::push_code<DIRS>(wacc,
                                       sa::dflag_hi<DIRS>(pre[PW - 1].dcode));
          }
          const Entry left = g == 0 ? Entry{0, qstream[at_t]} : rin[e];
          const bool edge = a == 0 || (p >= a && p < b);
          for (int j = jb; j >= a / 2; --j) {
            const int x = 2 * j;
            uint32_t lh, ld, lc;
            int32_t ls;
            if (x == a) {
              const uint32_t hd = static_cast<uint32_t>(left.h);
              lh = sa::h2_los(hd, c[j].H2);
              ld = sa::h2_left(hd, pre[j].dsel);
              lc = sa::h2_left(sa::dflag_word<DIRS>(sa::ring_dflag(left.s)),
                               pre[j].dcode);
              ls = sa::ring_s1d(left.s);
            } else {
              lh = sa::h2_left(c[j - 1].H2, c[j].H2);
              ld = sa::h2_left(pre[j - 1].dsel, pre[j].dsel);
              lc = sa::h2_left(pre[j - 1].dcode, pre[j].dcode);
              ls = s1d[x - 1];
            }
            if (x == p) s2v[x] = dstream[at_t];
            if (x + 1 == p) s2v[x + 1] = dstream[at_t];
            s1d[x + 1] = s1d[x];
            s1d[x] = ls;
            // The word's byte of matched codes, as the kernel's mx.
            auto matched = [&](int xx) {
              return static_cast<uint32_t>(WILDCARD ? s1d[xx] & s2v[xx]
                                                    : s1d[xx] ^ s2v[xx]) &
                     15u;
            };
            const uint32_t sub2 = sa::h2_sub2<WILDCARD, 0>(
                matched(x) | matched(x + 1) << 4, sc.s);
            const int ph = x == p ? 0 : x + 1 == p ? 1 : -1;
            const uint32_t code =
                edge ? sa::ring_word16<DIRS, MODE, COMPAT, true, true>(
                           c[j], pre[j], lh, ld, lc, sub2, x == 0, ph, p, sc)
                     : sa::ring_word16<DIRS, MODE, COMPAT, false, false>(
                           c[j], pre[j], lh, ld, lc, sub2, false, -1, p, sc);
            if (DIRS == sa::kDirsFast4) {
              acc[j] = sa::push_code2(acc[j], code);
            } else if (DIRS == sa::kDirsFull) {
              sa::push_full2(words[x], words[x + 1], code);
            }
            if (kModes) {
              for (int h = 1; h >= 0; --h) {
                const int xx = x + h;
                if (xx == p) {
                  flush_argmax(slot - 1, xx, (slot - 1) * S);
                  bv[xx] = sa::kNegBig;
                  bd[xx] = t - xx;
                  sa::modes_window<MODE>(xx, t, n1y, n2y, lo[xx], len[xx]);
                }
                sa::modes_track<MODE>(t, lo[xx], len[xx],
                                      sa::h2_get(c[j].M1, h),
                                      sa::h2_get(c[j].H1, h), bv[xx],
                                      bd[xx]);
              }
            }
          }
          if (!kModes) {
            for (int kk = 0; kk < NP; ++kk) {
              const int x = n2s[kk * R + row];
              if (kk * S + dsum[kk * R + row] != t || x < a || x >= b) {
                continue;
              }
              int32_t* f = out + (static_cast<size_t>(row) * NP + kk) * 3;
              f[0] = sa::h2_get(c[x / 2].M1, x & 1);
              f[1] = sa::h2_get(c[x / 2].I1, x & 1);
              f[2] = sa::h2_get(c[x / 2].D1, x & 1);
            }
          }
          if (DIRS == sa::kDirsFast4 && t % kPer == kPer / 2 - 1) {
            for (int j = a / 2; j < b / 2; ++j) {
              first[j] = acc[j];
              acc[j] = 0;
            }
          }
          if (kDirs && t % kPer == kPer - 1) {
            const int w = t / kPer;
            uint32_t* dst = dirs + (static_cast<size_t>(w) * R + row) * P;
            for (int j = a / 2; DIRS == sa::kDirsFast4 && j < b / 2; ++j) {
              sa::split_codes(first[j], acc[j], words[2 * j],
                              words[2 * j + 1]);
              acc[j] = 0;
            }
            for (int x = a; x < b; ++x) {
              if (x != 0) dst[x] = words[x];
            }
            if (a == 0) {
              wring[w % wrap] = words[0];
              wtag[w % wrap] = w;
            }
            if (b == P) {
              if (wtag[w % wrap] != w) return sa::kRingUnmet;
              dst[0] = wring[w % wrap] | wacc;
            }
          }
        }
        if (g > 0) freed[g - 1] = k + 1;
        if (g + 1 < G) full[g + 1] = k + 1;
        if (b == P) wrap_freed = words_end;
      }
    }
    if (kModes) {
      const int slot = (T - 1) / S;
      const int p_end = (T - 1) % S;
      for (int x = 0; x < P && x < S; ++x) {
        flush_argmax(slot, x, (x <= p_end ? slot : slot - 1) * S);
      }
    }
  }
  return 0;
}

typedef int (*HostRing)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, int32_t*, uint32_t*, int, int, int,
                        int, int, const sa::Scheme&, const sa::Split&, int,
                        int, int);

template <int DIRS, int MODE>
HostRing pick_ring(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? stream_ring_host<DIRS, MODE, true, true>
                    : stream_ring_host<DIRS, MODE, true, false>;
  }
  return wildcard ? stream_ring_host<DIRS, MODE, false, true>
                  : stream_ring_host<DIRS, MODE, false, false>;
}

// The instance for (dirs, mode, flags), as the kernel's dispatch.
HostRing pick_ring_fill(int dirs_mode, int mode, bool compat, bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return mode == sa::kModeGlobal
                 ? pick_ring<sa::kDirsNone, sa::kModeGlobal>(compat, wildcard)
             : mode == sa::kModeSemi
                 ? pick_ring<sa::kDirsNone, sa::kModeSemi>(false, wildcard)
                 : pick_ring<sa::kDirsNone, sa::kModeLocal>(false, wildcard);
    case sa::kDirsFast4:
      return mode == sa::kModeGlobal
                 ? pick_ring<sa::kDirsFast4, sa::kModeGlobal>(compat,
                                                              wildcard)
                 : nullptr;
    case sa::kDirsFull:
      return mode == sa::kModeGlobal
                 ? pick_ring<sa::kDirsFull, sa::kModeGlobal>(compat, wildcard)
             : mode == sa::kModeSemi
                 ? pick_ring<sa::kDirsFull, sa::kModeSemi>(false, wildcard)
                 : pick_ring<sa::kDirsFull, sa::kModeLocal>(false, wildcard);
  }
  return nullptr;
}

int ring_fill(int mode, const int32_t* qstream, const int32_t* dstream,
              const int32_t* dsum, const int32_t* n2, int32_t* out,
              uint32_t* dirs, int R, int T, int P, int S, int NP, int match,
              int mismatch, int gap_open, int gap_extend, int dirs_mode,
              bool compat, bool wildcard, int cta_lanes, int lpt, int chunk,
              int slots, int wrap) {
  const sa::Split sp =
      sa::stream_plan(P, cta_lanes, mode != sa::kModeGlobal, lpt);
  const sa::RingShape rg =
      sa::ring_shape(chunk, slots, wrap, mode != sa::kModeGlobal);
  if (sp.nctas == 0 || R <= 0 || T <= 0 || S <= 0 || NP <= 0 ||
      !sa::ring_ok(rg)) {
    return -1;
  }
  HostRing fn = pick_ring_fill(dirs_mode, mode, compat, wildcard);
  if (fn == nullptr) return -1;
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  return fn(qstream, dstream, dsum, n2, out, dirs, R, T, P, S, NP, sc, sp,
            rg.chunk, rg.slots, rg.wrap);
}

// The per-pair fills' cells for pair_ring_host, one lane at a time: the
// state a warp's lanes start from (wb: the warp's first lane), what a lane
// hands the lane to its right before a step (the ring entry), one cell
// (left: the left lane's entry; valid: the cell lies in the pair's matrix),
// and the pair's results from its lanes once every warp has swept.
struct Entry {
  int32_t h, d, s;
};

// The Gotoh cell: kernel #7 in global mode (the corner's M/I/D), kernel #6
// in the modes (each lane's running argmax).
template <int DIRS, int MODE, bool COMPAT, bool WILDCARD>
struct HostGotohCells {
  static constexpr bool kDirs = DIRS != sa::kDirsNone;
  struct Lane {
    sa::Cell c;
    int32_t bv, bd;
  };
  static Lane start(int wb, const sa::Scheme& sc) {
    Lane l;
    l.c = sa::triangle_state<MODE>(wb - 1, sc);
    l.c.s1d = 0;
    l.bv = sa::kNegBig;
    l.bd = 0;
    return l;
  }
  static Entry hand(const Lane& l, const sa::Scheme& sc) {
    const sa::Pre p = sa::stream_pre<DIRS>(l.c, sc);
    return {l.c.H2, p.dsel, l.c.s1d | p.dflag << 8};
  }
  static int32_t cell(Lane& l, const Entry& left, int x, int t, int32_t qc,
                      bool valid, int32_t n1, int32_t n2, int32_t /*mv*/,
                      const sa::Scheme& sc) {
    const sa::Pre mine = sa::stream_pre<DIRS>(l.c, sc);
    sa::Pre lp;
    lp.t0 = 0;
    lp.dsel = left.d;
    lp.dflag = left.s >> 8;
    const int32_t code = sa::stream_cell<DIRS, MODE, COMPAT, WILDCARD>(
        l.c, mine, left.h, lp, left.s & 0xff, x == 0, x == t, t, qc, l.c.s2v,
        sc);
    if (MODE != sa::kModeGlobal) {
      sa::modes_update<MODE>(x, t - x, t, n1, n2, l.c.M1, l.c.H1, l.bv,
                             l.bd);
    }
    return valid ? code : 0;
  }
  static void finish(const std::vector<Lane>& lanes, const sa::PairArgs& a,
                     int b, int32_t n2, bool corner) {
    if (MODE == sa::kModeGlobal) {
      if (corner) {
        a.out[static_cast<size_t>(b) * 3 + 0] = lanes[n2].c.M1;
        a.out[static_cast<size_t>(b) * 3 + 1] = lanes[n2].c.I1;
        a.out[static_cast<size_t>(b) * 3 + 2] = lanes[n2].c.D1;
      }
      return;
    }
    const size_t stride = static_cast<size_t>(a.B) * a.P;
    for (int x = 0; x < a.P; ++x) {
      a.out[static_cast<size_t>(b) * a.P + x] = lanes[x].bv;
      a.out[stride + static_cast<size_t>(b) * a.P + x] = lanes[x].bd;
    }
  }
};

// The linear cell: the corner's score into out[b], the maximum over the
// pair's cells into out2[b].  Its lanes start from lin_init.
template <bool DIRS, bool COMPAT, bool LOCAL>
struct HostLinearCells {
  static constexpr bool kDirs = DIRS;
  struct Lane {
    sa::LinCell c;
  };
  static Lane start(int /*wb*/, const sa::Scheme&) { return {sa::lin_init()}; }
  static Entry hand(const Lane& l, const sa::Scheme&) {
    return {l.c.S2, l.c.S1, l.c.s1d | l.c.G1 << 8};
  }
  static int32_t cell(Lane& l, const Entry& left, int x, int t, int32_t qc,
                      bool valid, int32_t, int32_t, int32_t mv,
                      const sa::Scheme& sc) {
    const int32_t code = sa::linear_cell<COMPAT, LOCAL, DIRS>(
        l.c, left.h, left.d, left.s >> 8, left.s & 0xff, x == 0, x == t, t,
        qc, valid, mv, sc);
    return valid ? code : 0;
  }
  static void finish(const std::vector<Lane>& lanes, const sa::PairArgs& a,
                     int b, int32_t n2, bool corner) {
    if (corner) a.out[b] = lanes[n2].c.S1;
    for (const Lane& l : lanes) a.out2[b] = sa::imax(a.out2[b], l.c.best);
  }
};

// The per-pair fills in the kernels' warp-ring schedule (pair_sweep.cuh),
// run serially: pair by pair, chunk by chunk, and in each chunk the pair's
// warps in order (CTA by CTA), each over its own steps only (its first
// lane's row-0 cell to its last lane's row-n1 cell, plus one when the next
// warp holds lanes of the pair's db, never past the last step), its lanes
// starting from Pol::start.  A warp's first lane takes the left lane's
// pre-step values from its ring slot, written by the warp to its left in
// this chunk's pass; lane 0 takes the step's query code and nothing from
// the left.  Every wait is checked in that order: one that would not hold
// returns kRingUnmet.  Bytes of cells outside the pair's matrix are 0, and
// so is every word a warp does not sweep.
template <class Pol>
int pair_ring_host(const sa::PairArgs& a, const sa::Split& sp, int C,
                   int slots) {
  using Lane = typename Pol::Lane;
  const int B = a.B, L1 = a.L1, P = a.P, D_total = a.D_total;
  const sa::Scheme& sc = a.sc;
  const int wlanes = 32 * sp.lpt;
  std::vector<int> w0, w1;
  for (int rank = 0; rank < sp.nctas; ++rank) {
    const int lo = sa::cta_first_lane(rank, sp);
    const int hi = lo + sa::cta_real_lanes(rank, sp, P);
    for (int u = 0; u < sa::ring_warps(rank, sp, P); ++u) {
      w0.push_back(lo + u * wlanes);
      w1.push_back(lo + (u + 1) * wlanes < hi ? lo + (u + 1) * wlanes : hi);
    }
  }
  const int G = static_cast<int>(w0.size());
  const int W = (D_total + 3) / 4;
  const size_t stride = static_cast<size_t>(B) * P;
  std::vector<Lane> lanes(P);
  std::vector<uint32_t> acc(P);
  std::vector<Entry> ring(static_cast<size_t>(G) * slots * C);
  std::vector<int32_t> full(G), freed(G);
  std::vector<char> active(G), has_next(G);
  std::vector<int> t_end(G);
  for (int b = 0; b < B; ++b) {
    const int32_t n1 = a.n1s[b], n2 = a.n2s[b];
    const int32_t mv = a.maxv != nullptr ? a.maxv[b] : 0;
    uint32_t* drow = a.dirs + static_cast<size_t>(b) * P;
    int k_last = -1;
    for (int g = 0; g < G; ++g) {
      active[g] = n1 >= 0 && n2 >= 0 && w0[g] <= n2;
      has_next[g] = active[g] && w1[g] <= n2;
      const int last = w1[g] - 1 < n2 ? w1[g] - 1 : n2;
      t_end[g] = last + n1 + (has_next[g] ? 1 : 0);
      if (t_end[g] > D_total - 1) t_end[g] = D_total - 1;
      full[g] = 0;
      freed[g] = w1[g] / C;
      const Lane first = Pol::start(w0[g], sc);
      for (int x = w0[g]; x < w1[g]; ++x) {
        lanes[x] = first;
        lanes[x].c.s2v = a.s2v[static_cast<size_t>(b) * P + x];
        acc[x] = 0;
      }
      // Words the warp does not sweep (all of them for an idle warp).
      const int lo_w = active[g] ? w0[g] / 4 : W;
      const int hi_w = active[g] ? t_end[g] / 4 + 1 : W;
      for (int w = 0; w < W; ++w) {
        if (Pol::kDirs && (w < lo_w || w >= hi_w)) {
          for (int x = w0[g]; x < w1[g]; ++x) drow[w * stride + x] = 0;
        }
      }
      if (active[g] && t_end[g] / C > k_last) k_last = t_end[g] / C;
    }
    for (int k = 0; k <= k_last; ++k) {
      for (int g = 0; g < G; ++g) {
        if (!active[g] || k * C > t_end[g] || k * C + C - 1 < w0[g]) {
          continue;
        }
        const int lo = w0[g], hi = w1[g];
        if (g > 0 && w0[g] > 0 && k * C <= lo + n1 &&
            full[g] < sa::ring_full_need(k)) {
          return sa::kRingUnmet;
        }
        if (has_next[g] && freed[g] < sa::ring_free_need(k, slots)) {
          return sa::kRingUnmet;
        }
        Entry* rin = &ring[(static_cast<size_t>(g) * slots + k % slots) * C];
        Entry* rout =
            has_next[g]
                ? &ring[(static_cast<size_t>(g + 1) * slots + k % slots) * C]
                : nullptr;
        const int t_lo = k * C > lo ? k * C : lo;
        const int t_hi = k * C + C - 1 < t_end[g] ? k * C + C - 1 : t_end[g];
        for (int t = t_lo; t <= t_hi; ++t) {
          const int e = t - k * C;
          const int q = t - 1 < 0 ? 0 : (t - 1 > L1 - 1 ? L1 - 1 : t - 1);
          const int32_t qc = a.query[static_cast<size_t>(b) * L1 + q];
          if (rout != nullptr) rout[e] = Pol::hand(lanes[hi - 1], sc);
          // Lane 0's left lane hands over nothing.
          const Entry left = lo == 0 ? Entry{0, 0, 0} : rin[e];
          // Right to left, so lane x-1 still holds its pre-step state.
          for (int x = hi - 1; x >= lo; --x) {
            const Entry l = x == lo ? left : Pol::hand(lanes[x - 1], sc);
            const uint32_t lim =
                x <= n2 ? static_cast<uint32_t>(n1 + 1) : 0u;
            const bool valid = static_cast<uint32_t>(t - x) < lim;
            const int32_t code =
                Pol::cell(lanes[x], l, x, t, qc, valid, n1, n2, mv, sc);
            acc[x] |= static_cast<uint32_t>(code) << (8u * (t & 3));
          }
          if (Pol::kDirs && ((t & 3) == 3 || t == t_end[g])) {
            for (int x = lo; x < hi; ++x) {
              drow[static_cast<size_t>(t >> 2) * stride + x] = acc[x];
              acc[x] = 0;
            }
          }
        }
        if (g > 0 && w0[g] > 0) freed[g - 1] = k + 1;
        if (has_next[g]) full[g + 1] = k + 1;
      }
    }
    // The corner: lane n2 has swept its row-n1 cell.
    const bool corner = n1 >= 0 && n2 >= 0 && n1 + n2 <= D_total - 1;
    Pol::finish(lanes, a, b, n2, corner);
  }
  return 0;
}

// The SM count the host build plans the per-pair split for (an H100).
constexpr int kHostSms = 132;

// A per-pair fill of Pol split and ringed as the kernels' wrappers plan it
// (for kHostSms SMs; knobs: cta_lanes, lpt, chunk, slots, 0 the default),
// run serially: -1 for an out-of-range shape, kRingUnmet for a schedule
// whose waits would not hold.
template <class Pol>
int run_pair(const sa::PairArgs& a, const int (&knobs)[4]) {
  const sa::Split sp = sa::pair_plan(a.P, a.B, kHostSms, knobs[0], knobs[1]);
  const sa::RingShape rg = sa::ring_shape(knobs[2], knobs[3], 0, true);
  if (sp.nctas == 0 || a.B <= 0 || a.L1 <= 0 || a.D_total <= 0 ||
      !sa::ring_ok(rg)) {
    return -1;
  }
  return pair_ring_host<Pol>(a, sp, rg.chunk, rg.slots);
}

typedef int (*HostRing16)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, int32_t*, uint32_t*, int, int, int,
                          int, int, const sa::Scheme&, int32_t,
                          const sa::Split&, int, int, int);

template <int DIRS, int MODE>
HostRing16 pick_ring16(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? stream_ring_host16<DIRS, MODE, true, true>
                    : stream_ring_host16<DIRS, MODE, true, false>;
  }
  return wildcard ? stream_ring_host16<DIRS, MODE, false, true>
                  : stream_ring_host16<DIRS, MODE, false, false>;
}

// The int16 instance for (dirs, mode, flags), as pick_ring_fill.
HostRing16 pick_ring16_fill(int dirs_mode, int mode, bool compat,
                            bool wildcard) {
  switch (dirs_mode) {
    case sa::kDirsNone:
      return mode == sa::kModeGlobal
                 ? pick_ring16<sa::kDirsNone, sa::kModeGlobal>(compat,
                                                               wildcard)
             : mode == sa::kModeSemi
                 ? pick_ring16<sa::kDirsNone, sa::kModeSemi>(false, wildcard)
                 : pick_ring16<sa::kDirsNone, sa::kModeLocal>(false,
                                                              wildcard);
    case sa::kDirsFast4:
      return mode == sa::kModeGlobal
                 ? pick_ring16<sa::kDirsFast4, sa::kModeGlobal>(compat,
                                                                wildcard)
                 : nullptr;
    case sa::kDirsFull:
      return mode == sa::kModeGlobal
                 ? pick_ring16<sa::kDirsFull, sa::kModeGlobal>(compat,
                                                               wildcard)
             : mode == sa::kModeSemi
                 ? pick_ring16<sa::kDirsFull, sa::kModeSemi>(false, wildcard)
                 : pick_ring16<sa::kDirsFull, sa::kModeLocal>(false,
                                                              wildcard);
  }
  return nullptr;
}

int ring_fill16(int mode, const int32_t* qstream, const int32_t* dstream,
                const int32_t* dsum, const int32_t* n2, int32_t* out,
                uint32_t* dirs, int R, int T, int P, int S, int NP, int match,
                int mismatch, int gap_open, int gap_extend, int dirs_mode,
                bool compat, bool wildcard, int cta_lanes, int lpt, int chunk,
                int slots, int wrap, int neg) {
  const sa::Split sp =
      sa::stream_plan(P, cta_lanes, mode != sa::kModeGlobal, lpt);
  const sa::RingShape rg =
      sa::ring_shape(chunk, slots, wrap, mode != sa::kModeGlobal);
  if (sp.nctas == 0 || R <= 0 || T <= 0 || S <= 0 || NP <= 0 ||
      !sa::ring_ok(rg)) {
    return -1;
  }
  HostRing16 fn = pick_ring16_fill(dirs_mode, mode, compat, wildcard);
  if (fn == nullptr) return -1;
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  return fn(qstream, dstream, dsum, n2, out, dirs, R, T, P, S, NP, sc, neg,
            sp, rg.chunk, rg.slots, rg.wrap);
}

}  // namespace

// sa_stream_fill's arguments minus the stream: the status word is not
// written (a wait that would not hold returns kRingUnmet, -4, instead).
extern "C" int hc_stream_fill(const int32_t* qstream, const int32_t* dstream,
                              const int32_t* dsum, const int32_t* n2,
                              int32_t* finals, uint32_t* dirs,
                              int32_t* /*status*/, int R, int T, int P, int S,
                              int NP, int match, int mismatch, int gap_open,
                              int gap_extend, int dirs_mode, int compat,
                              int wildcard, int cta_lanes, int lpt, int chunk,
                              int slots, int wrap) {
  return ring_fill(sa::kModeGlobal, qstream, dstream, dsum, n2, finals, dirs,
                   R, T, P, S, NP, match, mismatch, gap_open, gap_extend,
                   dirs_mode, compat != 0, wildcard != 0, cta_lanes, lpt,
                   chunk, slots, wrap);
}

// sa_stream_fill_i16's arguments minus the stream (as hc_stream_fill).
extern "C" int hc_stream_fill_i16(
    const int32_t* qstream, const int32_t* dstream, const int32_t* dsum,
    const int32_t* n2, int32_t* finals, uint32_t* dirs, int32_t* /*status*/,
    int R, int T, int P, int S, int NP, int match, int mismatch, int gap_open,
    int gap_extend, int dirs_mode, int compat, int wildcard, int cta_lanes,
    int lpt, int chunk, int slots, int wrap, int neg) {
  return ring_fill16(sa::kModeGlobal, qstream, dstream, dsum, n2, finals,
                     dirs, R, T, P, S, NP, match, mismatch, gap_open,
                     gap_extend, dirs_mode, compat != 0, wildcard != 0,
                     cta_lanes, lpt, chunk, slots, wrap, neg);
}

// sa_stream_modes_fill_i16's arguments minus the stream.
extern "C" int hc_stream_modes_fill_i16(
    const int32_t* qstream, const int32_t* dstream, const int32_t* dsum,
    const int32_t* n2, int32_t* out, uint32_t* dirs, int32_t* /*status*/,
    int R, int T, int P, int S, int NP, int match, int mismatch, int gap_open,
    int gap_extend, int dirs_mode, int local, int wildcard, int cta_lanes,
    int lpt, int chunk, int slots, int wrap, int neg) {
  if (dirs_mode == sa::kDirsFast4) return -1;
  return ring_fill16(local ? sa::kModeLocal : sa::kModeSemi, qstream,
                     dstream, dsum, n2, out, dirs, R, T, P, S, NP, match,
                     mismatch, gap_open, gap_extend, dirs_mode, false,
                     wildcard != 0, cta_lanes, lpt, chunk, slots, wrap, neg);
}

// The packed int16 helpers as the host computes them (stream_cell16.cuh),
// on words a, b, c: out rows 0-6 are h2_add_max(a, b, c),
// h2_add_max_relu(a, b, c), h2_max3(a, b, c), h2_max(a, b), h2_ne(a, b)
// (0 or 1 in each half), h2_left(a, b) and h2_add(a, b), each n words.
extern "C" void hc_h2_dpx(const uint32_t* a, const uint32_t* b,
                          const uint32_t* c, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    out[i] = sa::h2_add_max(a[i], b[i], c[i]);
    out[n + i] = sa::h2_add_max_relu(a[i], b[i], c[i]);
    out[2 * n + i] = sa::h2_max3(a[i], b[i], c[i]);
    out[3 * n + i] = sa::h2_max(a[i], b[i]);
    out[4 * n + i] = sa::h2_ne(a[i], b[i]);
    out[5 * n + i] = sa::h2_left(a[i], b[i]);
    out[6 * n + i] = sa::h2_add(a[i], b[i]);
  }
}

// The int16 instances' word-at-a-time flags and codes (stream_cell16.cuh),
// as ring_word16 builds them from a cell's packed M, I, D (after the
// step), I1 / D1 (before it), t0 = M1 + o and local's M before its clamp
// m: out rows 0-3 are h2_code_fast4 and h2_code_full (H = max(M, I, D),
// isel = max(I1, t0), no left D bits, full with m's restarts) and
// h2_dcode for fast4 and full (dsel = max(D1, t0)); rows 4 and 5 are the
// low and high lanes' direction words of split_codes after pushing the
// fast4 code words I, D, I1, m, then D1, t0, M, H (row 0's layout); rows
// 6 and 7 those of push_full2 after the full code words I, D, I1, m (row
// 1's layout).
extern "C" void hc_h2_codes(const uint32_t* M, const uint32_t* I,
                            const uint32_t* D, const uint32_t* I1,
                            const uint32_t* t0, const uint32_t* D1,
                            const uint32_t* m, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    const uint32_t H = sa::h2_max3(M[i], I[i], D[i]);
    const uint32_t isel = sa::h2_max(I1[i], t0[i]);
    const uint32_t dsel = sa::h2_max(D1[i], t0[i]);
    out[i] = sa::h2_code_fast4(M[i], I[i], H, isel, I1[i], 0);
    out[n + i] = sa::h2_code_full(M[i], I[i], D[i], H, isel, I1[i], t0[i],
                                  0, m[i] & sa::kH2Min);
    out[2 * n + i] = sa::h2_dcode<sa::kDirsFast4>(D1[i], t0[i], dsel);
    out[3 * n + i] = sa::h2_dcode<sa::kDirsFull>(D1[i], t0[i], dsel);
    const uint32_t mask = 0xf000f000u;
    uint32_t first = 0, acc = 0;
    for (const uint32_t* v : {I, D, I1, m}) {
      first = sa::push_code2(first, v[i] & mask);
    }
    for (const uint32_t* v : {D1, t0, M}) acc = sa::push_code2(acc, v[i] & mask);
    acc = sa::push_code2(acc, H & mask);
    sa::split_codes(first, acc, out[4 * n + i], out[5 * n + i]);
    uint32_t lo = 0, hi = 0;
    for (const uint32_t* v : {I, D, I1, m}) sa::push_full2(lo, hi, v[i]);
    out[6 * n + i] = lo;
    out[7 * n + i] = hi;
  }
}

// The streamed fills' launch shape (sa_stream_plan).
extern "C" int hc_stream_plan(int P, int cta_lanes, int modes, int lpt,
                              int chunk, int slots, int wrap, int* shape) {
  return sa::stream_launch_shape(P, cta_lanes, modes != 0, lpt, chunk, slots,
                                 wrap, shape);
}

namespace {

// The staged walks' warp run serially (traceback_device.cuh's Ops), for a
// ring of ROWS rows a slot: the probe's 32 lanes in a loop; a slot's
// copies land at its wait, its rows holding a poison pattern from the
// copy's start until then, so a read of a slot not yet waited on shows.
template <int ROWS>
struct HostOps {
  static constexpr uint32_t kPoison = 0xA5C3E1F7u;
  std::vector<uint32_t> ring =
      std::vector<uint32_t>(sa::kSlots * ROWS * sa::kStagePitch, kPoison);
  int32_t offs[sa::kSlots] = {};
  int n_of[sa::kSlots] = {};
  const uint32_t* src_of[sa::kSlots][ROWS] = {};
  unsigned restarts = 0;

  int lane() const { return 0; }
  int lanes() const { return 1; }
  void init() {}
  template <class F>
  void probe(F f, uint32_t& mm, uint32_t& okm, uint32_t& v0) {
    mm = okm = 0;
    for (int j = 0; j < 32; ++j) {
      uint32_t v;
      bool ok, mv;
      f(j, v, ok, mv);
      if (mv) mm |= 1u << j;
      if (ok) okm |= 1u << j;
      if (j == 0) v0 = v;
    }
  }
  uint32_t word(int r, int li) const {
    return ring[static_cast<size_t>(r) * sa::kStagePitch + li];
  }
  template <class Src>
  void copy(int r0, int n, int q, Src src) {
    n_of[q] = n;
    for (int j = 0; j < ROWS; ++j) {
      if (j < n) src_of[q][j] = src(j);
      for (int l = 0; l < sa::kStagePitch; ++l) {
        ring[static_cast<size_t>(r0 + j) * sa::kStagePitch + l] = kPoison;
      }
    }
  }
  void wait(int q) {
    for (int j = 0; j < n_of[q]; ++j) {
      memcpy(&ring[static_cast<size_t>(q * ROWS + j) * sa::kStagePitch],
             src_of[q][j], 4 * sa::kWalkWindow);
    }
    n_of[q] = 0;
  }
  void sync() {}
  void drain() {
    for (int q = 0; q < sa::kSlots; ++q) wait(q);
  }
  void count_restart() { ++restarts; }
  void set_offset(int q, int32_t e) { offs[q] = e; }
  int32_t offset(int q) const { return offs[q]; }
};

}  // namespace

// sa_walk_fast4's arguments minus the stream: the kernel's staged schedule
// run serially; slow: null, or two counters, the words the slow path read
// and the ring's restagings added to them.
extern "C" int hc_walk_fast4(const uint32_t* dirs, int NW, int R, int P,
                             const int32_t* x0, const int32_t* y0,
                             const int32_t* plane0, const int32_t* rowp,
                             const int32_t* off, int B, int WP,
                             uint32_t* packed, int32_t* xf, int32_t* yf,
                             int32_t* n_ops, uint64_t* slow) {
  if (NW <= 0 || R <= 0 || P < sa::kWalkWindow || P % 4 != 0 || B <= 0 ||
      WP <= 0) {
    return -1;
  }
  for (int b = 0; b < B; ++b) {
    HostOps<8> ops;
    int32_t x = x0[b];
    int32_t y = y0[b];
    unsigned nslow = 0;
    sa::walk_fast4_staged(ops, dirs, NW, R, P, static_cast<size_t>(rowp[b]),
                          off[b], x, y, plane0[b],
                          packed + static_cast<size_t>(b) * WP, WP, n_ops[b],
                          nslow);
    xf[b] = x;
    yf[b] = y;
    if (slow != nullptr) {
      slow[0] += nslow;
      slow[1] += ops.restarts;
    }
  }
  return 0;
}

// sa_stream_modes_fill's arguments minus the stream (as hc_stream_fill).
extern "C" int hc_stream_modes_fill(
    const int32_t* qstream, const int32_t* dstream, const int32_t* dsum,
    const int32_t* n2, int32_t* out, uint32_t* dirs, int32_t* /*status*/,
    int R, int T, int P, int S, int NP, int match, int mismatch, int gap_open,
    int gap_extend, int dirs_mode, int local, int wildcard, int cta_lanes,
    int lpt, int chunk, int slots, int wrap) {
  if (dirs_mode == sa::kDirsFast4) return -1;
  return ring_fill(local ? sa::kModeLocal : sa::kModeSemi, qstream, dstream,
                   dsum, n2, out, dirs, R, T, P, S, NP, match, mismatch,
                   gap_open, gap_extend, dirs_mode, false, wildcard != 0,
                   cta_lanes, lpt, chunk, slots, wrap);
}

// sa_modes_fill's arguments minus the stream (the split planned for
// kHostSms SMs): the status word is not written (a wait that would not
// hold returns kRingUnmet, -4, instead).
extern "C" int hc_modes_fill(const int32_t* query, const int32_t* s2v,
                             const int32_t* n1, const int32_t* n2,
                             int32_t* out, uint32_t* dirs, int B, int L1,
                             int P, int D_total, int match, int mismatch,
                             int gap_open, int gap_extend, int dirs_mode,
                             int local, int wildcard, int cta_lanes,
                             int32_t* /*status*/, int lpt, int chunk,
                             int slots) {
  const sa::PairArgs a{query, s2v,     n1, n2, nullptr, out, nullptr,
                       dirs,  nullptr, B,  L1, P,       D_total,
                       {match, mismatch, gap_open, gap_extend}};
  const int k[4] = {cta_lanes, lpt, chunk, slots};
  using sa::kDirsFull;
  using sa::kDirsNone;
  using sa::kModeLocal;
  using sa::kModeSemi;
  const bool w = wildcard != 0;
  if (dirs_mode == kDirsNone) {
    if (local) {
      return w ? run_pair<HostGotohCells<kDirsNone, kModeLocal, false, true>>(
                     a, k)
               : run_pair<HostGotohCells<kDirsNone, kModeLocal, false,
                                         false>>(a, k);
    }
    return w ? run_pair<HostGotohCells<kDirsNone, kModeSemi, false, true>>(
                   a, k)
             : run_pair<HostGotohCells<kDirsNone, kModeSemi, false, false>>(
                   a, k);
  }
  if (dirs_mode != kDirsFull) return -1;
  if (local) {
    return w ? run_pair<HostGotohCells<kDirsFull, kModeLocal, false, true>>(
                   a, k)
             : run_pair<HostGotohCells<kDirsFull, kModeLocal, false, false>>(
                   a, k);
  }
  return w ? run_pair<HostGotohCells<kDirsFull, kModeSemi, false, true>>(a, k)
           : run_pair<HostGotohCells<kDirsFull, kModeSemi, false, false>>(a,
                                                                          k);
}

// The per-pair fills' launch shape (sa_pair_plan, for kHostSms SMs).
extern "C" int hc_pair_plan(int P, int B, int cta_lanes, int lpt, int chunk,
                            int slots, int* shape) {
  return sa::pair_launch_shape(P, B, kHostSms, cta_lanes, lpt, chunk, slots,
                               shape);
}

// sa_gotoh_fill's arguments minus the stream (as hc_modes_fill).
extern "C" int hc_gotoh_fill(const int32_t* query, const int32_t* s2v,
                             const int32_t* n1, const int32_t* n2,
                             int32_t* finals, uint32_t* dirs, int B, int L1p,
                             int P, int D_total, int match, int mismatch,
                             int gap_open, int gap_extend, int dirs_mode,
                             int compat, int wildcard, int cta_lanes,
                             int32_t* /*status*/, int lpt, int chunk,
                             int slots) {
  const sa::PairArgs a{query, s2v,     n1, n2,  nullptr, finals, nullptr,
                       dirs,  nullptr, B,  L1p, P,       D_total,
                       {match, mismatch, gap_open, gap_extend}};
  const int k[4] = {cta_lanes, lpt, chunk, slots};
  constexpr int G = sa::kModeGlobal;
  const bool c = compat != 0, w = wildcard != 0;
  if (dirs_mode == sa::kDirsNone) {
    constexpr int N = sa::kDirsNone;
    if (c) {
      return w ? run_pair<HostGotohCells<N, G, true, true>>(a, k)
               : run_pair<HostGotohCells<N, G, true, false>>(a, k);
    }
    return w ? run_pair<HostGotohCells<N, G, false, true>>(a, k)
             : run_pair<HostGotohCells<N, G, false, false>>(a, k);
  }
  if (dirs_mode != sa::kDirsFull) return -1;
  constexpr int F = sa::kDirsFull;
  if (c) {
    return w ? run_pair<HostGotohCells<F, G, true, true>>(a, k)
             : run_pair<HostGotohCells<F, G, true, false>>(a, k);
  }
  return w ? run_pair<HostGotohCells<F, G, false, true>>(a, k)
           : run_pair<HostGotohCells<F, G, false, false>>(a, k);
}

// sa_walk_modes's arguments minus the stream (as hc_walk_fast4).
extern "C" int hc_walk_modes(const uint32_t* dirs, int NW, int R, int P,
                             const int32_t* x0, const int32_t* y0,
                             const int32_t* rowp, const int32_t* off, int B,
                             int WP, int local, uint32_t* packed, int32_t* xf,
                             int32_t* yf, int32_t* st, int32_t* n_ops,
                             uint64_t* slow) {
  if (NW <= 0 || R <= 0 || P < sa::kWalkWindow || P % 4 != 0 || B <= 0 ||
      WP <= 0) {
    return -1;
  }
  for (int b = 0; b < B; ++b) {
    HostOps<16> ops;
    int32_t x = x0[b];
    int32_t y = y0[b];
    unsigned nslow = 0;
    uint32_t* out = packed + static_cast<size_t>(b) * WP;
    const size_t row = static_cast<size_t>(rowp[b]);
    if (local) {
      sa::walk_modes_staged<true>(ops, dirs, NW, R, P, row, off[b], x, y,
                                  st[b], n_ops[b], out, WP, nslow);
    } else {
      sa::walk_modes_staged<false>(ops, dirs, NW, R, P, row, off[b], x, y,
                                   st[b], n_ops[b], out, WP, nslow);
    }
    xf[b] = x;
    yf[b] = y;
    if (slow != nullptr) {
      slow[0] += nslow;
      slow[1] += ops.restarts;
    }
  }
  return 0;
}

namespace {

// The banded fill's tiled route run serially (nw_banded_diag.cu): the tiles
// in ticket order, each computing lanes [lo, hi) of its pair over its block
// from the lanes' state at the block's start, with the kernel's chunk modes
// (band_cell, lean_cell with or without its valid mask), its end-lane rule
// and entering characters, and keeping its own lanes' codes, finals and end
// state; every lane reads its neighbour's state from before the step, as
// the kernel's shifts give it.  The counters as the kernel's (ctr: ticket,
// status, SM bitmaps, then per strip the blocks it has published).  Every
// wait a CTA would make (strips s - 1 .. s + 1 of the previous block
// published) must already hold when its tile runs: a wait that does not
// returns -4.
template <int DIRS, bool WILDCARD, bool STD>
int band_tiles_host(const int32_t* s1w0, const int32_t* s2w0,
                    const int32_t* c1s, const int32_t* c2s,
                    const int32_t* n1v, const int32_t* n2v, int32_t* finals,
                    uint32_t* dirs, int32_t* state, int32_t* ctr, int B,
                    int L, int n_iters, int he, int lim1, int lim0,
                    bool compat, const sa::Scheme& sc,
                    const sa::BandTiles& g) {
  constexpr int kUp = DIRS == sa::kDirsFast4 ? 8 : 4;
  constexpr int kSmWords = 8;
  const int rows = sa::band_rows(g, n_iters);
  const int ntiles = rows * B * g.S;
  int32_t* done_all = ctr + 2 + B * kSmWords;
  std::vector<sa::BandCell> c, c0;
  std::vector<uint32_t> acc;
  for (int ticket = 0; ticket < ntiles; ++ticket) {
    ctr[0] = ticket + 1;
    const sa::BandTile t = sa::band_tile(ticket, g, B, L, n_iters);
    int32_t* done = done_all + t.b * g.S;
    if (t.tau > 0) {
      for (int s = sa::band_dep_lo(t); s <= sa::band_dep_hi(t, g); ++s) {
        if (done[s] < t.tau) return -4;
      }
    }
    const int32_t n1 = n1v[t.b];
    const int32_t n2 = n2v[t.b];
    const int32_t* s1r = s1w0 + static_cast<size_t>(t.b) * L;
    const int32_t* s2r = s2w0 + static_cast<size_t>(t.b) * L;
    const int32_t* c1r = c1s + static_cast<size_t>(t.b) * n_iters;
    const int32_t* c2r = c2s + static_cast<size_t>(t.b) * n_iters;
    const int n = t.hi - t.lo;
    c.assign(n, sa::BandCell());
    acc.assign(n, 0);
    for (int k = 0; k < n; ++k) {
      const int l = t.lo + k;
      sa::BandCell& ck = c[k];
      if (t.tau == 0) {
        ck.M1 = l == -he ? 0 : sa::kNegBig;
        ck.I1 = ck.D1 = ck.H2 = sa::kNegBig;
      } else {
        const int32_t* v =
            state + 4 * ((static_cast<size_t>(t.tau & 1) * B + t.b) * L + l);
        ck.M1 = v[0];
        ck.I1 = v[1];
        ck.D1 = v[2];
        ck.H2 = v[3];
      }
      ck.H1 = sa::max3(ck.M1, ck.I1, ck.D1);
      ck.s1w = sa::band_s1(s1r, c1r, L, l + t.i0) & 0xf;
      ck.s2w = sa::band_s2(s2r, c2r, l - t.i0) & 0xf;
    }
    int ca = 0, clane = 0;
    const bool corner = sa::band_corner(n1, n2, he, ca, clane) &&
                        clane >= t.own_lo && clane < t.own_hi;
    // Wavefront a of parity par with the chunk's cell mode.
    auto step = [&](int par, int a, int32_t enter, int mode) {
      c0 = c;
      const int q = (a - par) / 2 - he;
      const int lim = par ? lim1 : lim0;
      int vlo = 0, vhi = 0;
      sa::band_valid_lanes(a, q, n1, n2, lim, vlo, vhi);
      const int aidx = a - 1;
      const uint32_t shift =
          DIRS == sa::kDirsFast4 ? 4u * (aidx & 7) : 8u * (aidx & 3);
      for (int k = 0; k < n; ++k) {
        const int l = t.lo + k;
        const bool end = par ? k == n - 1 : k == 0;
        const sa::BandCell& nb = c0[end ? k : (par ? k + 1 : k - 1)];
        const int32_t nbo = end ? sa::kNegBig : sa::band_open<STD>(nb, sc);
        const int32_t nbg = end ? sa::kNegBig : (par ? nb.D1 : nb.I1);
        const int32_t nbc = end ? (enter & 0xf) : (par ? nb.s1w : nb.s2w);
        sa::BandCell& ck = c[k];
        const int32_t xv = q - l;
        int32_t code;
        if (mode == sa::kBandRamp) {
          code = par ? sa::band_cell<1, DIRS, WILDCARD, STD>(
                           ck, nbo, nbg, nbc, xv, a - xv, l <= lim, n1, n2,
                           compat, sc)
                     : sa::band_cell<0, DIRS, WILDCARD, STD>(
                           ck, nbo, nbg, nbc, xv, a - xv, l <= lim, n1, n2,
                           compat, sc);
        } else {
          const int32_t own = sa::band_open<STD>(c0[k], sc);
          if (par) {
            ck.s1w = nbc;
          } else {
            ck.s2w = nbc;
          }
          const bool eq = sa::band_eq<WILDCARD>(
              sa::band_cmp<WILDCARD>(ck.s1w, ck.s2w), 0);
          const bool valid = l >= vlo && l <= vhi;
          const int32_t io = par ? own : nbo, ig = par ? c0[k].I1 : nbg;
          const int32_t dopen = par ? nbo : own, dg = par ? nbg : c0[k].D1;
          int32_t H;
          code = mode == sa::kBandMasked
                     ? sa::lean_cell<DIRS, true>(ck.H2, eq, io, ig, dopen, dg,
                                                 valid, sc, ck.M1, ck.I1,
                                                 ck.D1, H)
                     : sa::lean_cell<DIRS, false>(ck.H2, eq, io, ig, dopen,
                                                  dg, true, sc, ck.M1, ck.I1,
                                                  ck.D1, H);
          ck.H2 = ck.H1;
          ck.H1 = H;
        }
        acc[k] |= static_cast<uint32_t>(code) << shift;
        if (corner && a == ca && l == clane) {
          finals[static_cast<size_t>(t.b) * 3 + 0] = ck.M1;
          finals[static_cast<size_t>(t.b) * 3 + 1] = ck.I1;
          finals[static_cast<size_t>(t.b) * 3 + 2] = ck.D1;
        }
      }
      if (DIRS != sa::kDirsNone &&
          ((aidx & (kUp - 1)) == kUp - 1 || aidx == 2 * n_iters - 1)) {
        for (int k = 0; k < n; ++k) {
          const int l = t.lo + k;
          if (l >= t.own_lo && l < t.own_hi) {
            dirs[(static_cast<size_t>(aidx / kUp) * B + t.b) * L + l] =
                acc[k];
          }
          acc[k] = 0;
        }
      }
    };
    for (int it = 0; it < t.nit; it += 4) {
      const int nn = t.nit - it < 4 ? t.nit - it : 4;
      const int mode = sa::band_chunk_mode(t.i0 + it, nn, t.lo, t.hi, he, n1,
                                           n2, lim1, lim0);
      for (int k = 0; k < nn; ++k) {
        const int i = t.i0 + it + k;
        step(1, 2 * i + 1, sa::band_s1(s1r, c1r, L, t.hi + i), mode);
        step(0, 2 * i + 2, sa::band_s2(s2r, c2r, t.lo - i - 1), mode);
      }
    }
    if (t.tau + 1 < rows) {
      for (int l = t.own_lo; l < t.own_hi; ++l) {
        const sa::BandCell& ck = c[l - t.lo];
        int32_t* v = state +
                     4 * ((static_cast<size_t>((t.tau + 1) & 1) * B + t.b) *
                              L + l);
        v[0] = ck.M1;
        v[1] = ck.I1;
        v[2] = ck.D1;
        v[3] = ck.H2;
      }
      done[t.s] = t.tau + 1;
    }
  }
  return 0;
}

typedef int (*HostBand)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, const int32_t*,
                        int32_t*, uint32_t*, int32_t*, int32_t*, int, int, int,
                        int, int, int, bool, const sa::Scheme&,
                        const sa::BandTiles&);

template <int DIRS, bool STD>
HostBand pick_band(bool wildcard) {
  return wildcard ? band_tiles_host<DIRS, true, STD>
                  : band_tiles_host<DIRS, false, STD>;
}

}  // namespace

extern "C" int hc_fill_ctas(int P, int cta_lanes) {
  return sa::plan_split(P, cta_lanes).nctas;
}

// sa_banded_fill run serially (its arguments minus lpt, threads, the grid
// and the stream): finals (B, 3) zeroed by the caller; state (2, B, L, 4)
// int32 when there are several blocks; ctr 2 + 8B + B * strips int32,
// zeroed.  -1 for an unsupported shape or mode, -4 for a schedule whose
// waits would not hold in ticket order.
extern "C" int hc_banded_fill(const int32_t* s1w0, const int32_t* s2w0,
                              const int32_t* c1s, const int32_t* c2s,
                              const int32_t* n1v, const int32_t* n2v,
                              int32_t* finals, uint32_t* dirs, int32_t* state,
                              int32_t* ctr, int B, int L, int n_iters, int he,
                              int lim1, int lim0, int match, int mismatch,
                              int gap_open, int gap_extend, int dirs_mode,
                              int compat, int wildcard, int std_model,
                              int strip_lanes, int block_iters, int order) {
  const sa::BandTiles g{strip_lanes, block_iters,
                        strip_lanes > 0 ? (L + strip_lanes - 1) / strip_lanes
                                        : 0,
                        order};
  if (B <= 0 || !sa::band_tiles_ok(g, L, n_iters)) return -1;
  if (sa::band_rows(g, n_iters) > 1 && state == nullptr) return -1;
  HostBand fn = nullptr;
  const bool w = wildcard != 0;
  if (std_model) {
    if (dirs_mode == sa::kDirsNone) fn = pick_band<sa::kDirsNone, true>(w);
    if (dirs_mode == sa::kDirsFast4) fn = pick_band<sa::kDirsFast4, true>(w);
  } else {
    if (dirs_mode == sa::kDirsNone) fn = pick_band<sa::kDirsNone, false>(w);
    if (dirs_mode == sa::kDirsFast4) fn = pick_band<sa::kDirsFast4, false>(w);
    if (dirs_mode == sa::kDirsFull) fn = pick_band<sa::kDirsFull, false>(w);
  }
  if (fn == nullptr) return -1;
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  return fn(s1w0, s2w0, c1s, c2s, n1v, n2v, finals, dirs, state, ctr, B, L,
            n_iters, he, lim1, lim0, compat != 0, sc, g);
}

// sa_walk_banded's arguments minus the stream: the kernel's staged window
// run serially (batch m - 1 of kWalkDepth rows copied when the walk enters
// batch m), the words the slow path read added to *slow (when not null).
extern "C" int hc_walk_banded(const uint32_t* dirs, int W, int NB, int L,
                              const int32_t* x0, const int32_t* y0,
                              const int32_t* plane0, const int32_t* bidx,
                              int k_lo_even, int B, int WP, int std_model,
                              uint32_t* packed, int32_t* xf, int32_t* yf,
                              int32_t* n_ops, int win, uint64_t* slow) {
  if (W <= 0 || NB <= 0 || L < sa::kWalkWindow || L % 4 != 0 || B <= 0 ||
      WP <= 0 || !sa::walk_window(win)) {
    return -1;
  }
  constexpr int D = sa::kWalkDepth;
  std::vector<uint32_t> st(static_cast<size_t>(2 * D) * sa::kWalkWindow);
  int32_t lo_of[2];
  for (int b = 0; b < B; ++b) {
    int32_t x = x0[b];
    int32_t y = y0[b];
    int32_t plane = plane0[b];
    const size_t nb = static_cast<size_t>(bidx[b]);
    uint32_t* out = packed + static_cast<size_t>(b) * WP;
    uint32_t word = 0;
    int i = 0;
    int w = 0;
    auto stage_batch = [&](int32_t m, int32_t center) {
      const int q = m & 1;
      lo_of[q] = sa::window_at(center, win, L);
      for (int j = 0; j < D; ++j) {
        for (int l = 0; l < sa::kWalkWindow; ++l) {
          st[(q * D + j) * sa::kWalkWindow + l] =
              m * D + j < W ? sa::banded_word(dirs, W, NB, L, nb, m * D + j,
                                              lo_of[q] + l)
                            : 0;
        }
      }
    };
    if (x > 0 && y > 0) {
      int32_t a = x + y - 1;
      int32_t lane = sa::band_lane(x, y, k_lo_even);
      int32_t row = a >> 3;
      int32_t m = row / D;
      stage_batch(m, lane);
      if (m > 0) stage_batch(m - 1, lane);
      int32_t lane_in = lane;  // the walk's lane on entering batch m
      int32_t lo = lo_of[m & 1];
      int32_t held = INT32_MIN;
      uint32_t v = 0;
      for (;;) {
        if (lane != held) {
          held = lane;
          const int32_t li = lane - lo;
          if (static_cast<uint32_t>(li) < static_cast<uint32_t>(win)) {
            v = st[(row % (2 * D)) * sa::kWalkWindow + li];
          } else if (lane < 0 || lane >= L || row >= W) {
            v = 0;
          } else {
            v = sa::banded_word(dirs, W, NB, L, nb, row, lane);
            if (slow != nullptr) ++*slow;
          }
        }
        uint32_t bits;
        const int k =
            std_model ? sa::walk_banded_moves<true>(v, a, x, y, plane, bits)
                      : sa::walk_banded_moves<false>(v, a, x, y, plane, bits);
        sa::emit_ops(bits, k, i, w, word, out);
        if (x == 0 || y == 0) break;
        a = x + y - 1;
        lane = sa::band_lane(x, y, k_lo_even);
        if ((a >> 3) != row) {
          row = a >> 3;
          if (row / D != m) {
            m = row / D;
            const int32_t drift = lane - lane_in;
            lane_in = lane;
            if (m > 0) stage_batch(m - 1, lane + drift + drift / 2);
            lo = lo_of[m & 1];
          }
          held = INT32_MIN;
        }
      }
    }
    sa::emit_run(x == 0 ? 2u : 3u, x + y, i, w, word, out);
    if (i & 15) out[w++] = word;
    for (; w < WP; ++w) out[w] = 0;
    xf[b] = 0;
    yf[b] = 0;
    n_ops[b] = i;
  }
  return 0;
}

namespace {

// The tiled fill's strip schedule run serially (nw_affine_tiled.cu): the
// items in ticket order, each strip swept step by step with its lane 0's
// rows staged R at a time from its producer's ring slot, its last lane
// written into its own slot and published every R rows, and the kernels'
// counters (ctr: ticket, status, SM bitmaps, then per strip the rows
// published and consumed).  Every wait a CTA would make must already hold
// when its strip runs (its producer and its slot's last reader hold earlier
// tickets): a wait that does not returns -4.
template <bool COMPAT, bool WILDCARD>
int strips_host(const int32_t* query, const int32_t* db, const int32_t* n1v,
                const int32_t* n2v, int32_t* finals, int32_t* col,
                int32_t* ctr, const int32_t* items, int B, int L1, int L2,
                int nitems, int nstrips, int W, int R, int K,
                const sa::Scheme& sc) {
  constexpr int kSmWords = 8;
  const int nrow = L1 + 1;
  int32_t* prog = ctr + 2 + B * kSmWords;
  int32_t* cons = prog + nstrips;
  std::vector<sa::Cell> c(W), c0(W);
  std::vector<int32_t> ds(W), qs(R), hs(R), os(R);
  for (int ticket = 0; ticket < nitems; ++ticket) {
    ctr[0] = ticket + 1;
    const sa::StripItem it = sa::strip_item(items, ticket);
    const int32_t n1 = n1v[it.b];
    const int32_t n2 = n2v[it.b];
    const int x0 = it.s * W + 1;
    const bool last = it.s == sa::strip_count(n2, W) - 1;
    const int g_end = sa::strip_steps(n1, n2, x0, W, last);
    const int gcap = n2 - x0 + n1;
    const int32_t* q = query + static_cast<size_t>(it.b) * L1;
    const int32_t* cin =
        it.s > 0 ? col + sa::strip_slot(it.b, it.s - 1, K, nrow) : nullptr;
    int32_t* cout =
        last ? nullptr : col + sa::strip_slot(it.b, it.s, K, nrow);
    for (int l = 0; l < W; ++l) {
      c[l] = sa::cell_init();
      const int x = x0 + l;
      c[l].s2v = x <= n2 ? db[static_cast<size_t>(it.b) * L2 + x - 1] : 0;
    }
    for (int g = 0; g < g_end; ++g) {
      const int gc = g & (R - 1);
      if (gc == 0) {
        if (cin != nullptr && g <= n1 &&
            prog[it.gs - 1] < sa::chunk_rows_needed(g, R, n1)) {
          return -4;
        }
        const int need =
            cout != nullptr ? sa::ring_rows_needed(g, R, W, n1, it.s, K) : 0;
        if (need > 0 && cons[it.gs - K + 1] < need) return -4;
        for (int i = 0; i < R; ++i) {
          sa::tile_stage_row(g + i, n1, L1, q, cin, COMPAT, sc, qs[i], hs[i],
                             os[i]);
        }
        if (cin != nullptr) cons[it.gs] = sa::chunk_consumed(g, R);
      }
      for (int l = 0; l < W; ++l) ds[l] = sa::tile_dsel(c[l].M1, c[l].D1, sc);
      c0 = c;  // the neighbours' state before the step
      for (int l = W - 1; l >= 0; --l) {
        const int32_t lH2 = l == 0 ? hs[gc] : c0[l - 1].H2;
        const int32_t ldsel = l == 0 ? os[gc] : ds[l - 1];
        const int32_t ls1d = l == 0 ? qs[gc] : c0[l - 1].s1d;
        const bool eq = sa::tile_eq<WILDCARD>(ls1d, c[l].s2v, 0xfu);
        c[l].H2 = c[l].H1;
        c[l].H1 = sa::tile_cell<COMPAT>(eq, lH2, ldsel, l == g, x0 + l,
                                        c[l].M1, c[l].I1, c[l].D1, sc);
        c[l].s1d = ls1d;
      }
      if (last && g == gcap) {
        const sa::Cell& cc = c[n2 - x0];
        finals[static_cast<size_t>(it.b) * 3 + 0] = cc.M1;
        finals[static_cast<size_t>(it.b) * 3 + 1] = cc.I1;
        finals[static_cast<size_t>(it.b) * 3 + 2] = cc.D1;
      }
      if (cout != nullptr && g >= W - 1) {
        const int y = g - W + 1;
        const sa::Cell& e = c[W - 1];
        cout[2 * y] = e.H1;
        cout[2 * y + 1] = sa::add_max(e.M1, sc.gap_open, e.D1);
        const int pub = sa::chunk_publish(y, R, n1);
        if (pub >= 0) prog[it.gs] = pub;
      }
    }
    if (cin != nullptr) cons[it.gs] = sa::kStripDone;
  }
  return 0;
}

typedef int (*HostStrips)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, int32_t*, int32_t*, int32_t*,
                          const int32_t*, int, int, int, int, int, int, int,
                          int, const sa::Scheme&);

// One launch of the shard fill (nw_affine_tiled.cu, SHARD) run serially:
// its items from ctr[0] on, in ticket order, each strip swept step by step
// with its column from shard_strip_io (a whole column of the launch, or a
// boundary buffer another launch writes) and its last lane published
// there.  A strip whose boundary buffer is not complete yet (its producer
// is in a launch that has not got so far) is not started: the call returns
// 1 with ctr[0] at that ticket, to be called again once the other launches
// have run further.  0 when every item ran; -4 for a wait inside a strip
// that does not hold.
template <bool COMPAT, bool WILDCARD>
int shard_host(const int32_t* query, const int32_t* db, const int32_t* n1v,
               const int32_t* n2v, int32_t* finals, int32_t* col,
               int32_t* ctr, const int32_t* items, const int64_t* bufs,
               int B, int L1, int L2, int nitems, int nstrips, int W,
               int seg_strips, int nseg, int R, const sa::Scheme& sc) {
  constexpr int kSmWords = 8;
  const int nrow = L1 + 1;
  int32_t* prog = ctr + 2 + B * kSmWords;
  int32_t* cons = prog + nstrips;
  std::vector<sa::Cell> c(W), c0(W);
  std::vector<int32_t> ds(W), qs(R), hs(R), os(R);
  for (int ticket = ctr[0]; ticket < nitems; ++ticket) {
    const sa::StripItem it = sa::strip_item(items, ticket);
    const int32_t n1 = n1v[it.b];
    const int32_t n2 = n2v[it.b];
    const int x0 = it.s * W + 1;
    const bool last = it.s == sa::strip_count(n2, W) - 1;
    const int g_end = sa::strip_steps(n1, n2, x0, W, last);
    const int gcap = n2 - x0 + n1;
    const int32_t* q = query + static_cast<size_t>(it.b) * L1;
    const sa::StripIO io =
        sa::shard_strip_io(it, last, seg_strips, nseg, bufs, col, prog, nrow);
    // A boundary buffer's count may be stored by another thread (the
    // seqpar relay filling an inbox): loaded with acquire order, and the
    // producer's stored with release order, so the rows it covers are in
    // place.
    if (io.cin_peer && __atomic_load_n(io.cin_rows, __ATOMIC_ACQUIRE) <
                           n1 + 1) {
      ctr[0] = ticket;
      return 1;
    }
    for (int l = 0; l < W; ++l) {
      c[l] = sa::cell_init();
      const int x = x0 + l;
      c[l].s2v = x <= n2 ? db[static_cast<size_t>(it.b) * L2 + x - 1] : 0;
    }
    for (int g = 0; g < g_end; ++g) {
      const int gc = g & (R - 1);
      if (gc == 0) {
        if (io.cin != nullptr && g <= n1 &&
            __atomic_load_n(io.cin_rows, __ATOMIC_ACQUIRE) <
                sa::chunk_rows_needed(g, R, n1)) {
          return -4;
        }
        for (int i = 0; i < R; ++i) {
          sa::tile_stage_row(g + i, n1, L1, q, io.cin, COMPAT, sc, qs[i],
                             hs[i], os[i]);
        }
        if (io.cin != nullptr) cons[it.gs] = sa::chunk_consumed(g, R);
      }
      for (int l = 0; l < W; ++l) ds[l] = sa::tile_dsel(c[l].M1, c[l].D1, sc);
      c0 = c;  // the neighbours' state before the step
      for (int l = W - 1; l >= 0; --l) {
        const int32_t lH2 = l == 0 ? hs[gc] : c0[l - 1].H2;
        const int32_t ldsel = l == 0 ? os[gc] : ds[l - 1];
        const int32_t ls1d = l == 0 ? qs[gc] : c0[l - 1].s1d;
        const bool eq = sa::tile_eq<WILDCARD>(ls1d, c[l].s2v, 0xfu);
        c[l].H2 = c[l].H1;
        c[l].H1 = sa::tile_cell<COMPAT>(eq, lH2, ldsel, l == g, x0 + l,
                                        c[l].M1, c[l].I1, c[l].D1, sc);
        c[l].s1d = ls1d;
      }
      if (last && g == gcap) {
        const sa::Cell& cc = c[n2 - x0];
        finals[static_cast<size_t>(it.b) * 3 + 0] = cc.M1;
        finals[static_cast<size_t>(it.b) * 3 + 1] = cc.I1;
        finals[static_cast<size_t>(it.b) * 3 + 2] = cc.D1;
      }
      if (io.cout != nullptr && g >= W - 1) {
        const int y = g - W + 1;
        const sa::Cell& e = c[W - 1];
        io.cout[2 * y] = e.H1;
        io.cout[2 * y + 1] = sa::add_max(e.M1, sc.gap_open, e.D1);
        const int pub = sa::chunk_publish(y, R, n1);
        if (pub >= 0) __atomic_store_n(io.cout_rows, pub, __ATOMIC_RELEASE);
      }
    }
    if (io.cin != nullptr) cons[it.gs] = sa::kStripDone;
    ctr[0] = ticket + 1;
  }
  return 0;
}

typedef int (*HostShard)(const int32_t*, const int32_t*, const int32_t*,
                         const int32_t*, int32_t*, int32_t*, int32_t*,
                         const int32_t*, const int64_t*, int, int, int, int,
                         int, int, int, int, int, const sa::Scheme&);

}  // namespace

// sa_tiled_fill / sa_tiled_fold_fill run serially (their arguments minus
// the grid size and the stream): finals (B, 3) zeroed by the caller, col
// B * ring slots of 2 * (L1 + 1) int32, ctr 2 + 8B + 2 * nstrips int32
// zeroed, items (nitems, 3) strip-major.  -1 for an unsupported shape, -4
// for a schedule whose waits would not hold in ticket order.
extern "C" int hc_tiled_fill(const int32_t* query, const int32_t* db,
                             const int32_t* n1v, const int32_t* n2v,
                             int32_t* finals, int32_t* col, int32_t* ctr,
                             const int32_t* items, int B, int L1, int L2,
                             int nitems, int nstrips, int match,
                             int mismatch, int gap_open, int gap_extend,
                             int compat, int wildcard, int strip_lanes,
                             int chunk_rows, int ring) {
  if (strip_lanes <= 0 || strip_lanes % 128 != 0 || strip_lanes > 4096 ||
      chunk_rows < 2 || chunk_rows > 128 || (chunk_rows & (chunk_rows - 1)) ||
      ring < 2 || B <= 0 || L1 <= 0 ||
      L2 <= 0 || nitems <= 0) {
    return -1;
  }
  HostStrips fn;
  if (compat) {
    fn = wildcard ? strips_host<true, true> : strips_host<true, false>;
  } else {
    fn = wildcard ? strips_host<false, true> : strips_host<false, false>;
  }
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  return fn(query, db, n1v, n2v, finals, col, ctr, items, B, L1, L2, nitems,
            nstrips, strip_lanes, chunk_rows, ring, sc);
}

// sa_tiled_shard_fill run serially (its arguments minus the grid size and
// the stream): one device's launch, resumable -- 1 when it stopped before
// a strip whose boundary buffer another launch has not completed (ctr[0]
// holds that ticket; call again after the others), 0 when all its items
// ran, -1 for an unsupported shape, -4 for a wait inside a strip that
// would not hold.  A mesh's launches are run by calling each in turn until
// all return 0.
extern "C" int hc_tiled_shard_fill(const int32_t* query, const int32_t* db,
                                   const int32_t* n1v, const int32_t* n2v,
                                   int32_t* finals, int32_t* col,
                                   int32_t* ctr, const int32_t* items,
                                   const int64_t* bufs, int B, int L1,
                                   int L2, int nitems, int nstrips,
                                   int match, int mismatch, int gap_open,
                                   int gap_extend, int compat, int wildcard,
                                   int strip_lanes, int seg_strips, int nseg,
                                   int chunk_rows) {
  if (strip_lanes <= 0 || strip_lanes % 128 != 0 || strip_lanes > 4096 ||
      chunk_rows < 2 || chunk_rows > 128 || (chunk_rows & (chunk_rows - 1)) ||
      seg_strips < 1 || nseg < 1 || bufs == nullptr || B <= 0 || L1 <= 0 ||
      L2 <= 0 || nitems <= 0) {
    return -1;
  }
  HostShard fn;
  if (compat) {
    fn = wildcard ? shard_host<true, true> : shard_host<true, false>;
  } else {
    fn = wildcard ? shard_host<false, true> : shard_host<false, false>;
  }
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  return fn(query, db, n1v, n2v, finals, col, ctr, items, bufs, B, L1, L2,
            nitems, nstrips, strip_lanes, seg_strips, nseg, chunk_rows, sc);
}

// The tiled cell's DPX helpers as the host computes them: out[i] =
// add_max(a[i], b[i], c[i]) and out[n + i] = max3(a[i], b[i], c[i]).
extern "C" void hc_tile_dpx(const int32_t* a, const int32_t* b,
                            const int32_t* c, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    out[i] = sa::add_max(a[i], b[i], c[i]);
    out[n + i] = sa::max3(a[i], b[i], c[i]);
  }
}

namespace {

// Kernel #8's block route (nw_banded.cu) for one pair, serially: the same
// chunks of 4 lanes a thread, each thread's lanes scanned in order, the
// threads' totals combined into each thread's exclusive maximum and the
// chunk's maximum carried to the next chunk, through nw_banded.cuh.
template <int DIRS, bool COMPAT, bool WILDCARD>
void banded_row_host(const int32_t* s1w0, const int32_t* qin,
                     const int32_t* dcs, const int32_t* n1v,
                     const int32_t* n2v, int32_t* finals, uint32_t* dirs,
                     int B, int K, int Xp, int l2, int k_lo, int threads,
                     const sa::Scheme& sc) {
  constexpr int kLpt = 4;
  constexpr int kUp = DIRS == sa::kDirsFast4 ? 8 : 4;
  constexpr uint32_t kBits = 32 / kUp;
  const int W = threads * kLpt;
  const int nch = (K + W - 1) / W;
  std::vector<int32_t> rows(8 * static_cast<size_t>(K));
  std::vector<uint32_t> acc(K);
  std::vector<int32_t> M(W), D(W), dd(W), Dpr(W), v(W), s1(W), tot(threads),
      mleft(threads);
  for (int b = 0; b < B; ++b) {
    const int32_t n1 = n1v[b], n2 = n2v[b];
    const int32_t kc = n1 - n2 - k_lo;
    int32_t* fin = finals + static_cast<size_t>(b) * 3;
    for (int k = 0; k < K; ++k) {
      int32_t m, i, d, h;
      const int32_t code =
          sa::row0_cell<DIRS>(k, k_lo, n1, COMPAT, sc, m, i, d, h);
      rows[k] = m;
      rows[K + k] = d;
      rows[2 * K + k] = h;
      rows[3 * K + k] = s1w0[static_cast<size_t>(b) * K + k];
      if (n2 == 0 && k == kc) {
        fin[0] = m;
        fin[1] = i;
        fin[2] = d;
      }
      acc[k] = static_cast<uint32_t>(code);
      if (DIRS != sa::kDirsNone && l2 == 0) {
        dirs[static_cast<size_t>(b) * K + k] = acc[k];
      }
    }
    for (int x = 1; x <= l2; ++x) {
      const int32_t qc = qin[static_cast<size_t>(b) * Xp + x];
      const int32_t dc = dcs[static_cast<size_t>(b) * Xp + x];
      const int32_t* pM = rows.data() + static_cast<size_t>((x - 1) & 1) * 4 * K;
      const int32_t* pD = pM + K;
      const int32_t* pH = pD + K;
      const int32_t* pS = pH + K;
      int32_t* cM = rows.data() + static_cast<size_t>(x & 1) * 4 * K;
      int32_t* cD = cM + K;
      int32_t* cH = cD + K;
      int32_t* cS = cH + K;
      const sa::RowCtx r = sa::row_ctx(x, k_lo, n1, n2, COMPAT, sc);
      const uint32_t shift = kBits * (x & (kUp - 1));
      const bool flush = (x & (kUp - 1)) == kUp - 1 || x == l2;
      int32_t carry = sa::kScanFill;
      for (int c = 0; c < nch; ++c) {
        for (int j = 0; j < threads; ++j) {
          const int k0 = c * W + j * kLpt;
          int32_t ml = sa::kRowNegBig;
          if (k0 > 0 && k0 <= K - 1) {
            ml = sa::row_m<WILDCARD>(r, k0 - 1, pH[k0 - 1], pS[k0], dc, sc);
          }
          mleft[j] = ml;
          int32_t t = sa::kScanFill;
          for (int i = 0; i < kLpt; ++i) {
            const int k = k0 + i, at = j * kLpt + i;
            if (k < K) {
              const bool last = k == K - 1;
              s1[at] = last ? qc : pS[k + 1];
              M[at] = sa::row_m<WILDCARD>(r, k, pH[k], s1[at], dc, sc);
              D[at] = sa::row_d(r, k, K, last ? 0 : pM[k + 1],
                                last ? 0 : pD[k + 1], sc, dd[at], Dpr[at]);
              v[at] = sa::row_v(r, k, ml, sc);
              ml = M[at];
            } else {
              v[at] = sa::kScanFill;
            }
            t = sa::imax(t, v[at]);
          }
          tot[j] = t;
        }
        int32_t excl = carry;
        for (int j = 0; j < threads; ++j) {
          const int k0 = c * W + j * kLpt;
          int32_t I_l = k0 > 0 && k0 <= K
                            ? sa::row_i_masked(r, k0 - 1, excl, sc)
                            : sa::kRowNegBig;
          int32_t M_l = mleft[j];
          int32_t run = excl;
          for (int i = 0; i < kLpt; ++i) {
            const int k = k0 + i, at = j * kLpt + i;
            if (k >= K) break;
            run = sa::imax(run, v[at]);
            int32_t I, H;
            const int32_t code = sa::row_post<DIRS>(
                r, k, M[at], D[at], dd[at], Dpr[at], M_l, I_l, run, sc, I, H);
            cM[k] = M[at];
            cD[k] = D[at];
            cH[k] = H;
            cS[k] = s1[at];
            if (x == n2 && k == kc) {
              fin[0] = M[at];
              fin[1] = I;
              fin[2] = D[at];
            }
            if (DIRS != sa::kDirsNone) {
              const uint32_t w = acc[k] | (static_cast<uint32_t>(code) << shift);
              if (flush) {
                dirs[(static_cast<size_t>(x / kUp) * B + b) * K + k] = w;
                acc[k] = 0;
              } else {
                acc[k] = w;
              }
            }
            I_l = I;
            M_l = M[at];
          }
          excl = sa::imax(excl, tot[j]);
        }
        carry = excl;
      }
    }
  }
}

// Kernel #8's warp route (nw_banded_warp.cu) for each pair, serially: a
// row's 32 threads in a loop through nw_banded.cuh's passes, each taking
// its neighbours' row x-1 values as the shuffles give them (a snapshot at
// the row's start), the warp's scan a serial maximum of the keys.
template <int LPT, int DIRS, bool WILDCARD>
void banded_row_warp_host(const int32_t* s1w0, const int32_t* qin,
                          const int32_t* dcs, const int32_t* n1v,
                          const int32_t* n2v, int32_t* finals,
                          uint32_t* dirs, int B, int Xp, int l2, int k_lo,
                          bool compat, const sa::Scheme& sc) {
  constexpr int kT = 32, K = kT * LPT;
  constexpr int kUp = DIRS == sa::kDirsFast4 ? 8 : 4;
  constexpr uint32_t kBits = 32 / kUp;
  int32_t M[kT][LPT], D[kT][LPT], Hp[kT][LPT], S1[kT][LPT], C[kT][LPT];
  uint32_t acc[kT][LPT], bits[kT][LPT];
  int32_t m_r[kT], d_r[kT], s_r[kT], hp_l[kT], M_left[kT], A[kT];
  bool plain[kT];
  for (int b = 0; b < B; ++b) {
    const int32_t n1 = n1v[b], n2 = n2v[b];
    const int32_t kc = n1 - n2 - k_lo;
    int32_t* fin = finals + static_cast<size_t>(b) * 3;
    for (int t = 0; t < kT; ++t) {
      for (int i = 0; i < LPT; ++i) {
        const int k = t * LPT + i;
        int32_t I;
        acc[t][i] = static_cast<uint32_t>(sa::row0_cell<DIRS>(
            k, k_lo, n1, compat, sc, M[t][i], I, D[t][i], Hp[t][i]));
        S1[t][i] = s1w0[static_cast<size_t>(b) * K + k];
        if (n2 == 0 && k == kc) {
          fin[0] = M[t][i];
          fin[1] = I;
          fin[2] = D[t][i];
        }
        if (DIRS != sa::kDirsNone && l2 == 0) {
          dirs[static_cast<size_t>(b) * K + k] = acc[t][i];
        }
      }
    }
    for (int x = 1; x <= l2; ++x) {
      const int32_t qc = qin[static_cast<size_t>(b) * Xp + x];
      const int32_t dc = dcs[static_cast<size_t>(b) * Xp + x];
      const sa::RowCtx r = sa::row_ctx(x, k_lo, n1, n2, compat, sc);
      const uint32_t shift = kBits * (x & (kUp - 1));
      for (int t = 0; t < kT; ++t) {
        m_r[t] = t < kT - 1 ? M[t + 1][0] : sa::kRowNegBig;
        d_r[t] = t < kT - 1 ? D[t + 1][0] : sa::kRowNegBig;
        s_r[t] = t < kT - 1 ? S1[t + 1][0] : qc;
        hp_l[t] = t > 0 ? Hp[t - 1][LPT - 1] : 0;
      }
      for (int t = 0; t < kT; ++t) {
        const int k0 = t * LPT;
        M_left[t] = t > 0 ? sa::row_m<WILDCARD>(r, k0 - 1, hp_l[t],
                                                S1[t][0], dc, sc)
                          : sa::kRowNegBig;
        plain[t] = sa::row_span(r, k0, LPT).plain;
        A[t] = plain[t]
                   ? sa::row_warp_pre<LPT, DIRS, WILDCARD, true>(
                         r, k0, M[t], D[t], Hp[t], S1[t], C[t], bits[t],
                         m_r[t], d_r[t], s_r[t], M_left[t], dc, sc)
                   : sa::row_warp_pre<LPT, DIRS, WILDCARD, false>(
                         r, k0, M[t], D[t], Hp[t], S1[t], C[t], bits[t],
                         m_r[t], d_r[t], s_r[t], M_left[t], dc, sc);
      }
      int32_t excl = 0;
      for (int t = 0; t < kT; ++t) {
        const int k0 = t * LPT;
        const int32_t R_in = sa::row_r_in(excl, t, LPT, sc);
        const int32_t key = sa::row_key(A[t], t, LPT, sc);
        excl = t == 0 ? key : sa::imax(excl, key);
        if (x == n2) {
          sa::row_warp_post<LPT, DIRS, false, true>(
              r, k0, M[t], D[t], C[t], bits[t], Hp[t], acc[t], shift,
              M_left[t], R_in, sc, fin, kc);
        } else if (plain[t]) {
          sa::row_warp_post<LPT, DIRS, true, false>(
              r, k0, M[t], D[t], C[t], bits[t], Hp[t], acc[t], shift,
              M_left[t], R_in, sc, nullptr, kc);
        } else {
          sa::row_warp_post<LPT, DIRS, false, false>(
              r, k0, M[t], D[t], C[t], bits[t], Hp[t], acc[t], shift,
              M_left[t], R_in, sc, nullptr, kc);
        }
      }
      if (DIRS != sa::kDirsNone && ((x & (kUp - 1)) == kUp - 1 || x == l2)) {
        for (int t = 0; t < kT; ++t) {
          for (int i = 0; i < LPT; ++i) {
            dirs[(static_cast<size_t>(x / kUp) * B + b) * K + t * LPT + i] =
                acc[t][i];
            acc[t][i] = 0;
          }
        }
      }
    }
  }
}

typedef void (*HostRowWarp)(const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, const int32_t*, int32_t*,
                            uint32_t*, int, int, int, int, bool,
                            const sa::Scheme&);

template <int LPT, int DIRS>
HostRowWarp pick_row_warp_wild(bool wildcard) {
  return wildcard ? banded_row_warp_host<LPT, DIRS, true>
                  : banded_row_warp_host<LPT, DIRS, false>;
}

template <int LPT>
HostRowWarp pick_row_warp_dirs(int dirs_mode, bool wildcard) {
  if (dirs_mode == sa::kDirsNone) {
    return pick_row_warp_wild<LPT, sa::kDirsNone>(wildcard);
  }
  if (dirs_mode == sa::kDirsFast4) {
    return pick_row_warp_wild<LPT, sa::kDirsFast4>(wildcard);
  }
  if (dirs_mode == sa::kDirsFull) {
    return pick_row_warp_wild<LPT, sa::kDirsFull>(wildcard);
  }
  return nullptr;
}

HostRowWarp pick_row_warp(int lpt, int dirs_mode, bool wildcard) {
  switch (lpt) {
    case 4: return pick_row_warp_dirs<4>(dirs_mode, wildcard);
    case 8: return pick_row_warp_dirs<8>(dirs_mode, wildcard);
    case 12: return pick_row_warp_dirs<12>(dirs_mode, wildcard);
    case 16: return pick_row_warp_dirs<16>(dirs_mode, wildcard);
    default: return nullptr;
  }
}

typedef void (*HostRow)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, int32_t*, uint32_t*,
                        int, int, int, int, int, int, const sa::Scheme&);

template <int DIRS>
HostRow pick_row(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? banded_row_host<DIRS, true, true>
                    : banded_row_host<DIRS, true, false>;
  }
  return wildcard ? banded_row_host<DIRS, false, true>
                  : banded_row_host<DIRS, false, false>;
}

}  // namespace

// sa_banded_row_fill minus the scratch and the stream; chunk_lanes as the
// kernel's (0: the warp route up to 512 lanes, else the block route's K / 4
// threads up to 512; > 0: the block route's chunk width).
extern "C" int hc_banded_row_warp_lanes(int K, int chunk_lanes) {
  return sa::row_warp_lpt(K, chunk_lanes);
}

extern "C" int hc_banded_row_fill(const int32_t* s1w0, const int32_t* qin,
                                  const int32_t* dcs, const int32_t* n1v,
                                  const int32_t* n2v, int32_t* finals,
                                  uint32_t* dirs, int B, int K, int Xp,
                                  int l2, int k_lo, int match, int mismatch,
                                  int gap_open, int gap_extend, int dirs_mode,
                                  int compat, int wildcard, int chunk_lanes) {
  if (K <= 0 || K % 128 != 0 || chunk_lanes < 0 || chunk_lanes % 128 != 0 ||
      chunk_lanes > 2048 || B <= 0 || l2 < 0 || Xp < l2 + 1) {
    return -1;
  }
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  const bool c = compat != 0, w = wildcard != 0;
  const int lpt = sa::row_warp_lpt(K, chunk_lanes);
  if (lpt > 0) {
    HostRowWarp wf = pick_row_warp(lpt, dirs_mode, w);
    if (wf == nullptr) return -1;
    wf(s1w0, qin, dcs, n1v, n2v, finals, dirs, B, Xp, l2, k_lo, c, sc);
    return 0;
  }
  int threads = (chunk_lanes ? chunk_lanes : K) / 4;
  if (threads > 512) threads = 512;
  HostRow fn = nullptr;
  if (dirs_mode == sa::kDirsNone) fn = pick_row<sa::kDirsNone>(c, w);
  if (dirs_mode == sa::kDirsFast4) fn = pick_row<sa::kDirsFast4>(c, w);
  if (dirs_mode == sa::kDirsFull) fn = pick_row<sa::kDirsFull>(c, w);
  if (fn == nullptr) return -1;
  fn(s1w0, qin, dcs, n1v, n2v, finals, dirs, B, K, Xp, l2, k_lo, threads, sc);
  return 0;
}

// sa_linear_fill's arguments minus the stream (as hc_modes_fill).
extern "C" int hc_linear_fill(const int32_t* query, const int32_t* s2v,
                              const int32_t* n1v, const int32_t* n2v,
                              const int32_t* maxv, int32_t* corner,
                              int32_t* runmax, uint32_t* dirs, int B, int L1p,
                              int P, int D_total, int match, int mismatch,
                              int gap_open, int gap_extend, int with_dirs,
                              int compat, int local, int cta_lanes,
                              int32_t* /*status*/, int lpt, int chunk,
                              int slots) {
  const sa::PairArgs a{query, s2v,     n1v, n2v, maxv, corner, runmax,
                       dirs,  nullptr, B,   L1p, P,    D_total,
                       {match, mismatch, gap_open, gap_extend}};
  const int k[4] = {cta_lanes, lpt, chunk, slots};
  const bool c = compat != 0, l = local != 0;
  if (with_dirs) {
    if (l) {
      return c ? run_pair<HostLinearCells<true, true, true>>(a, k)
               : run_pair<HostLinearCells<true, false, true>>(a, k);
    }
    return c ? run_pair<HostLinearCells<true, true, false>>(a, k)
             : run_pair<HostLinearCells<true, false, false>>(a, k);
  }
  if (l) {
    return c ? run_pair<HostLinearCells<false, true, true>>(a, k)
             : run_pair<HostLinearCells<false, false, true>>(a, k);
  }
  return c ? run_pair<HostLinearCells<false, true, false>>(a, k)
           : run_pair<HostLinearCells<false, false, false>>(a, k);
}

// sa_wfa_chunk's arguments minus the stream: the fill kernel's schedule run
// serially -- pair by pair (a converged pair's rows NEG), step by step, and
// in a step each warp's lanes in order: every lane's candidate and its
// run's first word, then each run that goes on, taken by the warp's spans
// lane by lane (the first lane whose word ends the run, as the ballot),
// then the lanes' stores and end tests; the barrier ends the step with the
// convergence test (lowest hit lane).  The codes are packed at u0 == 0 (and
// written to `codes`) or copied from `codes`; the rings are copied into a
// shared-memory image with guard cells for the launch (shared 1) or used in
// place (0); shared -1 takes the kernel's route by shape.  After each pair
// its spare CTAs (wfa.cuh::wfa_neg_ctas for sms SMs) write their parts of
// its NEG rows if it converged before the launch.
extern "C" int hc_wfa_chunk(const int32_t* seq1, const int32_t* seq2,
                            const int32_t* n1v, const int32_t* n2v,
                            uint8_t* codes, int32_t* ring_m, int32_t* ring_i,
                            int32_t* ring_d, int32_t* done, int32_t* score,
                            int32_t* end_k, int16_t* hist, int B, int L1,
                            int L2, int K, int R, int k_lo, int u0,
                            int n_steps, int g, int x_off, int oe_off,
                            int e_off, int lead1, int lead2, int trail1,
                            int trail2, int lpt, int sms, int shared) {
  const int P1 = sa::wfa_code_pitch(L1);
  const int CP = P1 + sa::wfa_code_pitch(L2);
  if (B <= 0 || K <= 0 || K % 32 || n_steps <= 0 || lpt <= 0 ||
      K > 1024 * lpt || L1 < 0 || L2 < 0 || L1 + L2 > 2 * (1 << 14) ||
      x_off < 1 || oe_off < 1 || e_off < 1 || x_off >= R || oe_off >= R ||
      e_off >= R || g < 1 || sms <= 0 || shared < -1 || shared > 1) {
    return -1;
  }
  if (shared < 0) shared = sa::wfa_ring_in_shared(L1, L2, K, R);
  if (sa::wfa_fill_smem(L1, L2, K, R, shared) > sa::kWfaSharedMax) return -1;
  const int Y = sa::wfa_neg_ctas(B, sms, u0, n_steps);
  const int n_rp = 3 * n_steps;
  // Row-planes [rp0, rp1) of pair b: NEG.
  auto neg_rows = [&](int b, int rp0, int rp1) {
    for (int rp = rp0; rp < rp1; ++rp) {
      for (int lane = 0; lane < K; ++lane) {
        hist[sa::wfa_log_index(rp / 3, rp % 3, B, b, K, lane)] =
            static_cast<int16_t>(sa::kWfaNeg);
      }
    }
  };
  int threads = (K + lpt - 1) / lpt;
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  std::vector<uint32_t> words(CP / 4);
  std::vector<int32_t> sring(3 * R * (K + 2));
  int32_t m[32], iv[32], dv[32], lim[32];
  bool more[32];
  for (int b = 0; b < B; ++b) {
    int rp_neg = 0, rp_end = n_rp;
    if (done[b]) {
      if (Y > 1 && sa::wfa_done_before(score[b], u0, g)) {
        sa::wfa_neg_part(0, Y, n_rp, rp_neg, rp_end);
      }
    } else {
      uint8_t* row = codes + static_cast<size_t>(b) * CP;
      if (u0 == 0) {
        for (int p = 0; p < CP; ++p) {
          const int p2 = p - P1;
          row[p] = static_cast<uint8_t>(
              p < L1 ? seq1[static_cast<size_t>(b) * L1 + p]
                     : (p2 >= 0 && p2 < L2
                            ? seq2[static_cast<size_t>(b) * L2 + p2] : 0));
        }
      }
      memcpy(words.data(), row, CP);
      const uint32_t* w1 = words.data();
      const uint32_t* w2 = w1 + P1 / 4;
      const sa::WfaSharedRing sr{sring.data(), R, K};
      const sa::WfaDeviceRing dr{{ring_m, ring_i, ring_d}, B, K, b};
      if (shared) {
        for (int p = 0; p < 3; ++p) {
          for (int q = 0; q < R; ++q) {
            sr.row(p, q)[-1] = sr.row(p, q)[K] = sa::kWfaNeg;
            for (int lane = 0; lane < K; ++lane) {
              sr.put(p, q, lane, dr.at(p, q, lane));
            }
          }
        }
      }
      const int n1 = n1v[b], n2 = n2v[b];
      rp_neg = n_rp;
      for (int i = 0; i < n_steps; ++i) {
        const int u = u0 + i;
        const sa::WfaSlots q = sa::wfa_slots(u, u % R, R, x_off, oe_off,
                                             e_off);
        int hit_lane = -1;
        for (int w = 0; w < threads / 32; ++w) {
          for (int base = 32 * w; base < K; base += threads) {
            for (int j = 0; j < 32; ++j) {
              const int lane = base + j;
              const int32_t k = k_lo + lane;
              iv[j] = dv[j] = sa::kWfaNeg;
              int32_t t;
              if (u == 0) {
                t = sa::wfa_seed_start(k, n1, n2, lead1, lead2);
              } else if (shared) {
                t = sa::wfa_candidate(sr, q, lane, k, n1, n2, iv[j], dv[j]);
              } else {
                t = sa::wfa_candidate(dr, q, lane, k, n1, n2, iv[j], dv[j]);
              }
              lim[j] = n2 < n1 - k ? n2 : n1 - k;
              more[j] = false;
              m[j] = t > sa::kWfaNeg
                         ? sa::wfa_first_word(w1, w2, k, t, lim[j], more[j])
                         : sa::kWfaNeg;
            }
            for (int j = 0; j < 32; ++j) {
              if (!more[j]) continue;
              const int32_t k = k_lo + base + j;
              for (int32_t ts = m[j];; ts += 4 * sa::kWfaSpan) {
                int32_t end = 0;
                int l = 0;
                while (l < 32 && !sa::wfa_span_lane(w1, w2, k, ts, lim[j], l,
                                                    end)) {
                  ++l;
                }
                if (l < 32) {
                  m[j] = end;
                  break;
                }
              }
            }
            for (int j = 0; j < 32; ++j) {
              const int lane = base + j;
              const int32_t k = k_lo + lane;
              if (shared) {
                sr.put(0, q.w, lane, m[j]);
                sr.put(1, q.w, lane, iv[j]);
                sr.put(2, q.w, lane, dv[j]);
              } else {
                dr.put(0, q.w, lane, m[j]);
                dr.put(1, q.w, lane, iv[j]);
                dr.put(2, q.w, lane, dv[j]);
              }
              for (int p = 0; p < 3; ++p) {
                hist[sa::wfa_log_index(i, p, B, b, K, lane)] =
                    static_cast<int16_t>(p == 0 ? m[j] : (p == 1 ? iv[j]
                                                                 : dv[j]));
              }
              bool mask;
              const int32_t end_t =
                  sa::wfa_end_t(k, n1, n2, trail1, trail2, mask);
              if (mask && m[j] >= end_t &&
                  (hit_lane < 0 || lane < hit_lane)) {
                hit_lane = lane;
              }
            }
          }
        }
        if (hit_lane >= 0) {
          done[b] = 1;
          score[b] = u * g;
          end_k[b] = k_lo + hit_lane;
          rp_neg = 3 * (i + 1);
          break;
        }
      }
      if (shared) {
        for (int p = 0; p < 3; ++p) {
          for (int q = 0; q < R; ++q) {
            for (int lane = 0; lane < K; ++lane) {
              dr.put(p, q, lane, sr.at(p, q, lane));
            }
          }
        }
      }
    }
    neg_rows(b, rp_neg, rp_end);
    for (int y = 1; y < Y; ++y) {
      if (sa::wfa_done_before(score[b], u0, g)) {
        int lo, hi;
        sa::wfa_neg_part(y, Y, n_rp, lo, hi);
        neg_rows(b, lo, hi);
      }
    }
  }
  return 0;
}

// sa_wfa_ring_in_shared: 1 if a fill of this shape keeps its rings in
// shared memory, else 0.
extern "C" int hc_wfa_ring_in_shared(int L1, int L2, int K, int R) {
  return sa::wfa_ring_in_shared(L1, L2, K, R) ? 1 : 0;
}

// The walk's warp run serially (wfa.cuh::WfaStage's Ops): one lane, the
// slots poisoned when a batch is copied and filled when it is waited on,
// so a read the schedule did not wait for returns poison.
struct HostWalkOps {
  std::vector<int16_t> slots =
      std::vector<int16_t>(sa::kWfaSlots * sa::kWfaSlotCells);
  std::vector<const int16_t*> src[sa::kWfaSlots];
  int win[sa::kWfaSlots] = {0, 0, 0};

  int lane() const { return 0; }
  int lanes() const { return 1; }
  void init() {}
  // Batch r0's rows (3 row-planes a row) into slot q; the device copies
  // the whole box, rows past the log zero, which no read reaches.
  template <class Src>
  void copy(int q, int /*r0*/, int /*l0*/, int rows, int w, Src s) {
    src[q].clear();
    for (int j = 0; j < 3 * rows; ++j) src[q].push_back(s(j));
    win[q] = w;
    std::fill(slots.begin() + q * sa::kWfaSlotCells,
              slots.begin() + (q + 1) * sa::kWfaSlotCells,
              static_cast<int16_t>(0x5A5A));
  }
  void wait(int q) {
    for (size_t j = 0; j < src[q].size(); ++j) {
      memcpy(&slots[q * sa::kWfaSlotCells + j * win[q]], src[q][j],
             2 * win[q]);
    }
    src[q].clear();
  }
  void sync() {}
  int32_t cell(int q, int idx) const {
    return slots[q * sa::kWfaSlotCells + idx];
  }
  void mark(int, int32_t = 0) {}
};

// sa_wfa_walk's arguments minus the stream: each pair's walk in turn
// through wfa.cuh::wfa_walk_staged and its staged batches.
extern "C" int hc_wfa_walk(const int16_t* hist, int S, int Bh, int K,
                           int k_lo, int g, const int32_t* s0,
                           const int32_t* k0, const int32_t* t0,
                           const int32_t* live, const int32_t* budget, int B,
                           int x_pen, int o_pen, int e_pen, int W,
                           uint32_t* packed, int32_t* n_ops, int32_t* ok,
                           int sms) {
  if (B <= 0 || B > Bh || S <= 0 || K < 32 || K % 8 || W <= 0 || g <= 0 ||
      sms <= 0) {
    return -1;
  }
  for (int b = 0; b < B; ++b) {
    HostWalkOps ops;
    ok[b] = sa::wfa_walk_staged(ops, hist, S, Bh, K, b, k_lo, g, s0[b], k0[b],
                                t0[b], live[b] != 0, budget[b], x_pen, o_pen,
                                e_pen, packed + static_cast<int64_t>(b) * W,
                                &n_ops[b]);
  }
  return 0;
}

namespace {

// One ticket of sa_mm_rows, run by one host "warp": the strip's
// wavefront step by step, its 32 threads in a loop each step, each taking
// what its left neighbour handed on at the step before (a shuffle's
// snapshot); the first thread's words from the left strip's column with
// their tags checked (kRingUnmet when a word is not the row's: a wait that
// would not hold in ticket order).
template <int LPT>
int mm_strip_host(const sa::MmStrip& sp, const sa::Scheme& sc, int32_t* out,
                  uint64_t* bnd) {
  constexpr int kT = sa::kMmWarpLanes;
  constexpr int W = kT * LPT;
  const int32_t e = sc.gap_extend;
  const sa::MmSweep& w = sp.w;
  std::vector<int32_t> CC(W), DD(W), dc(W);
  for (int l = 0; l < W; ++l) {
    const int j = sp.strip * W + l;
    CC[l] = sa::mm_cc0(j, sc);
    DD[l] = sa::kNegInf;
    dc[l] = sa::mm_dcode(w, j, sp.n);
  }
  uint64_t* my = bnd + sp.my;
  const uint64_t* left = sp.left >= 0 ? bnd + sp.left : nullptr;
  my[0] = sa::mm_pack(CC[W - 1], 0);
  int32_t cc_out[kT], e_out[kT], qc[kT], cc_prev[kT];
  for (int t = 0; t < kT; ++t) {
    cc_out[t] = CC[t * LPT + LPT - 1];
    e_out[t] = sa::kNegInf;
    qc[t] = cc_prev[t] = 0;
  }
  for (int g = 1; g <= w.m + 31; ++g) {
    int32_t x = sa::kNegInf, c = 0;
    if (left != nullptr && g <= w.m) {
      const uint64_t a = left[2 * (g - 1)], b = left[2 * g + 1];
      if (!sa::mm_holds(a, g - 1) || !sa::mm_holds(b, g)) {
        return sa::kRingUnmet;
      }
      x = sa::mm_value(b);
      c = sa::mm_value(a);
    }
    const int32_t q0 = w.q[w.q_off + std::max(1, std::min(g, w.m)) - 1];
    int32_t e_old[kT], cc_old[kT], q_old[kT];
    std::copy(e_out, e_out + kT, e_old);
    std::copy(cc_out, cc_out + kT, cc_old);
    std::copy(qc, qc + kT, q_old);
    for (int t = 0; t < kT; ++t) {
      int32_t e_in = e_old[t > 0 ? t - 1 : 0];
      int32_t cc_left = cc_prev[t];
      cc_prev[t] = cc_old[t > 0 ? t - 1 : 0];
      qc[t] = t == 0 ? q0 : q_old[t - 1];
      if (t == 0) {
        e_in = x;
        cc_left = c;
      }
      const int i = sa::mm_row_at(g, t);
      if (i < 1 || i > w.m) continue;
      e_out[t] = sa::mm_step<LPT>(&CC[t * LPT], &DD[t * LPT], &dc[t * LPT],
                                  qc[t], cc_left, e_in,
                                  sp.strip == 0 && t == 0, w.tb + i * e, sc);
      cc_out[t] = CC[t * LPT + LPT - 1];
      if (t == kT - 1) {
        my[2 * i] = sa::mm_pack(cc_out[t], i);
        my[2 * i + 1] = sa::mm_pack(e_out[t], i);
      }
    }
  }
  for (int l = 0; l < W; ++l) {
    const int j = sp.strip * W + l;
    if (j <= sp.n) {
      out[sp.out + j] = CC[l];
      out[sp.out + sp.n + 1 + j] = DD[l];
    }
  }
  return 0;
}

typedef int (*HostMmStrip)(const sa::MmStrip&, const sa::Scheme&, int32_t*,
                           uint64_t*);

}  // namespace

// sa_mm_table_cols' host twin.
extern "C" void hc_mm_table_cols(int64_t* cols) { sa::mm_table_cols(cols); }

// sa_mm_rows_plan's host twin: the kernel's lanes a thread when lpt is 0;
// else lpt 2, 4, 8 or 16 (the kernel's 16, and narrower strips, 64 to 256
// lanes, for narrow tests).  -1 for an unsupported shape.
extern "C" int hc_mm_rows_plan(int64_t* table, int count, int lpt,
                               int64_t* words) {
  if (count <= 0) return -1;
  if (lpt == 0) lpt = sa::kMmLanesPerThread;
  if (lpt != 2 && lpt != 4 && lpt != 8 && lpt != 16) return -1;
  return sa::mm_plan_level(table, count, lpt, words) ? lpt : -1;
}

// sa_mm_rows' arguments minus the stream, its tickets run serially in
// order from ctr[0] (bnd zeroed or holding no tag of its rows).  -1 for an
// unsupported shape, -4 for a wait that would not hold in ticket order.
extern "C" int hc_mm_rows(const int32_t* qf, const int32_t* qr,
                          const int32_t* df, const int32_t* dr,
                          const int64_t* table, int count, int lpt,
                          int tickets, int32_t* out, int32_t* bnd,
                          int32_t* ctr, int match, int mismatch, int gap_open,
                          int gap_extend) {
  HostMmStrip fn;
  switch (lpt) {
    case 2: fn = mm_strip_host<2>; break;
    case 4: fn = mm_strip_host<4>; break;
    case 8: fn = mm_strip_host<8>; break;
    case 16: fn = mm_strip_host<16>; break;
    default: return -1;
  }
  if (count <= 0 || tickets <= 0) return -1;
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  while (ctr[0] < tickets) {
    const int t = ctr[0]++;
    const int rc = fn(sa::mm_strip_at(table, count, t, qf, qr, df, dr), sc,
                      out, reinterpret_cast<uint64_t*>(bnd));
    if (rc != 0) return rc;
  }
  return 0;
}

// Serial host build of the CUDA kernels' loops, through the same per-cell
// and per-step functions (nw_affine_stream.cuh, traceback_device.cuh).  It
// lets the kernels' arithmetic be compiled and checked against the plain
// PyTorch versions on a machine with no CUDA compiler:
//
//   c++ -O2 -std=c++17 -shared -fPIC -o libhost_check.so host_check.cpp
//
// The arguments and layouts are those of sa_stream_fill,
// sa_stream_modes_fill, sa_modes_fill, sa_walk_fast4 and sa_walk_modes (minus
// the stream).
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "nw_affine_stream.cuh"
#include "traceback_device.cuh"

namespace {

template <int DIRS, bool COMPAT, bool WILDCARD>
void stream_fill_host(const int32_t* qstream, const int32_t* dstream,
                      const int32_t* dsum, const int32_t* n2s,
                      int32_t* finals, uint32_t* dirs, int R, int T, int P,
                      int S, int NP, const sa::Scheme& sc) {
  std::vector<sa::Cell> c(P);
  std::vector<sa::Pre> pre(P);
  std::vector<uint32_t> acc(P);
  for (int row = 0; row < R; ++row) {
    for (int x = 0; x < P; ++x) {
      c[x] = sa::cell_init();
      acc[x] = 0;
    }
    int p = 0;
    for (int t = 0; t < T; ++t) {
      const int32_t qc = qstream[static_cast<size_t>(row) * T + t];
      const int32_t dc = dstream[static_cast<size_t>(row) * T + t];
      for (int x = 0; x < P; ++x) pre[x] = sa::stream_pre<DIRS>(c[x], sc);
      // The torus neighbour of lane 0 is lane P-1, read before it moves.
      const int32_t tH2 = c[P - 1].H2;
      const int32_t ts1d = c[P - 1].s1d;
      const uint32_t shift =
          DIRS == sa::kDirsFast4 ? 4u * (t & 7) : 8u * (t & 3);
      for (int x = P - 1; x >= 0; --x) {
        const int l = x == 0 ? P - 1 : x - 1;
        const int32_t lH2 = x == 0 ? tH2 : c[l].H2;
        const int32_t ls1d = x == 0 ? ts1d : c[l].s1d;
        const int32_t code =
            sa::stream_cell<DIRS, sa::kModeGlobal, COMPAT, WILDCARD>(
                c[x], pre[x], lH2, pre[l], ls1d, x == 0, x == p, p, qc, dc,
                sc);
        acc[x] |= static_cast<uint32_t>(code) << shift;
      }
      for (int k = 0; k < NP; ++k) {
        if (k * S + dsum[k * R + row] != t) continue;
        const sa::Cell& cc = c[n2s[k * R + row]];
        int32_t* f = finals + (static_cast<size_t>(row) * NP + k) * 3;
        f[0] = cc.M1;
        f[1] = cc.I1;
        f[2] = cc.D1;
      }
      if (DIRS != sa::kDirsNone &&
          (DIRS == sa::kDirsFast4 ? (t & 7) == 7 : (t & 3) == 3)) {
        const int w = DIRS == sa::kDirsFast4 ? t >> 3 : t >> 2;
        for (int x = 0; x < P; ++x) {
          dirs[(static_cast<size_t>(w) * R + row) * P + x] = acc[x];
          acc[x] = 0;
        }
      }
      if (++p == S) p = 0;
    }
  }
}

typedef void (*HostFill)(const int32_t*, const int32_t*, const int32_t*,
                         const int32_t*, int32_t*, uint32_t*, int, int, int,
                         int, int, const sa::Scheme&);

template <int DIRS>
HostFill pick(bool compat, bool wildcard) {
  if (compat) {
    return wildcard ? stream_fill_host<DIRS, true, true>
                    : stream_fill_host<DIRS, true, false>;
  }
  return wildcard ? stream_fill_host<DIRS, false, true>
                  : stream_fill_host<DIRS, false, false>;
}

// The streamed modes fill of one row at a time, with the kernel's running
// argmax: lane x holds the older pair until p == x, then the younger; at the
// turnover it writes the older pair's (bv, bd), and after the last step the
// last slot's pair where it is real.
template <int DIRS, int MODE, bool WILDCARD>
void stream_modes_host(const int32_t* qstream, const int32_t* dstream,
                       const int32_t* dsum, const int32_t* n2s, int32_t* out,
                       uint32_t* dirs, int R, int T, int P, int S, int NP,
                       const sa::Scheme& sc) {
  std::vector<sa::Cell> c(P);
  std::vector<sa::Pre> pre(P);
  std::vector<uint32_t> acc(P);
  std::vector<int32_t> bv(P), bd(P);
  const size_t plane = static_cast<size_t>(NP) * R * P;
  for (int row = 0; row < R; ++row) {
    auto flush = [&](int k, int x) {
      if (k < 0 || k >= NP) return;
      const size_t at = (static_cast<size_t>(k) * R + row) * P + x;
      out[at] = bv[x];
      out[plane + at] = bd[x];
      bv[x] = sa::kNegBig;
      bd[x] = 0;
    };
    for (int x = 0; x < P; ++x) {
      c[x] = sa::cell_init(sa::kNegBig);
      acc[x] = 0;
      bv[x] = sa::kNegBig;
      bd[x] = 0;
    }
    int slot = 0;
    int32_t n1y = -1, n2y = -1, n1o = -1, n2o = -1;
    int p = 0;
    for (int t = 0; t < T; ++t) {
      if (p == 0) {
        slot = t / S;
        n1o = n1y;
        n2o = n2y;
        n2y = slot < NP ? n2s[slot * R + row] : -1;
        n1y = slot < NP ? dsum[slot * R + row] - n2y : -1;
      }
      const int32_t qc = qstream[static_cast<size_t>(row) * T + t];
      const int32_t dc = dstream[static_cast<size_t>(row) * T + t];
      for (int x = 0; x < P; ++x) pre[x] = sa::stream_pre<DIRS>(c[x], sc);
      const int32_t tH2 = c[P - 1].H2;
      const int32_t ts1d = c[P - 1].s1d;
      for (int x = P - 1; x >= 0; --x) {
        const int l = x == 0 ? P - 1 : x - 1;
        const int32_t lH2 = x == 0 ? tH2 : c[l].H2;
        const int32_t ls1d = x == 0 ? ts1d : c[l].s1d;
        const int32_t code = sa::stream_cell<DIRS, MODE, false, WILDCARD>(
            c[x], pre[x], lH2, pre[l], ls1d, x == 0, x == p, p, qc, dc, sc);
        acc[x] |= static_cast<uint32_t>(code) << (8u * (t & 3));
        if (x == p) flush(slot - 1, x);
        const bool young = x <= p;
        const int32_t pk = young ? p : p + S;
        sa::modes_update<MODE>(x, pk - x, pk, young ? n1y : n1o,
                               young ? n2y : n2o, c[x].M1, c[x].H1, bv[x],
                               bd[x]);
      }
      if (DIRS != sa::kDirsNone && (t & 3) == 3) {
        for (int x = 0; x < P; ++x) {
          dirs[(static_cast<size_t>(t >> 2) * R + row) * P + x] = acc[x];
          acc[x] = 0;
        }
      }
      if (++p == S) p = 0;
    }
    for (int x = 0; x < P && x < S; ++x) flush(slot, x);
  }
}

// The per-pair modes fill of one pair at a time.
template <int DIRS, int MODE, bool WILDCARD>
void modes_host(const int32_t* query, const int32_t* s2v, const int32_t* n1s,
                const int32_t* n2s, int32_t* out, uint32_t* dirs, int B,
                int L1, int P, int D_total, const sa::Scheme& sc) {
  std::vector<sa::Cell> c(P);
  std::vector<sa::Pre> pre(P);
  std::vector<uint32_t> acc(P);
  std::vector<int32_t> bv(P), bd(P);
  for (int b = 0; b < B; ++b) {
    for (int x = 0; x < P; ++x) {
      c[x] = sa::cell_init(sa::kNegInf);
      c[x].s2v = s2v[static_cast<size_t>(b) * P + x];
      acc[x] = 0;
      bv[x] = sa::kNegBig;
      bd[x] = 0;
    }
    for (int d = 0; d < D_total; ++d) {
      const int q = d - 1 < 0 ? 0 : (d - 1 > L1 - 1 ? L1 - 1 : d - 1);
      const int32_t qc = query[static_cast<size_t>(b) * L1 + q];
      for (int x = 0; x < P; ++x) pre[x] = sa::stream_pre<DIRS>(c[x], sc);
      const int32_t tH2 = c[P - 1].H2;
      const int32_t ts1d = c[P - 1].s1d;
      for (int x = P - 1; x >= 0; --x) {
        const int l = x == 0 ? P - 1 : x - 1;
        const int32_t lH2 = x == 0 ? tH2 : c[l].H2;
        const int32_t ls1d = x == 0 ? ts1d : c[l].s1d;
        const int32_t code = sa::stream_cell<DIRS, MODE, false, WILDCARD>(
            c[x], pre[x], lH2, pre[l], ls1d, x == 0, x == d, d, qc, c[x].s2v,
            sc);
        acc[x] |= static_cast<uint32_t>(code) << (8u * (d & 3));
        sa::modes_update<MODE>(x, d - x, d, n1s[b], n2s[b], c[x].M1, c[x].H1,
                               bv[x], bd[x]);
      }
      if (DIRS != sa::kDirsNone && ((d & 3) == 3 || d == D_total - 1)) {
        for (int x = 0; x < P; ++x) {
          dirs[(static_cast<size_t>(d >> 2) * B + b) * P + x] = acc[x];
          acc[x] = 0;
        }
      }
    }
    for (int x = 0; x < P; ++x) {
      out[static_cast<size_t>(b) * P + x] = bv[x];
      out[static_cast<size_t>(B) * P + static_cast<size_t>(b) * P + x] = bd[x];
    }
  }
}

typedef void (*HostModes)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, int32_t*, uint32_t*, int, int, int,
                          int, int, const sa::Scheme&);
typedef void (*HostPerPair)(const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, int32_t*, uint32_t*, int, int,
                            int, int, const sa::Scheme&);

template <int DIRS, int MODE>
HostModes pick_stream_modes(bool wildcard) {
  return wildcard ? stream_modes_host<DIRS, MODE, true>
                  : stream_modes_host<DIRS, MODE, false>;
}

template <int DIRS, int MODE>
HostPerPair pick_modes(bool wildcard) {
  return wildcard ? modes_host<DIRS, MODE, true> : modes_host<DIRS, MODE, false>;
}

}  // namespace

extern "C" int hc_stream_fill(const int32_t* qstream, const int32_t* dstream,
                              const int32_t* dsum, const int32_t* n2,
                              int32_t* finals, uint32_t* dirs, int R, int T,
                              int P, int S, int NP, int match, int mismatch,
                              int gap_open, int gap_extend, int dirs_mode,
                              int compat, int wildcard) {
  HostFill fn = nullptr;
  switch (dirs_mode) {
    case sa::kDirsNone: fn = pick<sa::kDirsNone>(compat, wildcard); break;
    case sa::kDirsFast4: fn = pick<sa::kDirsFast4>(compat, wildcard); break;
    case sa::kDirsFull: fn = pick<sa::kDirsFull>(compat, wildcard); break;
  }
  if (fn == nullptr) return -1;
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  fn(qstream, dstream, dsum, n2, finals, dirs, R, T, P, S, NP, sc);
  return 0;
}

extern "C" int hc_walk_fast4(const uint32_t* dirs, int R, int P,
                             const int32_t* x0, const int32_t* y0,
                             const int32_t* plane0, const int32_t* rowp,
                             const int32_t* off, int B, int W,
                             uint32_t* packed, int32_t* xf, int32_t* yf,
                             int32_t* n_ops) {
  for (int b = 0; b < B; ++b) {
    int32_t x = x0[b];
    int32_t y = y0[b];
    int32_t plane = plane0[b];
    const size_t row = static_cast<size_t>(rowp[b]);
    const int steps = x + y;
    uint32_t* out = packed + static_cast<size_t>(b) * W;
    for (int w = 0; w < W; ++w) out[w] = 0;
    int i = 0;
    while (i < steps && (x != 0 || y != 0)) {
      const int32_t d = x + y + off[b];
      const uint32_t v =
          dirs[(static_cast<size_t>(d >> 3) * R + row) * P + x];
      const uint32_t nib = (v >> (4 * (d & 7))) & 0xFu;
      out[i >> 4] |= sa::walk_step(nib, x, y, plane) << (2 * (i & 15));
      ++i;
    }
    xf[b] = x;
    yf[b] = y;
    n_ops[b] = i;
  }
  return 0;
}

extern "C" int hc_stream_modes_fill(const int32_t* qstream,
                                    const int32_t* dstream,
                                    const int32_t* dsum, const int32_t* n2,
                                    int32_t* out, uint32_t* dirs, int R, int T,
                                    int P, int S, int NP, int match,
                                    int mismatch, int gap_open,
                                    int gap_extend, int dirs_mode, int local,
                                    int wildcard) {
  HostModes fn = nullptr;
  if (dirs_mode == sa::kDirsNone) {
    fn = local ? pick_stream_modes<sa::kDirsNone, sa::kModeLocal>(wildcard)
               : pick_stream_modes<sa::kDirsNone, sa::kModeSemi>(wildcard);
  } else if (dirs_mode == sa::kDirsFull) {
    fn = local ? pick_stream_modes<sa::kDirsFull, sa::kModeLocal>(wildcard)
               : pick_stream_modes<sa::kDirsFull, sa::kModeSemi>(wildcard);
  }
  if (fn == nullptr) return -1;
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  fn(qstream, dstream, dsum, n2, out, dirs, R, T, P, S, NP, sc);
  return 0;
}

extern "C" int hc_modes_fill(const int32_t* query, const int32_t* s2v,
                             const int32_t* n1, const int32_t* n2,
                             int32_t* out, uint32_t* dirs, int B, int L1,
                             int P, int D_total, int match, int mismatch,
                             int gap_open, int gap_extend, int dirs_mode,
                             int local, int wildcard) {
  HostPerPair fn = nullptr;
  if (dirs_mode == sa::kDirsNone) {
    fn = local ? pick_modes<sa::kDirsNone, sa::kModeLocal>(wildcard)
               : pick_modes<sa::kDirsNone, sa::kModeSemi>(wildcard);
  } else if (dirs_mode == sa::kDirsFull) {
    fn = local ? pick_modes<sa::kDirsFull, sa::kModeLocal>(wildcard)
               : pick_modes<sa::kDirsFull, sa::kModeSemi>(wildcard);
  }
  if (fn == nullptr) return -1;
  const sa::Scheme sc{match, mismatch, gap_open, gap_extend};
  fn(query, s2v, n1, n2, out, dirs, B, L1, P, D_total, sc);
  return 0;
}

extern "C" int hc_walk_modes(const uint32_t* dirs, int W, int R, int P,
                             const int32_t* x0, const int32_t* y0,
                             const int32_t* rowp, const int32_t* off, int B,
                             int WP, int local, uint32_t* packed, int32_t* xf,
                             int32_t* yf, int32_t* st, int32_t* n_ops) {
  for (int b = 0; b < B; ++b) {
    int32_t x = x0[b];
    int32_t y = y0[b];
    uint32_t* out = packed + static_cast<size_t>(b) * WP;
    if (local) {
      sa::walk_modes_pair<true>(dirs, W, R, P, static_cast<size_t>(rowp[b]),
                                off[b], x, y, st[b], n_ops[b], out, WP);
    } else {
      sa::walk_modes_pair<false>(dirs, W, R, P, static_cast<size_t>(rowp[b]),
                                 off[b], x, y, st[b], n_ops[b], out, WP);
    }
    xf[b] = x;
    yf[b] = y;
  }
  return 0;
}

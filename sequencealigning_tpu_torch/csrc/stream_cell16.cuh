// The streamed Gotoh fills' cell with int16 score state, two lanes a word.
//
// It is ops/nw_affine_stream.py::_stream_step with int16 state written for
// a pair of adjacent lanes of a row: lane 2j in the low half of a 32-bit
// word, lane 2j + 1 in the high half, so each of H2, H1, M1, I1 and D1 is
// one register for two lanes, and every add-max, max3 and compare-select of
// the recurrence is one Hopper DPX instruction for both (__viaddmax_s16x2,
// __vimax3_s16x2, __vibmax_s16x2).  On the host each half is computed on its
// own with the same integers (host_check.cpp).
//
// The -inf sentinel `neg` is a kernel argument from the closed-form
// certification ops.nw_affine_stream.stream_i16_neg, not kNegInf: -32768
// would wrap on the first gap step.  As in the JAX package the accumulating
// I and D chains are floored at it each step after their flags are taken,
// and the boundary values are clamped to it.  The certification keeps every
// add of the recurrence inside int16, so an add is max(a + b, INT16_MIN).
#pragma once

#include <stdint.h>

#include "nw_affine_stream.cuh"

namespace sa {

constexpr uint32_t kH2Min = 0x80008000u;  // INT16_MIN in both halves

// A word's halves as int32 (sign-extended), and a word from two values
// (each cut to 16 bits).
SA_HD int32_t h2_lo(uint32_t w) {
  return static_cast<int16_t>(static_cast<uint16_t>(w & 0xffffu));
}
SA_HD int32_t h2_hi(uint32_t w) {
  return static_cast<int16_t>(static_cast<uint16_t>(w >> 16));
}
SA_HD int32_t h2_get(uint32_t w, int half) {
  return half ? h2_hi(w) : h2_lo(w);
}
SA_HD uint32_t h2_pack(int32_t lo, int32_t hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         (static_cast<uint32_t>(hi) << 16);
}
SA_HD uint32_t h2_set(uint32_t w, int half, int32_t v) {
  const int at = 16 * half;
  return (w & ~(0xffffu << at)) |
         ((static_cast<uint32_t>(v) & 0xffffu) << at);
}

// __byte_perm: bytes of the 64-bit {y, x} chosen by the selector's nibbles.
SA_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t sel) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, y, sel);
#else
  const uint64_t v = static_cast<uint64_t>(y) << 32 | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = (sel >> 4 * i) & 7;
    r |= static_cast<uint32_t>((v >> 8 * b) & 0xff) << 8 * i;
  }
  return r;
#endif
}

// The left neighbours of a word's lanes: the previous word's high lane and
// the word's own low lane.  One PRMT.
SA_HD uint32_t h2_left(uint32_t prev, uint32_t cur) {
  return byte_perm(prev, cur, 0x5432);
}
// (a's high lane, b's high lane): what a thread hands its right neighbour.
SA_HD uint32_t h2_his(uint32_t a, uint32_t b) {
  return byte_perm(a, b, 0x7632);
}
// (a's low half, b's low half).
SA_HD uint32_t h2_los(uint32_t a, uint32_t b) {
  return byte_perm(a, b, 0x5410);
}

// max(a + b, c) in each half: one VIADDMAX.  The host wraps the add to 16
// bits; the certified fills never reach a wrap.
SA_HD uint32_t h2_add_max(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return __viaddmax_s16x2(a, b, c);
#else
  const int32_t lo = static_cast<int16_t>(h2_lo(a) + h2_lo(b));
  const int32_t hi = static_cast<int16_t>(h2_hi(a) + h2_hi(b));
  return h2_pack(imax(lo, h2_lo(c)), imax(hi, h2_hi(c)));
#endif
}

// max(a + b, c, 0) in each half: one VIADDMAX with its relu.
SA_HD uint32_t h2_add_max_relu(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return __viaddmax_s16x2_relu(a, b, c);
#else
  const uint32_t m = h2_add_max(a, b, c);
  return h2_pack(imax(h2_lo(m), 0), imax(h2_hi(m), 0));
#endif
}

// a + b in each half.
SA_HD uint32_t h2_add(uint32_t a, uint32_t b) {
  return h2_add_max(a, b, kH2Min);
}

// max(a, b, c) in each half: one VIMNMX3.
SA_HD uint32_t h2_max3(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return __vimax3_s16x2(a, b, c);
#else
  return h2_pack(imax(h2_lo(a), imax(h2_lo(b), h2_lo(c))),
                 imax(h2_hi(a), imax(h2_hi(b), h2_hi(c))));
#endif
}

// max(a, b) in each half, with ge_hi / ge_lo = (a >= b) in that half.
// Used only where the maximum itself is used: ptxas for sm_90a has been
// seen to build a wrong operand half for a VIMNMX.S16x2 whose maximum is
// dropped and only its flags read (in the modes instances); those
// compares are h2_eq of a maximum and its operand instead.
SA_HD uint32_t h2_bmax(uint32_t a, uint32_t b, bool& ge_hi, bool& ge_lo) {
#if defined(__CUDA_ARCH__)
  return __vibmax_s16x2(a, b, &ge_hi, &ge_lo);
#else
  ge_lo = h2_lo(a) >= h2_lo(b);
  ge_hi = h2_hi(a) >= h2_hi(b);
  return h2_pack(ge_lo ? h2_lo(a) : h2_lo(b), ge_hi ? h2_hi(a) : h2_hi(b));
#endif
}

// max(a, b) in each half: one VIADDMAX.
SA_HD uint32_t h2_max(uint32_t a, uint32_t b) {
  return h2_add_max(a, 0u, b);
}

// eq_hi / eq_lo = (a == b) in that half: two 32-bit compares of a ^ b.
SA_HD void h2_eq(uint32_t a, uint32_t b, bool& eq_hi, bool& eq_lo) {
  const uint32_t x = a ^ b;
  eq_lo = (x & 0xffffu) == 0;
  eq_hi = x < 0x10000u;
}

// The scheme in both halves, and the sentinel.
struct Scheme16 {
  Scheme s;
  int32_t neg;
  uint32_t o2, e2, neg2;
};

SA_HD Scheme16 scheme16(const Scheme& s, int32_t neg) {
  Scheme16 r;
  r.s = s;
  r.neg = neg;
  r.o2 = h2_pack(s.gap_open, s.gap_open);
  r.e2 = h2_pack(s.gap_extend, s.gap_extend);
  r.neg2 = h2_pack(neg, neg);
  return r;
}

// Two lanes' rolling scores (their codes are kept by the caller).
struct Cell16 {
  uint32_t H2, H1, M1, I1, D1;
};

SA_HD Cell16 cell16_init(int32_t neg) {
  const uint32_t n = h2_pack(neg, neg);
  return Cell16{n, n, n, n, n};
}

// What each lane hands its right neighbour (ring_pre per half): t0 = M1 + o,
// the merged D source and the D bits.
struct Pre16 {
  uint32_t t0, dsel;
  int32_t dflag_lo, dflag_hi;
};

template <int DIRS>
SA_HD Pre16 ring_pre16(const Cell16& c, const Scheme16& s) {
  Pre16 r;
  r.t0 = h2_add(c.M1, s.o2);
  bool cd_hi, cd_lo;
  r.dsel = h2_bmax(c.D1, r.t0, cd_hi, cd_lo);
  if (DIRS == kDirsFull) {
    // t0 >= D1: the merged source is t0.
    bool op_hi, op_lo;
    h2_eq(r.dsel, r.t0, op_hi, op_lo);
    r.dflag_lo = (cd_lo ? kDEXT : 0) | (op_lo ? kDOPEN : 0);
    r.dflag_hi = (cd_hi ? kDEXT : 0) | (op_hi ? kDOPEN : 0);
  } else if (DIRS == kDirsFast4) {
    r.dflag_lo = cd_lo ? 8 : 0;
    r.dflag_hi = cd_hi ? 8 : 0;
  } else {
    r.dflag_lo = r.dflag_hi = 0;
  }
  return r;
}

// boundary() with every value clamped to the sentinel (the JAX package's
// int16 row0/col0).
SA_HD void boundary16(int32_t p, bool compat, bool col, const Scheme16& s,
                      int32_t& M, int32_t& I, int32_t& D) {
  boundary(p, compat, col, s.s, M, I, D);
  M = imax(M, s.neg);
  I = imax(I, s.neg);
  D = imax(D, s.neg);
}

// One step of a word's two lanes: ring_cell for both halves.  pre: the
// word's own ring_pre16; lH2 / ldsel: the lanes' left neighbours' H2 and
// merged D source (h2_left); lflag: the low lane's left neighbour's D bits
// (the high lane's are pre.dflag_lo); sub2: each lane's substitution score.
// ATP / AT0 as ring_cell: ph is the half holding lane p (-1: neither),
// at0 whether the low half is lane 0.  Writes both lanes' direction codes.
template <int DIRS, int MODE, bool COMPAT, bool ATP, bool AT0>
SA_HD void ring_word16(Cell16& c, const Pre16& pre, uint32_t lH2,
                       uint32_t ldsel, int32_t lflag, uint32_t sub2, bool at0,
                       int ph, int32_t p, const Scheme16& s,
                       int32_t& code_lo, int32_t& code_hi) {
  uint32_t M;
  bool rs_lo = false, rs_hi = false;  // local's restarts
  if (MODE == kModeLocal && DIRS == kDirsNone) {
    M = h2_add_max_relu(lH2, sub2, kH2Min);
  } else if (MODE == kModeLocal) {
    // A restart is a cell the clamp moved (M < 0 before it).
    const uint32_t m = h2_add(lH2, sub2);
    M = h2_add_max_relu(m, 0u, kH2Min);
    bool kept_hi, kept_lo;
    h2_eq(M, m, kept_hi, kept_lo);
    rs_lo = !kept_lo;
    rs_hi = !kept_hi;
  } else {
    M = h2_add(lH2, sub2);
  }
  bool ci_hi, ci_lo;
  const uint32_t isel = h2_bmax(c.I1, pre.t0, ci_hi, ci_lo);
  uint32_t I = h2_add_max(isel, s.e2, s.neg2);
  uint32_t D = h2_add_max(ldsel, s.e2, s.neg2);
  if (ATP || AT0) {
    const bool ap = ATP && ph >= 0;
    const bool a0 = AT0 && at0;
    if (MODE == kModeGlobal) {
      int32_t m, i, d;
      if (ap) {
        boundary16(p, COMPAT, true, s, m, i, d);
        M = h2_set(M, ph, m);
        I = h2_set(I, ph, i);
        D = h2_set(D, ph, d);
      }
      if (a0) {
        boundary16(p, COMPAT, false, s, m, i, d);
        M = h2_set(M, 0, m);
        I = h2_set(I, 0, i);
        D = h2_set(D, 0, d);
      }
    } else {
      if (ap) {
        M = h2_set(M, ph, 0);
        I = h2_set(I, ph, s.neg);
        D = h2_set(D, ph, s.neg);
        (ph ? rs_hi : rs_lo) = true;
      }
      if (a0) {
        M = h2_set(M, 0, 0);
        I = h2_set(I, 0, s.neg);
        D = h2_set(D, 0, s.neg);
        rs_lo = true;
      }
    }
  }
  uint32_t H;
  code_lo = code_hi = 0;
  if (DIRS == kDirsNone) {
    H = h2_max3(M, I, D);
  } else {
    // H = max(M, I, D) with its argmax, priority M > I > D: mfirst is
    // M == H, ifirst is I == max(I, D).
    bool mf_hi, mf_lo;
    if (DIRS == kDirsFast4) {
      bool if_hi, if_lo;
      H = h2_bmax(M, h2_bmax(I, D, if_hi, if_lo), mf_hi, mf_lo);
      code_lo = (mf_lo ? 0 : (if_lo ? 1 : 2)) | (ci_lo ? 4 : 0) | lflag;
      code_hi = (mf_hi ? 0 : (if_hi ? 1 : 2)) | (ci_hi ? 4 : 0) |
                pre.dflag_lo;
    } else {
      H = h2_bmax(M, h2_max(I, D), mf_hi, mf_lo);
      // t0 >= I1: the merged I source is t0.
      bool hi_hi, hi_lo, hd_hi, hd_lo, io_hi, io_lo;
      h2_eq(I, H, hi_hi, hi_lo);
      h2_eq(D, H, hd_hi, hd_lo);
      h2_eq(isel, pre.t0, io_hi, io_lo);
      code_lo = (mf_lo ? kHM : 0) | (hi_lo ? kHI : 0) | (hd_lo ? kHD : 0) |
                (ci_lo ? kIEXT : 0) | (io_lo ? kIOPEN : 0) | lflag;
      code_hi = (mf_hi ? kHM : 0) | (hi_hi ? kHI : 0) | (hd_hi ? kHD : 0) |
                (ci_hi ? kIEXT : 0) | (io_hi ? kIOPEN : 0) | pre.dflag_lo;
      if (MODE == kModeLocal) {
        if (rs_lo) code_lo |= kLSTART;
        if (rs_hi) code_hi |= kLSTART;
      }
    }
  }
  c.H2 = c.H1;
  c.H1 = H;
  c.M1 = M;
  c.I1 = I;
  c.D1 = D;
}

// Both lanes' substitution scores from whether their codes match.
SA_HD uint32_t h2_sub(bool eq_lo, bool eq_hi, const Scheme& s) {
  return h2_los(static_cast<uint32_t>(eq_lo ? s.match : s.mismatch),
                static_cast<uint32_t>(eq_hi ? s.match : s.mismatch));
}

}  // namespace sa

// The streamed fills' cell with int16 score state, two lanes a word.
//
// It is ops/nw_affine_stream.py::_stream_step with int16 state written for
// a pair of adjacent lanes of a row: lane 2j in the low half of a 32-bit
// word, lane 2j + 1 in the high half, so each of H2, H1, M1, I1 and D1 is
// one register for two lanes, and every add-max, max3 and max of the
// recurrence is one Hopper DPX instruction for both (__viaddmax_s16x2,
// __vimax3_s16x2, __vibmax_s16x2).  On the host each half is computed on
// its own with the same integers (host_check.cpp).
//
// The direction codes are built a word for both lanes too.  Every flag of
// ring_cell is an equality of a maximum and one of its operands; both
// halves are tested at once as min_u16(a ^ b, 1) -- 0 where equal, 1 where
// not, one LOP3 and one VIMNMX.U16x2, and no borrow crosses the halves
// -- and the flags are weighed into both lanes' codes by integer
// multiply-adds: each lane's code in the top nibble (fast4) or byte (full)
// of its half (h2_code_fast4, h2_code_full).  A word of fast4 codes is
// shifted into one accumulator for the pair, which holds half a direction
// word of each lane, and split into the two lanes' words with two PRMTs
// once a word (push_code2, split_codes); a word of full codes goes into
// the lanes' words with a PRMT each (push_full2).  No flag is read from a
// __vibmax_s16x2 predicate: ptxas for sm_90a was seen to build a wrong
// operand half for one whose maximum is dropped, and to drop the
// predicates of one whose maximum is kept (a packed running argmax of
// local's scores).  The modes' running argmax stays int32 a lane
// (stream_ring_kernel.cuh::lane_modes): a window of eligible steps in int16
// would need the query shorter than 2^15 steps, which the certification
// does not bound for every scheme.
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
constexpr uint32_t kH2One = 0x00010001u;  // 1 in both halves

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

// max(a, b) in each half: one VIMNMX (its flags not read; an add-max of 0
// would rebuild the zero operand in a register at every use).
SA_HD uint32_t h2_max(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  bool hi, lo;
  return __vibmax_s16x2(a, b, &hi, &lo);
#else
  return h2_add_max(a, 0u, b);
#endif
}

// (x != 0) in each half as 0 or 1: min_u16(x, 1), one VIMNMX.U16x2.
SA_HD uint32_t h2_nz(uint32_t x) {
#if defined(__CUDA_ARCH__)
  bool hi, lo;
  return __vibmin_u16x2(x, kH2One, &hi, &lo);
#else
  return ((x & 0xffffu) != 0 ? 1u : 0u) | ((x >> 16) != 0 ? 0x10000u : 0u);
#endif
}

// (a != b) in each half as 0 or 1: a LOP3 and h2_nz.
SA_HD uint32_t h2_ne(uint32_t a, uint32_t b) { return h2_nz(a ^ b); }

// (a != b and c != d) in each half as 0 or 1: one VIMNMX3.U16x2 of the
// two XORs and 1.
SA_HD uint32_t h2_ne2(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
#if defined(__CUDA_ARCH__)
  return __vimin3_u16x2(a ^ b, c ^ d, kH2One);
#else
  return h2_ne(a, b) & h2_ne(c, d);
#endif
}

// w (< 2^16) in each half whose flag nz (0 or 1, as h2_ne) is 0, else 0:
// w * 0x10001 - nz * w, one multiply-add.  A sum of such terms, and of
// other per-half values, is exact in 32 bits whatever the order of the
// adds, as long as each half of the total stays below 2^16.
SA_HD uint32_t h2_unless(uint32_t nz, uint32_t w) {
  return w * kH2One - nz * w;
}

// Where a lane's direction code sits in its half of a code word: the top
// nibble (fast4) or byte (full): a word of fast4 codes shifts into a lane
// pair's accumulator with one add (push_code2), and each half's top byte
// is a PRMT's pick (push_full2).
template <int DIRS>
SA_HD constexpr int code_at() {
  return DIRS == kDirsFast4 ? 12 : 8;
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

// Both lanes' D bits of ring_pre (the merged source D1 or t0 = M1 + o) at
// their code position: fast4 8 where D1 >= t0; full kDEXT there and kDOPEN
// where t0 >= D1.  dsel = max(D1, t0).
template <int DIRS>
SA_HD uint32_t h2_dcode(uint32_t D1, uint32_t t0, uint32_t dsel) {
  constexpr int at = code_at<DIRS>();
  if (DIRS == kDirsFast4) return h2_unless(h2_ne(dsel, D1), 8u << at);
  if (DIRS == kDirsFull) {
    return h2_unless(h2_ne(dsel, D1), kDEXT << at) +
           h2_unless(h2_ne(dsel, t0), kDOPEN << at);
  }
  return 0;
}

// Both lanes' fast4 codes (ring_cell's: the argmax of H = max(M, I, D)
// with priority M > I > D, 4 where I1 >= t0, and the left lane's D bits
// ldcode) at bits 12-15 and 28-31.  isel = max(I1, t0).  The argmax is 0
// where M == H, else 1 where I == H, else 2: [M != H] + [M != H and I !=
// H].
SA_HD uint32_t h2_code_fast4(uint32_t M, uint32_t I, uint32_t H,
                             uint32_t isel, uint32_t I1, uint32_t ldcode) {
  constexpr int at = code_at<kDirsFast4>();
  const uint32_t arg = h2_ne(M, H) + h2_ne2(M, H, I, H);
  return arg * (1u << at) + h2_unless(h2_ne(isel, I1), 4u << at) + ldcode;
}

// Both lanes' full codes (ring_cell's: kHM / kHI / kHD where M / I / D
// equals H, kIEXT where I1 >= t0, kIOPEN where t0 >= I1, the left lane's D
// bits ldcode, and local's restarts rs: kLSTART << 8 in a half that
// restarts) at bits 8-15 and 24-31.
SA_HD uint32_t h2_code_full(uint32_t M, uint32_t I, uint32_t D, uint32_t H,
                            uint32_t isel, uint32_t I1, uint32_t t0,
                            uint32_t ldcode, uint32_t rs) {
  constexpr int at = code_at<kDirsFull>();
  return h2_unless(h2_ne(M, H), kHM << at) +
         h2_unless(h2_ne(I, H), kHI << at) +
         h2_unless(h2_ne(D, H), kHD << at) +
         h2_unless(h2_ne(isel, I1), kIEXT << at) +
         h2_unless(h2_ne(isel, t0), kIOPEN << at) + ldcode + rs;
}

// A word of two lanes' fast4 codes (at bits 12-15 and 28-31) shifted into
// the pair's accumulator: each half holds the lane's last 4 codes, the
// oldest lowest.  Exact while the accumulator started from 0 at its half
// word's first step (the halves do not mix before then).
SA_HD uint32_t push_code2(uint32_t acc, uint32_t code) {
  return (acc >> 4) + code;
}

// The two lanes' fast4 direction words from a pair's accumulators: first,
// the word's first 4 steps, and acc, its last 4.
SA_HD void split_codes(uint32_t first, uint32_t acc, uint32_t& lo,
                       uint32_t& hi) {
  lo = byte_perm(first, acc, 0x5410);
  hi = byte_perm(first, acc, 0x7632);
}

// A word of two lanes' full codes (at bits 8-15 and 24-31) shifted into
// the lanes' direction words (push_code per lane): one PRMT each.
SA_HD void push_full2(uint32_t& lo, uint32_t& hi, uint32_t code) {
  lo = byte_perm(lo, code, 0x5321);
  hi = byte_perm(hi, code, 0x7321);
}

// What each lane hands its right neighbour (ring_pre per half): t0 = M1 + o,
// the merged D source, and the D bits at their code position (h2_dcode).
struct Pre16 {
  uint32_t t0, dsel, dcode;
};

template <int DIRS>
SA_HD Pre16 ring_pre16(const Cell16& c, const Scheme16& s) {
  Pre16 r;
  r.t0 = h2_add(c.M1, s.o2);
  r.dsel = h2_max(c.D1, r.t0);
  r.dcode = h2_dcode<DIRS>(c.D1, r.t0, r.dsel);
  return r;
}

// The high lane's D bits of a dcode as ring_pre's dflag (what a thread
// hands the next one), and a left neighbour's dflag as the previous word
// of a dcode (for h2_left).
template <int DIRS>
SA_HD int32_t dflag_hi(uint32_t dcode) {
  return static_cast<int32_t>(dcode >> (16 + code_at<DIRS>()));
}
template <int DIRS>
SA_HD uint32_t dflag_word(int32_t dflag) {
  return static_cast<uint32_t>(dflag) << (16 + code_at<DIRS>());
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
// word's own ring_pre16; lH2 / ldsel / ldcode: the lanes' left neighbours'
// H2, merged D source and D bits (h2_left); sub2: each lane's substitution
// score.  ATP / AT0 as ring_cell: ph is the half holding lane p (-1:
// neither), at0 whether the low half is lane 0.  Returns both lanes'
// direction codes at code_at (0 for DIRS none).
template <int DIRS, int MODE, bool COMPAT, bool ATP, bool AT0>
SA_HD uint32_t ring_word16(Cell16& c, const Pre16& pre, uint32_t lH2,
                           uint32_t ldsel, uint32_t ldcode, uint32_t sub2,
                           bool at0, int ph, int32_t p, const Scheme16& s) {
  uint32_t M;
  uint32_t rs = 0;  // local's restarts: kLSTART << 8 in a half
  if (MODE == kModeLocal && DIRS == kDirsNone) {
    M = h2_add_max_relu(lH2, sub2, kH2Min);
  } else if (MODE == kModeLocal) {
    // A restart is a cell the clamp moved (M < 0 before it): its sign bit
    // is kLSTART's place in a full code.
    const uint32_t m = h2_add(lH2, sub2);
    M = h2_add_max_relu(m, 0u, kH2Min);
    rs = m & kH2Min;
  } else {
    M = h2_add(lH2, sub2);
  }
  const uint32_t isel = h2_max(c.I1, pre.t0);
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
        rs |= 0x8000u << 16 * ph;
      }
      if (a0) {
        M = h2_set(M, 0, 0);
        I = h2_set(I, 0, s.neg);
        D = h2_set(D, 0, s.neg);
        rs |= 0x8000u;
      }
    }
  }
  const uint32_t H = h2_max3(M, I, D);
  uint32_t code = 0;
  if (DIRS == kDirsFast4) {
    code = h2_code_fast4(M, I, H, isel, c.I1, ldcode);
  } else if (DIRS == kDirsFull) {
    code = h2_code_full(M, I, D, H, isel, c.I1, pre.t0, ldcode,
                        MODE == kModeLocal ? rs : 0u);
  }
  c.H2 = c.H1;
  c.H1 = H;
  c.M1 = M;
  c.I1 = I;
  c.D1 = D;
  return code;
}

// Both lanes' substitution scores from their byte of matched codes (lane
// 2j's 4 bits low, 2j + 1's high: the codes' XOR, zero where they match,
// or for wildcards their AND, zero where they do not): the byte spread
// into both halves (a PRMT), each lane's nibble kept (a LOP3), tested for
// zero (h2_nz), and base + nz * step in one multiply-add -- base the score
// where nz is 0 in both halves, step its difference to the other, less
// the carry a low half's add would hand the high one.  B is the byte's
// place in the word of matched codes.
template <bool WILDCARD, int B>
SA_HD uint32_t h2_sub2(uint32_t mx, const Scheme& s) {
  const int32_t base = WILDCARD ? s.mismatch : s.match;
  const uint32_t diff = static_cast<uint32_t>(
                            WILDCARD ? s.match - s.mismatch
                                     : s.mismatch - s.match) & 0xffffu;
  const uint32_t carry =
      ((static_cast<uint32_t>(base) & 0xffffu) + diff) >> 16;
  const uint32_t both = byte_perm(mx, 0u, 0x4040u | B << 8 | B);
  return h2_nz(both & 0x00f0000fu) * (diff - (carry << 16)) +
         h2_pack(base, base);
}

}  // namespace sa

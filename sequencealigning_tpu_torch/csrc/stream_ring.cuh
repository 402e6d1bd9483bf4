// The warp-ring schedule of the streamed fills (nw_affine_stream.cu), shared
// with the serial host build (host_check.cpp): the block shape of each
// instance, the ring and wrap geometry, and (device builds only) the waits.
//
// A row of P lanes is held by one block, or past 8192 lanes by a cluster
// (cluster_split.cuh's CTAs); each warp owns 32 x LPT consecutive lanes and
// sweeps the row's T steps at its own pace, in chunks of C steps.  What a
// warp's first lane needs from the lane left of it (H two steps back, the
// merged D source, the query code and the D bits) the warp holding that lane
// writes into a ring in shared memory: one entry a step, the entries of a
// chunk in one of `slots` slots, published by a release store of the chunk
// count, which the consumer acquires before its chunk and answers with the
// count it has read.  The last warp of a CTA writes into the next CTA's ring
// through distributed shared memory.  Lane 0's only dependence on lane P-1
// (the torus of jnp.roll) is the D bits in its direction code: the warp
// holding lane 0 leaves lane 0's words without them in a wrap ring of
// `wrap` words, in the CTA holding lane P-1, whose thread ORs in the bits
// and stores the word.  So the waits form a chain from lane 0 to lane P-1,
// plus the wrap ring's slack back to lane 0, checked once a chunk: no block
// barrier a step.
#pragma once

#include <stdint.h>

#include "cluster_split.cuh"

namespace sa {

constexpr int kRingMaxWarps = 32;     // warps a CTA (1024 threads)
constexpr int kRingMaxEntries = 64;   // slots x chunk steps a warp edge
constexpr int kWrapMaxWords = 256;    // lane 0's words in flight at most
constexpr int kRingStalled = 1;       // the status word after a stall
constexpr int kRingUnmet = -4;        // the host build's unmet wait

// Threads a block of an instance with LPT lanes a thread at most, and its
// register cap: a SM's four schedulers hold 16384 registers each, and a
// block's warps spread over them, so at most 16384 / (32 x its warps on one
// scheduler), a multiple of 8: 64 at 1024 threads, 96 at 544 (17 warps),
// 128 at 512.  The modes' 4-lane instance takes 544 threads, a 2176-lane
// row.
SA_HD constexpr int ring_max_threads(int lpt, bool modes) {
  return lpt == 2 ? 1024 : lpt == 4 ? (modes ? 544 : 1024) : 512;
}
SA_HD constexpr int ring_max_regs(int lpt, bool modes) {
  return 16384 / (32 * ((ring_max_threads(lpt, modes) / 32 + 3) / 4)) / 8 *
         8;
}

// The split of a row of P lanes for the streamed fills: plan_split's CTAs,
// with lanes a thread chosen for the instance -- 8 for the global fill and
// 4 for the modes (the shapes measured fastest on the H100 at 2048 and 2176
// lanes: two 256-thread blocks of 128 registers a SM, one 544-thread block
// of 96), more where the threads would not fit -- or `lpt` (2, 4, 8 or
// 16) when forced.  nctas == 0: out of range.
SA_HD Split stream_plan(int P, int cta_lanes, bool modes, int lpt) {
  Split sp = plan_split(P, cta_lanes);
  if (sp.nctas == 0) return sp;
  if (lpt == 0) {
    for (lpt = modes ? 4 : 8; lpt <= 16; lpt *= 2) {
      if (sp.cta_lanes / lpt <= ring_max_threads(lpt, modes)) break;
    }
  }
  if ((lpt != 2 && lpt != 4 && lpt != 8 && lpt != 16) ||
      sp.cta_lanes / lpt > ring_max_threads(lpt, modes)) {
    sp.nctas = 0;
    return sp;
  }
  sp.lpt = lpt;
  return sp;
}

// The per-pair fills (pair_sweep.cuh: kernels #6 and #7 and the linear
// fill) on the same rings: each pair's row of P lanes over a cluster of
// CTAs of a few warps, so a small batch fills the card.  Their CTAs hold
// at most 256 threads at 2 or 4 lanes a thread (so a thread may keep its
// lanes in up to 255 registers), 512 at 8 or 16 (128 registers).
SA_HD constexpr int pair_max_threads(int lpt) { return lpt <= 4 ? 256 : 512; }

// The split of a pair's P lanes when B pairs share a card of `sms` SMs:
// CTAs of 256 lanes, or fewer CTAs a pair where B of them would pass 3/4 of
// the SMs, but three a pair at least from 768 lanes a pair (two from 512;
// at most 16 CTAs, at most 8192 lanes a CTA), each a multiple of 128
// lanes; 2 lanes a thread where 256 threads hold a CTA's lanes, else 4, 8
// or 16.  (On an NVIDIA H100 80GB HBM3 at 700 W, the fastest splits timed:
// one pair of 2046 bp in 9 CTAs of 256 lanes x 2 a thread, 1.31 ms; 31
// pairs in 3 CTAs a pair at 4 lanes a thread, 2.04 ms; chip_smoke.py phase
// 6; for kernel #7 and the linear fill at 512 and 4096 pairs, 3 CTAs a
// pair at 4 lanes a thread, 2 at 8 within 1-7%, one CTA of 272 threads up
// to 1.45x slower, csrc/stream_sweep.py --pairs.)  cta_lanes > 0
// forces the CTA width (as plan_split: at most 16 CTAs) and lpt > 0 the
// lanes a thread.  nctas == 0: out of range.
SA_HD Split pair_plan(int P, int B, int sms, int cta_lanes, int lpt) {
  Split sp = {0, 0, 0};
  if (P <= 0 || P % 128 != 0 || B <= 0) return sp;
  if (cta_lanes == 0) {
    const int units = P / 128;
    int want = (units + 1) / 2;            // CTAs of 256 lanes
    const int fill = 3 * sms / 4 / B;      // CTAs a pair the card holds
    want = want < fill ? want : fill;
    // Many pairs: still three CTAs a pair (two below 768 lanes).
    const int least = units >= 6 ? 3 : units >= 4 ? 2 : 1;
    want = want < least ? least : want;
    const int fit = (P + 8191) / 8192;     // CTAs of at most 8192 lanes
    want = want < fit ? fit : want > kMaxClusterCtas ? kMaxClusterCtas : want;
    cta_lanes = (units + want - 1) / want * 128;
  }
  sp = plan_split(P, cta_lanes);
  if (sp.nctas == 0) return sp;
  if (lpt == 0) {
    for (lpt = 2; lpt < 16; lpt *= 2) {
      if (sp.cta_lanes / lpt <= pair_max_threads(lpt)) break;
    }
  }
  if ((lpt != 2 && lpt != 4 && lpt != 8 && lpt != 16) ||
      sp.cta_lanes / lpt > pair_max_threads(lpt)) {
    sp.nctas = 0;
    return sp;
  }
  sp.lpt = lpt;
  return sp;
}

// The rings' shape: chunk steps (1-32, one code a lane of a warp), slots
// (>= 1; slots x chunk <= kRingMaxEntries) and wrap words (a power of two,
// 1..kWrapMaxWords).  A 0 takes the default: chunks of 16 steps for the
// global fill and 32 for the modes (the fastest measured at the main
// shapes, csrc/stream_sweep.py), as many slots as fit kRingMaxEntries but
// at most 4, kWrapMaxWords wrap words.
struct RingShape {
  int chunk, slots, wrap;
};

SA_HD RingShape ring_shape(int chunk, int slots, int wrap, bool modes) {
  RingShape r;
  r.chunk = chunk != 0 ? chunk : (modes ? 32 : 16);
  const int fit = r.chunk >= 1 ? kRingMaxEntries / r.chunk : 1;
  r.slots = slots != 0 ? slots : fit < 1 ? 1 : fit > 4 ? 4 : fit;
  r.wrap = wrap != 0 ? wrap : kWrapMaxWords;
  return r;
}

SA_HD bool ring_ok(const RingShape& r) {
  return r.chunk >= 1 && r.chunk <= 32 && r.slots >= 1 &&
         r.slots * r.chunk <= kRingMaxEntries && r.wrap >= 1 &&
         r.wrap <= kWrapMaxWords && (r.wrap & (r.wrap - 1)) == 0;
}

// A launch's shape for the wrappers (sa_stream_plan, hc_stream_plan):
// shape[0..5] = lanes a thread, threads a CTA, CTAs a row, chunk steps,
// slots, wrap words; -1 when the split or the rings are out of range.
SA_HD int stream_launch_shape(int P, int cta_lanes, bool modes, int lpt,
                              int chunk, int slots, int wrap, int* shape) {
  const Split sp = stream_plan(P, cta_lanes, modes, lpt);
  const RingShape r = ring_shape(chunk, slots, wrap, modes);
  if (sp.nctas == 0 || !ring_ok(r)) return -1;
  shape[0] = sp.lpt;
  shape[1] = cta_threads(sp);
  shape[2] = sp.nctas;
  shape[3] = r.chunk;
  shape[4] = r.slots;
  shape[5] = r.wrap;
  return 0;
}

// The per-pair fills' launch shape (sa_pair_plan, hc_pair_plan):
// shape[0..4] = lanes a thread, threads a CTA, CTAs a pair, chunk steps,
// slots; -1 when the split or the rings are out of range.
SA_HD int pair_launch_shape(int P, int B, int sms, int cta_lanes, int lpt,
                            int chunk, int slots, int* shape) {
  const Split sp = pair_plan(P, B, sms, cta_lanes, lpt);
  const RingShape r = ring_shape(chunk, slots, 0, true);
  if (sp.nctas == 0 || !ring_ok(r)) return -1;
  shape[0] = sp.lpt;
  shape[1] = cta_threads(sp);
  shape[2] = sp.nctas;
  shape[3] = r.chunk;
  shape[4] = r.slots;
  return 0;
}

// Warps of CTA `rank` holding real lanes.
SA_HD int ring_warps(int rank, const Split& sp, int P) {
  return (cta_real_lanes(rank, sp, P) / sp.lpt + 31) / 32;
}

// What a lane hands the next lane, packed for the ring: the query code in
// the low byte, the D bits above it.
SA_HD int32_t ring_pack(int32_t s1d, int32_t dflag) {
  return s1d | dflag << 8;
}
SA_HD int32_t ring_s1d(int32_t v) { return v & 0xff; }
SA_HD int32_t ring_dflag(int32_t v) { return v >> 8; }

// The waits' targets.  A producer writes chunk k into slot k % slots once
// its consumer has read chunk k - slots; a consumer reads chunk k once it is
// published.  Lane 0's word w goes into wrap slot w % wrap; the warp holding
// lane 0 starts a chunk after whose end words_end words are complete once
// the thread of lane P-1 has read back words_end - wrap of them (it
// publishes its count at the end of each of its chunks).  It reads a word
// in the step that completes it, ordered after the write by the chain of
// rings.  Every wait is on lanes to the left except the wrap's, which is
// met in any order while wrap >= the words a chunk completes, and never
// when a chunk completes more.
SA_HD int32_t ring_free_need(int k, int slots) { return k + 1 - slots; }
SA_HD int32_t ring_full_need(int k) { return k + 1; }
SA_HD int32_t wrap_free_need(int words_end, int wrap) {
  return words_end - wrap;
}

}  // namespace sa

#if defined(__CUDACC__)
namespace sa {

constexpr unsigned kRingSpinLimit = 1u << 22;

// A CTA's rings: entry[w] is warp w's input ring (slots x chunk entries of
// (H2, merged D source, packed query code and D bits)); full[w] counts the
// chunks published into it, freed[w] the chunks of warp w's OUTPUT ring its
// consumer has read (so each producer polls its own CTA).  wrap is used in
// the CTA holding lane P-1, wrap_freed (lane 0's words read back) in CTA 0
// (the streamed fills only).
struct RingSmem {
  int4 entry[kRingMaxWarps][kRingMaxEntries];
  int32_t full[kRingMaxWarps];
  int32_t freed[kRingMaxWarps];
  uint32_t wrap[kWrapMaxWords];
  int32_t wrap_freed;
};

// 32-bit shared-memory addresses of the rings: a ring entry is stored by
// its producer (in the next CTA of a cluster for a CTA's last warp) and
// loaded by its consumer, one 16-byte access a step.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void ring_put(uint32_t a, bool remote, int32_t x,
                                         int32_t y, int32_t z) {
  if (remote) {
    asm volatile("st.shared::cluster.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(a),
                 "r"(x), "r"(y), "r"(z), "r"(0));
  } else {
    asm volatile("st.shared.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(a), "r"(x),
                 "r"(y), "r"(z), "r"(0));
  }
}
__device__ __forceinline__ int4 ring_get(uint32_t a) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

// The counters live in shared memory and are named by 32-bit addresses:
// a wait reads this CTA's (shared::cta), a release may write another CTA's
// of the cluster (shared::cluster, from mapa).
__device__ __forceinline__ int32_t ring_acquire(uint32_t a, bool cluster) {
  int32_t v;
  if (cluster) {
    asm volatile("ld.acquire.cluster.shared::cta.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"(a)
                 : "memory");
  } else {
    asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"(a)
                 : "memory");
  }
  return v;
}

__device__ __forceinline__ void ring_release(uint32_t a, int32_t v,
                                             bool cluster) {
  if (cluster) {
    asm volatile("st.release.cluster.shared::cluster.b32 [%0], %1;" ::"r"(a),
                 "r"(v)
                 : "memory");
  } else {
    asm volatile("st.release.cta.shared::cta.b32 [%0], %1;" ::"r"(a), "r"(v)
                 : "memory");
  }
}

// Waits until the counter at a (this CTA's) reaches target.  False when
// the launch's status word is set, or when the counter has not moved for
// kRingSpinLimit polls (then this wait sets it): a schedule that cannot be
// met raises in the wrapper instead of hanging.
__device__ __forceinline__ bool ring_wait(uint32_t a, int32_t target,
                                          bool cluster, int32_t* status) {
  int32_t last = ring_acquire(a, cluster);
  unsigned polls = 0;
  while (last < target) {
    if (++polls > 32) {
      if (*reinterpret_cast<volatile int32_t*>(status) != 0) return false;
      if (polls > kRingSpinLimit) {
        atomicCAS(status, 0, kRingStalled);
        return false;
      }
      __nanosleep(64);
    }
    const int32_t v = ring_acquire(a, cluster);
    if (v != last) {
      last = v;
      polls = 0;
    }
  }
  return true;
}

}  // namespace sa
#endif

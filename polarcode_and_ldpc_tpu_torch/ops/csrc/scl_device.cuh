// Device functions of the SCL list decoder for Hopper (sm_90a): the size-S
// subtree list decode ("chunk body") that every SCL kernel runs, written once
// so that the chunk-body, chunk-step, last-chunk and whole-decode kernels of
// scl_kernels.cuh are the same functions in different launches.
//
// They compute what polarcode_and_ldpc_tpu/ops/scl_body_pallas.py computes
// (the f/g recursion over one static frozen pattern, rate-0 metric collapse,
// exact REP node, per-info-leaf stable top-L of 2L candidates, lazy rank
// re-indexing), for ONE FRAME PER WARP:
//
//   alpha   level stack of the chunk, depth d holds [L][S >> d] floats; the
//           top plane (depth 0) where the kernel keeps it (see chunk_body)
//   beta    S words: bit l of word m is path l's partial sum at position m
//   Rstack  one saved left-child rank vector per depth
//   pm, R   in registers: lane l holds path l's metric and R[l], the rank
//           vector the last node handed back
//
// What bounds the body on Hopper (the stage profile, -DSCL_PROFILE, on an
// NVIDIA H100 80GB HBM3 at 700 W): issue and latency per op, not bytes; a
// warp's op takes 600-2000 cycles with 20-32 warps per SM.  So the design
// cuts instructions and round trips: the prune ranks its candidates by
// shuffles and ballots in registers (no shared memory, no __syncwarp inside
// it), and the bottom of the tree, where F and G leave most lanes idle, runs
// as one in-register op per subtree (OP_SUBTREE, one element per lane).
//
// Path bits are PACKED across the list axis (L <= 32): a rank apply on a bit
// plane is then local to one word (no cross-lane hazard), a combine is one
// XOR per position, and the final butterfly moves L x less data.  A rank apply
// on an alpha plane never moves data either: the only reader of a permuted
// alpha is the g that follows, so g reads its operands THROUGH the rank
// vector.  Rate-0 and REP nodes work in place on their own alpha level, which
// nothing reads again.
//
// The node program (F, G, COMBINE and the leaf kinds, with "has a rank
// vector" flags) is built on the host from the chunk's frozen pattern and
// read from global memory, so one compiled kernel serves every chunk of every
// code.  The order of the float additions and of the candidates IS the
// result: the rate-0 sum pairs neighbours first, REP adds its block sums to
// the metric from the largest block to the smallest, and the 2L candidates
// (bit-0 paths, then bit-1 paths) rank stable descending with the lower index
// winning a tie.  Build with -fmad=false and no fast-math.
//
// A fast program (node_mode="fast") adds the SSCL fast list nodes of the
// TPU kernel's _rate1_fast_rank_loop / _rep_fast_rank_loop: OP_RATE1_FAST
// decodes an all-info subtree in min(L-1, size) prune stages over its least
// reliable positions, OP_REP_FAST scores a repetition subtree's two codewords
// whole in one prune.  Both sum with the halving tree (x[:h] + x[h:]), not
// the adjacent-pair tree of rate-0 / REP.  It runs in instances of its own
// (kFast; the exact ones carry none of its code), and like the exact program
// it decodes the bottom of the tree in registers: a fast OP_SUBTREE
// (kFlagFast) takes the fast dispatch, and a larger fast node holds its
// elements in its paths' lane groups (see rate1_fast): run through shared
// memory, these nodes made a fast flagship step take 1.24x the cycles of the
// exact one, 41 % of them in the small fast nodes (NVIDIA H100 80GB HBM3,
// 700 W, the stage profile at position 3).
//
// LIVE WIDTH (the TPU kernel's widths= mode, make_superchunk_pallas): an
// exact body can start at fewer live paths w than the list holds (the list
// fills 1 -> 2 -> ... -> L, doubling per info leaf).  Every op then runs over
// the first w rows only, an info leaf ranks 2w candidates (bit-0 paths, then
// bit-1 paths) and keeps min(2w, L), and w doubles; rows and lanes >= w are
// never read or written.  At w = L this is the full-width body.  Fast programs
// run at full width only.
//
// Where the context lives: Ctx is plain pointers.  The kernels point it at
// the warp's slice of shared memory, or, when the chunk's working set does
// not fit there, at the warp's slice of a scratch buffer in device memory;
// the device functions are the same.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fastnode_device.cuh"

namespace scl {

// Stage profile (compile with -DSCL_PROFILE; the normal build has none of
// it): lane 0 of each warp adds the clock64() cycles of each part of a chunk
// step and of each body op kind (F / G / COMBINE split at w * size < 32, the
// sub-warp ops; the fast nodes split at L * size <= 32, and inside a larger
// fast node its sums, its selection rounds with its prunes, and its bits) to
// a per-thread table, which the kernel adds to device-global
// counters at the end of its frame; the whole-decode kernel also counts its
// last chunk (descend, body, ascend), the butterfly, the outputs, and the
// frame's whole decode; the last-chunk kernel its descend, body, ascend to the
// root, butterfly, outputs and whole frame (the STEP slot); the one-hot modes
// of the chunk step and the last chunk their staging of the pendings' planes
// (ONEHOT_LOAD) and the chunk step its stores of the written planes
// (ONEHOT_STORE), outside the STEP slot; the chunk-body kernel its copy-in,
// body, output stores (OUT) and whole frame (STEP).  The counters'
// cost lands outside the timed intervals, but it and the clock reads stretch
// the kernel: read the split as shares, not as times.
enum ProfSlot : int {
  PROF_DESCEND = 0, PROF_COPY_IN, PROF_F_SMALL, PROF_F_WIDE, PROF_G_SMALL, PROF_G_WIDE,
  PROF_COMBINE_SMALL, PROF_COMBINE_WIDE, PROF_LEAF, PROF_REP, PROF_RATE0, PROF_RATE1_FAST,
  PROF_REP_FAST, PROF_SUBTREE, PROF_BODY, PROF_COMPOSE, PROF_ASCEND, PROF_STEP, PROF_LAST,
  PROF_BUTTERFLY, PROF_DECODE, PROF_RATE1_FAST_SMALL, PROF_REP_FAST_SMALL, PROF_FAST_SUM,
  PROF_FAST_STAGES, PROF_FAST_BITS, PROF_OUT, PROF_ONEHOT_LOAD, PROF_ONEHOT_STORE, kProfSlots
};
#ifdef SCL_PROFILE
__device__ unsigned long long g_prof[2 * kProfSlots];  // cycles, then counts
#define SCL_PROF_DECL unsigned long long prof_acc[2 * scl::kProfSlots] = {}
#define SCL_PROF_BIND(c) (c).prof = prof_acc
#define SCL_PROF_T(name) const long long name = clock64()
#define SCL_PROF_ADD(c, slot, t0)                                  \
  do {                                                             \
    if ((c).lane == 0) {                                           \
      (c).prof[(slot)] += (unsigned long long)(clock64() - (t0));  \
      (c).prof[scl::kProfSlots + (slot)] += 1ull;                  \
    }                                                              \
  } while (0)
#define SCL_PROF_FLUSH(c)                                                 \
  do {                                                                    \
    if ((c).lane == 0)                                                    \
      for (int q = 0; q < 2 * scl::kProfSlots; ++q)                       \
        if ((c).prof[q]) atomicAdd(&scl::g_prof[q], (c).prof[q]);         \
  } while (0)
#else
#define SCL_PROF_DECL
#define SCL_PROF_BIND(c)
#define SCL_PROF_T(name)
#define SCL_PROF_ADD(c, slot, t0)
#define SCL_PROF_FLUSH(c)
#endif

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

enum Op : int {
  OP_F = 0,        // y = depth, z = half
  OP_G = 1,        // y = depth, z = half, w = beta offset of the left child
  OP_COMBINE = 2,  // y = depth, z = half, w = beta offset
  OP_RATE0 = 3,    // y = depth, z = size, w = beta offset
  OP_LEAF = 4,     // y = depth, w = beta offset (one info leaf)
  OP_REP = 5,      // y = depth, z = size, w = beta offset
  OP_RATE1_FAST = 6,  // y = depth, z = size, w = beta offset
  OP_REP_FAST = 7,    // y = depth, z = size, w = beta offset
  OP_SUBTREE = 8      // y = depth, z = size (2 or 4), w = beta offset; frozen bits in x >> 16
};
// flags in bits 8.. of the op word
constexpr int kFlagRL = 1 << 8;  // the left child handed back a rank vector
constexpr int kFlagRR = 2 << 8;  // the right child did
constexpr int kFlagFast = 4 << 8;  // an OP_SUBTREE of a fast program (the fast instances
                                   // run every OP_SUBTREE so)

// W: the word of a position's path bits, uint32_t up to L = 32, or (a wide
// list, see WIDE LISTS below) a 64-bit word
template <typename W>
struct CtxT {
  float* alpha;   // the alpha stack below the chunk's top: depth d >= 1 is [L][S >> d];
                  // its first L * S words hold the top plane of a chunk that is one
                  // rate-0 or REP node (chunk_top)
  W* beta;
  int* R;         // L: the fast body kernel's top-plane address (two words; at L = 1
                  // the second is tmp[0], which no body reads), see ctx_top
  int* tmp;       // L: an effective pending
  int* Rstack;    // (log2 S + 1) x L
  int L, S, lane;
#ifdef SCL_PROFILE
  unsigned long long* prof;  // the warp's cycle and count table (lane 0)
#endif
};
using Ctx = CtxT<uint32_t>;

// 32-bit words of shared memory one frame needs.  No kernel keeps the chunk's
// top plane in it: the chunk step, the last chunk and the whole decode read it
// where their descend left it, in device memory (the level stacks, or the last
// chunk's scratch plane: its state is read only), the body kernel where its
// input lies; the L * S words of the stack region (depths 1.. take L * (S -
// 1)) hold it only for a chunk that is one rate-0 or REP node, which works on
// it in place.
__host__ __device__ inline int ctx_words(int L, int S, int lgS) {
  return S * L + S + L * (2 + lgS + 1);
}

__device__ __forceinline__ Ctx make_ctx(float* base, int L, int S, int lane) {
  Ctx c;
  c.alpha = base;
  c.beta = reinterpret_cast<uint32_t*>(base + S * L);
  c.R = reinterpret_cast<int*>(base + S * L + S);
  c.tmp = c.R + L;
  c.Rstack = c.tmp + L;
  c.L = L;
  c.S = S;
  c.lane = lane;
  return c;
}

// A wide list (33 <= L <= 64, see WIDE LISTS below): its context in the same
// order, each region rounded up to four words so that the 64-bit words of
// beta and the next warp's slice stay aligned; beta holds S 64-bit words.
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int ctx_words_wide(int L, int S, int lgS) {
  return round4(S * L) + 2 * S + round4(L * (2 + lgS + 1));
}

__device__ __forceinline__ float f_minsum(float a, float b) {
  float m = fminf(fabsf(a), fabsf(b));
  uint32_t s = (__float_as_uint(a) ^ __float_as_uint(b)) & 0x80000000u;
  return __uint_as_float(__float_as_uint(m) | s);
}

// (log P(0|a), log P(1|a)) with the shared log1p(exp(-|a|)) term explicit
__device__ __forceinline__ void d0_d1(float a, float& d0, float& d1) {
  float t = log1pf(expf(-fabsf(a)));
  d0 = -(fmaxf(0.0f, -a) + t);
  d1 = -(fmaxf(0.0f, a) + t);
}

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// w rounded up to a power of two (w >= 1)
__device__ __forceinline__ int pow2_ceil(int w) { return w <= 1 ? 1 : 1 << (32 - __clz(w - 1)); }

// The path whose candidates a lane holds in a prune of w live paths: lanes
// form groups of pow2_ceil(w), and lane g * P + p holds path p.
__device__ __forceinline__ int cand_path(int lane, int w) { return lane & (pow2_ceil(w) - 1); }

// shuffles from lane src mod 32
__device__ __forceinline__ float shfl_f(float v, int src) {
  return __shfl_sync(kFull, v, src & (kWarp - 1));
}
__device__ __forceinline__ int shfl_i(int v, int src) {
  return __shfl_sync(kFull, v, src & (kWarp - 1));
}

// rank apply on packed path bits: bit l of the result is bit r[l] of w
__device__ __forceinline__ uint32_t perm_word(uint32_t w, const int* r, int L) {
  uint32_t out = 0;
  for (int l = 0; l < L; ++l) out |= ((w >> r[l]) & 1u) << l;
  return out;
}

// the same on 64-bit words (a wide list, see WIDE LISTS)
__device__ __forceinline__ unsigned long long perm_word_wide(unsigned long long w, const int* r,
                                                             int L) {
  unsigned long long out = 0;
  for (int l = 0; l < L; ++l) out |= ((w >> r[l]) & 1ull) << l;
  return out;
}

// The same with the rank vector in registers (lane l holds r[l]); every lane
// of the warp must call it, each with its own word: n shuffles.
__device__ __forceinline__ uint32_t perm_word_reg(uint32_t w, int r, int n) {
  uint32_t out = 0;
  for (int l = 0; l < n; ++l) out |= ((w >> __shfl_sync(kFull, r, l)) & 1u) << l;
  return out;
}

// perm_word_reg for the words of m <= 32 positions, position i's on lane i:
// bit l of position i's result is lane l's bit of that word, one shuffle and
// one ballot a position (2m warp operations against n shuffles).
__device__ __forceinline__ uint32_t perm_words_ballot(uint32_t w, int r, int n, int m,
                                                      int lane) {
  uint32_t out = 0;
  for (int i = 0; i < m; ++i) {
    const uint32_t wi = __shfl_sync(kFull, w, i);
    const uint32_t b = __ballot_sync(kFull, lane < n && ((wi >> r) & 1u));
    if (lane == i) out = b;
  }
  return out;
}

// the alpha plane at depth d ([L][S >> d] floats): the top plane a0 at depth
// 0, else the stack.  kTopInCtx: the top plane's address is read from the
// context (two words at c.R, written by the kernel before the body; volatile,
// so it is read where it is used and held in no register through the body)
template <typename W>
__device__ __forceinline__ float* ctx_top(const CtxT<W>& c) {
  const volatile uint32_t* w = reinterpret_cast<const volatile uint32_t*>(c.R);
  return reinterpret_cast<float*>(((uint64_t)w[1] << 32) | w[0]);
}
template <bool kTopInCtx = false, typename W>
__device__ __forceinline__ float* depth_ptr(const CtxT<W>& c, float* a0, int d) {
  if (d != 0) return c.alpha + c.L * (c.S - ((2 * c.S) >> d));
  return kTopInCtx ? ctx_top(c) : a0;
}

// leaf LLRs of a subtree under all-zero decisions, in place: z is [L][M]
__device__ __forceinline__ void zero_dec_inplace(float* z, int total, int M, int lane) {
  for (int m = M; m > 1; m >>= 1) {
    const int h = m >> 1, lgh = ilog2(h);
    for (int q = lane; q < total / 2; q += kWarp) {
      const int p = (q >> lgh) * m + (q & (h - 1));
      const float a = z[p], b = z[p + h];
      z[p] = f_minsum(a, b);
      z[p + h] = b + a;
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void d0_inplace(float* z, int total, int lane) {
  for (int i = lane; i < total; i += kWarp) {
    float d0, d1;
    d0_d1(z[i], d0, d1);
    z[i] = d0;
  }
  __syncwarp();
}

// Stable top-`keep` prune of the 2w candidates of w live paths, in
// registers: candidate p (p < w) is path p's bit-0 candidate c0, candidate
// w + p its bit-1 candidate c1, both held by every lane of path p =
// cand_path(lane, w).  Candidate i goes before candidate j iff its metric is
// larger, or equal with i < j (-inf phantoms rank by index like any tie).
// Each group of P = pow2_ceil(w) lanes counts the candidates above its two
// over its share of the w paths (two shuffles per path), one xor-shuffle
// tree sums the groups; then each lane finds the candidates of rank p and
// p + P the same way (w <= 16), or, for a list wider than half a warp, slot
// lane s finds the candidate of rank s from the ranks' bits, one ballot per
// bit and half (the lanes of the live paths whose rank has bit b set): the
// search costs w / G shuffle pairs, the ballots log2(2w) ballot pairs: with
// the shuffle search at w = 32 too, K5 at L=32, S=1024 took 1.22x and the
// N=4096 SCL-32 decode 1.14x as long, the kernels at L=8 the same within 2 %
// (NVIDIA H100 80GB HBM3, 700 W, tools/scl_kernel_ab.py).  Afterwards slot
// lane s < keep holds the s-th candidate's metric in pm and its path in R
// (lanes >= keep keep theirs); returns the word of the slots' bit-1 flags.
// No shared memory, no __syncwarp.  kWide = false: the caller knows w <= 16
// (an OP_SUBTREE leaf), and the ballot path is not compiled in (compiled into
// those prunes it cost K3 at L=8 3 % and K3-fast 7 %, same card and script).
template <bool kWide = true>
__device__ __forceinline__ uint32_t prune(float c0, float c1, int w, int keep, int lane,
                                          float& pm, int& R) {
  const int P = pow2_ceil(w), G = kWarp / P, g = lane / P, p = lane & (P - 1);
  const int per = (w + G - 1) / G;
  int r0 = 0, r1 = 0;
  for (int k = 0; k < per; ++k) {
    const int j = g * per + k;
    const float a = __shfl_sync(kFull, c0, j & (kWarp - 1));
    const float b = __shfl_sync(kFull, c1, j & (kWarp - 1));
    if (j < w) {
      r0 += (a > c0 || (a == c0 && j < p) ? 1 : 0) + (b > c0 ? 1 : 0);
      r1 += (a >= c1 ? 1 : 0) + (b > c1 || (b == c1 && j < p) ? 1 : 0);
    }
  }
  for (int off = P; off < kWarp; off <<= 1) {
    r0 += __shfl_xor_sync(kFull, r0, off);
    r1 += __shfl_xor_sync(kFull, r1, off);
  }
  int src;
  if (!kWide || P < kWarp) {
    int s0 = -1, s1 = -1;  // the candidates of rank p and p + P
    for (int k = 0; k < per; ++k) {
      const int j = g * per + k;
      const int a = __shfl_sync(kFull, r0, j & (kWarp - 1));
      const int b = __shfl_sync(kFull, r1, j & (kWarp - 1));
      if (j < w) {
        if (a == p) s0 = j;
        if (b == p) s0 = w + j;
        if (a == p + P) s1 = j;
        if (b == p + P) s1 = w + j;
      }
    }
    for (int off = P; off < kWarp; off <<= 1) {
      s0 = max(s0, __shfl_xor_sync(kFull, s0, off));
      s1 = max(s1, __shfl_xor_sync(kFull, s1, off));
    }
    src = lane < P ? s0 : s1;
  } else {
    // lane l < w holds path l's ranks: the lanes of rank `lane` in each half
    const bool own = lane < w;
    uint32_t m0 = __ballot_sync(kFull, own), m1 = m0;
    for (int b = 0, nb = 32 - __clz(2 * w - 1); b < nb; ++b) {
      const uint32_t b0 = __ballot_sync(kFull, own && ((r0 >> b) & 1));
      const uint32_t b1 = __ballot_sync(kFull, own && ((r1 >> b) & 1));
      m0 &= (lane >> b) & 1 ? b0 : ~b0;
      m1 &= (lane >> b) & 1 ? b1 : ~b1;
    }
    src = m0 ? __ffs(m0) - 1 : w + __ffs(m1) - 1;  // for lane < keep, one of them
  }
  const int q = src < w ? src : src - w;
  const float v0 = __shfl_sync(kFull, c0, q & (kWarp - 1));
  const float v1 = __shfl_sync(kFull, c1, q & (kWarp - 1));
  if (lane < keep) {
    pm = src < w ? v0 : v1;
    R = q;
  }
  return __ballot_sync(kFull, lane < keep && src >= w);
}

// Branch + stable top-L prune of w live paths (kNarrow: keeping min(2w, L);
// else the full list, w = L): a_p is the leaf LLR of this lane's path
// cand_path(lane, w), pm the metrics on the slot lanes.
template <bool kNarrow, bool kWide = true>
__device__ __forceinline__ uint32_t info_leaf(float a_p, int w, int L, int lane, float& pm,
                                              int& R) {
  const float pp = __shfl_sync(kFull, pm, cand_path(lane, w));
  float d0, d1;
  d0_d1(a_p, d0, d1);
  return prune<kWide>(pp + d0, pp + d1, w, kNarrow ? min(2 * w, L) : L, lane, pm, R);
}

// ---- the larger fast nodes (OP_RATE1_FAST, OP_REP_FAST) ------------------
//
// A fast node too wide for OP_SUBTREE (L * size > 32, or a size above
// SUBTREE_MAX) runs on its [L][sz] plane where F or G left it, with each
// path's G = min(group_lanes(L), sz) lanes (lane = q * G + j) holding its
// elements: lane (q, j) the positions j + G * k, k < E = sz / G.  For E <= 8
// (at L = 8 the nodes of size 8, 16 and 32, most of a decode's larger fast
// nodes) the lane keeps them in registers, read once (kE = E); a wider node
// (kE = 0) reads them from the plane on every selection round and sums them
// in shared memory (fastnode::halving_sum).  The levels below the node's
// plane are scratch: nothing reads them before the next F or G writes them.
struct GroupLanes {
  int G, lgG, q, j;
  bool on;  // q < L: the lane holds a path's elements
};

__device__ __forceinline__ GroupLanes group_of(int lane, int L, int sz) {
  const int G = min(fastnode::group_lanes(L), sz), lgG = ilog2(G);
  return GroupLanes{G, lgG, lane >> lgG, lane & (G - 1), (lane >> lgG) < L};
}

// the elements one lane holds in a fast node of size sz (E above)
__device__ __forceinline__ int fast_elements(int L, int sz) {
  return sz >> ilog2(min(fastnode::group_lanes(L), sz));
}

// The halving-tree sum (x[:h] + x[h:]) of a path's values: over the lane's
// kE registers in k (the strides sz / 2 down to G), then over the group's
// lanes by xor-shuffles (G / 2 down to 1); every lane of the path ends with
// the sum.
template <int kE>
__device__ __forceinline__ float group_halving_sum(float (&v)[kE], int G) {
#pragma unroll
  for (int h = kE / 2; h >= 1; h >>= 1)
#pragma unroll
    for (int k = 0; k < h; ++k) v[k] = v[k] + v[k + h];
  float z = v[0];
  for (int d = G / 2; d >= 1; d >>= 1) z = z + __shfl_xor_sync(kFull, z, d);
  return z;
}

// one element of a selection round: keep the least (|a|, position) pair
// strictly above the last pick (ties to the lower position)
__device__ __forceinline__ void pick_min(float m, int i, float last_m, int last_p, float& bm,
                                         int& bp) {
  const bool above = m > last_m || (m == last_m && i > last_p);
  if (above && (m < bm || (m == bm && i < bp))) {
    bm = m;
    bp = i;
  }
}

// Fast rate-1 node on the [L][sz] plane a, beta words at c.beta + off.  The
// metric pays the halving-tree sum of log1p(exp(-|a|)); then K = min(L-1, sz)
// stages each offer every slot a flip of its s-th least reliable position at
// cost -|a|_(s) through the prune.  Stage s runs selection round s first
// (fastnode::select_k's round over the lane's registers, then a group argmin
// by shuffles), so slot p's cost is a shuffle from its ORIGINAL path
// rtot[p]'s group (lane l's register: the composition of the stage rank
// vectors) and the picks go to scratch ([L][K]) only for the flips.  Lane l's
// `flips` holds, bit s, whether slot l's lineage took stage s's flip,
// composed through each stage's rank vector as rtot is.  The words: slot l's
// hard decisions of its original path, 32 / pow2(L) positions a ballot, then
// each slot's flips XORed in at its original path's picks.  The node's rank
// vector (K > 0) is left in R.
template <int kE>
__device__ __forceinline__ void rate1_fast(const Ctx& c, const float* a, int sz, int off,
                                           float* scratch, float& pm, int& R) {
  const int L = c.L, lane = c.lane;
  const GroupLanes g = group_of(lane, L, sz);
  const float* row = a + (g.on ? g.q : 0) * sz + g.j;  // element k at row[k << lgG]
  float m[kE > 0 ? kE : 1];
  float pen;
  SCL_PROF_T(t_sum);
  if constexpr (kE > 0) {
    float v[kE];
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      m[k] = fabsf(row[k << g.lgG]);
      v[k] = log1pf(expf(-m[k]));
    }
    pen = shfl_f(group_halving_sum<kE>(v, g.G), lane << g.lgG);
  } else {
    fastnode::halving_sum(a, L, sz, scratch, fastnode::Softplus(), lane);
    pen = lane < L ? scratch[lane * (sz / 2)] : 0.0f;
    __syncwarp();
  }
  if (lane < L) pm = pm - pen;
  SCL_PROF_ADD(c, PROF_FAST_SUM, t_sum);
  SCL_PROF_T(t_stages);
  const int K = min(L - 1, sz), p = cand_path(lane, L);
  int* idx = reinterpret_cast<int*>(scratch);
  int rtot = lane;
  uint32_t flips = 0;
  float last_m = -INFINITY;
  int last_p = -1;
  for (int s = 0; s < K; ++s) {
    float bm = INFINITY;
    int bp = 0x7fffffff;
    if constexpr (kE > 0) {
#pragma unroll
      for (int k = 0; k < kE; ++k) pick_min(m[k], g.j + (k << g.lgG), last_m, last_p, bm, bp);
    } else {
      for (int k = 0; k < (sz >> g.lgG); ++k)
        pick_min(fabsf(row[k << g.lgG]), g.j + (k << g.lgG), last_m, last_p, bm, bp);
    }
    for (int d = g.G / 2; d >= 1; d >>= 1) {
      const float om = __shfl_xor_sync(kFull, bm, d);
      const int op = __shfl_xor_sync(kFull, bp, d);
      if (om < bm || (om == bm && op < bp)) {
        bm = om;
        bp = op;
      }
    }
    last_m = bm;
    last_p = bp;
    if (g.on && g.j == 0) idx[g.q * K + s] = bp;
    const float pp = shfl_f(pm, p);
    const float c1 = pp - shfl_f(bm, shfl_i(rtot, p) << g.lgG);
    const uint32_t word = prune(pp, c1, L, L, lane, pm, R);
    const int from = lane < L ? R : 0;  // x[l] = x[r[l]]
    flips = __shfl_sync(kFull, flips, from) | (((word >> lane) & 1u) << s);
    rtot = shfl_i(rtot, from);
  }
  if (K > 0 && lane < L) R = rtot;
  SCL_PROF_ADD(c, PROF_FAST_STAGES, t_stages);
  SCL_PROF_T(t_bits);
  // lane jj * P + l votes slot l's hard decision (a < 0, so -0.0 decides 0) of
  // position base + jj of its original path
  const int lgP = ilog2(pow2_ceil(L)), l = lane & ((1 << lgP) - 1), jj = lane >> lgP;
  const int r = K > 0 ? shfl_i(rtot, l) : l;
  const uint32_t mask = lgP == 5 ? kFull : (1u << (1 << lgP)) - 1u;
  for (int base = 0; base < sz; base += kWarp >> lgP) {
    const int i = base + jj;
    const uint32_t b = __ballot_sync(kFull, l < L && i < sz && a[r * sz + i] < 0.0f);
    if (l == 0 && i < sz) c.beta[off + i] = (b >> (jj << lgP)) & mask;
  }
  __syncwarp();
  for (int base = 0; base < L * K; base += kWarp) {  // every lane runs the shuffles
    const int q = base + lane, sl = q < L * K ? q / K : 0, st = q - sl * K;
    const int rs = shfl_i(rtot, sl);
    const uint32_t fs = __shfl_sync(kFull, flips, sl);
    if (q < L * K && ((fs >> st) & 1u)) atomicXor(&c.beta[off + idx[rs * K + st]], 1u << sl);
  }
  SCL_PROF_ADD(c, PROF_FAST_BITS, t_bits);
}

// Fast repetition node: the two candidates per slot are pm + the halving-tree
// sums of log P(0 | a) and log P(1 | a) over the node (one softplus an
// element), one prune, the bit repeated over the node.
template <int kE>
__device__ __forceinline__ void rep_fast(const Ctx& c, const float* a, int sz, int off,
                                         float* scratch, float& pm, int& R) {
  const int L = c.L, lane = c.lane;
  const GroupLanes g = group_of(lane, L, sz);
  const int p = cand_path(lane, L);
  float s0, s1;  // path p's two sums
  SCL_PROF_T(t_sum);
  if constexpr (kE > 0) {
    const float* row = a + (g.on ? g.q : 0) * sz + g.j;
    float v0[kE], v1[kE];
#pragma unroll
    for (int k = 0; k < kE; ++k) d0_d1(row[k << g.lgG], v0[k], v1[k]);
    const float z0 = group_halving_sum<kE>(v0, g.G), z1 = group_halving_sum<kE>(v1, g.G);
    s0 = shfl_f(z0, p << g.lgG);
    s1 = shfl_f(z1, p << g.lgG);
  } else {
    const int H = sz / 2;
    fastnode::halving_sum(a, L, sz, scratch, fastnode::LogP0(), lane);
    fastnode::halving_sum(a, L, sz, scratch + L * H, fastnode::LogP1(), lane);
    s0 = p < L ? scratch[p * H] : 0.0f;
    s1 = p < L ? scratch[L * H + p * H] : 0.0f;
  }
  SCL_PROF_ADD(c, PROF_FAST_SUM, t_sum);
  SCL_PROF_T(t_stages);
  const float pp = shfl_f(pm, p);
  const uint32_t word = prune(pp + s0, pp + s1, L, L, lane, pm, R);
  SCL_PROF_ADD(c, PROF_FAST_STAGES, t_stages);
  SCL_PROF_T(t_bits);
  for (int i = lane; i < sz; i += kWarp) c.beta[off + i] = word;
  SCL_PROF_ADD(c, PROF_FAST_BITS, t_bits);
}

// A larger fast node (OP_RATE1_FAST or OP_REP_FAST): its registers' instance.
template <int kE>
__device__ __forceinline__ void fast_node_e(const Ctx& c, bool rate1, const float* a, int sz,
                                            int off, float* scratch, float& pm, int& R) {
  if (rate1)
    rate1_fast<kE>(c, a, sz, off, scratch, pm, R);
  else
    rep_fast<kE>(c, a, sz, off, scratch, pm, R);
}

__device__ __forceinline__ void fast_node(const Ctx& c, bool rate1, const float* a, int sz,
                                          int off, float* scratch, float& pm, int& R) {
  switch (fast_elements(c.L, sz)) {
    case 1: fast_node_e<1>(c, rate1, a, sz, off, scratch, pm, R); break;
    case 2: fast_node_e<2>(c, rate1, a, sz, off, scratch, pm, R); break;
    case 4: fast_node_e<4>(c, rate1, a, sz, off, scratch, pm, R); break;
    case 8: fast_node_e<8>(c, rate1, a, sz, off, scratch, pm, R); break;
    default: fast_node_e<0>(c, rate1, a, sz, off, scratch, pm, R); break;
  }
}

// ---- a subtree in registers (OP_SUBTREE) -------------------------------
//
// A node of size sz with L * sz <= 32 (sz = 2 or 4: the bottom of the tree,
// where an F or G over w * sz < 32 elements leaves most of the warp idle)
// decodes whole in registers, one element per lane: lane = l * sz + i holds
// path l's element i.  F and G are shuffles within a row (G reads its parent
// through the left child's rank vector), rate-0 and REP sum their pairs by
// xor-shuffles in the plain body's order, a leaf or REP prunes with the
// register prune, and a node's partial sums are one bit per lane; the node
// program needs one op for the subtree, whose frozen pattern it carries.
// Every lane runs every shuffle (the pattern is the warp's), lanes of paths
// >= w compute what they compute and no live lane reads them.
struct SubLanes {
  int lane, l, i, lgsz;  // l = lane >> lgsz, i = lane & (sz - 1)
};


// the all-zero-decision pass of a node of size 2^K on its lanes (in place
// in the smem body: zero_dec_inplace)
template <int K>
__device__ __forceinline__ float sub_zero_dec(const SubLanes& s, float z) {
#pragma unroll
  for (int h = (1 << K) / 2; h >= 1; h >>= 1) {
    const float o = __shfl_xor_sync(kFull, z, h);
    z = (s.i & h) ? z + o : f_minsum(z, o);
  }
  return z;
}

// The halving-tree sum (x[:h] + x[h:], distance 2^K / 2 first) of a path's
// values over its 2^K lanes, by xor-shuffles: every lane of the path ends
// with the sum (a + b and b + a are the same float).
template <int K>
__device__ __forceinline__ float sub_halving_sum(float z) {
#pragma unroll
  for (int h = (1 << K) / 2; h >= 1; h >>= 1) z = z + __shfl_xor_sync(kFull, z, h);
  return z;
}

// The fast rate-1 node of a fast program in registers (rate1_fast without
// shared memory), at full width: the metric pays the halving-tree sum of
// log1p(exp(-|a|)); lane (l, i) ranks its element in path l's stable
// ascending order of |a| (ties to the lower position) from the path's 2^K
// magnitudes, and holds the magnitude of rank i; then K = min(L - 1, 2^K)
// register prunes, stage s offering slot p a flip of the rank-s position of
// its original path rtot[p].  Lane (l, i)'s bit: the hard decision of
// position i of slot l's original path, XOR the flip its lineage took at the
// stage of that position's rank.
template <int K>
__device__ __forceinline__ uint32_t sub_rate1_fast(const SubLanes& s, float a, int L, float& pm,
                                                   int& R, bool& has_r) {
  constexpr int M = 1 << K;
  const int lane = s.lane;
  const float mag = fabsf(a);
  const float pen = shfl_f(sub_halving_sum<K>(log1pf(expf(-mag))), lane << s.lgsz);
  if (lane < L) pm = pm - pen;
  float m[M];
#pragma unroll
  for (int j = 0; j < M; ++j) m[j] = shfl_f(mag, (s.l << s.lgsz) + j);
  int rank = 0;       // of this lane's element
  float smag = 0.0f;  // the magnitude of rank i
#pragma unroll
  for (int j = 0; j < M; ++j) {
    int rj = 0;
#pragma unroll
    for (int q = 0; q < M; ++q)
      if (q != j) rj += m[q] < m[j] || (m[q] == m[j] && q < j) ? 1 : 0;
    if (rj == s.i) smag = m[j];
    if (j == s.i) rank = rj;
  }
  const int n = min(L - 1, M), p = cand_path(lane, L);
  int rtot = lane;
  uint32_t flips = 0;
  for (int st = 0; st < n; ++st) {
    const float pp = shfl_f(pm, p);
    const float c1 = pp - shfl_f(smag, (shfl_i(rtot, p) << s.lgsz) + st);
    const uint32_t word = prune<false>(pp, c1, L, L, lane, pm, R);
    const int from = lane < L ? R : 0;  // x[l] = x[r[l]]
    flips = __shfl_sync(kFull, flips, from) | (((word >> lane) & 1u) << st);
    rtot = shfl_i(rtot, from);
  }
  if (n > 0 && lane < L) R = rtot;
  has_r = n > 0;
  const int src = ((n > 0 ? shfl_i(rtot, s.l) : s.l) << s.lgsz) + s.i;
  const uint32_t hard = shfl_f(a, src) < 0.0f ? 1u : 0u;
  const int rk = shfl_i(rank, src);
  const uint32_t fl = __shfl_sync(kFull, flips, s.l & (kWarp - 1));
  return hard ^ (rk < n ? (fl >> rk) & 1u : 0u);
}

// The fast repetition node in registers (rep_fast without shared memory):
// log P(0 | a) and log P(1 | a) share one softplus, their halving-tree sums
// are the two candidates of each slot's path, one register prune.
template <int K>
__device__ __forceinline__ uint32_t sub_rep_fast(const SubLanes& s, float a, int L, float& pm,
                                                 int& R, bool& has_r) {
  float d0, d1;
  d0_d1(a, d0, d1);
  d0 = sub_halving_sum<K>(d0);
  d1 = sub_halving_sum<K>(d1);
  const int p = cand_path(s.lane, L);
  const float pp = shfl_f(pm, p);
  const uint32_t word = prune<false>(pp + shfl_f(d0, p << s.lgsz), pp + shfl_f(d1, p << s.lgsz),
                                     L, L, s.lane, pm, R);
  has_r = true;
  return (word >> s.l) & 1u;
}

// Decode a node of size 2^K (frozen bits fz, bit q = position q) whose alpha
// is `a` on lanes (l, i < 2^K); returns this lane's partial-sum bit (lanes
// (l, i < 2^K)), updates the metrics, the rank vector and the live width as
// the smem body's ops do, and says whether the node pruned (has_r).  kFast:
// the node program's fast dispatch (full width): an all-info node is the
// fast rate-1 node, a repetition node the fast REP.
template <int K, bool kNarrow, bool kFast>
__device__ __forceinline__ uint32_t sub_node(const SubLanes& s, float a, uint32_t fz, int L,
                                             int& w, float& pm, int& R, bool& has_r) {
  constexpr int M = 1 << K;
  constexpr uint32_t all = (1u << M) - 1u;
  const int lane = s.lane;
  if ((fz & all) == all) {  // rate-0: zero decisions, d0, adjacent-pair tree
    float z = sub_zero_dec<K>(s, a);
    float d0, d1;
    d0_d1(z, d0, d1);
    z = d0;
#pragma unroll
    for (int st = 1; st < M; st <<= 1) {
      const float o = __shfl_xor_sync(kFull, z, st);
      if ((s.i & (2 * st - 1)) == 0) z = z + o;
    }
    const float v = shfl_f(z, lane << s.lgsz);
    if (lane < w) pm = pm + v;
    has_r = false;
    return 0u;
  }
  if constexpr (K == 0) {  // an info leaf
    const int p = cand_path(lane, w);
    const uint32_t word = info_leaf<kNarrow, false>(shfl_f(a, p << s.lgsz), w, L, lane, pm, R);
    if (kNarrow) w = min(2 * w, L);
    has_r = true;
    return (word >> s.l) & 1u;
  } else {
    if constexpr (kFast) {
      if ((fz & all) == 0u) return sub_rate1_fast<K>(s, a, L, pm, R, has_r);
      if ((fz & all) == (all >> 1)) return sub_rep_fast<K>(s, a, L, pm, R, has_r);
    } else if ((fz & all) == (all >> 1)) {  // REP: every position but the last frozen
      float z = sub_zero_dec<K>(s, a);
      const float leaf = shfl_f(z, (cand_path(lane, w) << s.lgsz) + M - 1);
      float d0, d1;
      d0_d1(z, d0, d1);
      z = d0;
#pragma unroll
      for (int k = 0; (M >> k) > 2; ++k) {  // pair sums but each path's last pair
        const int st = 1 << k;
        const float o = __shfl_xor_sync(kFull, z, st);
        if ((s.i & (2 * st - 1)) == 0 && s.i < M - 2 * st) z = z + o;
      }
      float acc = pm;
#pragma unroll
      for (int j = 1; j <= K; ++j) acc = acc + shfl_f(z, (lane << s.lgsz) + M - (M >> (j - 1)));
      if (lane < w) pm = acc;
      const uint32_t word = info_leaf<kNarrow, false>(leaf, w, L, lane, pm, R);
      if (kNarrow) w = min(2 * w, L);
      has_r = true;
      return (word >> s.l) & 1u;
    }
    constexpr int h = M / 2;
    bool rl, rr;
    // F, the left child, G through its rank vector, the right child
    const uint32_t bl =
        sub_node<K - 1, kNarrow, kFast>(s, f_minsum(a, __shfl_down_sync(kFull, a, h)), fz, L,
                                        w, pm, R, rl);
    const int Rl = R;
    const int r = rl ? shfl_i(Rl, s.l) : s.l;
    const float first = shfl_f(a, (r << s.lgsz) + s.i);
    const float second = shfl_f(a, (r << s.lgsz) + s.i + h);
    const float sgn = 1.0f - 2.0f * (float)bl;
    const uint32_t br = sub_node<K - 1, kNarrow, kFast>(s, second + sgn * first, fz >> h, L, w,
                                                        pm, R, rr);
    // COMBINE: left bits through the right child's rank vector, XOR the right
    const int lsrc = rr ? shfl_i(R, s.l) : s.l;
    const uint32_t left = __shfl_sync(kFull, bl, ((lsrc << s.lgsz) + s.i) & (kWarp - 1));
    const uint32_t up = __shfl_up_sync(kFull, br, h);
    const int composed = shfl_i(Rl, rr ? R : lane);  // R_l[R_r[l]]
    if (rl) R = composed;
    has_r = rl || rr;
    return s.i < h ? (left ^ br) : up;
  }
}

// OP_SUBTREE: the node's plane [L][sz] at `plane`; the packed partial sums of
// its sz positions go to beta (bits of the live paths only).  kFast: a fast
// program's subtree (kFlagFast in its op word), decoded by the fast dispatch.
template <bool kNarrow, bool kFast>
__device__ __forceinline__ void subtree(const Ctx& c, const float* plane, int sz, uint32_t fz,
                                        uint32_t* beta, int& w, float& pm, int& R) {
  const int L = c.L, lane = c.lane, lgsz = ilog2(sz);
  const SubLanes s{lane, lane >> lgsz, lane & (sz - 1), lgsz};
  const float a = lane < L * sz ? plane[lane] : 0.0f;
  bool has_r;
  const uint32_t bit = sz == 2 ? sub_node<1, kNarrow, kFast>(s, a, fz, L, w, pm, R, has_r)
                               : sub_node<2, kNarrow, kFast>(s, a, fz, L, w, pm, R, has_r);
  const uint32_t ball = __ballot_sync(kFull, bit != 0u && s.l < w);
  if (lane < sz) {
    uint32_t word = 0;
    for (int l = 0; l < L; ++l) word |= ((ball >> ((l << lgsz) + lane)) & 1u) << l;
    beta[lane] = word;
  }
}

// The chunk body: decode the size-S subtree whose alpha lies at a0 ([L][S],
// shared or device memory; written only by a chunk that is one rate-0 or REP
// node), with metrics pm (lane l holds path l's).  Leaves the packed
// partial sums in c.beta, the new metrics in pm and the chunk's rank vector
// in R (lane l holds R[l]).  kNarrow: start at w_in live paths and double at
// every info leaf (live width); otherwise the full list, the width a
// constant the compiler sees.  kFast: a fast node program (the fast ops and
// the fast OP_SUBTREE are compiled only into the fast instances).
// kTopInCtx: a0's address is also in the context (ctx_top), and the body
// reads it there at each depth-0 op.
template <bool kNarrow, bool kFast, bool kTopInCtx = false>
__device__ __forceinline__ void chunk_body(const Ctx& c, float* a0, const int4* __restrict__ prog,
                                           int n_ops, int has_R, int w_in, float& pm, int& R) {
  const int L = c.L, lane = c.lane;
  int w = kNarrow ? w_in : L;
  // F and G on planes of rows >= 8 wide move four elements per lane (float4,
  // uint4) when the context and the top plane are 16-byte aligned
  const bool vec = (((uintptr_t)a0 | (uintptr_t)c.alpha | (uintptr_t)c.beta) & 15u) == 0;
  for (int pc = 0; pc < n_ops; ++pc) {
    SCL_PROF_T(t_op);
    const int4 op = __ldg(prog + pc);
    const int d = op.y, sz = op.z, off = op.w;
    switch (op.x & 0xff) {
      case OP_F: {
        const float* src = depth_ptr<kTopInCtx>(c, a0, d);
        float* dst = depth_ptr<kTopInCtx>(c, a0, d + 1);
        const int lg = ilog2(sz);
        if (vec && sz >= 4) {
          for (int q = lane; q < (w * sz) >> 2; q += kWarp) {
            const int idx = q << 2, l = idx >> lg, i = idx & (sz - 1);
            const float4 x = *reinterpret_cast<const float4*>(src + l * 2 * sz + i);
            const float4 y = *reinterpret_cast<const float4*>(src + l * 2 * sz + sz + i);
            *reinterpret_cast<float4*>(dst + idx) = make_float4(
                f_minsum(x.x, y.x), f_minsum(x.y, y.y), f_minsum(x.z, y.z), f_minsum(x.w, y.w));
          }
          break;
        }
        for (int idx = lane; idx < w * sz; idx += kWarp) {
          const int l = idx >> lg, i = idx & (sz - 1);
          dst[idx] = f_minsum(src[l * 2 * sz + i], src[l * 2 * sz + sz + i]);
        }
        break;
      }
      case OP_G: {
        const float* src = depth_ptr<kTopInCtx>(c, a0, d);
        float* dst = depth_ptr<kTopInCtx>(c, a0, d + 1);
        int* saved = c.Rstack + d * L;
        const bool rl = op.x & kFlagRL;
        if (rl) {
          if (lane < w) saved[lane] = R;
          __syncwarp();
        }
        const int lg = ilog2(sz);
        if (vec && sz >= 4) {
          for (int q = lane; q < (w * sz) >> 2; q += kWarp) {
            const int idx = q << 2, l = idx >> lg, i = idx & (sz - 1);
            const int r = rl ? saved[l] : l;
            const float4 x = *reinterpret_cast<const float4*>(src + r * 2 * sz + i);
            const float4 y = *reinterpret_cast<const float4*>(src + r * 2 * sz + sz + i);
            const uint4 b = *reinterpret_cast<const uint4*>(c.beta + off + i);
            *reinterpret_cast<float4*>(dst + idx) =
                make_float4(y.x + (1.0f - 2.0f * (float)((b.x >> l) & 1u)) * x.x,
                            y.y + (1.0f - 2.0f * (float)((b.y >> l) & 1u)) * x.y,
                            y.z + (1.0f - 2.0f * (float)((b.z >> l) & 1u)) * x.z,
                            y.w + (1.0f - 2.0f * (float)((b.w >> l) & 1u)) * x.w);
          }
          break;
        }
        for (int idx = lane; idx < w * sz; idx += kWarp) {
          const int l = idx >> lg, i = idx & (sz - 1);
          const int r = rl ? saved[l] : l;  // the parent alpha, read through the rank vector
          const float sgn = 1.0f - 2.0f * (float)((c.beta[off + i] >> l) & 1u);
          dst[idx] = src[r * 2 * sz + sz + i] + sgn * src[r * 2 * sz + i];
        }
        break;
      }
      case OP_COMBINE: {
        const bool rl = op.x & kFlagRL, rr = op.x & kFlagRR;
        // few positions and a wide list: the rank apply by ballots (the N=4096
        // SCL-32 decode 4.5 % faster, K5 at L=32 7 %; NVIDIA H100 80GB HBM3,
        // 700 W, tools/scl_kernel_ab.py)
        if (rr && 2 * sz < w) {
          const uint32_t word = perm_words_ballot(lane < sz ? c.beta[off + lane] : 0u, R, w, sz,
                                                  lane);
          if (lane < sz) c.beta[off + lane] = word ^ c.beta[off + sz + lane];
        } else {
          for (int base = 0; base < sz; base += kWarp) {  // every lane runs the shuffles
            const int i = base + lane;
            uint32_t word = i < sz ? c.beta[off + i] : 0u;
            if (rr) word = perm_word_reg(word, R, w);
            if (i < sz) c.beta[off + i] = word ^ c.beta[off + sz + i];
          }
        }
        if (rl && lane < w) R = c.Rstack[d * L + (rr ? R : lane)];  // R_l[R_r[l]]
        break;
      }
      case OP_RATE0: {
        float* z = depth_ptr<kTopInCtx>(c, a0, d);
        zero_dec_inplace(z, w * sz, sz, lane);
        d0_inplace(z, w * sz, lane);
        // adjacent-pair tree sum per path, in place with a growing stride
        for (int s = 1; s < sz; s <<= 1) {
          for (int q = lane; q < (w * sz) / (2 * s); q += kWarp) {
            const int p = q * 2 * s;
            z[p] = z[p] + z[p + s];
          }
          __syncwarp();
        }
        if (lane < w) pm = pm + z[lane * sz];
        for (int i = lane; i < sz; i += kWarp) c.beta[off + i] = 0u;
        break;
      }
      case OP_LEAF: {
        const float* a = depth_ptr<kTopInCtx>(c, a0, d);
        const int p = cand_path(lane, w);
        const uint32_t word = info_leaf<kNarrow>(p < w ? a[p] : 0.0f, w, L, lane, pm, R);
        if (lane == 0) c.beta[off] = word;
        if (kNarrow) w = min(2 * w, L);
        break;
      }
      case OP_REP: {
        float* z = depth_ptr<kTopInCtx>(c, a0, d);
        const int lgM = ilog2(sz);
        zero_dec_inplace(z, w * sz, sz, lane);
        const int pp = cand_path(lane, w);
        const float leaf = pp < w ? z[pp * sz + sz - 1] : 0.0f;
        __syncwarp();
        d0_inplace(z, w * sz, lane);
        // pair sums at every level EXCEPT each path's last pair: the block sums
        // the metric needs (position sz - 2^(k+1) at level k) then stay in place
        for (int k = 0; (sz >> k) > 2; ++k) {
          const int pairs = (sz >> (k + 1)) - 1;  // per path
          for (int q = lane; q < w * pairs; q += kWarp) {
            const int l = q / pairs, i = q - l * pairs;
            const int p = l * sz + (i << (k + 1));
            z[p] = z[p] + z[p + (1 << k)];
          }
          __syncwarp();
        }
        if (lane < w) {
          float p = pm;
          for (int j = 1; j <= lgM; ++j) p = p + z[lane * sz + sz - (sz >> (j - 1))];
          pm = p;
        }
        const uint32_t word = info_leaf<kNarrow>(leaf, w, L, lane, pm, R);
        for (int i = lane; i < sz; i += kWarp) c.beta[off + i] = word;
        if (kNarrow) w = min(2 * w, L);
        break;
      }
      case OP_RATE1_FAST:
      case OP_REP_FAST:
        if constexpr (kFast)
          fast_node(c, (op.x & 0xff) == OP_RATE1_FAST, depth_ptr<kTopInCtx>(c, a0, d), sz, off,
                    depth_ptr<kTopInCtx>(c, a0, d + 1), pm, R);
        break;
      case OP_SUBTREE:
        subtree<kNarrow, kFast>(c, depth_ptr<kTopInCtx>(c, a0, d), sz, (uint32_t)op.x >> 16, c.beta + off,
                                w, pm, R);
        break;
      default:
        break;
    }
    __syncwarp();
#ifdef SCL_PROFILE
    {
      const int kind = op.x & 0xff, small = kind == OP_COMBINE ? sz < kWarp : w * sz < kWarp;
      const int slot = kind == OP_F          ? (small ? PROF_F_SMALL : PROF_F_WIDE)
                       : kind == OP_G        ? (small ? PROF_G_SMALL : PROF_G_WIDE)
                       : kind == OP_COMBINE  ? (small ? PROF_COMBINE_SMALL : PROF_COMBINE_WIDE)
                       : kind == OP_LEAF     ? PROF_LEAF
                       : kind == OP_REP      ? PROF_REP
                       : kind == OP_RATE0    ? PROF_RATE0
                       : kind == OP_RATE1_FAST
                           ? (L * sz <= kWarp ? PROF_RATE1_FAST_SMALL : PROF_RATE1_FAST)
                       : kind == OP_REP_FAST
                           ? (L * sz <= kWarp ? PROF_REP_FAST_SMALL : PROF_REP_FAST)
                                             : PROF_SUBTREE;
      SCL_PROF_ADD(c, slot, t_op);
    }
#endif
  }
  if (!has_R) R = lane;
}


// ---- WIDE LISTS (33 <= L <= 64): two paths a lane -------------------------
//
// A list wider than a warp runs at TWO PATHS A LANE (kP = 2 in the kernels'
// templates; every L <= 32 keeps the one-path instances above, unchanged):
// lane l holds paths l and l + 32 in slots 0 and 1 of its pm[2] and R[2] (a
// slot whose path is not live holds nothing that is read), and the bits of a
// position are one 64-bit word, bit p = path p.  Exact node programs only
// (F, G, COMBINE, rate-0, REP, leaves): OP_SUBTREE needs L * size <= 32, and
// the fast nodes and the one-hot modes stay at L <= 32, as the host says.
// The float expressions and their order are chunk_body's, the candidates'
// order and ties prune's, so the wide body equals the plain version bit for
// bit as the narrow one does.  An info leaf ranks its 2w <= 128 candidates
// four a lane (prune_wide).
using WideWord = unsigned long long;
using CtxWide = CtxT<WideWord>;

__device__ __forceinline__ CtxWide make_ctx_wide(float* base, int L, int S, int lane) {
  CtxWide c;
  c.alpha = base;
  c.beta = reinterpret_cast<WideWord*>(base + round4(S * L));
  c.R = reinterpret_cast<int*>(base + round4(S * L) + 2 * S);
  c.tmp = c.R + L;
  c.Rstack = c.tmp + L;
  c.L = L;
  c.S = S;
  c.lane = lane;
  return c;
}

// Stable top-`keep` prune of the 2w candidates of w <= 64 live paths, four a
// lane: c0[s] / c1[s] are the bit-0 / bit-1 candidates (indices p and w + p)
// of path p = lane + 32 s, read only where p < w.  Candidate i goes before
// candidate j iff its metric is larger, or equal with i < j, as in prune.
// Every lane counts the candidates above each of its four over the w paths
// (two shuffles a path of slot 0, two more for slot 1's paths: the lanes hold
// distinct paths, so no lane group shares a count); then slot s (lane s & 31,
// register s >> 5) finds the candidate of rank s from the ranks' bits, one
// ballot per bit and kind of candidate (the four (slot, bit) kinds), and
// takes its metric and path by shuffles.  Afterwards slot s < keep holds the
// s-th candidate's metric in pm and its path in R (the others keep theirs);
// returns the 64-bit word of the slots' bit-1 flags.  No shared memory.
__device__ __forceinline__ WideWord prune_wide(const float (&c0)[2], const float (&c1)[2], int w,
                                               int keep, int lane, float (&pm)[2], int (&R)[2]) {
  int r[4] = {0, 0, 0, 0};  // the ranks of c0[0], c1[0], c0[1], c1[1]
  for (int k = 0; k < min(w, kWarp); ++k) {
    // path k (candidates k and w + k) against paths lane and lane + 32
    const float a = __shfl_sync(kFull, c0[0], k), b = __shfl_sync(kFull, c1[0], k);
    r[0] += (a > c0[0] || (a == c0[0] && k < lane) ? 1 : 0) + (b > c0[0] ? 1 : 0);
    r[1] += (a >= c1[0] ? 1 : 0) + (b > c1[0] || (b == c1[0] && k < lane) ? 1 : 0);
    r[2] += (a >= c0[1] ? 1 : 0) + (b > c0[1] ? 1 : 0);
    r[3] += (a >= c1[1] ? 1 : 0) + (b >= c1[1] ? 1 : 0);
    if (k + kWarp < w) {  // path k + 32 (warp-uniform)
      const float a1 = __shfl_sync(kFull, c0[1], k), b1 = __shfl_sync(kFull, c1[1], k);
      r[0] += (a1 > c0[0] ? 1 : 0) + (b1 > c0[0] ? 1 : 0);
      r[1] += (a1 >= c1[0] ? 1 : 0) + (b1 > c1[0] ? 1 : 0);
      r[2] += (a1 > c0[1] || (a1 == c0[1] && k < lane) ? 1 : 0) + (b1 > c0[1] ? 1 : 0);
      r[3] += (a1 >= c1[1] ? 1 : 0) + (b1 > c1[1] || (b1 == c1[1] && k < lane) ? 1 : 0);
    }
  }
  // m[t][q]: the lanes whose candidate of kind q has rank lane + 32 t
  const bool v0 = lane < w, v1 = lane + kWarp < w;
  uint32_t m[2][4];
  {
    const uint32_t o0 = __ballot_sync(kFull, v0), o1 = __ballot_sync(kFull, v1);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      m[t][0] = m[t][1] = o0;
      m[t][2] = m[t][3] = o1;
    }
  }
  for (int b = 0, nb = 32 - __clz(2 * w - 1); b < nb; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t bq = __ballot_sync(kFull, (q < 2 ? v0 : v1) && ((r[q] >> b) & 1));
      m[0][q] &= (lane >> b) & 1 ? bq : ~bq;
      m[1][q] &= ((lane + kWarp) >> b) & 1 ? bq : ~bq;
    }
  }
  float v[2];
  int path[2];
  bool one[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {  // slot t's candidate (used where it is < keep)
    // by selects, not by an index: m indexed at run time went to local memory
    const int q = m[t][0] ? 0 : m[t][1] ? 1 : m[t][2] ? 2 : 3;
    const uint32_t mq = m[t][0] ? m[t][0] : m[t][1] ? m[t][1] : m[t][2] ? m[t][2] : m[t][3];
    const int src = mq ? __ffs(mq) - 1 : 0;
    const float x00 = __shfl_sync(kFull, c0[0], src), x10 = __shfl_sync(kFull, c1[0], src);
    const float x01 = __shfl_sync(kFull, c0[1], src), x11 = __shfl_sync(kFull, c1[1], src);
    v[t] = q == 0 ? x00 : q == 1 ? x10 : q == 2 ? x01 : x11;
    path[t] = src + (q >> 1) * kWarp;
    one[t] = q & 1;
  }
  if (lane < keep) {
    pm[0] = v[0];
    R[0] = path[0];
  }
  if (lane + kWarp < keep) {
    pm[1] = v[1];
    R[1] = path[1];
  }
  const uint32_t lo = __ballot_sync(kFull, lane < keep && one[0]);
  const uint32_t hi = __ballot_sync(kFull, lane + kWarp < keep && one[1]);
  return lo | ((WideWord)hi << 32);
}

// Branch + stable top-L prune (kNarrow: keeping min(2w, L)) of the paths of
// the lane's two slots: a[s] is the leaf LLR of path lane + 32 s.
template <bool kNarrow>
__device__ __forceinline__ WideWord info_leaf_wide(const float (&a)[2], int w, int L, int lane,
                                                   float (&pm)[2], int (&R)[2]) {
  float c0[2], c1[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float d0, d1;
    d0_d1(a[s], d0, d1);
    c0[s] = pm[s] + d0;
    c1[s] = pm[s] + d1;
  }
  return prune_wide(c0, c1, w, kNarrow ? min(2 * w, L) : L, lane, pm, R);
}

// rank apply on a 64-bit word with the rank vector in the slots (entry p on
// lane p & 31, slot p >> 5); every lane must call it: n shuffles
__device__ __forceinline__ WideWord perm_word_reg_wide(WideWord w, const int (&r)[2], int n) {
  WideWord out = 0;
  for (int l = 0; l < min(n, kWarp); ++l)
    out |= ((w >> __shfl_sync(kFull, r[0], l)) & 1ull) << l;
  for (int l = kWarp; l < n; ++l)
    out |= ((w >> __shfl_sync(kFull, r[1], l - kWarp)) & 1ull) << l;
  return out;
}

// perm_words_ballot for 64-bit words (m <= 32 positions, position i's word on
// lane i): two ballots a position, one per slot
__device__ __forceinline__ WideWord perm_words_ballot_wide(WideWord w, const int (&r)[2], int n,
                                                           int m, int lane) {
  WideWord out = 0;
  for (int i = 0; i < m; ++i) {
    const WideWord wi = __shfl_sync(kFull, w, i);
    const uint32_t b0 = __ballot_sync(kFull, lane < n && ((wi >> r[0]) & 1ull));
    const uint32_t b1 = __ballot_sync(kFull, lane + kWarp < n && ((wi >> r[1]) & 1ull));
    if (lane == i) out = b0 | ((WideWord)b1 << 32);
  }
  return out;
}

// The chunk body of a wide list (chunk_body's ops, exact nodes): the metrics
// and the rank vector in the slots (pm[s], R[s]: path lane + 32 s), the
// packed partial sums in c.beta as 64-bit words.  kNarrow: from w_in live
// paths, doubling at every info leaf.
template <bool kNarrow>
__device__ __forceinline__ void chunk_body_wide(const CtxWide& c, float* a0,
                                                const int4* __restrict__ prog, int n_ops,
                                                int has_R, int w_in, float (&pm)[2],
                                                int (&R)[2]) {
  const int L = c.L, lane = c.lane;
  int w = kNarrow ? w_in : L;
  const bool vec = (((uintptr_t)a0 | (uintptr_t)c.alpha) & 15u) == 0;
  for (int pc = 0; pc < n_ops; ++pc) {
    SCL_PROF_T(t_op);
    const int4 op = __ldg(prog + pc);
    const int d = op.y, sz = op.z, off = op.w;
    switch (op.x & 0xff) {
      case OP_F: {
        const float* src = depth_ptr(c, a0, d);
        float* dst = depth_ptr(c, a0, d + 1);
        const int lg = ilog2(sz);
        if (vec && sz >= 4) {
          for (int q = lane; q < (w * sz) >> 2; q += kWarp) {
            const int idx = q << 2, l = idx >> lg, i = idx & (sz - 1);
            const float4 x = *reinterpret_cast<const float4*>(src + l * 2 * sz + i);
            const float4 y = *reinterpret_cast<const float4*>(src + l * 2 * sz + sz + i);
            *reinterpret_cast<float4*>(dst + idx) = make_float4(
                f_minsum(x.x, y.x), f_minsum(x.y, y.y), f_minsum(x.z, y.z), f_minsum(x.w, y.w));
          }
          break;
        }
        for (int idx = lane; idx < w * sz; idx += kWarp) {
          const int l = idx >> lg, i = idx & (sz - 1);
          dst[idx] = f_minsum(src[l * 2 * sz + i], src[l * 2 * sz + sz + i]);
        }
        break;
      }
      case OP_G: {
        const float* src = depth_ptr(c, a0, d);
        float* dst = depth_ptr(c, a0, d + 1);
        int* saved = c.Rstack + d * L;
        const bool rl = op.x & kFlagRL;
        if (rl) {
          if (lane < w) saved[lane] = R[0];
          if (lane + kWarp < w) saved[lane + kWarp] = R[1];
          __syncwarp();
        }
        const int lg = ilog2(sz);
        if (vec && sz >= 4) {
          for (int q = lane; q < (w * sz) >> 2; q += kWarp) {
            const int idx = q << 2, l = idx >> lg, i = idx & (sz - 1);
            const int r = rl ? saved[l] : l;
            const float4 x = *reinterpret_cast<const float4*>(src + r * 2 * sz + i);
            const float4 y = *reinterpret_cast<const float4*>(src + r * 2 * sz + sz + i);
            const WideWord* b = c.beta + off + i;
            *reinterpret_cast<float4*>(dst + idx) =
                make_float4(y.x + (1.0f - 2.0f * (float)((b[0] >> l) & 1ull)) * x.x,
                            y.y + (1.0f - 2.0f * (float)((b[1] >> l) & 1ull)) * x.y,
                            y.z + (1.0f - 2.0f * (float)((b[2] >> l) & 1ull)) * x.z,
                            y.w + (1.0f - 2.0f * (float)((b[3] >> l) & 1ull)) * x.w);
          }
          break;
        }
        for (int idx = lane; idx < w * sz; idx += kWarp) {
          const int l = idx >> lg, i = idx & (sz - 1);
          const int r = rl ? saved[l] : l;
          const float sgn = 1.0f - 2.0f * (float)((c.beta[off + i] >> l) & 1ull);
          dst[idx] = src[r * 2 * sz + sz + i] + sgn * src[r * 2 * sz + i];
        }
        break;
      }
      case OP_COMBINE: {
        const bool rl = op.x & kFlagRL, rr = op.x & kFlagRR;
        if (rr && 2 * sz < w) {
          const WideWord word =
              perm_words_ballot_wide(lane < sz ? c.beta[off + lane] : 0ull, R, w, sz, lane);
          if (lane < sz) c.beta[off + lane] = word ^ c.beta[off + sz + lane];
        } else {
          for (int base = 0; base < sz; base += kWarp) {  // every lane runs the shuffles
            const int i = base + lane;
            WideWord word = i < sz ? c.beta[off + i] : 0ull;
            if (rr) word = perm_word_reg_wide(word, R, w);
            if (i < sz) c.beta[off + i] = word ^ c.beta[off + sz + i];
          }
        }
        if (rl) {  // R_l[R_r[l]]
          const int* rs = c.Rstack + d * L;
          if (lane < w) R[0] = rs[rr ? R[0] : lane];
          if (lane + kWarp < w) R[1] = rs[rr ? R[1] : lane + kWarp];
        }
        break;
      }
      case OP_RATE0: {
        float* z = depth_ptr(c, a0, d);
        zero_dec_inplace(z, w * sz, sz, lane);
        d0_inplace(z, w * sz, lane);
        for (int s = 1; s < sz; s <<= 1) {
          for (int q = lane; q < (w * sz) / (2 * s); q += kWarp) {
            const int p = q * 2 * s;
            z[p] = z[p] + z[p + s];
          }
          __syncwarp();
        }
        if (lane < w) pm[0] = pm[0] + z[lane * sz];
        if (lane + kWarp < w) pm[1] = pm[1] + z[(lane + kWarp) * sz];
        for (int i = lane; i < sz; i += kWarp) c.beta[off + i] = 0ull;
        break;
      }
      case OP_LEAF: {
        const float* a = depth_ptr(c, a0, d);
        const float leaf[2] = {lane < w ? a[lane] : 0.0f,
                               lane + kWarp < w ? a[lane + kWarp] : 0.0f};
        const WideWord word = info_leaf_wide<kNarrow>(leaf, w, L, lane, pm, R);
        if (lane == 0) c.beta[off] = word;
        if (kNarrow) w = min(2 * w, L);
        break;
      }
      case OP_REP: {
        float* z = depth_ptr(c, a0, d);
        const int lgM = ilog2(sz);
        zero_dec_inplace(z, w * sz, sz, lane);
        const float leaf[2] = {lane < w ? z[lane * sz + sz - 1] : 0.0f,
                               lane + kWarp < w ? z[(lane + kWarp) * sz + sz - 1] : 0.0f};
        __syncwarp();
        d0_inplace(z, w * sz, lane);
        for (int k = 0; (sz >> k) > 2; ++k) {
          const int pairs = (sz >> (k + 1)) - 1;  // per path
          for (int q = lane; q < w * pairs; q += kWarp) {
            const int l = q / pairs, i = q - l * pairs;
            const int p = l * sz + (i << (k + 1));
            z[p] = z[p] + z[p + (1 << k)];
          }
          __syncwarp();
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int path = lane + s * kWarp;
          if (path < w) {
            float p = pm[s];
            for (int j = 1; j <= lgM; ++j) p = p + z[path * sz + sz - (sz >> (j - 1))];
            pm[s] = p;
          }
        }
        const WideWord word = info_leaf_wide<kNarrow>(leaf, w, L, lane, pm, R);
        for (int i = lane; i < sz; i += kWarp) c.beta[off + i] = word;
        if (kNarrow) w = min(2 * w, L);
        break;
      }
      default:
        break;
    }
    __syncwarp();
#ifdef SCL_PROFILE
    {
      const int kind = op.x & 0xff, small = kind == OP_COMBINE ? sz < kWarp : w * sz < kWarp;
      const int slot = kind == OP_F         ? (small ? PROF_F_SMALL : PROF_F_WIDE)
                       : kind == OP_G       ? (small ? PROF_G_SMALL : PROF_G_WIDE)
                       : kind == OP_COMBINE ? (small ? PROF_COMBINE_SMALL : PROF_COMBINE_WIDE)
                       : kind == OP_LEAF    ? PROF_LEAF
                       : kind == OP_REP     ? PROF_REP
                                            : PROF_RATE0;
      SCL_PROF_ADD(c, slot, t_op);
    }
#endif
  }
  if (!has_R) {
    R[0] = lane;
    R[1] = lane + kWarp;
  }
}


// ---- XL LISTS (65 <= L <= 256): four or eight paths a lane ----------------
//
// A list above 64 runs at kP = 4 (L <= 128) or kP = 8 (L <= 256) paths a
// lane (every L <= 64 keeps the instances above, unchanged): lane l holds
// paths l + 32 s in slot s of its pm[kP] and R[kP] (a slot whose path is not
// live holds nothing that is read), and a position's path bits are kP 32-bit
// words, bit b of word s = path 32 s + b, at beta[kP m + s] for position m.
// Exact node programs on rank vectors only (F, G, COMBINE, rate-0, REP,
// leaves), as for the wide lists.  The float expressions and their order are
// chunk_body's, the candidates' order and ties prune's, so the body equals the
// plain version bit for bit.
//
// The prune (prune_xl) does not rank by ballots over rank bits, whose table
// grows as kP^2 (prune_wide's m[2][4] spilled until it was rewritten with
// selects): every lane writes its 2 kP candidates into a per-frame scratch of
// 2L words of the context, counts each one's rank by a loop over the 2w
// scratch entries (broadcast reads), and the candidate of rank r < keep
// writes its metric, path and bit into slot r of the scratch; slot lane + 32 s
// reads entry lane + 32 s back.  O(w) per candidate, exact under the tie rule.
// A rank apply on a position's kP words (COMBINE, the ascend) is kP ballots,
// one per slot, each lane voting its path's source bit.

// The context of an XL list: alpha as chunk_body's, beta S positions of kP
// words, Rstack (log2 S + 1) x L saved rank vectors, scr the prune's 2L words;
// each region rounded up to four words (16-byte aligned slices).
template <int kP>
struct CtxXl {
  float* alpha;
  uint32_t* beta;
  int* Rstack;
  float* scr;
  int L, S, lane;
};

__host__ __device__ inline int ctx_words_xl(int L, int S, int lgS, int kP) {
  return round4(S * L) + kP * S + round4(L * (lgS + 1)) + round4(2 * L);
}

template <int kP>
__device__ __forceinline__ CtxXl<kP> make_ctx_xl(float* base, int L, int S, int lgS, int lane) {
  CtxXl<kP> c;
  c.alpha = base;
  c.beta = reinterpret_cast<uint32_t*>(base + round4(S * L));
  c.Rstack = reinterpret_cast<int*>(c.beta + kP * S);
  c.scr = reinterpret_cast<float*>(c.Rstack + round4(L * (lgS + 1)));
  c.L = L;
  c.S = S;
  c.lane = lane;
  return c;
}

template <int kP>
__device__ __forceinline__ float* depth_ptr_xl(const CtxXl<kP>& c, float* a0, int d) {
  return d != 0 ? c.alpha + c.L * (c.S - ((2 * c.S) >> d)) : a0;
}

// path p's bit of the position whose kP words start at w
template <int kP>
__device__ __forceinline__ uint32_t path_bit_xl(const uint32_t* w, int p) {
  return (w[p >> 5] >> (p & 31)) & 1u;
}

// n positions' kP words, the same at each: `mine` is word lane mod kP (a
// lane keeps the one word it stores: the ballots' kP words held in an array
// and selected by lane went to local memory), lanes q < n kP storing word q
// mod kP (the warp's stride is a multiple of kP)
__device__ __forceinline__ void fill_words_xl(uint32_t* dst, int n, int kP, uint32_t mine,
                                              int lane) {
  for (int q = lane; q < n * kP; q += kWarp) dst[q] = mine;
}

// dst = (src through the rank vector r) XOR right, for n positions of kP
// words: bit p of position i's result is bit r[p] of src's position i, for
// the live paths p < w (slot s of each lane: r[s], path lane + 32 s); kP
// ballots a position, lanes q < kP storing word q.  dst may be src.
template <int kP>
__device__ __forceinline__ void perm_xor_xl(uint32_t* dst, const uint32_t* src,
                                            const uint32_t* right, const int (&r)[kP], int w,
                                            int n, int lane) {
  for (int i = 0; i < n; ++i) {
    uint32_t mine = 0;  // word lane of the position (lanes < kP)
#pragma unroll
    for (int s = 0; s < kP; ++s) {
      const bool live = lane + kWarp * s < w;
      const uint32_t b =
          __ballot_sync(kFull, live && path_bit_xl<kP>(src + kP * i, live ? r[s] : 0));
      if (lane == s) mine = b;
    }
    if (lane < kP) dst[kP * i + lane] = mine ^ right[kP * i + lane];
  }
}

// Stable top-`keep` prune of the 2w candidates of w <= L live paths: c0[s] /
// c1[s] are the bit-0 / bit-1 candidates (indices p and w + p) of path p =
// lane + 32 s, read only where p < w.  Candidate i goes before candidate j iff
// its metric is larger, or equal with i < j, as in prune.  Afterwards slot q
// < keep (lane q & 31, register q >> 5) holds the q-th candidate's metric in
// pm and its path in R (the others keep theirs); returns word lane mod kP of
// the slots' bit-1 flags (word s: slots 32 s .. 32 s + 31).  scr: the
// context's 2L words.
template <int kP>
__device__ __forceinline__ uint32_t prune_xl(const float (&c0)[kP], const float (&c1)[kP],
                                             int w, int keep, int L, int lane, float* scr,
                                             float (&pm)[kP], int (&R)[kP]) {
#pragma unroll
  for (int s = 0; s < kP; ++s) {
    const int p = lane + kWarp * s;
    if (p < w) {
      scr[p] = c0[s];
      scr[w + p] = c1[s];
    }
  }
  __syncwarp();
  int r0[kP], r1[kP];
#pragma unroll
  for (int s = 0; s < kP; ++s) r0[s] = r1[s] = 0;
  for (int j = 0; j < 2 * w; ++j) {
    const float x = scr[j];  // one address: a broadcast
#pragma unroll
    for (int s = 0; s < kP; ++s) {
      const int p = lane + kWarp * s;
      r0[s] += x > c0[s] || (x == c0[s] && j < p) ? 1 : 0;
      r1[s] += x > c1[s] || (x == c1[s] && j < w + p) ? 1 : 0;
    }
  }
  __syncwarp();  // every rank counted before the slots overwrite the candidates
  int* from = reinterpret_cast<int*>(scr) + L;  // slot q's path, | 1 << 16 for bit 1
#pragma unroll
  for (int s = 0; s < kP; ++s) {
    const int p = lane + kWarp * s;
    if (p < w) {
      if (r0[s] < keep) {
        scr[r0[s]] = c0[s];
        from[r0[s]] = p;
      }
      if (r1[s] < keep) {
        scr[r1[s]] = c1[s];
        from[r1[s]] = p | (1 << 16);
      }
    }
  }
  __syncwarp();
  uint32_t mine = 0;
#pragma unroll
  for (int s = 0; s < kP; ++s) {
    const int q = lane + kWarp * s;
    bool one = false;
    if (q < keep) {
      const int v = from[q];
      pm[s] = scr[q];
      R[s] = v & 0xffff;
      one = (v >> 16) != 0;
    }
    const uint32_t b = __ballot_sync(kFull, one);
    if ((lane & (kP - 1)) == s) mine = b;
  }
  __syncwarp();  // the slots read before the next prune writes
  return mine;
}

// Branch + stable top-L prune (kNarrow: keeping min(2w, L)) of the paths of
// the lane's slots: a[s] is the leaf LLR of path lane + 32 s; returns prune_xl's
// word.
template <bool kNarrow, int kP>
__device__ __forceinline__ uint32_t info_leaf_xl(const CtxXl<kP>& c, const float (&a)[kP],
                                                 int w, float (&pm)[kP], int (&R)[kP]) {
  float c0[kP], c1[kP];
#pragma unroll
  for (int s = 0; s < kP; ++s) {
    float d0, d1;
    d0_d1(a[s], d0, d1);
    c0[s] = pm[s] + d0;
    c1[s] = pm[s] + d1;
  }
  return prune_xl<kP>(c0, c1, w, kNarrow ? min(2 * w, c.L) : c.L, c.L, c.lane, c.scr, pm, R);
}

// The chunk body of an XL list (chunk_body's ops, exact nodes): the metrics
// and the rank vector in the slots (pm[s], R[s]: path lane + 32 s), the
// packed partial sums in c.beta as kP words a position.  kNarrow: from w_in
// live paths, doubling at every info leaf.
template <bool kNarrow, int kP>
__device__ __forceinline__ void chunk_body_xl(const CtxXl<kP>& c, float* a0,
                                              const int4* __restrict__ prog, int n_ops, int has_R,
                                              int w_in, float (&pm)[kP], int (&R)[kP]) {
  const int L = c.L, lane = c.lane;
  int w = kNarrow ? w_in : L;
  const bool vec = (((uintptr_t)a0 | (uintptr_t)c.alpha) & 15u) == 0;
  for (int pc = 0; pc < n_ops; ++pc) {
    const int4 op = __ldg(prog + pc);
    const int d = op.y, sz = op.z, off = op.w;
    switch (op.x & 0xff) {
      case OP_F: {
        const float* src = depth_ptr_xl(c, a0, d);
        float* dst = depth_ptr_xl(c, a0, d + 1);
        const int lg = ilog2(sz);
        if (vec && sz >= 4) {
          for (int q = lane; q < (w * sz) >> 2; q += kWarp) {
            const int idx = q << 2, l = idx >> lg, i = idx & (sz - 1);
            const float4 x = *reinterpret_cast<const float4*>(src + l * 2 * sz + i);
            const float4 y = *reinterpret_cast<const float4*>(src + l * 2 * sz + sz + i);
            *reinterpret_cast<float4*>(dst + idx) = make_float4(
                f_minsum(x.x, y.x), f_minsum(x.y, y.y), f_minsum(x.z, y.z), f_minsum(x.w, y.w));
          }
          break;
        }
        for (int idx = lane; idx < w * sz; idx += kWarp) {
          const int l = idx >> lg, i = idx & (sz - 1);
          dst[idx] = f_minsum(src[l * 2 * sz + i], src[l * 2 * sz + sz + i]);
        }
        break;
      }
      case OP_G: {
        const float* src = depth_ptr_xl(c, a0, d);
        float* dst = depth_ptr_xl(c, a0, d + 1);
        int* saved = c.Rstack + d * L;
        const bool rl = op.x & kFlagRL;
        if (rl) {
#pragma unroll
          for (int s = 0; s < kP; ++s)
            if (lane + kWarp * s < w) saved[lane + kWarp * s] = R[s];
          __syncwarp();
        }
        const uint32_t* bits = c.beta + kP * off;
        const int lg = ilog2(sz);
        if (vec && sz >= 4) {
          for (int q = lane; q < (w * sz) >> 2; q += kWarp) {
            const int idx = q << 2, l = idx >> lg, i = idx & (sz - 1);
            const int r = rl ? saved[l] : l;
            const float4 x = *reinterpret_cast<const float4*>(src + r * 2 * sz + i);
            const float4 y = *reinterpret_cast<const float4*>(src + r * 2 * sz + sz + i);
            const uint32_t* b = bits + kP * i;
            *reinterpret_cast<float4*>(dst + idx) =
                make_float4(y.x + (1.0f - 2.0f * (float)path_bit_xl<kP>(b, l)) * x.x,
                            y.y + (1.0f - 2.0f * (float)path_bit_xl<kP>(b + kP, l)) * x.y,
                            y.z + (1.0f - 2.0f * (float)path_bit_xl<kP>(b + 2 * kP, l)) * x.z,
                            y.w + (1.0f - 2.0f * (float)path_bit_xl<kP>(b + 3 * kP, l)) * x.w);
          }
          break;
        }
        for (int idx = lane; idx < w * sz; idx += kWarp) {
          const int l = idx >> lg, i = idx & (sz - 1);
          const int r = rl ? saved[l] : l;
          const float sgn = 1.0f - 2.0f * (float)path_bit_xl<kP>(bits + kP * i, l);
          dst[idx] = src[r * 2 * sz + sz + i] + sgn * src[r * 2 * sz + i];
        }
        break;
      }
      case OP_COMBINE: {
        const bool rl = op.x & kFlagRL, rr = op.x & kFlagRR;
        uint32_t* left = c.beta + kP * off;
        const uint32_t* right = left + kP * sz;
        if (rr) {
          perm_xor_xl<kP>(left, left, right, R, w, sz, lane);
        } else {
          for (int q = lane; q < sz * kP; q += kWarp) left[q] ^= right[q];
        }
        if (rl) {  // R_l[R_r[l]]
          const int* rs = c.Rstack + d * L;
#pragma unroll
          for (int s = 0; s < kP; ++s)
            if (lane + kWarp * s < w) R[s] = rs[rr ? R[s] : lane + kWarp * s];
        }
        break;
      }
      case OP_RATE0: {
        float* z = depth_ptr_xl(c, a0, d);
        zero_dec_inplace(z, w * sz, sz, lane);
        d0_inplace(z, w * sz, lane);
        for (int s = 1; s < sz; s <<= 1) {
          for (int q = lane; q < (w * sz) / (2 * s); q += kWarp) {
            const int p = q * 2 * s;
            z[p] = z[p] + z[p + s];
          }
          __syncwarp();
        }
#pragma unroll
        for (int s = 0; s < kP; ++s)
          if (lane + kWarp * s < w) pm[s] = pm[s] + z[(lane + kWarp * s) * sz];
        for (int q = lane; q < sz * kP; q += kWarp) c.beta[kP * off + q] = 0u;
        break;
      }
      case OP_LEAF: {
        const float* a = depth_ptr_xl(c, a0, d);
        float leaf[kP];
#pragma unroll
        for (int s = 0; s < kP; ++s) leaf[s] = lane + kWarp * s < w ? a[lane + kWarp * s] : 0.0f;
        const uint32_t word = info_leaf_xl<kNarrow, kP>(c, leaf, w, pm, R);
        fill_words_xl(c.beta + kP * off, 1, kP, word, lane);
        if (kNarrow) w = min(2 * w, L);
        break;
      }
      case OP_REP: {
        float* z = depth_ptr_xl(c, a0, d);
        const int lgM = ilog2(sz);
        zero_dec_inplace(z, w * sz, sz, lane);
        float leaf[kP];
#pragma unroll
        for (int s = 0; s < kP; ++s) {
          const int p = lane + kWarp * s;
          leaf[s] = p < w ? z[p * sz + sz - 1] : 0.0f;
        }
        __syncwarp();
        d0_inplace(z, w * sz, lane);
        for (int k = 0; (sz >> k) > 2; ++k) {
          const int pairs = (sz >> (k + 1)) - 1;  // per path
          for (int q = lane; q < w * pairs; q += kWarp) {
            const int l = q / pairs, i = q - l * pairs;
            const int p = l * sz + (i << (k + 1));
            z[p] = z[p] + z[p + (1 << k)];
          }
          __syncwarp();
        }
#pragma unroll
        for (int s = 0; s < kP; ++s) {
          const int path = lane + kWarp * s;
          if (path < w) {
            float p = pm[s];
            for (int j = 1; j <= lgM; ++j) p = p + z[path * sz + sz - (sz >> (j - 1))];
            pm[s] = p;
          }
        }
        const uint32_t word = info_leaf_xl<kNarrow, kP>(c, leaf, w, pm, R);
        fill_words_xl(c.beta + kP * off, sz, kP, word, lane);
        if (kNarrow) w = min(2 * w, L);
        break;
      }
      default:
        break;
    }
    __syncwarp();
  }
  if (!has_R) {
#pragma unroll
    for (int s = 0; s < kP; ++s) R[s] = lane + kWarp * s;
  }
}

}  // namespace scl

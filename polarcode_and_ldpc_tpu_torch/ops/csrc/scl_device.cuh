// Device functions of the SCL list decoder for Hopper (sm_90a): the size-S
// subtree list decode ("chunk body") that every SCL kernel runs, written once
// so that the chunk-body, chunk-step, last-chunk and whole-decode kernels of
// scl_decode.cu are the same functions in different launches.
//
// They compute what polarcode_and_ldpc_tpu/ops/scl_body_pallas.py computes
// (the f/g recursion over one static frozen pattern, rate-0 metric collapse,
// exact REP node, per-info-leaf stable top-L of 2L candidates, lazy rank
// re-indexing), for ONE FRAME PER WARP, all state in shared memory:
//
//   alpha   level stack of the chunk, depth d holds [L][S >> d] floats
//   beta    S words: bit l of word m is path l's partial sum at position m
//   pm      L path metrics;  R: the rank vector a node hands back
//   Rstack  one saved left-child rank vector per depth
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
// reliable positions (fastnode_device.cuh picks them), OP_REP_FAST scores a
// repetition subtree's two codewords whole in one prune.  Both sum with the
// halving tree (x[:h] + x[h:]), not the adjacent-pair tree of rate-0 / REP,
// and use the levels below their own alpha plane as scratch: nothing reads
// them before the next F or G writes them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fastnode_device.cuh"

namespace scl {

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
  OP_REP_FAST = 7     // y = depth, z = size, w = beta offset
};
// flags in bits 8.. of the op word
constexpr int kFlagRL = 1 << 8;  // the left child handed back a rank vector
constexpr int kFlagRR = 2 << 8;  // the right child did

struct Ctx {
  float* alpha;
  uint32_t* beta;
  float* pm;
  float* cand;    // 2L candidate metrics
  float* leaf_a;  // L leaf LLRs
  int* R;         // L: rank vector handed back by the last node
  int* tmp;       // L: slot bits of a prune, or an effective pending
  int* Rstack;    // (log2 S + 1) x L
  int L, S, lane;
};

// 32-bit words of shared memory one frame needs
__host__ __device__ inline int ctx_words(int L, int S, int lgS) {
  return 2 * S * L + S + L * (6 + lgS + 1);
}

__device__ __forceinline__ Ctx make_ctx(float* base, int L, int S, int lgS, int lane) {
  Ctx c;
  c.alpha = base;
  c.beta = reinterpret_cast<uint32_t*>(base + 2 * S * L);
  c.pm = base + 2 * S * L + S;
  c.cand = c.pm + L;
  c.leaf_a = c.cand + 2 * L;
  c.R = reinterpret_cast<int*>(c.leaf_a + L);
  c.tmp = c.R + L;
  c.Rstack = c.tmp + L;
  c.L = L;
  c.S = S;
  c.lane = lane;
  return c;
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

// rank apply on packed path bits: bit l of the result is bit r[l] of w
__device__ __forceinline__ uint32_t perm_word(uint32_t w, const int* r, int L) {
  uint32_t out = 0;
  for (int l = 0; l < L; ++l) out |= ((w >> r[l]) & 1u) << l;
  return out;
}

// offset of depth d in the chunk's alpha stack ([L][S >> d] floats)
__device__ __forceinline__ int depth_base(const Ctx& c, int d) {
  return c.L * (2 * c.S - ((2 * c.S) >> d));
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

// Stable top-L prune of the 2L candidates in c.cand (first half: bit 0 /
// keep, second half: bit 1 / flip).  Afterwards c.pm and c.R hold the
// survivors; returns the packed word of their second-half flags (bit l =
// decision of slot l).  Candidate i goes before candidate j iff its metric is
// larger, or equal with i < j.
__device__ __forceinline__ uint32_t prune(const Ctx& c) {
  const int L = c.L, lane = c.lane;
  for (int i = lane; i < 2 * L; i += kWarp) {
    const float ci = c.cand[i];
    int rank = 0;
    for (int j = 0; j < 2 * L; ++j) {
      const float cj = c.cand[j];
      rank += (cj > ci || (cj == ci && j < i)) ? 1 : 0;
    }
    if (rank < L) {
      c.pm[rank] = ci;
      c.R[rank] = i < L ? i : i - L;
      c.tmp[rank] = i >= L ? 1 : 0;
    }
  }
  __syncwarp();
  const uint32_t word = __ballot_sync(kFull, lane < L && c.tmp[lane] != 0);
  __syncwarp();
  return word;
}

// Branch + stable top-L prune on leaf LLRs c.leaf_a and metrics c.pm.
__device__ __forceinline__ uint32_t info_leaf(const Ctx& c) {
  const int L = c.L, lane = c.lane;
  if (lane < L) {
    float d0, d1;
    d0_d1(c.leaf_a[lane], d0, d1);
    const float p = c.pm[lane];
    c.cand[lane] = p + d0;
    c.cand[L + lane] = p + d1;
  }
  __syncwarp();
  return prune(c);
}

// Fast rate-1 node on the [L][sz] plane a, beta words at c.beta + off, using
// the L * sz words at `scratch`.  The metric pays the halving-tree sum of
// log1p(exp(-|a|)); then K = min(L-1, sz) stages each offer every slot a flip
// of its s-th least reliable position at cost -|a|_(s) through the prune.
// Slot l's picks are those of its ORIGINAL path rtot[l] (lane l's register:
// the composition of the stage rank vectors), so no per-path array moves.
// Stage s's flip word lives in lane s.  Returns whether the node has a rank
// vector (K > 0), which it leaves in c.R.
__device__ __forceinline__ bool rate1_fast(const Ctx& c, const float* a, int sz, int off,
                                           float* scratch) {
  const int L = c.L, lane = c.lane;
  const int H = sz > 1 ? sz / 2 : 1;
  fastnode::halving_sum(a, L, sz, scratch, fastnode::Softplus(), lane);
  if (lane < L) c.pm[lane] = c.pm[lane] - scratch[lane * H];
  __syncwarp();
  const int K = min(L - 1, sz);
  int* idx = reinterpret_cast<int*>(scratch);  // [L][K], over the sums just read
  if (K > 0) fastnode::select_k(a, L, sz, K, idx, lane);
  int rtot = lane;
  uint32_t fw = 0;
  for (int s = 0; s < K; ++s) {
    if (lane < L) {
      const float p = c.pm[lane];
      c.cand[lane] = p;
      c.cand[L + lane] = p - fabsf(a[rtot * sz + idx[rtot * K + s]]);
    }
    __syncwarp();
    const uint32_t word = prune(c);
    if (lane < s) fw = perm_word(fw, c.R, L);
    else if (lane == s) fw = word;
    rtot = __shfl_sync(kFull, rtot, lane < L ? c.R[lane] : 0);  // rtot[l] = rtot[r[l]]
  }
  __syncwarp();
  if (K > 0) {
    if (lane < L) c.R[lane] = rtot;
    if (lane < K) c.tmp[lane] = (int)fw;
  }
  __syncwarp();
  // hard decisions (a < 0, so -0.0 decides 0) of the original paths, moved
  // through the final rank vector, then every stage's flips XORed in
  for (int i = lane; i < sz; i += kWarp) {
    uint32_t w = 0;
    for (int p = 0; p < L; ++p) w |= (a[p * sz + i] < 0.0f ? 1u : 0u) << p;
    c.beta[off + i] = K > 0 ? perm_word(w, c.R, L) : w;
  }
  __syncwarp();
  for (int q = lane; q < L * K; q += kWarp) {
    const int l = q / K, s = q - l * K;
    if (((uint32_t)c.tmp[s] >> l) & 1u) atomicXor(&c.beta[off + idx[c.R[l] * K + s]], 1u << l);
  }
  return K > 0;
}

// Fast repetition node: the two candidates per slot are pm + the halving-tree
// sums of log P(0 | a) and log P(1 | a) over the node, one prune, the bit
// repeated over the node.
__device__ __forceinline__ void rep_fast(const Ctx& c, const float* a, int sz, int off,
                                         float* scratch) {
  const int L = c.L, lane = c.lane;
  const int H = sz > 1 ? sz / 2 : 1;
  float* z0 = scratch;
  float* z1 = scratch + L * H;
  fastnode::halving_sum(a, L, sz, z0, fastnode::LogP0(), lane);
  fastnode::halving_sum(a, L, sz, z1, fastnode::LogP1(), lane);
  if (lane < L) {
    const float p = c.pm[lane];
    c.cand[lane] = p + z0[lane * H];
    c.cand[L + lane] = p + z1[lane * H];
  }
  __syncwarp();
  const uint32_t word = prune(c);
  for (int i = lane; i < sz; i += kWarp) c.beta[off + i] = word;
}

// The chunk body: decode the size-S subtree whose alpha lies at depth 0 of
// c.alpha, with metrics c.pm.  Leaves the packed partial sums in c.beta, the
// new metrics in c.pm and the chunk's rank vector in c.R.
__device__ __forceinline__ void chunk_body(const Ctx& c, const int4* __restrict__ prog,
                                           int n_ops, int has_R) {
  const int L = c.L, lane = c.lane;
  for (int pc = 0; pc < n_ops; ++pc) {
    const int4 op = __ldg(prog + pc);
    const int d = op.y, sz = op.z, off = op.w;
    switch (op.x & 0xff) {
      case OP_F: {
        const float* src = c.alpha + depth_base(c, d);
        float* dst = c.alpha + depth_base(c, d + 1);
        const int lg = ilog2(sz);
        for (int idx = lane; idx < L * sz; idx += kWarp) {
          const int l = idx >> lg, i = idx & (sz - 1);
          dst[idx] = f_minsum(src[l * 2 * sz + i], src[l * 2 * sz + sz + i]);
        }
        break;
      }
      case OP_G: {
        const float* src = c.alpha + depth_base(c, d);
        float* dst = c.alpha + depth_base(c, d + 1);
        int* saved = c.Rstack + d * L;
        const bool rl = op.x & kFlagRL;
        if (rl) {
          if (lane < L) saved[lane] = c.R[lane];
          __syncwarp();
        }
        const int lg = ilog2(sz);
        for (int idx = lane; idx < L * sz; idx += kWarp) {
          const int l = idx >> lg, i = idx & (sz - 1);
          const int r = rl ? saved[l] : l;  // the parent alpha, read through the rank vector
          const float sgn = 1.0f - 2.0f * (float)((c.beta[off + i] >> l) & 1u);
          dst[idx] = src[r * 2 * sz + sz + i] + sgn * src[r * 2 * sz + i];
        }
        break;
      }
      case OP_COMBINE: {
        const bool rl = op.x & kFlagRL, rr = op.x & kFlagRR;
        for (int i = lane; i < sz; i += kWarp) {
          uint32_t w = c.beta[off + i];
          if (rr) w = perm_word(w, c.R, L);
          c.beta[off + i] = w ^ c.beta[off + sz + i];
        }
        if (rl) {  // R = compose(R_r, R_l): R[l] = R_l[R_r[l]]
          const int* saved = c.Rstack + d * L;
          int v = 0;
          if (lane < L) v = saved[rr ? c.R[lane] : lane];
          __syncwarp();
          if (lane < L) c.R[lane] = v;
        }
        break;
      }
      case OP_RATE0: {
        float* z = c.alpha + depth_base(c, d);
        zero_dec_inplace(z, L * sz, sz, lane);
        d0_inplace(z, L * sz, lane);
        // adjacent-pair tree sum per path, in place with a growing stride
        for (int s = 1; s < sz; s <<= 1) {
          for (int q = lane; q < (L * sz) / (2 * s); q += kWarp) {
            const int p = q * 2 * s;
            z[p] = z[p] + z[p + s];
          }
          __syncwarp();
        }
        if (lane < L) c.pm[lane] = c.pm[lane] + z[lane * sz];
        for (int i = lane; i < sz; i += kWarp) c.beta[off + i] = 0u;
        break;
      }
      case OP_LEAF: {
        const float* a = c.alpha + depth_base(c, d);
        if (lane < L) c.leaf_a[lane] = a[lane];
        __syncwarp();
        const uint32_t word = info_leaf(c);
        if (lane == 0) c.beta[off] = word;
        break;
      }
      case OP_REP: {
        float* z = c.alpha + depth_base(c, d);
        const int lgM = ilog2(sz);
        zero_dec_inplace(z, L * sz, sz, lane);
        if (lane < L) c.leaf_a[lane] = z[lane * sz + sz - 1];
        __syncwarp();
        d0_inplace(z, L * sz, lane);
        // pair sums at every level EXCEPT each path's last pair: the block sums
        // the metric needs (position sz - 2^(k+1) at level k) then stay in place
        for (int k = 0; (sz >> k) > 2; ++k) {
          const int pairs = (sz >> (k + 1)) - 1;  // per path
          for (int q = lane; q < L * pairs; q += kWarp) {
            const int l = q / pairs, i = q - l * pairs;
            const int p = l * sz + (i << (k + 1));
            z[p] = z[p] + z[p + (1 << k)];
          }
          __syncwarp();
        }
        if (lane < L) {
          float p = c.pm[lane];
          for (int j = 1; j <= lgM; ++j) p = p + z[lane * sz + sz - (sz >> (j - 1))];
          c.pm[lane] = p;
        }
        __syncwarp();
        const uint32_t word = info_leaf(c);
        for (int i = lane; i < sz; i += kWarp) c.beta[off + i] = word;
        break;
      }
      case OP_RATE1_FAST:
        rate1_fast(c, c.alpha + depth_base(c, d), sz, off, c.alpha + depth_base(c, d + 1));
        break;
      case OP_REP_FAST:
        rep_fast(c, c.alpha + depth_base(c, d), sz, off, c.alpha + depth_base(c, d + 1));
        break;
      default:
        break;
    }
    __syncwarp();
  }
  if (!has_R) {
    if (lane < L) c.R[lane] = lane;
    __syncwarp();
  }
}

}  // namespace scl

// Device functions of the SSCL fast rate-1 node's preamble for Hopper
// (sm_90a), shared by the standalone selection kernel (fastnode.cu,
// fastnode_select) and the OP_RATE1_FAST op of the list decoder's chunk body
// (scl_device.cuh), so the two are one computation in two launches.
//
// They compute what tools/mosaic_fastnode_probe.py (the kernel at :53-75)
// and the rate-1 node of
// polarcode_and_ldpc_tpu/ops/scl_body_pallas.py (_rate1_fast_rank_loop)
// compute, for ONE FRAME PER WARP on an [L][M] plane in shared memory:
//
//   * the K least-reliable positions of every path: the first K of a stable
//     ascending sort of |a| (ties to the lower position).  K rounds of a
//     warp argmin over (|a|, position) pairs compared lexicographically: a
//     round takes the least pair strictly above the previous round's pick,
//     so no "taken" flags are kept and the picks are exactly the stable
//     sort's prefix.  The paths run side by side: each owns a group of
//     G = 32 / 2^ceil(log2 L) lanes, and the argmin is a shuffle reduction
//     inside the group;
//   * a halving-tree sum over the M positions (x[:h] + x[h:] until one is
//     left) of a per-element function, for the rate-1 penalty
//     log1p(exp(-|a|)) and the repetition node's d0 / d1 sums.  The order
//     of the additions is the result: build with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fastnode {

constexpr unsigned kFullMask = 0xffffffffu;

// per-element terms of the halving-tree sums
struct Softplus {  // log1p(exp(-|a|)): the rate-1 node's penalty
  __device__ __forceinline__ float operator()(float a) const { return log1pf(expf(-fabsf(a))); }
};
struct LogP0 {  // log P(0 | a), as scl::d0_d1 computes it
  __device__ __forceinline__ float operator()(float a) const {
    return -(fmaxf(0.0f, -a) + log1pf(expf(-fabsf(a))));
  }
};
struct LogP1 {  // log P(1 | a)
  __device__ __forceinline__ float operator()(float a) const {
    return -(fmaxf(0.0f, a) + log1pf(expf(-fabsf(a))));
  }
};

// Halving-tree sum of f(a) along each of the L rows of a ([L][M], M a power
// of two).  z is scratch of L * max(M / 2, 1) floats that may not overlap a;
// afterwards z[l * max(M / 2, 1)] holds row l's sum.
template <class F>
__device__ __forceinline__ void halving_sum(const float* a, int L, int M, float* z, F f,
                                            int lane) {
  const int H = M > 1 ? M / 2 : 1;
  for (int q = lane; q < L * H; q += 32) {
    const int l = q / H, i = q - l * H;
    z[q] = M > 1 ? f(a[l * M + i]) + f(a[l * M + i + H]) : f(a[l]);
  }
  __syncwarp();
  for (int h = H / 2; h >= 1; h >>= 1) {
    for (int q = lane; q < L * h; q += 32) {
      const int l = q / h, i = q - l * h;
      z[l * H + i] = z[l * H + i] + z[l * H + i + h];
    }
    __syncwarp();
  }
}

// lanes per path in select_k: the largest power of two G with G * L <= 32
__device__ __forceinline__ int group_lanes(int L) {
  int G = 32;
  while (G * L > 32) G >>= 1;
  return G;
}

// The K least-reliable positions of each of the L rows of a ([L][M]):
// idx[l * K + k] = position of the k-th smallest (|a|, position) pair of row
// l.  Needs K <= M and L <= 32; every lane of the warp must call it.
__device__ __forceinline__ void select_k(const float* a, int L, int M, int K, int* idx,
                                         int lane) {
  const int G = group_lanes(L);
  const int path = lane / G, sub = lane % G;
  const bool on = path < L;
  const float* row = a + (on ? path : 0) * M;
  float last_m = -INFINITY;
  int last_p = -1;
  for (int k = 0; k < K; ++k) {
    float bm = INFINITY;
    int bp = 0x7fffffff;
    if (on) {
      for (int i = sub; i < M; i += G) {
        const float m = fabsf(row[i]);
        const bool above = m > last_m || (m == last_m && i > last_p);
        if (above && (m < bm || (m == bm && i < bp))) {
          bm = m;
          bp = i;
        }
      }
    }
    for (int off = G / 2; off >= 1; off >>= 1) {
      const float om = __shfl_xor_sync(kFullMask, bm, off);
      const int op = __shfl_xor_sync(kFullMask, bp, off);
      if (om < bm || (om == bm && op < bp)) {
        bm = om;
        bp = op;
      }
    }
    last_m = bm;
    last_p = bp;
    if (on && sub == 0) idx[path * K + k] = bp;
  }
  __syncwarp();
}

}  // namespace fastnode

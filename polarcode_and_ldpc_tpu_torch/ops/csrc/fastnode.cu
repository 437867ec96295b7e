// The SSCL fast rate-1 node's selection for Hopper (sm_90a): replaces the
// Pallas kernel of tools/mosaic_fastnode_probe.py (:53-79).
//
//   fastnode_select  a [L][S][B] f32 -> mags [L][K][B] f32, idx [L][K][B]
//                    int32 (the K least-reliable (|a|, position) pairs of
//                    every path, stable ascending), penalty [L][B] f32 (the
//                    halving-tree sum of log1p(exp(-|a|)) over S)
//
// It computes what fastnode::halving_sum + fastnode::select_k of
// fastnode_device.cuh compute (the rate-1 node's preamble on its own, whose
// selection rounds the list decoder's OP_RATE1_FAST runs over registers,
// scl_device.cuh).  The probe's layout (frames last) is kept so the kernel
// and its plain version compare like with like.
//
// What bounds it: each input read once and each output written once is
// 4*L*(S + 2K + 1) bytes per frame, a few hundred operations per path; the
// roofline is the memory rate.
//
// Design: ONE OR TWO LANES STREAM EACH (PATH, FRAME) — two, each on one half
// of the positions, for lists of up to 15 and S >= 32 — consecutive lanes on
// consecutive frames, so that a warp's
// load of a[l][s][b0 ..] is 64 or 128 contiguous bytes, each byte read once;
// no shared memory.  A lane streams its S values, the next 16 loaded while
// the current 16 are worked on:
//   * the K least (|a|, position) pairs as a sorted list in registers (of
//     7, 15 or 32 entries, the first that holds K), compared
//     lexicographically as one 64-bit key (|a|'s bits above the position:
//     for |a| >= 0 the unsigned order of the keys is the order of the pairs),
//     each value inserted by a compare-exchange pass over the list — the
//     magnitudes by float min / max, the positions by selects on the compares
//     — so the list keeps the stable sort's prefix (ties to the lower
//     position) whatever order the positions come in; the second lane's list
//     is inserted into the first's at the end (shuffles);
//   * the halving-tree sum (x[:h] + x[h:] until one is left) with exactly its
//     additions: the tree's in-order leaves are the positions in bit-reversed
//     order, so each lane takes its part of that order (a complete subtree),
//     sums each run of 16 leaves pairwise, adds the runs' sums as a binary
//     counter does (a stack of partial sums, one per level, in registers),
//     and the two halves' sums make the root.  Same expf / log1pf and
//     -fmad=false as the plain version's float ops.
// The list's inserts are most of the work.  At the flagship's node shape [8,
// 128, 4096], K = 7, the first version (one lane a (path, frame), the 64-bit
// keys moved by selects) read 0.029 ms of device time, two lanes with the
// next loads in flight 0.030, the magnitudes by min / max on a list of 7
// 0.022 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, tools/scl_kernel_ab.py,
// PERF.md); a list of 32 runs on one lane (its registers).  The
// warp-per-frame design it replaces ran each frame's K argmin rounds over
// shared memory, one dependent chain per warp: 0.0528 ms against a 0.0056 ms
// bound.
//
// K is at most kStreamMaxK: every list of up to 32 paths has K = L - 1 <= 31,
// and the probe runs K = 7.

#include <stdint.h>

#include "fastnode_device.cuh"

namespace {

// the register list's bound, and the levels of the partial-sum stack (S up to
// 2^(kStackLevels + 3) with runs of 16; 2^(kStackLevels - 1) with runs of 1)
constexpr int kStreamMaxK = 32;
constexpr int kStackLevels = 13;

// One (|a|, position) pair of a list: the magnitude as a float (the list's
// magnitudes move by min / max), ordered as the 64-bit key of |a|'s bits
// above the position.
struct Pick {
  float m;
  int p;
};
__device__ __forceinline__ uint64_t pick_key(Pick x) {
  return ((uint64_t)__float_as_uint(x.m) << 32) | (uint32_t)x.p;
}

// Insert `x` into the ascending list, dropping its largest pair.
template <int kMaxK>
__device__ __forceinline__ void insert_pick(Pick (&list)[kMaxK], Pick x) {
  const uint64_t key = pick_key(x);
  bool before[kMaxK];  // x goes before entry k
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) before[k] = key < pick_key(list[k]);
#pragma unroll
  for (int k = kMaxK - 1; k > 0; --k) {
    list[k].m = fmaxf(list[k - 1].m, fminf(x.m, list[k].m));
    list[k].p = before[k - 1] ? list[k - 1].p : (before[k] ? x.p : list[k].p);
  }
  list[0].m = fminf(x.m, list[0].m);
  list[0].p = before[0] ? x.p : list[0].p;
}

// position i of the bit-reversed order of lgS bits
__device__ __forceinline__ int brev_pos(int i, int lgS) {
  return lgS ? (int)(__brev((unsigned)i) >> (32 - lgS)) : 0;
}
// four-bit reversal, for offsets known at compile time
__host__ __device__ constexpr int brev4(int r) {
  return ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | ((r & 8) >> 3);
}

// kMaxK: the list's length (>= K); kRun: leaves summed as one subtree before
// they enter the counter (16, or 1 when S < 16); kLanes: lanes per (path,
// frame), each on its part of the bit-reversed order (2 needs S >= 32).
// Lane q of a warp serves pair (the warp's first pair + q % (32 / kLanes)),
// part q / (32 / kLanes).
template <int kMaxK, int kRun, int kLanes>
__global__ void __launch_bounds__(256)
    fastnode_stream_kernel(const float* __restrict__ a, float* __restrict__ mags,
                           int* __restrict__ idx, float* __restrict__ pen, int L, int S, int lgS,
                           int K, int B) {
  constexpr int kPairs = 32 / kLanes;  // (path, frame) pairs of a warp
  const int gid = blockIdx.x * blockDim.x + threadIdx.x, lane = threadIdx.x % 32;
  const int q = gid / 32 * kPairs + lane % kPairs, part = lane / kPairs;
  const bool on = q < L * B;  // every lane runs the shuffles
  const int l = on ? q / B : 0, b = on ? q - l * B : 0;
  const float* row = a + (size_t)l * S * B + b;  // a[l][s][b] at row[s * B]
  const int runs = S / kRun / kLanes, first = part * runs;  // this lane's runs
  // run R holds positions brev(kRun R + u): with runs of 16, brev4(u) <<
  // (lgS - 4) | brev_{lgS-4}(R), a base per run and a stride per u
  const int run_bits = kRun == 16 ? lgS - 4 : lgS;
  const size_t u_stride = kRun == 16 ? (size_t)B << (lgS - 4) : 0;
  Pick list[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) list[k] = Pick{INFINITY, -1};  // after every pair
  float level[kStackLevels];  // the counter's partial sums, level k: 2^k runs
#pragma unroll
  for (int k = 0; k < kStackLevels; ++k) level[k] = 0.0f;
  float total = 0.0f;
  const fastnode::Softplus f{};
  float next[kRun];
  {
    const float* base = row + (size_t)brev_pos(first, run_bits) * B;
#pragma unroll
    for (int u = 0; u < kRun; ++u) next[u] = on ? base[brev4(u) * u_stride] : 0.0f;
  }
#pragma unroll 1
  for (int r = 0; r < runs; ++r) {
    float x[kRun];
#pragma unroll
    for (int u = 0; u < kRun; ++u) x[u] = next[u];
    if (r + 1 < runs) {  // the next run's loads, in flight while this one is worked on
      const float* base = row + (size_t)brev_pos(first + r + 1, run_bits) * B;
#pragma unroll
      for (int u = 0; u < kRun; ++u) next[u] = on ? base[brev4(u) * u_stride] : 0.0f;
    }
    const int run_pos = brev_pos(first + r, run_bits);
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      insert_pick(list, Pick{fabsf(x[u]),
                             kRun == 16 ? (brev4(u) << (lgS - 4)) | run_pos : run_pos});
      x[u] = f(x[u]);
    }
#pragma unroll
    for (int w = kRun / 2; w >= 1; w /= 2)  // the run's subtree, pairwise
#pragma unroll
      for (int u = 0; u < w; ++u) x[u] = x[2 * u] + x[2 * u + 1];
    // the run's sum into the counter: merge with the levels the runs so far
    // have taken (the trailing ones of r), park at the first free one
    const int merges = __ffs(~r) - 1;
    float carry = x[0];
#pragma unroll
    for (int k = 0; k < kStackLevels; ++k) {
      if (k < merges) carry = level[k] + carry;
      if (k == merges) level[k] = carry;
    }
    total = carry;  // after the last run: the lane's whole subtree
  }
  if (kLanes == 2) {  // the second part's list into the first's, and the root
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const Pick other{__shfl_xor_sync(fastnode::kFullMask, list[k].m, kPairs),
                       __shfl_xor_sync(fastnode::kFullMask, list[k].p, kPairs)};
      if (part == 0 && k < K) insert_pick(list, other);
    }
    total = total + __shfl_xor_sync(fastnode::kFullMask, total, kPairs);
  }
  if (!on || part) return;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      const size_t o = ((size_t)l * K + k) * B + b;
      mags[o] = list[k].m;
      idx[o] = list[k].p;
    }
  }
  pen[(size_t)l * B + b] = total;
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernel: K <= kStreamMaxK (STREAM_MAX_K of fastnode_cuda.py), S a power
// of two up to 2^(kStackLevels + 3) (STREAM_MAX_S), L * B < 2^31.  Runs on
// `stream`; returns the cudaGetLastError code (0 = ok).
template <int kMaxK>
static void launch_stream(const float* a, float* mags, int* idx, float* pen, int L, int S,
                          int lgS, int K, int B, cudaStream_t st) {
  const long long pairs = (long long)L * B;
  const int threads = 256;
  const auto blocks = [&](int lanes) { return (int)((pairs * lanes + threads - 1) / threads); };
  if constexpr (kMaxK <= 15) {  // two lanes a (path, frame)
    if (S >= 32) {
      fastnode_stream_kernel<kMaxK, 16, 2><<<blocks(2), threads, 0, st>>>(a, mags, idx, pen, L,
                                                                           S, lgS, K, B);
      return;
    }
  }
  if (S >= 16)
    fastnode_stream_kernel<kMaxK, 16, 1><<<blocks(1), threads, 0, st>>>(a, mags, idx, pen, L, S,
                                                                         lgS, K, B);
  else
    fastnode_stream_kernel<kMaxK, 1, 1><<<blocks(1), threads, 0, st>>>(a, mags, idx, pen, L, S,
                                                                        lgS, K, B);
}

extern "C" int fastnode_select_launch(const float* a, float* mags, int* idx, float* pen, int L,
                                      int S, int K, int B, void* stream) {
  if (K < 1 || K > kStreamMaxK || K > S || S > (1 << (kStackLevels + 3)) || (S & (S - 1)))
    return (int)cudaErrorInvalidValue;
  const int lgS = 31 - __builtin_clz((unsigned)S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 7)
    launch_stream<7>(a, mags, idx, pen, L, S, lgS, K, B, st);
  else if (K <= 15)
    launch_stream<15>(a, mags, idx, pen, L, S, lgS, K, B, st);
  else
    launch_stream<kStreamMaxK>(a, mags, idx, pen, L, S, lgS, K, B, st);
  return (int)cudaGetLastError();
}

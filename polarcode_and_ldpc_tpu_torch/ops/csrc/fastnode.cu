// The SSCL fast rate-1 node's selection for Hopper (sm_90a): replaces the
// Pallas kernel of tools/mosaic_fastnode_probe.py (:53-79).
//
//   fastnode_select  a [L][S][B] f32 -> mags [L][K][B] f32, idx [L][K][B]
//                    int32 (the K least-reliable (|a|, position) pairs of
//                    every path, stable ascending), penalty [L][B] f32 (the
//                    halving-tree sum of log1p(exp(-|a|)) over S)
//
// Its body is fastnode::halving_sum + fastnode::select_k of
// fastnode_device.cuh: the rate-1 node's preamble on its own, whose
// selection rounds the list decoder's OP_RATE1_FAST runs over registers
// (scl_device.cuh).  The probe's layout (frames last) is kept so the kernel
// and its plain version compare like with like.
//
// What bounds it: each input read once and each output written once is
// 4*L*(S + 2K + 1) bytes per frame, a few hundred operations per path; the
// roofline is the memory rate.  Design: ONE WARP PER FRAME, the frame's
// [L][S] plane in shared memory (loaded by the whole block, consecutive
// threads on consecutive frames), K rounds of a grouped warp argmin, no
// block-wide barrier after the load.

#include "fastnode_device.cuh"

namespace {

__global__ void fastnode_select_kernel(const float* __restrict__ a, float* __restrict__ mags,
                                       int* __restrict__ idx, float* __restrict__ pen, int L,
                                       int S, int K, int B, int per_warp) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * warps;
  for (int q = threadIdx.x; q < L * S * warps; q += blockDim.x) {
    const int w = q % warps, ls = q / warps, b = b0 + w;
    smem[w * per_warp + ls] = b < B ? a[(size_t)ls * B + b] : 0.0f;
  }
  __syncthreads();
  const int b = b0 + warp;
  if (b >= B) return;
  const float* plane = smem + warp * per_warp;
  float* scratch = smem + warp * per_warp + L * S;
  const int H = S > 1 ? S / 2 : 1;
  fastnode::halving_sum(plane, L, S, scratch, fastnode::Softplus(), lane);
  if (lane < L) pen[(size_t)lane * B + b] = scratch[lane * H];
  __syncwarp();
  int* picks = reinterpret_cast<int*>(scratch);
  fastnode::select_k(plane, L, S, K, picks, lane);
  for (int q = lane; q < L * K; q += 32) {
    const int l = q / K, p = picks[q];
    idx[(size_t)q * B + b] = p;
    mags[(size_t)q * B + b] = fabsf(plane[l * S + p]);
  }
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 32-bit words of shared memory one frame (one warp) needs
extern "C" int fastnode_words_per_frame(int L, int S, int K) {
  const int H = S > 1 ? S / 2 : 1;
  return L * S + L * (H > K ? H : K);
}

// Runs on `stream`; returns the cudaGetLastError code (0 = ok).
extern "C" int fastnode_select_launch(const float* a, float* mags, int* idx, float* pen, int L,
                                      int S, int K, int B, int warps_per_block, void* stream) {
  const int per_warp = fastnode_words_per_frame(L, S, K);
  const size_t smem = (size_t)warps_per_block * per_warp * 4;
  cudaError_t err = cudaFuncSetAttribute(fastnode_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps_per_block - 1) / warps_per_block;
  fastnode_select_kernel<<<blocks, warps_per_block * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      a, mags, idx, pen, L, S, K, B, per_warp);
  return (int)cudaGetLastError();
}

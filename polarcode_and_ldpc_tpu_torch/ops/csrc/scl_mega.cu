// K6, scl_decode_mega (replaces polarcode_and_ldpc_tpu/ops/scl_mega_pallas.py,
// make_scl_mega_pallas): the whole chunked list decode in one launch.  The
// kernel and its device functions are in scl_kernels.cuh and scl_device.cuh.

#define SCL_DECODE_MEGA
#include "scl_kernels.cuh"

// The launcher runs on `stream` and returns the cudaGetLastError code (0 =
// ok).
// llr is [B][N] in natural order; llr_rev, alpha, beta, pend_a, pend_b are
// scratch of the state's shapes (see the top of the file); steps is [C][8].
extern "C" int scl_decode_mega_launch(const float* llr, float* llr_rev, float* alpha, int* beta,
                                      int* pend_a, int* pend_b, int8_t* u, float* pm,
                                      const int* prog, const int* steps, int C, int B, int N,
                                      int S, int L, int t, int lgS, int log2N,
                                      int warps_per_block, void* stream) {
  const size_t per_frame = mega_frame_bytes(L, S, lgS, N, t);
  const int warps = plan_warps((const void*)&scl_decode_mega_kernel, per_frame, warps_per_block);
  const size_t smem = (size_t)warps * per_frame;
  cudaError_t err = allow_smem(scl_decode_mega_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  const int blocks = (B + warps - 1) / warps;
  scl_decode_mega_kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, llr_rev, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, u, pm,
      reinterpret_cast<const int4*>(prog), steps, C, g, log2N);
  return (int)cudaGetLastError();
}

namespace {
const KernelEntry kKernels[] = {
    {"scl_decode_mega", (const void*)&scl_decode_mega_kernel, &mega_frame_bytes},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

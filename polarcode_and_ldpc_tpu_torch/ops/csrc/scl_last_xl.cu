// K4 (scl_last_chunk) for XL lists, 65 <= L <= 256: the instances at four
// paths a lane (L <= 128) and eight (L <= 256), in shared or device memory.
// The kernel and its device functions are in scl_kernels.cuh and
// scl_device.cuh ("XL LISTS"); a source of its own, built beside scl_last.cu,
// whose instances (L <= 64) are unchanged.  The launcher takes the arguments
// of scl_last.cu's (beta as kP 32-bit words a position; `top` scratch [B][L][S]
// floats) and refuses a list outside 65 .. 256, a fast program and one-hot
// pendings.

#include "scl_kernels.cuh"

namespace {

template <int kP>
int last_chunk_xl(const float* llr, const float* alpha, const int* beta, const int* pend_a,
                  const int* pend_b, const float* pm, int8_t* u, float* pm_out, float* top,
                  const int* prog, int n_ops, int has_R, int B, int N, int S, int L, int t,
                  int lgS, int log2N, int one_a, int one_b, int warps_per_block, float* ctx_dev,
                  int grid, void* stream) {
  decltype(&scl_last_chunk_xl_kernel<false, kP>) kernel;
  size_t smem;
  int blocks, warps;
  cudaError_t err = configure(&scl_last_chunk_xl_kernel<false, kP>,
                              &scl_last_chunk_xl_kernel<true, kP>, ctx_dev,
                              last_frame_bytes_xl<kP>(L, S, lgS, N, t), B, warps_per_block, grid,
                              &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, alpha, reinterpret_cast<const uint32_t*>(beta), pend_a, pend_b, pm, u, pm_out, top,
      reinterpret_cast<const int4*>(prog), n_ops, has_R, g, log2N, one_a, one_b, ctx_dev);
  return (int)cudaGetLastError();
}

}  // namespace

// The launcher runs on `stream` and returns the cudaGetLastError code (0 =
// ok); ctx_dev (null: the context in shared memory) and grid as in
// scl_last.cu.
extern "C" int scl_last_chunk_launch(const float* llr, const float* alpha, const int* beta,
                                     const int* pend_a, const int* pend_b, const float* pm,
                                     int8_t* u, float* pm_out, float* top,
                                     const int* prog, int n_ops, int has_R, int B, int N, int S,
                                     int L, int t, int lgS, int log2N, int one_a, int one_b,
                                     int onehot, int fast, int warps_per_block, float* ctx_dev,
                                     int grid, void* stream) {
  if (L <= kWideListMax || L > kXlListMax || fast || onehot) return (int)cudaErrorInvalidValue;
  return (xl_paths_per_lane(L) == 4 ? &last_chunk_xl<4> : &last_chunk_xl<8>)(
      llr, alpha, beta, pend_a, pend_b, pm, u, pm_out, top, prog, n_ops, has_R, B, N, S, L, t,
      lgS, log2N, one_a, one_b, warps_per_block, ctx_dev, grid, stream);
}

namespace {
const KernelEntry kKernels[] = {
    {"scl_last_chunk_xl4", (const void*)&scl_last_chunk_xl_kernel<false, 4>,
     &last_frame_bytes_xl<4>},
    {"scl_last_chunk_xl8", (const void*)&scl_last_chunk_xl_kernel<false, 8>,
     &last_frame_bytes_xl<8>},
    {"scl_last_chunk_xl4_devmem", (const void*)&scl_last_chunk_xl_kernel<true, 4>, nullptr},
    {"scl_last_chunk_xl8_devmem", (const void*)&scl_last_chunk_xl_kernel<true, 8>, nullptr},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

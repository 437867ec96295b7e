// K5 (scl_chunk_body) for XL lists, 65 <= L <= 256: the instances at four
// paths a lane (L <= 128) and eight (L <= 256), in shared or device memory.
// The kernel and its device functions are in scl_kernels.cuh and
// scl_device.cuh ("XL LISTS"); a source of its own, built beside scl_body.cu,
// whose instances (L <= 64) are unchanged.  The launcher takes the arguments
// of scl_body.cu's (r_out: long long [B][L] rank vectors) and refuses a list
// outside 65 .. 256, a fast program and one-hot permutations.

#include "scl_kernels.cuh"

namespace {

template <int kP>
int chunk_body_xl(const float* alpha, const float* pm, int8_t* beta_out, float* pm_out,
                  void* r_out, const int* prog, int n_ops, int has_R, int B, int S, int L,
                  int lgS, int warps_per_block, float* ctx_dev, int grid, void* stream) {
  decltype(&scl_chunk_body_xl_kernel<false, kP>) kernel;
  size_t smem;
  int blocks, warps;
  cudaError_t err = configure(&scl_chunk_body_xl_kernel<false, kP>,
                              &scl_chunk_body_xl_kernel<true, kP>, ctx_dev,
                              ctx_frame_bytes_xl<kP>(L, S, lgS, 0, 0), B, warps_per_block, grid,
                              &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      alpha, pm, beta_out, pm_out, static_cast<long long*>(r_out),
      reinterpret_cast<const int4*>(prog), n_ops, has_R, B, S, L, lgS, ctx_dev);
  return (int)cudaGetLastError();
}

}  // namespace

// The launcher runs on `stream` and returns the cudaGetLastError code (0 =
// ok); ctx_dev (null: the context in shared memory) and grid as in
// scl_body.cu.
extern "C" int scl_chunk_body_launch(const float* alpha, const float* pm, int8_t* beta_out,
                                     float* pm_out, void* r_out, const int* prog, int n_ops,
                                     int has_R, int B, int S, int L, int lgS, int onehot,
                                     int fast, int warps_per_block, float* ctx_dev, int grid,
                                     void* stream) {
  if (L <= kWideListMax || L > kXlListMax || fast || onehot) return (int)cudaErrorInvalidValue;
  return (xl_paths_per_lane(L) == 4 ? &chunk_body_xl<4> : &chunk_body_xl<8>)(
      alpha, pm, beta_out, pm_out, r_out, prog, n_ops, has_R, B, S, L, lgS, warps_per_block,
      ctx_dev, grid, stream);
}

namespace {
const KernelEntry kKernels[] = {
    {"scl_chunk_body_xl4", (const void*)&scl_chunk_body_xl_kernel<false, 4>,
     &ctx_frame_bytes_xl<4>},
    {"scl_chunk_body_xl8", (const void*)&scl_chunk_body_xl_kernel<false, 8>,
     &ctx_frame_bytes_xl<8>},
    {"scl_chunk_body_xl4_devmem", (const void*)&scl_chunk_body_xl_kernel<true, 4>, nullptr},
    {"scl_chunk_body_xl8_devmem", (const void*)&scl_chunk_body_xl_kernel<true, 8>, nullptr},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

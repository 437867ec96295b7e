// K5, scl_chunk_body (replaces polarcode_and_ldpc_tpu/ops/scl_body_pallas.py,
// make_chunk_body_pallas): one chunk's list decode on its own.  The kernel
// and its device functions are in scl_kernels.cuh and scl_device.cuh.  Built
// with -DSCL_PROFILE (the build's scl_body_profile variant) it also exports
// the stage profile's counters.

#include "scl_kernels.cuh"

#ifdef SCL_PROFILE
// The stage profile's counters: zero them, or copy the 2 * kProfSlots
// unsigned 64-bit values (cycles, then counts) to host memory.
extern "C" int scl_profile_reset() {
  static const unsigned long long zeros[2 * scl::kProfSlots] = {};
  return (int)cudaMemcpyToSymbol(scl::g_prof, zeros, sizeof(zeros));
}
extern "C" int scl_profile_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, scl::g_prof, sizeof(scl::g_prof));
}
#endif

// The launcher runs on `stream` and returns the cudaGetLastError code (0 =
// ok).
// It takes `ctx_dev` (null: the context in shared memory; else grid *
// warps_per_block slices of the context in device memory) and `grid` (the
// blocks of the device-memory mode).
// alpha is read where it lies (the kernel's context has no top plane).
// r_out: long long [B][L] rank vectors, or (onehot) float [B][L][L] planes.
// fast: the node program is a fast one, run by the fast instance.  A wide list
// (32 < L <= 64) runs the wide instance: exact nodes, rank vectors.
extern "C" int scl_chunk_body_launch(const float* alpha, const float* pm, int8_t* beta_out,
                                     float* pm_out, void* r_out, const int* prog, int n_ops,
                                     int has_R, int B, int S, int L, int lgS, int onehot,
                                     int fast, int warps_per_block, float* ctx_dev, int grid,
                                     void* stream) {
  if (L < 1 || L > kWideListMax || (L > kNarrowListMax && (fast || onehot)))
    return (int)cudaErrorInvalidValue;
  if (L > kNarrowListMax) {
    decltype(&scl_chunk_body_wide_kernel<false>) kernel;
    size_t smem;
    int blocks, warps;
    cudaError_t err = configure(&scl_chunk_body_wide_kernel<false>,
                                &scl_chunk_body_wide_kernel<true>, ctx_dev,
                                ctx_frame_bytes_wide(L, S, lgS, 0, 0), B, warps_per_block, grid,
                                &kernel, &smem, &blocks, &warps);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
        alpha, pm, beta_out, pm_out, static_cast<long long*>(r_out),
        reinterpret_cast<const int4*>(prog), n_ops, has_R, B, S, L, lgS, ctx_dev);
    return (int)cudaGetLastError();
  }
  decltype(&scl_chunk_body_kernel<false, false, false>) kernel;
  size_t smem;
  int blocks, warps;
  if (fast && onehot) return (int)cudaErrorInvalidValue;
  const size_t per_frame = ctx_frame_bytes(L, S, lgS, 0, 0);
  cudaError_t err =
      fast ? configure(&scl_chunk_body_kernel<false, false, true>,
                       &scl_chunk_body_kernel<true, false, true>, ctx_dev, per_frame, B,
                       warps_per_block, grid, &kernel, &smem, &blocks, &warps)
      : onehot ? configure(&scl_chunk_body_kernel<false, true, false>,
                           &scl_chunk_body_kernel<true, true, false>, ctx_dev, per_frame, B,
                           warps_per_block, grid, &kernel, &smem, &blocks, &warps)
               : configure(&scl_chunk_body_kernel<false, false, false>,
                           &scl_chunk_body_kernel<true, false, false>, ctx_dev, per_frame, B,
                           warps_per_block, grid, &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      alpha, pm, beta_out, pm_out, r_out, reinterpret_cast<const int4*>(prog), n_ops, has_R,
      B, S, L, lgS, ctx_dev);
  return (int)cudaGetLastError();
}


namespace {
const KernelEntry kKernels[] = {
    {"scl_chunk_body", (const void*)&scl_chunk_body_kernel<false, false, false>,
     &ctx_frame_bytes},
    {"scl_chunk_body_fast", (const void*)&scl_chunk_body_kernel<false, false, true>,
     &ctx_frame_bytes},
    {"scl_chunk_body_onehot", (const void*)&scl_chunk_body_kernel<false, true, false>,
     &ctx_frame_bytes},
    {"scl_chunk_body_devmem", (const void*)&scl_chunk_body_kernel<true, false, false>, nullptr},
    {"scl_chunk_body_fast_devmem", (const void*)&scl_chunk_body_kernel<true, false, true>,
     nullptr},
    {"scl_chunk_body_onehot_devmem", (const void*)&scl_chunk_body_kernel<true, true, false>,
     nullptr},
    {"scl_chunk_body_wide", (const void*)&scl_chunk_body_wide_kernel<false>,
     &ctx_frame_bytes_wide},
    {"scl_chunk_body_wide_devmem", (const void*)&scl_chunk_body_wide_kernel<true>, nullptr},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

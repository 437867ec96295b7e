// K4, scl_last_chunk (replaces polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py,
// make_last_superchunk_pallas): the last chunk, the ascend to the root and the
// butterfly.  The kernel and its device functions are in scl_kernels.cuh and
// scl_device.cuh.  Built with -DSCL_PROFILE (the build's scl_last_profile
// variant) it also exports the stage profile's counters.

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
// blocks of the device-memory mode).  `top` is scratch for the chunk's top
// plane, [B][L][S] floats.
// fast: the node program is a fast one, run by the fast instance.  A wide list
// (32 < L <= 64; beta as 64-bit words) runs the wide instance: exact nodes,
// rank vectors.
extern "C" int scl_last_chunk_launch(const float* llr, const float* alpha, const int* beta,
                                     const int* pend_a, const int* pend_b, const float* pm,
                                     int8_t* u, float* pm_out, float* top,
                                     const int* prog, int n_ops, int has_R, int B, int N, int S,
                                     int L, int t, int lgS, int log2N, int one_a, int one_b,
                                     int onehot, int fast, int warps_per_block, float* ctx_dev,
                                     int grid, void* stream) {
  if (L < 1 || L > kWideListMax || (L > kNarrowListMax && (fast || onehot)))
    return (int)cudaErrorInvalidValue;
  if (L > kNarrowListMax) {
    decltype(&scl_last_chunk_wide_kernel<false>) kernel;
    size_t smem;
    int blocks, warps;
    cudaError_t err = configure(&scl_last_chunk_wide_kernel<false>,
                                &scl_last_chunk_wide_kernel<true>, ctx_dev,
                                last_frame_bytes_wide(L, S, lgS, N, t), B, warps_per_block, grid,
                                &kernel, &smem, &blocks, &warps);
    if (err != cudaSuccess) return (int)err;
    const Geometry g{B, N, S, L, t, lgS};
    kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
        llr, alpha, reinterpret_cast<const WideWord*>(beta), pend_a, pend_b, pm, u, pm_out, top,
        reinterpret_cast<const int4*>(prog), n_ops, has_R, g, log2N, one_a, one_b, ctx_dev);
    return (int)cudaGetLastError();
  }
  decltype(&scl_last_chunk_kernel<false, false, false>) kernel;
  size_t smem;
  int blocks, warps;
  if ((fast && onehot) || (onehot && 2 * t > 32)) return (int)cudaErrorInvalidValue;
  const size_t per_frame = 4 * (size_t)last_ctx_words(L, S, lgS, N, t, onehot);
  cudaError_t err =
      fast ? configure(&scl_last_chunk_kernel<false, false, true>,
                       &scl_last_chunk_kernel<true, false, true>, ctx_dev, per_frame, B,
                       warps_per_block, grid, &kernel, &smem, &blocks, &warps)
      : onehot ? configure(&scl_last_chunk_kernel<false, true, false>,
                           &scl_last_chunk_kernel<true, true, false>, ctx_dev, per_frame, B,
                           warps_per_block, grid, &kernel, &smem, &blocks, &warps)
               : configure(&scl_last_chunk_kernel<false, false, false>,
                           &scl_last_chunk_kernel<true, false, false>, ctx_dev, per_frame, B,
                           warps_per_block, grid, &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, alpha, reinterpret_cast<const uint32_t*>(beta), pend_a, pend_b, pm, u, pm_out, top,
      reinterpret_cast<const int4*>(prog), n_ops, has_R, g, log2N, one_a, one_b, ctx_dev);
  return (int)cudaGetLastError();
}


namespace {
const KernelEntry kKernels[] = {
    {"scl_last_chunk", (const void*)&scl_last_chunk_kernel<false, false, false>,
     &last_frame_bytes<false>},
    {"scl_last_chunk_fast", (const void*)&scl_last_chunk_kernel<false, false, true>,
     &last_frame_bytes<false>},
    {"scl_last_chunk_onehot", (const void*)&scl_last_chunk_kernel<false, true, false>,
     &last_frame_bytes<true>},
    {"scl_last_chunk_devmem", (const void*)&scl_last_chunk_kernel<true, false, false>, nullptr},
    {"scl_last_chunk_fast_devmem", (const void*)&scl_last_chunk_kernel<true, false, true>,
     nullptr},
    {"scl_last_chunk_onehot_devmem", (const void*)&scl_last_chunk_kernel<true, true, false>,
     nullptr},
    {"scl_last_chunk_wide", (const void*)&scl_last_chunk_wide_kernel<false>,
     &last_frame_bytes_wide},
    {"scl_last_chunk_wide_devmem", (const void*)&scl_last_chunk_wide_kernel<true>, nullptr},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

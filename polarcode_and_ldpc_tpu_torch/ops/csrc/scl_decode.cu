// K3, scl_chunk_step (replaces polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py,
// make_superchunk_pallas): one chunk of the list decode on the level stacks of
// a batch, every mode (full and live width, rank and one-hot pendings, context
// in shared or device memory).  The kernel, its device functions and the
// design are in scl_kernels.cuh and scl_device.cuh.  Built with -DSCL_PROFILE
// (the build's scl_decode_profile variant) it also exports the stage
// profile's counters.

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
// lv_in / lv_out: the live paths entering and leaving the chunk (L, L: full
// width); one_a / one_b: level bit masks of the one-lane pendings; onehot:
// pend_a / pend_b are float one-hot planes [B][t][L][L] (full width only, t <= 16);
// fast: the node program is a fast one (full width, rank vectors), run by the
// fast instance.
extern "C" int scl_chunk_step_launch(const float* llr, float* alpha, int* beta, int* pend_a,
                                     int* pend_b, float* pm, const int* prog, int n_ops,
                                     int has_R, int B, int N, int S, int L, int t, int lgS,
                                     int k, int inv, int j, int mask_a, int mask_b, int lv_in,
                                     int lv_out, int one_a, int one_b, int onehot, int fast,
                                     int warps_per_block, float* ctx_dev, int grid,
                                     void* stream) {
  decltype(&scl_chunk_step_kernel<false, false, false, false>) kernel;
  size_t smem;
  int blocks, warps;
  const bool narrow = lv_in < L || lv_out < L;
  if ((narrow && onehot) || (fast && (narrow || onehot)) || (onehot && 2 * t > 32))
    return (int)cudaErrorInvalidValue;
  const size_t per_frame =
      onehot ? step_frame_bytes<true>(L, S, lgS, N, t) : step_frame_bytes<false>(L, S, lgS, N, t);
  cudaError_t err =
      fast ? configure(&scl_chunk_step_kernel<false, false, false, true>,
                       &scl_chunk_step_kernel<true, false, false, true>, ctx_dev, per_frame, B,
                       warps_per_block, grid, &kernel, &smem, &blocks, &warps)
      : narrow ? configure(&scl_chunk_step_kernel<false, true, false, false>,
                           &scl_chunk_step_kernel<true, true, false, false>, ctx_dev, per_frame,
                           B, warps_per_block, grid, &kernel, &smem, &blocks, &warps)
      : onehot ? configure(&scl_chunk_step_kernel<false, false, true, false>,
                           &scl_chunk_step_kernel<true, false, true, false>, ctx_dev, per_frame,
                           B, warps_per_block, grid, &kernel, &smem, &blocks, &warps)
               : configure(&scl_chunk_step_kernel<false, false, false, false>,
                           &scl_chunk_step_kernel<true, false, false, false>, ctx_dev, per_frame,
                           B, warps_per_block, grid, &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  const StepArgs a{k, inv, j, mask_a, mask_b, 0, n_ops, has_R, lv_in, lv_out, one_a, one_b};
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, pm,
      reinterpret_cast<const int4*>(prog), g, a, ctx_dev);
  return (int)cudaGetLastError();
}

namespace {
const KernelEntry kKernels[] = {
    {"scl_chunk_step", (const void*)&scl_chunk_step_kernel<false, false, false, false>,
     &step_frame_bytes<false>},
    {"scl_chunk_step_fast", (const void*)&scl_chunk_step_kernel<false, false, false, true>,
     &step_frame_bytes<false>},
    {"scl_chunk_step_narrow", (const void*)&scl_chunk_step_kernel<false, true, false, false>,
     &step_frame_bytes<false>},
    {"scl_chunk_step_onehot", (const void*)&scl_chunk_step_kernel<false, false, true, false>,
     &step_frame_bytes<true>},
    {"scl_chunk_step_devmem", (const void*)&scl_chunk_step_kernel<true, false, false, false>,
     nullptr},
    {"scl_chunk_step_fast_devmem", (const void*)&scl_chunk_step_kernel<true, false, false, true>,
     nullptr},
    {"scl_chunk_step_narrow_devmem", (const void*)&scl_chunk_step_kernel<true, true, false, false>,
     nullptr},
    {"scl_chunk_step_onehot_devmem", (const void*)&scl_chunk_step_kernel<true, false, true, false>,
     nullptr},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

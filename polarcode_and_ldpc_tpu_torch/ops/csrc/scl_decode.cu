// K3, scl_chunk_step (replaces polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py,
// make_superchunk_pallas): one chunk of the list decode on the level stacks of
// a batch, every mode (rank and one-hot pendings, exact and fast node
// programs, context in shared or device memory); and the live width's
// narrow steps (its widths= mode), the whole narrow prefix of a decode in one
// launch, scl_narrow_prefix.  The kernel, its device functions and the
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

// The launchers run on `stream` and return the cudaGetLastError code (0 =
// ok).  They take `ctx_dev` (null: the context in shared memory; else grid *
// warps_per_block slices of the context in device memory) and `grid` (the
// blocks of the device-memory mode).

// One chunk step at full width (a narrow step runs in
// scl_narrow_prefix_launch).  onehot: pend_a / pend_b are float one-hot planes
// [B][t][L][L] (t <= 16); fast: the node program is a fast one (rank
// vectors), run by the fast instance.  A wide list (32 < L <= 64; beta as
// 64-bit words) runs the wide instance: exact nodes, rank vectors.
extern "C" int scl_chunk_step_launch(const float* llr, float* alpha, int* beta, int* pend_a,
                                     int* pend_b, float* pm, const int* prog, int n_ops,
                                     int has_R, int B, int N, int S, int L, int t, int lgS,
                                     int k, int inv, int j, int mask_a, int mask_b, int onehot,
                                     int fast, int warps_per_block, float* ctx_dev, int grid,
                                     void* stream) {
  if (L < 1 || L > kWideListMax || (L > kNarrowListMax && (fast || onehot)))
    return (int)cudaErrorInvalidValue;
  if (L > kNarrowListMax) {
    decltype(&scl_chunk_step_wide_kernel<false>) kernel;
    size_t smem;
    int blocks, warps;
    cudaError_t err = configure(&scl_chunk_step_wide_kernel<false>,
                                &scl_chunk_step_wide_kernel<true>, ctx_dev,
                                ctx_frame_bytes_wide(L, S, lgS, N, t), B, warps_per_block, grid,
                                &kernel, &smem, &blocks, &warps);
    if (err != cudaSuccess) return (int)err;
    const Geometry g{B, N, S, L, t, lgS};
    const StepArgs a{k, inv, j, mask_a, mask_b, 0, n_ops, has_R, L, L, 0, 0};
    kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
        llr, alpha, reinterpret_cast<WideWord*>(beta), pend_a, pend_b, pm,
        reinterpret_cast<const int4*>(prog), g, a, ctx_dev);
    return (int)cudaGetLastError();
  }
  decltype(&scl_chunk_step_kernel<false, false, false>) kernel;
  size_t smem;
  int blocks, warps;
  if ((fast && onehot) || (onehot && 2 * t > 32)) return (int)cudaErrorInvalidValue;
  const size_t per_frame =
      onehot ? step_frame_bytes<true>(L, S, lgS, N, t) : step_frame_bytes<false>(L, S, lgS, N, t);
  cudaError_t err =
      fast ? configure(&scl_chunk_step_kernel<false, false, true>,
                       &scl_chunk_step_kernel<true, false, true>, ctx_dev, per_frame, B,
                       warps_per_block, grid, &kernel, &smem, &blocks, &warps)
      : onehot ? configure(&scl_chunk_step_kernel<false, true, false>,
                           &scl_chunk_step_kernel<true, true, false>, ctx_dev, per_frame, B,
                           warps_per_block, grid, &kernel, &smem, &blocks, &warps)
               : configure(&scl_chunk_step_kernel<false, false, false>,
                           &scl_chunk_step_kernel<true, false, false>, ctx_dev, per_frame, B,
                           warps_per_block, grid, &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  const StepArgs a{k, inv, j, mask_a, mask_b, 0, n_ops, has_R, L, L, 0, 0};
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, pm,
      reinterpret_cast<const int4*>(prog), g, a, ctx_dev);
  return (int)cudaGetLastError();
}

// The narrow prefix of a live decode in one launch: `rows` [n_rows][12] in
// host memory, each a narrow step's StepArgs (k, inv, j, mask_a, mask_b,
// prog_off, n_ops, has_R, lv_in, lv_out, one_a, one_b; one_a / one_b: level
// bit masks of the pendings kept at one lane), into the launch's parameters
// (1 <= n_rows <= kPrefixParamRows); `prog` the rows' node programs back to
// back.  Rank vectors, exact node programs (the host's SCLPrefixSpec refuses
// others); a row that is not narrow is refused.  A wide list (32 < L <= 64;
// beta as 64-bit words) runs the wide instance.
extern "C" int scl_narrow_prefix_launch(const float* llr, float* alpha, int* beta, int* pend_a,
                                        int* pend_b, float* pm, const int* prog,
                                        const int* rows, int n_rows, int B, int N, int S, int L,
                                        int t, int lgS, int warps_per_block, float* ctx_dev,
                                        int grid, void* stream) {
  if (n_rows < 1 || n_rows > kPrefixParamRows || L < 1 || L > kWideListMax)
    return (int)cudaErrorInvalidValue;
  const bool wide = L > kNarrowListMax;
  decltype(&scl_narrow_prefix_kernel<false>) kernel;
  decltype(&scl_narrow_prefix_wide_kernel<false>) kernel_wide;
  size_t smem;
  int blocks, warps;
  cudaError_t err =
      wide ? configure(&scl_narrow_prefix_wide_kernel<false>, &scl_narrow_prefix_wide_kernel<true>,
                       ctx_dev, ctx_frame_bytes_wide(L, S, lgS, N, t), B, warps_per_block, grid,
                       &kernel_wide, &smem, &blocks, &warps)
           : configure(&scl_narrow_prefix_kernel<false>, &scl_narrow_prefix_kernel<true>,
                       ctx_dev, step_frame_bytes<false>(L, S, lgS, N, t), B, warps_per_block,
                       grid, &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  PrefixSteps steps{};
  steps.n = n_rows;
  for (int r = 0; r < n_rows; ++r) {
    const int* q = rows + 12 * r;
    // a narrow row: 1 <= lv_in <= lv_out <= L with lv_in < L (live counts grow)
    if (q[5] < 0 || q[6] < 0 || q[8] < 1 || q[8] >= L || q[9] < q[8] || q[9] > L)
      return (int)cudaErrorInvalidValue;
    steps.rows[r] = StepArgs{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], q[10],
                             q[11]};
  }
  const Geometry g{B, N, S, L, t, lgS};
  if (wide)
    kernel_wide<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
        llr, alpha, reinterpret_cast<WideWord*>(beta), pend_a, pend_b, pm,
        reinterpret_cast<const int4*>(prog), g, steps, ctx_dev);
  else
    kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
        llr, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, pm,
        reinterpret_cast<const int4*>(prog), g, steps, ctx_dev);
  return (int)cudaGetLastError();
}

// the most rows one scl_narrow_prefix launch takes (kPrefixParamRows)
extern "C" int scl_narrow_prefix_rows() { return kPrefixParamRows; }

namespace {
const KernelEntry kKernels[] = {
    {"scl_chunk_step", (const void*)&scl_chunk_step_kernel<false, false, false>,
     &step_frame_bytes<false>},
    {"scl_chunk_step_fast", (const void*)&scl_chunk_step_kernel<false, false, true>,
     &step_frame_bytes<false>},
    {"scl_chunk_step_onehot", (const void*)&scl_chunk_step_kernel<false, true, false>,
     &step_frame_bytes<true>},
    {"scl_narrow_prefix", (const void*)&scl_narrow_prefix_kernel<false>, &step_frame_bytes<false>},
    {"scl_chunk_step_devmem", (const void*)&scl_chunk_step_kernel<true, false, false>, nullptr},
    {"scl_chunk_step_fast_devmem", (const void*)&scl_chunk_step_kernel<true, false, true>,
     nullptr},
    {"scl_chunk_step_onehot_devmem", (const void*)&scl_chunk_step_kernel<true, true, false>,
     nullptr},
    {"scl_narrow_prefix_devmem", (const void*)&scl_narrow_prefix_kernel<true>, nullptr},
    {"scl_chunk_step_wide", (const void*)&scl_chunk_step_wide_kernel<false>,
     &ctx_frame_bytes_wide},
    {"scl_narrow_prefix_wide", (const void*)&scl_narrow_prefix_wide_kernel<false>,
     &ctx_frame_bytes_wide},
    {"scl_chunk_step_wide_devmem", (const void*)&scl_chunk_step_wide_kernel<true>, nullptr},
    {"scl_narrow_prefix_wide_devmem", (const void*)&scl_narrow_prefix_wide_kernel<true>,
     nullptr},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

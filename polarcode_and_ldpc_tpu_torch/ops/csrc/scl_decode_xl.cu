// K3 (scl_chunk_step) and its narrow prefix (scl_narrow_prefix) for XL lists,
// 65 <= L <= 256: the instances at four paths a lane (L <= 128) and eight
// (L <= 256), in shared or device memory.  The kernels, their device functions
// and the design are in scl_kernels.cuh and scl_device.cuh ("XL LISTS").  A
// source of its own, so that nvcc builds these instances beside scl_decode.cu,
// whose instances (L <= 64) are unchanged.  The launchers take the arguments
// of scl_decode.cu's (beta as kP 32-bit words a position) and refuse a list
// outside 65 .. 256, a fast program and one-hot pendings.

#include "scl_kernels.cuh"

namespace {

template <int kP>
int chunk_step_xl(const float* llr, float* alpha, int* beta, int* pend_a, int* pend_b, float* pm,
                  const int* prog, int n_ops, int has_R, int B, int N, int S, int L, int t,
                  int lgS, int k, int inv, int j, int mask_a, int mask_b, int warps_per_block,
                  float* ctx_dev, int grid, void* stream) {
  decltype(&scl_chunk_step_xl_kernel<false, kP>) kernel;
  size_t smem;
  int blocks, warps;
  cudaError_t err = configure(&scl_chunk_step_xl_kernel<false, kP>,
                              &scl_chunk_step_xl_kernel<true, kP>, ctx_dev,
                              ctx_frame_bytes_xl<kP>(L, S, lgS, N, t), B, warps_per_block, grid,
                              &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  const StepArgs a{k, inv, j, mask_a, mask_b, 0, n_ops, has_R, L, L, 0, 0};
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, pm,
      reinterpret_cast<const int4*>(prog), g, a, ctx_dev);
  return (int)cudaGetLastError();
}

template <int kP>
int narrow_prefix_xl(const float* llr, float* alpha, int* beta, int* pend_a, int* pend_b,
                     float* pm, const int* prog, const PrefixSteps& steps, int B, int N, int S,
                     int L, int t, int lgS, int warps_per_block, float* ctx_dev, int grid,
                     void* stream) {
  decltype(&scl_narrow_prefix_xl_kernel<false, kP>) kernel;
  size_t smem;
  int blocks, warps;
  cudaError_t err = configure(&scl_narrow_prefix_xl_kernel<false, kP>,
                              &scl_narrow_prefix_xl_kernel<true, kP>, ctx_dev,
                              ctx_frame_bytes_xl<kP>(L, S, lgS, N, t), B, warps_per_block, grid,
                              &kernel, &smem, &blocks, &warps);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, pm,
      reinterpret_cast<const int4*>(prog), g, steps, ctx_dev);
  return (int)cudaGetLastError();
}

}  // namespace

// The launchers run on `stream` and return the cudaGetLastError code (0 =
// ok); ctx_dev (null: the context in shared memory) and grid as in
// scl_decode.cu.  One chunk step at full width.
extern "C" int scl_chunk_step_launch(const float* llr, float* alpha, int* beta, int* pend_a,
                                     int* pend_b, float* pm, const int* prog, int n_ops,
                                     int has_R, int B, int N, int S, int L, int t, int lgS,
                                     int k, int inv, int j, int mask_a, int mask_b, int onehot,
                                     int fast, int warps_per_block, float* ctx_dev, int grid,
                                     void* stream) {
  if (L <= kWideListMax || L > kXlListMax || fast || onehot) return (int)cudaErrorInvalidValue;
  return (xl_paths_per_lane(L) == 4 ? &chunk_step_xl<4> : &chunk_step_xl<8>)(
      llr, alpha, beta, pend_a, pend_b, pm, prog, n_ops, has_R, B, N, S, L, t, lgS, k, inv, j,
      mask_a, mask_b, warps_per_block, ctx_dev, grid, stream);
}

// The narrow prefix of a live decode in one launch: `rows` [n_rows][12] in
// host memory (as scl_decode.cu's scl_narrow_prefix_launch).
extern "C" int scl_narrow_prefix_launch(const float* llr, float* alpha, int* beta, int* pend_a,
                                        int* pend_b, float* pm, const int* prog,
                                        const int* rows, int n_rows, int B, int N, int S, int L,
                                        int t, int lgS, int warps_per_block, float* ctx_dev,
                                        int grid, void* stream) {
  if (n_rows < 1 || n_rows > kPrefixParamRows || L <= kWideListMax || L > kXlListMax)
    return (int)cudaErrorInvalidValue;
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
  return (xl_paths_per_lane(L) == 4 ? &narrow_prefix_xl<4> : &narrow_prefix_xl<8>)(
      llr, alpha, beta, pend_a, pend_b, pm, prog, steps, B, N, S, L, t, lgS, warps_per_block,
      ctx_dev, grid, stream);
}

namespace {
const KernelEntry kKernels[] = {
    {"scl_chunk_step_xl4", (const void*)&scl_chunk_step_xl_kernel<false, 4>,
     &ctx_frame_bytes_xl<4>},
    {"scl_chunk_step_xl8", (const void*)&scl_chunk_step_xl_kernel<false, 8>,
     &ctx_frame_bytes_xl<8>},
    {"scl_narrow_prefix_xl4", (const void*)&scl_narrow_prefix_xl_kernel<false, 4>,
     &ctx_frame_bytes_xl<4>},
    {"scl_narrow_prefix_xl8", (const void*)&scl_narrow_prefix_xl_kernel<false, 8>,
     &ctx_frame_bytes_xl<8>},
    {"scl_chunk_step_xl4_devmem", (const void*)&scl_chunk_step_xl_kernel<true, 4>, nullptr},
    {"scl_chunk_step_xl8_devmem", (const void*)&scl_chunk_step_xl_kernel<true, 8>, nullptr},
    {"scl_narrow_prefix_xl4_devmem", (const void*)&scl_narrow_prefix_xl_kernel<true, 4>,
     nullptr},
    {"scl_narrow_prefix_xl8_devmem", (const void*)&scl_narrow_prefix_xl_kernel<true, 8>,
     nullptr},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

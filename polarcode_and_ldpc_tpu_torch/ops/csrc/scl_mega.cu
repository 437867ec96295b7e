// K6, scl_decode_mega (replaces polarcode_and_ldpc_tpu/ops/scl_mega_pallas.py,
// make_scl_mega_pallas): the whole chunked list decode in one launch, one warp
// per frame for the whole decode.  The kernel (scl_kernels.cuh) runs the chunk
// step's device functions on the chunk step's context (no top plane; the root
// plane of the last chunk on dead words), held to 64 registers by its launch
// bounds: 32 warps per SM at the flagship code (N=1024, L=8, S=128), so that
// 4096 frames are one wave on 132 SMs.  The step table travels in the
// launch's parameters for up to 80 chunks (kMegaParamRows), else in device
// memory (scl_decode_mega_long); a single-chunk code has an instance of its
// own (scl_decode_mega_single).  It is bound by instruction issue, as the
// chunk step is.  Built with -DSCL_PROFILE (the build's scl_mega_profile
// variant) it also exports the stage profile's counters.

#define SCL_DECODE_MEGA
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
// llr is [B][N] in natural order; llr_rev, alpha, beta, pend_a, pend_b are
// scratch of the state's shapes (see the top of scl_kernels.cuh; alpha holds
// the L x N plane of a single-chunk code); the step table is [C] MegaRows, in
// host memory (steps_host) and in device memory (steps_dev).
// in_params: the table goes into the launch's parameters (needs C <=
// kMegaParamRows), else the kernel reads it from device memory.
template <typename Steps, bool kSingle>
static cudaError_t launch(const Steps& steps, const float* llr, float* llr_rev, float* alpha,
                          int* beta, int* pend_a, int* pend_b, int8_t* u, float* pm,
                          const int* prog, int C, const Geometry& g, int log2N,
                          int warps_per_block, void* stream) {
  const auto kernel = &scl_decode_mega_kernel<Steps, kSingle>;
  const size_t per_frame = ctx_frame_bytes(g.L, g.S, g.lgS, g.N, g.t);
  const int warps = plan_warps((const void*)kernel, per_frame, warps_per_block);
  const size_t smem = (size_t)warps * per_frame;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (g.B + warps - 1) / warps;
  kernel<<<blocks, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
          llr, llr_rev, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, u, pm,
          reinterpret_cast<const int4*>(prog), steps, C, g, log2N);
  return cudaGetLastError();
}

extern "C" int scl_decode_mega_launch(const float* llr, float* llr_rev, float* alpha, int* beta,
                                      int* pend_a, int* pend_b, int8_t* u, float* pm,
                                      const int* prog, const int* steps_host,
                                      const int* steps_dev, int C, int B, int N, int S, int L,
                                      int t, int lgS, int log2N, int in_params,
                                      int warps_per_block, void* stream) {
  // no wide instance: a list wider than 32 runs on the per-chunk kernels
  if (L < 1 || L > kNarrowListMax) return (int)cudaErrorInvalidValue;
  if (in_params && C > kMegaParamRows) return (int)cudaErrorInvalidValue;
  if (!in_params && t == 0) return (int)cudaErrorInvalidValue;  // one chunk: one row
  const Geometry g{B, N, S, L, t, lgS};
  if (in_params) {
    ParamSteps steps{};
    for (int c = 0; c < C; ++c) {
      const int* r = steps_host + 8 * c;  // a MegaRow, at full width
      steps.rows[c] = StepArgs{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], L, L, 0, 0};
    }
    return (int)(t == 0 ? launch<ParamSteps, true>(steps, llr, llr_rev, alpha, beta, pend_a,
                                                    pend_b, u, pm, prog, C, g, log2N,
                                                    warps_per_block, stream)
                        : launch<ParamSteps, false>(steps, llr, llr_rev, alpha, beta, pend_a,
                                                     pend_b, u, pm, prog, C, g, log2N,
                                                     warps_per_block, stream));
  }
  const DeviceSteps steps{reinterpret_cast<const MegaRow*>(steps_dev)};
  return (int)launch<DeviceSteps, false>(steps, llr, llr_rev, alpha, beta, pend_a, pend_b, u,
                                         pm, prog, C, g, log2N, warps_per_block, stream);
}

namespace {
const KernelEntry kKernels[] = {
    {"scl_decode_mega", (const void*)&scl_decode_mega_kernel<ParamSteps, false>,
     &ctx_frame_bytes},
    {"scl_decode_mega_single", (const void*)&scl_decode_mega_kernel<ParamSteps, true>,
     &ctx_frame_bytes},
    {"scl_decode_mega_long", (const void*)&scl_decode_mega_kernel<DeviceSteps, false>,
     &ctx_frame_bytes},
};
}  // namespace

SCL_KERNEL_REPORT_EXPORTS

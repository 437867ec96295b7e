// Whole-decode LDPC message passing for Hopper (sm_90a): the flooding
// schedule (bp_decode_kernel) and the row-layered min-sum schedule
// (bp_layered_decode_kernel, described above that kernel).
//
// Replaces the TPU kernel polarcode_and_ldpc_tpu/ops/bp_pallas.py
// (make_bp_decoder_pallas): sum-product (tanh clipped to
// +-0.999999, 2*atanh written log1p(p) - log1p(-p)) or min-sum with
// normalization alpha / offset beta, syndrome check, per-frame iteration
// count and early exit, in ONE kernel.
//
// What bounds it: device memory sees 4 bytes in and 1 byte out per code bit
// plus 4 bytes per frame, so the roofline is set by operations: every
// iteration that a frame actually runs costs, per edge, one tanhf and two
// log1pf (sum-product) or a handful of compares (min-sum).  Design: ONE
// THREAD BLOCK PER FRAME.  Both message layouts (var-major V, check-major C),
// the channel LLRs and the hard decisions stay in shared memory for the whole
// decode; the two layouts are linked by gather index tables (no permutation
// tensor, no matrix unit); a frame stops at its own first zero syndrome, so
// the work follows the data, and blocks of converged frames make room for the
// next frames.  Messages are stored slot-major (V[slot*n + v], C[slot*m + c])
// so that neighbouring threads touch neighbouring words.
//
// Exactness: the exclusive prefix/suffix sweeps run over the slots in the
// same order as the plain PyTorch version, the slot sum of the variable
// update is taken in slot order, and the file is compiled without fast-math
// and without multiply-add contraction; min-sum rules are association-free.
//
// Device-memory mode (template argument kDev; a port mode: the JAX package
// runs such codes through XLA): a generic code with padded check degree
// dc_max can need more than one block's 227 KB for a frame (the default
// MacKay (8192, 4096) code: dc_max 19, 761,856 bytes).  Decided on the host by
// size, each block then keeps the same per-frame planes, in the same layout,
// in its own slice of a scratch buffer in device memory that the wrapper
// allocates, and walks frames blockIdx.x, blockIdx.x + gridDim.x, ... (a
// grid of a few blocks per SM, so the scratch does not grow with the batch).
// The arithmetic and its order are the shared-memory kernel's: only the
// address space of the planes differs.  In shared-memory mode the grid is
// one block per frame and the frame loop runs once.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kTanhClip = 0.999999f;
constexpr int RULE_BP = 0;  // sum-product; any other value: min-sum

__device__ __forceinline__ float clipf(float x) {
  return fminf(fmaxf(x, -kTanhClip), kTanhClip);
}

// the per-frame planes of a block: shared memory, or the block's slice of
// the device-memory scratch (`stride` bytes per block)
template <bool kDev>
__device__ __forceinline__ float* frame_planes(float* smem, unsigned char* scratch,
                                               long long stride) {
  return kDev ? reinterpret_cast<float*>(scratch + (size_t)blockIdx.x * stride) : smem;
}

// Run `f(frame)` for this block's frames: its one frame (shared memory, one
// block per frame), or frames blockIdx.x, blockIdx.x + gridDim.x, ... (device
// memory), with a block barrier between two frames on the same planes.
template <bool kDev, typename F>
__device__ __forceinline__ void for_each_frame(int B, F&& f) {
  if (!kDev) {
    f(blockIdx.x);
    return;
  }
  for (int frame = blockIdx.x; frame < B; frame += gridDim.x) {
    f(frame);
    __syncthreads();
  }
}

template <bool kDev>
__global__ void bp_decode_kernel(const float* __restrict__ llr,
                                 int8_t* __restrict__ bits_out,
                                 int* __restrict__ iters_out,
                                 const int* __restrict__ cv_idx,   // [dc*m] index into V, -1 = padded
                                 const int* __restrict__ vc_idx,   // [dv*n] index into C, -1 = padded
                                 const int* __restrict__ chk_var,  // [dc*m] variable of the slot, -1 = padded
                                 int B, int n, int m, int dv, int dc, int max_iter,
                                 int early_stop, int rule, float normalization,
                                 float offset, unsigned char* scratch, long long stride) {
  extern __shared__ __align__(16) float smem[];
  float* V = frame_planes<kDev>(smem, scratch, stride);  // [dv*n] variable-to-check messages
  float* C = V + (size_t)dv * n;  // [dc*m] check-to-variable messages
  float* T = C + (size_t)dc * m;  // [dc*m] sweep scratch
  float* L = T + (size_t)dc * m;  // [n] channel LLRs
  uint8_t* hard = reinterpret_cast<uint8_t*>(L + n);  // [n] hard decisions

  for_each_frame<kDev>(B, [&](int frame) {
    const float* in = llr + (size_t)frame * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      const float l = in[v];
      L[v] = l;
      for (int sp = 0; sp < dv; ++sp) V[sp * n + v] = l;
      hard[v] = l <= 0.0f ? 1 : 0;
    }
    __syncthreads();

    int iters = max_iter;
    for (int it = 0; it < max_iter; ++it) {
      // ---- check-node update: exclusive prefix, then exclusive suffix ----
      for (int c = threadIdx.x; c < m; c += blockDim.x) {
        if (rule == RULE_BP) {
          float run = 1.0f;
          for (int s = 0; s < dc; ++s) {
            const int e = s * m + c;
            const int idx = __ldg(cv_idx + e);
            const float t = idx >= 0 ? clipf(tanhf(V[idx] * 0.5f)) : 1.0f;
            T[e] = t;
            C[e] = run;
            run = run * t;
          }
          run = 1.0f;
          for (int s = dc - 1; s >= 0; --s) {
            const int e = s * m + c;
            const float prod = clipf(C[e] * run);
            C[e] = log1pf(prod) - log1pf(-prod);
            run = run * T[e];
          }
        } else {
          float run_s = 1.0f, run_m = CUDART_INF_F;
          for (int s = 0; s < dc; ++s) {
            const int e = s * m + c;
            const int idx = __ldg(cv_idx + e);
            float sg = 1.0f, mg = CUDART_INF_F;
            if (idx >= 0) {
              const float x = V[idx];
              sg = (float)((x > 0.0f) - (x < 0.0f));
              mg = fabsf(x);
            }
            T[e] = run_s;
            C[e] = run_m;
            run_s = run_s * sg;
            run_m = fminf(run_m, mg);
          }
          run_s = 1.0f;
          run_m = CUDART_INF_F;
          for (int s = dc - 1; s >= 0; --s) {
            const int e = s * m + c;
            const int idx = __ldg(cv_idx + e);
            float sg = 1.0f, mg = CUDART_INF_F;
            if (idx >= 0) {
              const float x = V[idx];
              sg = (float)((x > 0.0f) - (x < 0.0f));
              mg = fabsf(x);
            }
            float mag = fminf(C[e], run_m);
            if (offset != 0.0f) mag = fmaxf(mag - offset, 0.0f);
            float out = (T[e] * run_s) * mag;
            out = out * normalization;
            C[e] = isfinite(out) ? out : 0.0f;
            run_s = run_s * sg;
            run_m = fminf(run_m, mg);
          }
        }
      }
      __syncthreads();

      // ---- variable-node update: total minus self, hard decision ----
      for (int v = threadIdx.x; v < n; v += blockDim.x) {
        float acc = 0.0f;
        for (int sp = 0; sp < dv; ++sp) {
          const int idx = __ldg(vc_idx + sp * n + v);
          const float c2v = idx >= 0 ? C[idx] : 0.0f;
          acc = sp == 0 ? c2v : acc + c2v;
        }
        const float total = L[v] + acc;
        for (int sp = 0; sp < dv; ++sp) {
          const int idx = __ldg(vc_idx + sp * n + v);
          const float c2v = idx >= 0 ? C[idx] : 0.0f;
          V[sp * n + v] = total - c2v;
        }
        hard[v] = total <= 0.0f ? 1 : 0;
      }
      __syncthreads();

      // ---- syndrome; the frame stops at its own first zero syndrome ----
      if (early_stop) {
        int bad = 0;
        for (int c = threadIdx.x; c < m; c += blockDim.x) {
          int parity = 0;
          for (int s = 0; s < dc; ++s) {
            const int v = __ldg(chk_var + s * m + c);
            if (v >= 0) parity ^= hard[v];
          }
          bad |= parity;
        }
        if (!__syncthreads_or(bad)) {
          iters = it + 1;
          break;
        }
      }
    }

    int8_t* out = bits_out + (size_t)frame * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x) out[v] = (int8_t)hard[v];
    if (threadIdx.x == 0) iters_out[frame] = iters;
  });
}

// Row-layered min-sum (schedule="layered" of make_bp_decoder_pallas,
// _layered_iteration): the checks are cut into contiguous layers
// [layer_starts[g], layer_starts[g+1]); within an iteration the layers run one
// after the other, each reading the totals the earlier layers left.
//
// One thread block per frame, as the flooding kernel.  In shared memory for
// the whole decode: the running totals Q [n], the check messages R [dc*m]
// (slot-major), the hard decisions, and for the layer at hand the prefix
// signs T and the prefix minima / deltas D, [dc*layer_checks] each.  The
// TPU kernel's one-hot permutation tensors are the gather tables here.
//
// A layer is TWO PASSES with a block barrier between, because a contiguous
// layer may hold two edges of one variable and every check of the layer
// must read Q before any delta lands:
//   pass 1, threads over the layer's checks: qtemp = Q[v] - R_old per slot,
//     exclusive prefix then suffix sweeps in slot order (sign product with
//     sign(0) = 0, minimum magnitude; a padded slot is the identity: sign 1,
//     magnitude +inf), beta then alpha, a non-finite result -> 0; stores
//     R_new and delta = R_new - R_old;
//   pass 2, threads over the variables: Q[v] += delta of slot sp, for
//     sp = 0..dv-1 in order, where that slot's check lies in the layer.  Each
//     (v, slot) receives from exactly one edge, so this is the plain version's
//     order of additions; no atomics.
// The plain version adds an exact 0.0 for every slot outside the layer; the
// kernel skips those adds.  That can only change the sign of a zero total,
// and Q <= 0, |Q - R| and sign(Q - R) are the same for -0.0 and +0.0.
template <bool kDev>
__global__ void bp_layered_decode_kernel(const float* __restrict__ llr,
                                         int8_t* __restrict__ bits_out,
                                         int* __restrict__ iters_out,
                                         const int* __restrict__ vc_idx,   // [dv*n] index into R, -1 = padded
                                         const int* __restrict__ chk_var,  // [dc*m] variable of the slot, -1 = padded
                                         const int* __restrict__ layer_starts,  // [layers + 1]
                                         int B, int n, int m, int dv, int dc, int layers,
                                         int layer_checks, int max_iter, int early_stop,
                                         float normalization, float offset,
                                         unsigned char* scratch, long long stride) {
  extern __shared__ __align__(16) float smem[];
  float* Q = frame_planes<kDev>(smem, scratch, stride);  // [n] running totals
  float* R = Q + n;                          // [dc*m] check-to-variable messages
  float* T = R + (size_t)dc * m;             // [dc*layer_checks] prefix sign products
  float* D = T + (size_t)dc * layer_checks;  // [dc*layer_checks] prefix minima, then deltas
  uint8_t* hard = reinterpret_cast<uint8_t*>(D + (size_t)dc * layer_checks);  // [n]

  for_each_frame<kDev>(B, [&](int frame) {
    const float* in = llr + (size_t)frame * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      const float l = in[v];
      Q[v] = l;
      hard[v] = l <= 0.0f ? 1 : 0;
    }
    for (int e = threadIdx.x; e < dc * m; e += blockDim.x) R[e] = 0.0f;
    __syncthreads();

    int iters = max_iter;
    for (int it = 0; it < max_iter; ++it) {
      for (int g = 0; g < layers; ++g) {
        const int c0 = __ldg(layer_starts + g), c1 = __ldg(layer_starts + g + 1);
        // ---- pass 1: the layer's checks, all reading Q as the layer found it ----
        for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
          float run_s = 1.0f, run_m = CUDART_INF_F;
          for (int s = 0; s < dc; ++s) {
            const int v = __ldg(chk_var + s * m + c);
            float sg = 1.0f, mg = CUDART_INF_F;
            if (v >= 0) {
              const float x = Q[v] - R[s * m + c];
              sg = (float)((x > 0.0f) - (x < 0.0f));
              mg = fabsf(x);
            }
            const int k = s * layer_checks + (c - c0);
            T[k] = run_s;
            D[k] = run_m;
            run_s = run_s * sg;
            run_m = fminf(run_m, mg);
          }
          run_s = 1.0f;
          run_m = CUDART_INF_F;
          for (int s = dc - 1; s >= 0; --s) {
            const int e = s * m + c, k = s * layer_checks + (c - c0);
            const int v = __ldg(chk_var + e);
            const float r_old = R[e];
            float sg = 1.0f, mg = CUDART_INF_F;
            if (v >= 0) {
              const float x = Q[v] - r_old;
              sg = (float)((x > 0.0f) - (x < 0.0f));
              mg = fabsf(x);
            }
            float mag = fminf(D[k], run_m);
            if (offset != 0.0f) mag = fmaxf(mag - offset, 0.0f);
            float out = (T[k] * run_s) * mag;
            out = out * normalization;
            const float r_new = (v >= 0 && isfinite(out)) ? out : 0.0f;
            D[k] = v >= 0 ? r_new - r_old : 0.0f;
            R[e] = r_new;
            run_s = run_s * sg;
            run_m = fminf(run_m, mg);
          }
        }
        __syncthreads();
        // ---- pass 2: the totals absorb the deltas in variable-slot order ----
        for (int v = threadIdx.x; v < n; v += blockDim.x) {
          float q = Q[v];
          for (int sp = 0; sp < dv; ++sp) {
            const int idx = __ldg(vc_idx + sp * n + v);
            if (idx < 0) continue;
            const int s = idx / m, c = idx - s * m;
            if (c >= c0 && c < c1) q = q + D[s * layer_checks + (c - c0)];
          }
          Q[v] = q;
        }
        __syncthreads();
      }

      for (int v = threadIdx.x; v < n; v += blockDim.x) hard[v] = Q[v] <= 0.0f ? 1 : 0;
      __syncthreads();

      // ---- syndrome after the whole iteration; the frame stops at its own
      // first zero syndrome ----
      if (early_stop) {
        int bad = 0;
        for (int c = threadIdx.x; c < m; c += blockDim.x) {
          int parity = 0;
          for (int s = 0; s < dc; ++s) {
            const int v = __ldg(chk_var + s * m + c);
            if (v >= 0) parity ^= hard[v];
          }
          bad |= parity;
        }
        if (!__syncthreads_or(bad)) {
          iters = it + 1;
          break;
        }
      }
    }

    int8_t* out = bits_out + (size_t)frame * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x) out[v] = (int8_t)hard[v];
    if (threadIdx.x == 0) iters_out[frame] = iters;
  });
}

// Shared memory per block and grid: the planes in shared memory and one block
// per frame, or (scratch given) no dynamic shared memory and `grid` blocks.
template <typename K>
cudaError_t configure(K smem_kernel, K dev_kernel, const void* scratch, long long bytes,
                      int B, int grid, K* kernel, size_t* smem, int* blocks) {
  if (scratch) {
    *kernel = dev_kernel;
    *smem = 0;
    *blocks = grid;
    return cudaSuccess;
  }
  *kernel = smem_kernel;
  *smem = (size_t)bytes;
  *blocks = B;
  return cudaFuncSetAttribute(smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bytes of shared memory one frame (one block) needs
extern "C" long long bp_decode_smem_bytes(int n, int m, int dv, int dc) {
  return ((long long)dv * n + 2LL * dc * m + n) * 4 + n;
}

// Launches on `stream`; returns the cudaGetLastError code (0 = ok).  With
// `scratch` (grid * stride bytes, stride >= bp_decode_smem_bytes rounded up
// to 16) the planes live in device memory and `grid` blocks walk the frames.
extern "C" int bp_decode_launch(const float* llr, int8_t* bits, int* iters,
                                const int* cv_idx, const int* vc_idx,
                                const int* chk_var, int B, int n, int m, int dv,
                                int dc, int max_iter, int early_stop, int rule,
                                float normalization, float offset, int threads,
                                void* scratch, long long stride, int grid, void* stream) {
  decltype(&bp_decode_kernel<false>) kernel;
  size_t smem;
  int blocks;
  cudaError_t err = configure(&bp_decode_kernel<false>, &bp_decode_kernel<true>, scratch,
                              bp_decode_smem_bytes(n, m, dv, dc), B, grid, &kernel, &smem,
                              &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, iters, cv_idx, vc_idx, chk_var, B, n, m, dv, dc, max_iter,
      early_stop, rule, normalization, offset, static_cast<unsigned char*>(scratch), stride);
  return (int)cudaGetLastError();
}

// bytes of shared memory one frame needs in the layered kernel
extern "C" long long bp_layered_decode_smem_bytes(int n, int m, int dc, int layer_checks) {
  return ((long long)n + (long long)dc * m + 2LL * dc * layer_checks) * 4 + n;
}

extern "C" int bp_layered_decode_launch(const float* llr, int8_t* bits, int* iters,
                                        const int* vc_idx, const int* chk_var,
                                        const int* layer_starts, int B, int n, int m,
                                        int dv, int dc, int layers, int layer_checks,
                                        int max_iter, int early_stop, float normalization,
                                        float offset, int threads, void* scratch,
                                        long long stride, int grid, void* stream) {
  decltype(&bp_layered_decode_kernel<false>) kernel;
  size_t smem;
  int blocks;
  cudaError_t err = configure(&bp_layered_decode_kernel<false>, &bp_layered_decode_kernel<true>,
                              scratch, bp_layered_decode_smem_bytes(n, m, dc, layer_checks), B,
                              grid, &kernel, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, iters, vc_idx, chk_var, layer_starts, B, n, m, dv, dc, layers, layer_checks,
      max_iter, early_stop, normalization, offset, static_cast<unsigned char*>(scratch), stride);
  return (int)cudaGetLastError();
}

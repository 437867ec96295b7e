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
// THREAD BLOCK PER FRAME, the frame's messages in shared memory for the whole
// decode; a frame stops at its own first zero syndrome, so the work follows
// the data, and blocks of converged frames make room for the next frames.
//
// Compact edges (ops/bp_cuda.py kernel_tables): every message is addressed
// by its edge e, with no padded slot.  The host orders the checks by degree,
// so that the rows a warp steps together have equal or near degree; check
// position p has row_degree[p] edges, consecutive from edge row_first[p] on
// in the check's slot order (CSR rows, one thread per row).  edge_var[e] is
// the variable of edge e, and vc_edge[sp*n + v] the edge in slot sp of
// variable v (-1: a padded slot of an irregular column).  The flooding
// kernel keeps no variable-to-check plane: the message of edge e into its
// check is total[v] - C[e], the variable's total minus the check's own last
// message, which is the plain version's "total minus self".
//
// Exactness: a padded slot was the identity of every sweep (tanh 1.0, sign 1,
// magnitude +inf, +0.0 in a slot sum), so dropping it changes no bit.  The
// sum-product sweeps run over a check's edges in slot order; min-sum keeps the
// smallest magnitude with its first edge, the second smallest and the parity
// of the negative inputs, from which each edge's exclusive minimum and
// exclusive sign product follow exactly (a minimum and a product of
// {-1, 0, 1} do not depend on association, and the sign of a zero product is
// the parity of its negative factors).  The slot sum of the variable update
// is taken in slot order, and the file is compiled without fast-math and
// without multiply-add contraction.
//
// Device-memory mode (template argument kDev; a port mode: the JAX package
// runs such codes through XLA): a code whose frame needs more than one
// block's 227 KB (a MacKay (4096, 2048) code of column weight 16: 540,672
// bytes for sum-product), decided on the host by size.  Each block then keeps
// the same per-frame planes in its own slice of a scratch buffer in device
// memory that the wrapper allocates, and walks frames blockIdx.x,
// blockIdx.x + gridDim.x, ... (a grid of the blocks that the occupancy
// calculator fits on each SM, so the scratch does not grow with the batch).
// The arithmetic, its order and the tables are the shared-memory kernel's:
// only the address space of the planes differs.  In shared-memory mode the
// grid is one block per frame and the frame loop runs once.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kTanhClip = 0.999999f;
constexpr int RULE_BP = 0;  // sum-product; any other value: min-sum
constexpr int kMaxThreads = 1024;
constexpr float kInf = __builtin_huge_valf();

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

// One check's min-sum update from its inputs x (variable-to-check messages),
// fed in slot order: the exclusive minimum magnitude of edge e is the second
// smallest on the first edge that holds the smallest, the smallest elsewhere;
// its exclusive sign product is +-1 with the sign bit the parity of the other
// negative inputs.  sign(0) = 0 needs no count: another zero input makes the
// exclusive minimum 0, and the product's zero then carries that same sign bit
// (as the prefix/suffix product rounds it).  Offset, sign product,
// normalization and the non-finite -> 0 rule in the plain version's order; a
// degree-1 check gives +inf * alpha -> 0.
struct MinSumRow {
  float min1 = kInf, min2 = kInf;
  int amin = -1, neg = 0;

  __device__ __forceinline__ void add(int e, float x) {
    const float a = fabsf(x);
    if (a < min1) {
      min2 = min1;
      min1 = a;
      amin = e;
    } else {
      min2 = fminf(min2, a);
    }
    neg ^= x < 0.0f;
  }
  __device__ __forceinline__ float message(int e, float x, float normalization,
                                           float offset) const {
    float mag = e == amin ? min2 : min1;
    if (offset != 0.0f) mag = fmaxf(mag - offset, 0.0f);
    float out = (neg ^ (x < 0.0f) ? -1.0f : 1.0f) * mag;
    out = out * normalization;
    return isfinite(out) ? out : 0.0f;
  }
};

// Run `f(e0, d)` for the check positions [p0, p1), a thread per position:
// e0 the position's first edge, d its degree (its edges e0 .. e0 + d - 1).
template <typename F>
__device__ __forceinline__ void for_each_row(int p0, int p1, const int* __restrict__ row_first,
                                             const int* __restrict__ row_degree, F&& f) {
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x)
    f(__ldg(row_first + p), __ldg(row_degree + p));
}

// the frame's syndrome: 1 when some check sees odd parity of the hard
// decisions total <= 0 (a block barrier: every thread gets the block's
// answer)
__device__ __forceinline__ int syndrome_bad(const float* total, const int* __restrict__ row_first,
                                            const int* __restrict__ row_degree,
                                            const int* __restrict__ edge_var, int m) {
  int bad = 0;
  for_each_row(0, m, row_first, row_degree, [&](int e0, int d) {
    if (bad) return;  // this thread has its answer
    int parity = 0;
    for (int e = e0; e < e0 + d; ++e) parity ^= total[__ldg(edge_var + e)] <= 0.0f;
    bad = parity;
  });
  return __syncthreads_or(bad);
}

// Flooding: per iteration the check update over the check positions, the
// variable update over the variables, then the syndrome, each followed by a
// block barrier.  Planes: total [n] (channel LLR plus every check message),
// C [E] (check-to-variable messages), and for sum-product T [E] (the clipped
// tanh of each input, for the suffix sweep).  In the first iteration total is
// the LLR and C is 0, so total - C is the LLR bit for bit (also -0.0).
template <bool kDev>
__global__ void __launch_bounds__(kMaxThreads, 1)
    bp_decode_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits_out,
                     int* __restrict__ iters_out, const int* __restrict__ row_first,
                     const int* __restrict__ row_degree, const int* __restrict__ edge_var,
                     const int* __restrict__ vc_edge, int B,
                     int n, int m, int E, int dv, int rule, int max_iter, int early_stop,
                     float normalization, float offset, unsigned char* scratch,
                     long long stride) {
  extern __shared__ __align__(16) float smem[];
  float* total = frame_planes<kDev>(smem, scratch, stride);  // [n]
  float* C = total + n;                                       // [E]
  float* T = C + E;                                           // [E], sum-product only

  for_each_frame<kDev>(B, [&](int frame) {
    const float* in = llr + (size_t)frame * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x) total[v] = in[v];
    for (int e = threadIdx.x; e < E; e += blockDim.x) C[e] = 0.0f;
    __syncthreads();

    int iters = max_iter;
    for (int it = 0; it < max_iter; ++it) {
      // ---- check-node update over the check positions ----
      for_each_row(0, m, row_first, row_degree, [&](int e0, int d) {
        const int e1 = e0 + d;
        if (rule == RULE_BP) {
          // exclusive prefix product (C holds the input's old message until
          // it is read), then exclusive suffix product
          float run = 1.0f;
          for (int e = e0; e < e1; ++e) {
            const float t = clipf(tanhf((total[__ldg(edge_var + e)] - C[e]) * 0.5f));
            T[e] = t;
            C[e] = run;
            run = run * t;
          }
          run = 1.0f;
          for (int e = e1 - 1; e >= e0; --e) {
            const float prod = clipf(C[e] * run);
            C[e] = log1pf(prod) - log1pf(-prod);
            run = run * T[e];
          }
        } else {
          MinSumRow row;
          for (int e = e0; e < e1; ++e) {
            const float x = total[__ldg(edge_var + e)] - C[e];
            C[e] = x;
            row.add(e, x);
          }
          for (int e = e0; e < e1; ++e) C[e] = row.message(e, C[e], normalization, offset);
        }
      });
      __syncthreads();

      // ---- variable-node update: the channel LLR plus the slot sum ----
      for (int v = threadIdx.x; v < n; v += blockDim.x) {
        float acc = 0.0f;
        for (int sp = 0; sp < dv; ++sp) {
          const int e = __ldg(vc_edge + sp * n + v);
          const float c2v = e >= 0 ? C[e] : 0.0f;
          acc = sp == 0 ? c2v : acc + c2v;
        }
        total[v] = __ldg(in + v) + acc;
      }
      __syncthreads();

      // ---- syndrome; the frame stops at its own first zero syndrome ----
      if (early_stop && !syndrome_bad(total, row_first, row_degree, edge_var, m)) {
        iters = it + 1;
        break;
      }
    }

    int8_t* out = bits_out + (size_t)frame * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x) out[v] = total[v] <= 0.0f ? 1 : 0;
    if (threadIdx.x == 0) iters_out[frame] = iters;
  });
}

// Row-layered min-sum (schedule="layered" of make_bp_decoder_pallas,
// _layered_iteration): the check positions are cut into contiguous layers
// [layer_starts[g], layer_starts[g+1]) (the host orders checks by degree only
// inside a layer), whose edges are the contiguous range
// [row_first[layer start], row_first[layer end]); within an iteration the
// layers run one after the other, each reading the totals the earlier layers
// left.
//
// One thread block per frame, as the flooding kernel.  In shared memory for
// the whole decode: the running totals Q [n] and the check messages R [E];
// for the layer at hand D, one word per edge of the widest layer.  The TPU
// kernel's one-hot permutation tensors are the edge tables here.
//
// A layer is TWO PASSES with a block barrier between, because a contiguous
// layer may hold two edges of one variable and every check of the layer
// must read Q before any delta lands:
//   pass 1, warps over the layer's checks: qtemp = Q[v] - R_old per edge,
//     kept in D, the min-sum update of MinSumRow; then R_new and
//     delta = R_new - R_old (in D);
//   pass 2, threads over the variables: Q[v] += delta of slot sp, for
//     sp = 0..dv-1 in order, where that slot's edge lies in the layer.  Each
//     (v, slot) receives from exactly one edge, so this is the plain version's
//     order of additions; no atomics.
// The plain version adds an exact 0.0 for every slot outside the layer; the
// kernel skips those adds.  That can only change the sign of a zero total,
// and Q <= 0, |Q - R| and sign(Q - R) are the same for -0.0 and +0.0.
template <bool kDev>
__global__ void __launch_bounds__(kMaxThreads, 1)
    bp_layered_decode_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits_out,
                             int* __restrict__ iters_out, const int* __restrict__ row_first,
                             const int* __restrict__ row_degree,
                             const int* __restrict__ edge_var, const int* __restrict__ vc_edge,
                             const int* __restrict__ layer_starts, int B, int n, int m, int E,
                             int dv, int layers, int max_iter, int early_stop,
                             float normalization, float offset, unsigned char* scratch,
                             long long stride) {
  extern __shared__ __align__(16) float smem[];
  float* Q = frame_planes<kDev>(smem, scratch, stride);  // [n] running totals
  float* R = Q + n;                                       // [E] check-to-variable messages
  float* D = R + E;  // [widest layer's edges] qtemp, then deltas

  for_each_frame<kDev>(B, [&](int frame) {
    const float* in = llr + (size_t)frame * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x) Q[v] = in[v];
    for (int e = threadIdx.x; e < E; e += blockDim.x) R[e] = 0.0f;
    __syncthreads();

    int iters = max_iter;
    for (int it = 0; it < max_iter; ++it) {
      for (int g = 0; g < layers; ++g) {
        const int p0 = __ldg(layer_starts + g), p1 = __ldg(layer_starts + g + 1);
        const int eb = __ldg(row_first + p0), ee = __ldg(row_first + p1);
        // ---- pass 1: the layer's checks, all reading Q as the layer found it ----
        for_each_row(p0, p1, row_first, row_degree, [&](int e0, int d) {
          MinSumRow row;
          for (int e = e0; e < e0 + d; ++e) {
            const float x = Q[__ldg(edge_var + e)] - R[e];
            D[e - eb] = x;
            row.add(e, x);
          }
          for (int e = e0; e < e0 + d; ++e) {
            const float r_old = R[e];
            const float r_new = row.message(e, D[e - eb], normalization, offset);
            D[e - eb] = r_new - r_old;
            R[e] = r_new;
          }
        });
        __syncthreads();
        // ---- pass 2: the totals absorb the deltas in variable-slot order ----
        for (int v = threadIdx.x; v < n; v += blockDim.x) {
          float q = Q[v];
          for (int sp = 0; sp < dv; ++sp) {
            const int e = __ldg(vc_edge + sp * n + v);
            if ((unsigned)(e - eb) < (unsigned)(ee - eb)) q = q + D[e - eb];
          }
          Q[v] = q;
        }
        __syncthreads();
      }

      // ---- syndrome after the whole iteration; the frame stops at its own
      // first zero syndrome ----
      if (early_stop && !syndrome_bad(Q, row_first, row_degree, edge_var, m)) {
        iters = it + 1;
        break;
      }
    }

    int8_t* out = bits_out + (size_t)frame * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x) out[v] = Q[v] <= 0.0f ? 1 : 0;
    if (threadIdx.x == 0) iters_out[frame] = iters;
  });
}

// cudaFuncSetAttribute once per device and size: the largest dynamic
// shared-memory size allowed so far for each shared-memory kernel (0
// flooding, 1 layered) on each device
constexpr int kMaxDevices = 64;
std::mutex smem_mu;
size_t smem_allowed[2][kMaxDevices] = {};

cudaError_t allow_smem(const void* kernel, int which, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(smem_mu);
  if (smem <= smem_allowed[which][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) smem_allowed[which][dev] = smem;
  return err;
}

// The kernel mode and its dynamic shared memory: the planes in shared memory,
// or (scratch given) the device-memory kernel with none.  `bytes` is the
// plan's size of one frame's planes; a size below what the kernel addresses
// (`need`), or a block that is not whole warps, is refused.
template <typename K>
cudaError_t configure(K smem_kernel, K dev_kernel, int which, const void* scratch,
                      long long bytes, long long need, int threads, K* kernel, size_t* smem) {
  if (bytes < need || threads < 32 || threads > kMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  if (scratch) {
    *kernel = dev_kernel;
    *smem = 0;
    return cudaSuccess;
  }
  *kernel = smem_kernel;
  *smem = (size_t)bytes;
  return allow_smem((const void*)smem_kernel, which, *smem);
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns the cudaGetLastError code (0 = ok).  `bytes`
// is one frame's planes: the dynamic shared memory of a block, or with
// `scratch` (grid * bytes) the stride of a block's slice, whose `grid`
// blocks then walk the frames.
extern "C" int bp_decode_launch(const float* llr, int8_t* bits, int* iters,
                                const int* row_first, const int* row_degree,
                                const int* edge_var, const int* vc_edge,
                                int B, int n, int m, int E, int dv, int rule, int max_iter,
                                int early_stop, float normalization, float offset, int threads,
                                long long bytes, void* scratch, int grid, void* stream) {
  decltype(&bp_decode_kernel<false>) kernel;
  size_t smem;
  const long long need = ((long long)n + (rule == RULE_BP ? 2LL : 1LL) * E) * 4;
  cudaError_t err = configure(&bp_decode_kernel<false>, &bp_decode_kernel<true>, 0, scratch,
                              bytes, need, threads, &kernel, &smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<scratch ? grid : B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, iters, row_first, row_degree, edge_var, vc_edge, B, n, m, E, dv, rule, max_iter,
      early_stop, normalization, offset, static_cast<unsigned char*>(scratch), bytes);
  return (int)cudaGetLastError();
}

extern "C" int bp_layered_decode_launch(const float* llr, int8_t* bits, int* iters,
                                        const int* row_first, const int* row_degree,
                                        const int* edge_var, const int* vc_edge,
                                        const int* layer_starts, int B,
                                        int n, int m, int E, int dv, int layers,
                                        int layer_edges, int max_iter, int early_stop,
                                        float normalization, float offset, int threads,
                                        long long bytes, void* scratch, int grid,
                                        void* stream) {
  decltype(&bp_layered_decode_kernel<false>) kernel;
  size_t smem;
  const long long need = ((long long)n + E + layer_edges) * 4;
  cudaError_t err = configure(&bp_layered_decode_kernel<false>, &bp_layered_decode_kernel<true>,
                              1, scratch, bytes, need, threads, &kernel, &smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<scratch ? grid : B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, iters, row_first, row_degree, edge_var, vc_edge, layer_starts, B, n, m, E, dv,
      layers, max_iter, early_stop, normalization, offset, static_cast<unsigned char*>(scratch),
      bytes);
  return (int)cudaGetLastError();
}

// Blocks of one kernel mode resident on one SM at `threads` per block and
// `smem` bytes of dynamic shared memory (the occupancy calculator: registers,
// shared memory and threads); a negative value is a CUDA error code.
extern "C" int bp_decode_blocks_per_sm(int layered, int dev, int threads, long long smem) {
  const void* kernel =
      layered ? (dev ? (const void*)&bp_layered_decode_kernel<true>
                     : (const void*)&bp_layered_decode_kernel<false>)
              : (dev ? (const void*)&bp_decode_kernel<true>
                     : (const void*)&bp_decode_kernel<false>);
  cudaError_t err = dev ? cudaSuccess : allow_smem(kernel, layered ? 1 : 0, (size_t)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, (size_t)smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

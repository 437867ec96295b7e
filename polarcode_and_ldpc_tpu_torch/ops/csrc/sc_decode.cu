// Whole-decode successive-cancellation (SC) polar decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel polarcode_and_ldpc_tpu/ops/sc_mega_pallas.py
// (make_sc_decoder_mega): the full f/g recursion of one frame with rate-0 /
// REP (always) and rate-1 / SPC (under fast_nodes) node shortcuts, then the
// butterfly u = beta * G, in ONE kernel.
//
// What bounds it: 4 bytes in + 1 byte out per code bit and N*log2(N) cheap
// f/g operations per frame put the roofline at the memory rate; in practice
// the decode is latency bound: it is a chain of a few hundred dependent steps,
// most of them narrower than a warp.  Design: ONE WARP PER FRAME.  The level
// stack of alphas (2N floats) and the partial sums (N bytes) of a frame live
// in shared memory for the whole decode, every step is followed by a
// __syncwarp (no block-wide barrier), and several independent warps per block
// and blocks per SM hide each other's latency.  Device memory is touched
// twice: the coalesced LLR read and the coalesced bit write.
//
// Storage is bit-reversed inside shared memory so every even/odd split of the
// natural-order recursion is a contiguous half split and the combine is an
// in-place XOR of the second half into the first; the caller sees natural
// order on both sides (the permutation happens on the way in and out).
//
// The node program (F, G, COMBINE and the leaf kinds) is built on the host
// from the frozen mask and read from global memory, so one compiled kernel
// serves every code.  All arithmetic is exact in float32 (sign-bit XOR on
// min(|a|,|b|), +-1 multiplies, hard decisions, XORs); REP sums by the same
// halving adds as the plain PyTorch version, and SPC takes the first minimum
// in natural order, so the output equals the plain version bit for bit.
//
// Subtree mode (sc_decode_sub_launch; replaces the TPU kernel's hybrid
// sub-kernel, sc_mega_pallas.py _make_sub_kernel): for a code whose frame
// does not fit one block (9*N bytes), the host runs the top f/g levels and
// launches this kernel once per size-n subtree on its contiguous slice of
// bit-reversed storage, with the subtree's own node program.  The slice IS
// the subtree's bit-reversed storage, so the kernel reads alpha and writes
// beta in storage order: no bit reversal and no butterfly inside.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op : int {
  OP_F = 0,        // a = depth, b = half
  OP_G = 1,        // a = depth, b = half, c = beta offset of the left child
  OP_COMBINE = 2,  // b = half, c = beta offset
  OP_RATE0 = 3,    // b = size, c = beta offset
  OP_HARD = 4,     // a = depth, b = size, c = beta offset (info leaf, rate-1)
  OP_REP = 5,      // a = depth, b = size, c = beta offset
  OP_SPC = 6       // a = depth, b = size, c = beta offset
};

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float f_minsum(float a, float b) {
  float m = fminf(fabsf(a), fabsf(b));
  uint32_t s = (__float_as_uint(a) ^ __float_as_uint(b)) & 0x80000000u;
  return __uint_as_float(__float_as_uint(m) | s);
}

// offset of the alpha vector of depth d (length N >> d) in the level stack
__device__ __forceinline__ int level_base(int N, int d) {
  return 2 * N - ((2 * N) >> d);
}

__global__ void sc_decode_kernel(const float* __restrict__ llr,
                                 int8_t* __restrict__ u,
                                 const int4* __restrict__ prog, int n_ops,
                                 int B, int N, int log2N, int subtree) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int frame = blockIdx.x * warps + warp;
  if (frame >= B) return;  // whole warp leaves together; no block barrier used

  float* alpha = reinterpret_cast<float*>(smem_raw) + (size_t)warp * 2 * N;
  int8_t* beta = reinterpret_cast<int8_t*>(
                     reinterpret_cast<float*>(smem_raw) + (size_t)warps * 2 * N) +
                 (size_t)warp * N;

  // channel LLRs into level 0, bit-reversed storage
  const float* in = llr + (size_t)frame * N;
  const int shift = 32 - log2N;
  for (int i = lane; i < N; i += kWarp) {
    int r = (log2N && !subtree) ? (int)(__brev((unsigned)i) >> shift) : i;
    alpha[r] = in[i];
  }
  __syncwarp();

  for (int pc = 0; pc < n_ops; ++pc) {
    const int4 op = __ldg(prog + pc);
    const int d = op.y, sz = op.z, boff = op.w;
    switch (op.x) {
      case OP_F: {
        const float* src = alpha + level_base(N, d);
        float* dst = alpha + level_base(N, d + 1);
        for (int i = lane; i < sz; i += kWarp) dst[i] = f_minsum(src[i], src[i + sz]);
        break;
      }
      case OP_G: {
        const float* src = alpha + level_base(N, d);
        float* dst = alpha + level_base(N, d + 1);
        const int8_t* bl = beta + boff;
        for (int i = lane; i < sz; i += kWarp) {
          float sgn = 1.0f - 2.0f * (float)bl[i];
          dst[i] = src[i + sz] + sgn * src[i];
        }
        break;
      }
      case OP_COMBINE: {
        int8_t* b = beta + boff;
        for (int i = lane; i < sz; i += kWarp) b[i] ^= b[i + sz];
        break;
      }
      case OP_RATE0: {
        int8_t* b = beta + boff;
        for (int i = lane; i < sz; i += kWarp) b[i] = 0;
        break;
      }
      case OP_HARD: {
        const float* src = alpha + level_base(N, d);
        int8_t* b = beta + boff;
        for (int i = lane; i < sz; i += kWarp) b[i] = src[i] < 0.0f ? 1 : 0;
        break;
      }
      case OP_REP: {
        // sum by halving adds (the g chain with all partial sums zero):
        // first through the free deeper levels of the stack, then by shuffles
        int dd = d, h = sz;
        while (h > kWarp) {
          h >>= 1;
          const float* src = alpha + level_base(N, dd);
          float* dst = alpha + level_base(N, dd + 1);
          for (int i = lane; i < h; i += kWarp) dst[i] = src[i + h] + src[i];
          ++dd;
          __syncwarp();
        }
        const float* src = alpha + level_base(N, dd);
        float v = lane < h ? src[lane] : 0.0f;
        for (int s = h >> 1; s >= 1; s >>= 1) {
          float other = __shfl_down_sync(kFull, v, s);
          v = other + v;  // lanes < s hold the live partial sums
        }
        v = __shfl_sync(kFull, v, 0);
        const int8_t bit = v < 0.0f ? 1 : 0;
        int8_t* b = beta + boff;
        for (int i = lane; i < sz; i += kWarp) b[i] = bit;
        break;
      }
      case OP_SPC: {
        const float* src = alpha + level_base(N, d);
        int8_t* b = beta + boff;
        const int lg = 31 - __clz(sz);
        int ones = 0;
        float best_mag = __int_as_float(0x7f800000);  // +inf
        int best_nat = sz;                            // natural-order position
        int best_pos = 0;                             // storage position
        for (int i = lane; i < sz; i += kWarp) {
          float a = src[i];
          int bit = a < 0.0f ? 1 : 0;
          b[i] = (int8_t)bit;
          ones += bit;
          float mag = fabsf(a);
          int nat = (int)(__brev((unsigned)i) >> (32 - lg));
          if (mag < best_mag || (mag == best_mag && nat < best_nat)) {
            best_mag = mag; best_nat = nat; best_pos = i;
          }
        }
        for (int s = kWarp / 2; s >= 1; s >>= 1) {
          ones += __shfl_xor_sync(kFull, ones, s);
          float om = __shfl_xor_sync(kFull, best_mag, s);
          int on = __shfl_xor_sync(kFull, best_nat, s);
          int op_ = __shfl_xor_sync(kFull, best_pos, s);
          if (om < best_mag || (om == best_mag && on < best_nat)) {
            best_mag = om; best_nat = on; best_pos = op_;
          }
        }
        __syncwarp();
        if ((ones & 1) && lane == 0) b[best_pos] ^= 1;
        break;
      }
      default:
        break;
    }
    __syncwarp();
  }

  int8_t* out = u + (size_t)frame * N;
  if (subtree) {  // beta in storage order: the host combines and transforms
    for (int i = lane; i < N; i += kWarp) out[i] = beta[i];
    return;
  }
  // butterfly u = beta * G in storage order (F^(x)n is invariant under the
  // simultaneous row and column bit reversal), then natural order on the way out
  for (int s = 1; s < N; s <<= 1) {
    for (int idx = lane; idx < N / 2; idx += kWarp) {
      int j = ((idx / s) * 2 * s) + (idx % s);
      beta[j] ^= beta[j + s];
    }
    __syncwarp();
  }
  for (int i = lane; i < N; i += kWarp) {
    int r = log2N ? (int)(__brev((unsigned)i) >> shift) : 0;
    out[i] = beta[r];
  }
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bytes of shared memory one frame (one warp) needs
extern "C" int sc_decode_smem_per_frame(int N) { return 2 * N * 4 + N; }

namespace {

int launch(const float* in, int8_t* out, const int* prog, int n_ops, int B, int N,
           int log2N, int warps_per_block, int subtree, void* stream) {
  const size_t smem = (size_t)warps_per_block * sc_decode_smem_per_frame(N);
  cudaError_t err = cudaFuncSetAttribute(
      sc_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps_per_block - 1) / warps_per_block;
  sc_decode_kernel<<<blocks, warps_per_block * kWarp, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      in, out, reinterpret_cast<const int4*>(prog), n_ops, B, N, log2N, subtree);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaGetLastError code (0 = ok).
// llr [B][N] natural order -> u [B][N] natural order.
extern "C" int sc_decode_launch(const float* llr, int8_t* u, const int* prog,
                                int n_ops, int B, int N, int log2N,
                                int warps_per_block, void* stream) {
  return launch(llr, u, prog, n_ops, B, N, log2N, warps_per_block, 0, stream);
}

// One hybrid subtree: alpha [B][n] -> beta [B][n], both in storage order.
extern "C" int sc_decode_sub_launch(const float* alpha, int8_t* beta, const int* prog,
                                    int n_ops, int B, int n, int log2n,
                                    int warps_per_block, void* stream) {
  return launch(alpha, beta, prog, n_ops, B, n, log2n, warps_per_block, 1, stream);
}

// Whole-decode successive-cancellation (SC) polar decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel polarcode_and_ldpc_tpu/ops/sc_mega_pallas.py
// (make_sc_decoder_mega): the full f/g recursion of one frame with rate-0 /
// REP (always) and rate-1 / SPC (under fast_nodes) node shortcuts, then the
// butterfly u = beta * G, in ONE kernel.
//
// What bounds it: 4 bytes in + 1 byte out per code bit and N*log2(N) cheap
// f/g operations per frame put the roofline at the memory rate; in practice
// the decode is latency bound: a frame is a chain of dependent steps, most of
// them narrower than a warp, so the design is about how many independent
// frames an SM holds and how short each frame's chain is.
//
// - One warp per frame (a subtree frame: several warps, see below).  The
//   level stack of alphas and the partial sums live in shared memory, every
//   op is followed by a __syncwarp, and the blocks per SM hide each other's
//   latency; the host plans the launch for the fewest waves
//   (sc_mega_cuda.plan_sc_launch).
// - A node of 32 positions is ONE op decoded in registers (reg_node: lane i
//   holds alpha_i, f and g by shuffles, hard decisions and SPC's parity by
//   ballot, the combine by one shuffle), so the program has a third of the
//   rows and no op narrower than a warp.
// - The wide F / G move four positions a thread by 16-byte loads and stores,
//   COMBINE and the butterfly four partial sums a word.
//
// Storage is bit-reversed inside shared memory so every even/odd split of the
// natural-order recursion is a contiguous half split and the combine is an
// in-place XOR of the second half into the first; the caller sees natural
// order on both sides (the permutation happens on the way in and out).
//
// The node program (F, G, COMBINE, the leaf kinds and the register nodes) is
// built on the host from the frozen mask and read from global memory, so one
// compiled kernel serves every code.  All arithmetic is exact in float32
// (sign-bit XOR on min(|a|,|b|), +-1 multiplies, hard decisions, XORs); REP
// sums by the same halving adds as the plain PyTorch version, and SPC takes
// the first minimum in natural order, so the output equals the plain version
// bit for bit.
//
// Subtree mode (sc_decode_sub_launch; replaces the TPU kernel's hybrid
// sub-kernel, sc_mega_pallas.py _make_sub_kernel): for a code whose frame
// does not fit one block (9*N bytes), the host runs the top f/g levels and
// launches this kernel once per size-n subtree on its contiguous slice of
// bit-reversed storage, with the subtree's own node program.  The slice IS
// the subtree's bit-reversed storage, so the kernel reads alpha and writes
// beta in storage order: no bit reversal and no butterfly inside.  The top
// `c` levels of such a frame's stack stay in device memory (level 0 is the
// input itself), so several frames share an SM (n = 16384: 24,576 instead of
// 147,456 bytes of shared memory per frame, 8 frames per SM instead of 1),
// and a frame runs on several warps of its own block: ops of at least a
// frame's threads on all of them between block barriers, the others on the
// first warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

// Stage profile (compile with -DSC_PROFILE; the normal build has none of
// it): lane 0 of each warp adds the clock64() cycles of the program fetch,
// of each op by kind and size class, and of the copies in and out to a
// per-thread table, which the kernel adds to device-global counters at the
// end of its frame.  The clock reads stretch the kernel: read the split as
// shares, not as times.
enum ProfSlot : int {
  PROF_FETCH = 0, PROF_F_WIDE, PROF_F_SMALL, PROF_G_WIDE, PROF_G_SMALL, PROF_COMBINE_WIDE,
  PROF_COMBINE_SMALL, PROF_RATE0, PROF_HARD, PROF_REP, PROF_SPC, PROF_NODE, PROF_COPY_IN,
  PROF_COPY_OUT, PROF_FRAME, kProfSlots
};
#ifdef SC_PROFILE
__device__ unsigned long long g_prof[2 * kProfSlots];  // cycles, then counts
#define SC_PROF_DECL unsigned long long prof[2 * kProfSlots] = {}
#define SC_PROF_T(name) long long name = clock64()
#define SC_PROF_ADD(slot, t0)                                         \
  do {                                                                \
    if (tid == 0) {                                                   \
      prof[(slot)] += (unsigned long long)(clock64() - (t0));         \
      prof[kProfSlots + (slot)] += 1ull;                              \
    }                                                                 \
  } while (0)
// the fetch is timed to the branch on the op's kind (the first use of the
// load), the op from there to its __syncwarp
#define SC_PROF_OP_DECL \
  long long t_op = 0;   \
  int slot = 0
#define SC_PROF_OP(kind)           \
  t_op = clock64();                \
  SC_PROF_ADD(PROF_FETCH, t_fetch); \
  slot = (kind)
#define SC_PROF_FLUSH()                                               \
  do {                                                                \
    if (tid == 0)                                                     \
      for (int q = 0; q < 2 * kProfSlots; ++q)                        \
        if (prof[q]) atomicAdd(&g_prof[q], prof[q]);                  \
  } while (0)
#else
#define SC_PROF_DECL
#define SC_PROF_T(name)
#define SC_PROF_ADD(slot, t0)
#define SC_PROF_OP_DECL
#define SC_PROF_OP(kind)
#define SC_PROF_FLUSH()
#endif

enum Op : int {
  OP_F = 0,        // a = depth, b = half
  OP_G = 1,        // a = depth, b = half, c = beta offset of the left child
  OP_COMBINE = 2,  // b = half, c = beta offset
  OP_RATE0 = 3,    // b = size, c = beta offset
  OP_HARD = 4,     // a = depth, b = size, c = beta offset (info leaf, rate-1)
  OP_REP = 5,      // a = depth, b = size, c = beta offset
  OP_SPC = 6,      // a = depth, b = size, c = beta offset
  // a node of size 32 decoded in registers (reg_node), exact or with the
  // rate-1 / SPC shortcuts: a = its frozen pattern (bit i: storage position
  // i of the node), b = 32, c = beta offset
  OP_NODE = 7,
  OP_NODE_FAST = 8
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

// Where a frame's level stack lives: levels 0..c-1 in device memory (level 0
// is the launch's own input, read in place; levels 1..c-1 a per-frame slice
// of the scratch), levels c.. and the partial sums in shared memory.
struct Frame {
  const float* in;  // level 0 when c > 0
  float* dev;       // levels 1..c-1
  float* sh;        // levels c..log2N
  int8_t* beta;
  int N, c;
  __device__ __forceinline__ const float* dev_level(int d) const {
    return d == 0 ? in : dev + (level_base(N, d) - N);
  }
  __device__ __forceinline__ float* dev_out(int d) const {  // d >= 1: written by F / G
    return dev + (level_base(N, d) - N);
  }
  __device__ __forceinline__ float* sh_level(int d) const {
    return sh + (level_base(N, d) - level_base(N, c));
  }
  // either, as a generic pointer, for the rare ops that may touch both kinds
  // (level 0 in device memory is only read)
  __device__ __forceinline__ float* level(int d) const {
    return d >= c ? sh_level(d) : d == 0 ? const_cast<float*>(in) : dev_out(d);
  }
};

// F and G over `sz` positions by the threads t = 0..nt-1 (a warp's lanes, or
// all the warps of a frame); with `v4`, four positions at a time (16-byte
// loads and stores: `sz` a multiple of 4, every pointer 16-byte aligned),
// each position computed alike
__device__ __forceinline__ float g_one(float a, float b, uint32_t bit) {
  float sgn = 1.0f - 2.0f * (float)bit;
  return b + sgn * a;
}

__device__ __forceinline__ void op_f(const float* src, float* dst, int sz, int t, int nt,
                                     bool v4) {
  if (v4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int q = sz / 4;
    for (int i = t; i < q; i += nt) {
      const float4 a = s4[i], b = s4[i + q];
      d4[i] = make_float4(f_minsum(a.x, b.x), f_minsum(a.y, b.y), f_minsum(a.z, b.z),
                          f_minsum(a.w, b.w));
    }
    return;
  }
  for (int i = t; i < sz; i += nt) dst[i] = f_minsum(src[i], src[i + sz]);
}

__device__ __forceinline__ void op_g(const float* src, float* dst, const int8_t* bl, int sz,
                                     int t, int nt, bool v4) {
  if (v4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const uint32_t* b4 = reinterpret_cast<const uint32_t*>(bl);
    const int q = sz / 4;
    for (int i = t; i < q; i += nt) {
      const float4 a = s4[i], b = s4[i + q];
      const uint32_t w = b4[i];  // four partial-sum bytes, each 0 or 1
      d4[i] = make_float4(g_one(a.x, b.x, w & 0xffu), g_one(a.y, b.y, (w >> 8) & 0xffu),
                          g_one(a.z, b.z, (w >> 16) & 0xffu), g_one(a.w, b.w, w >> 24));
    }
    return;
  }
  for (int i = t; i < sz; i += nt) dst[i] = g_one(src[i], src[i + sz], (uint32_t)bl[i]);
}

// One node of size K <= 32 decoded in registers, as the node program would
// decode it op by op: lane i holds the node's alpha_i (i < K, storage order)
// and gets back its beta_i; `fz` is the node's frozen pattern (bit i: storage
// position i), warp-uniform, so every branch is taken by the whole warp and
// every shuffle has all 32 lanes.  Lanes >= K carry values nobody reads.
// The kinds follow build_sc_program_rev: rate-0, an info leaf, REP, and with
// `fast` rate-1 and SPC; a split runs f and g by shuffles (the same
// f_minsum and b + sgn * a as OP_F / OP_G), and the combine by one shuffle.
template <int K>
__device__ __forceinline__ int reg_node(float a, uint32_t fz, bool fast, int lane) {
  const int frozen = __popc(fz);
  if (frozen == K) return 0;  // rate-0
  const int bit = a < 0.0f ? 1 : 0;
  if constexpr (K == 1) {
    return bit;  // info leaf
  } else {
    if (frozen == K - 1 && !((fz >> (K - 1)) & 1u)) {  // REP: OP_REP's halving adds
      float v = a;
      for (int s = K / 2; s >= 1; s >>= 1) v = __shfl_down_sync(kFull, v, s) + v;
      return __shfl_sync(kFull, v, 0) < 0.0f ? 1 : 0;
    }
    if (fast && frozen == 0) return bit;  // rate-1
    if (fast && frozen == 1 && (fz & 1u)) {  // SPC: flip the first minimum, natural order
      const uint32_t live = K == 32 ? kFull : (1u << (K % 32)) - 1u;
      if (!(__popc(__ballot_sync(kFull, bit) & live) & 1)) return bit;
      // (|a| bits, natural position) in one key: the order of OP_SPC's
      // comparison; a lane out of the node (or a NaN) is no candidate
      const float mag = fabsf(a);
      constexpr int lg = K == 2 ? 1 : K == 4 ? 2 : K == 8 ? 3 : K == 16 ? 4 : 5;
      const uint32_t nat = __brev((unsigned)lane) >> (32 - lg);
      uint64_t key = (lane < K && mag == mag)
                         ? ((uint64_t)__float_as_uint(mag) << 32) | nat
                         : ((uint64_t)0x7f800000u << 32) | (uint32_t)K;
      for (int s = K / 2; s >= 1; s >>= 1) {
        const uint64_t other = __shfl_xor_sync(kFull, key, s);
        key = other < key ? other : key;
      }
      return bit ^ (lane < K && (uint32_t)key == nat ? 1 : 0);
    }
    constexpr int H = K / 2;
    const float hi = __shfl_down_sync(kFull, a, H);  // lanes < H: alpha_{i+H}
    const int bl = reg_node<H>(f_minsum(a, hi), fz & ((1u << H) - 1u), fast, lane);
    const float sgn = 1.0f - 2.0f * (float)bl;
    const int br = reg_node<H>(hi + sgn * a, fz >> H, fast, lane);
    const int up = __shfl_up_sync(kFull, br, H);
    return lane < H ? (bl ^ br) : up;
  }
}

// alpha floats of the level stack that a frame keeps in shared memory, and
// in its slice of the device-memory scratch (levels 1..c-1, rounded up to 16
// bytes so that every frame's slice starts on a 16-byte boundary)
__host__ __device__ __forceinline__ int shared_levels_floats(int N, int c) {
  return (2 * N) >> c;
}
__host__ __device__ __forceinline__ int dev_scratch_floats(int N, int c) {
  return c > 1 ? (N - ((2 * N) >> c) + 3) / 4 * 4 : 0;
}

// The barrier of one frame's `nt` threads: its warp, or, when a frame has
// several warps, its block (such a block holds one frame).  A named barrier
// per frame of a block would cost the kernel its occupancy: with a runtime
// barrier id all 16 barriers are reserved, and an SM held a third of the
// blocks (measured on an H100; PERF.md, section 6).
__device__ __forceinline__ void frame_sync(int nt) {
  if (nt == kWarp)
    __syncwarp();
  else
    __syncthreads();
}

// at most 8 warps a block and 64 registers a thread: the 32 resident warps per
// SM that the host's launch plan counts on
__global__ void __launch_bounds__(256, 4) sc_decode_kernel(const float* __restrict__ llr,
                                 int8_t* __restrict__ u,
                                 const int4* __restrict__ prog, int n_ops,
                                 int B, int N, int log2N, int subtree,
                                 float* __restrict__ scratch, int c, int wpf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int frames = blockDim.x / (kWarp * wpf);  // frames per block
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int fib = warp / wpf;                      // the frame's place in the block
  const int sub = warp - fib * wpf;                // the warp's place in its frame
  const int tid = sub * kWarp + lane, nthr = wpf * kWarp;
  const int frame = blockIdx.x * frames + fib;
  if (frame >= B) return;  // a frame's warps leave together; no block barrier used

  const int sh_floats = shared_levels_floats(N, c);
  Frame fr;
  fr.N = N;
  fr.c = c;
  fr.sh = reinterpret_cast<float*>(smem_raw) + (size_t)fib * sh_floats;
  fr.beta = reinterpret_cast<int8_t*>(reinterpret_cast<float*>(smem_raw) +
                                      (size_t)frames * sh_floats) +
            (size_t)fib * N;
  const float* in = llr + (size_t)frame * N;
  fr.in = in;
  fr.dev = scratch + (size_t)frame * dev_scratch_floats(N, c);
  // level 0 in place: four positions a load only on a 16-byte boundary
  const bool vec_in = c == 0 || (N % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0);
  int8_t* beta = fr.beta;

  SC_PROF_DECL;
  SC_PROF_T(t_frame);
  const int shift = 32 - log2N;  // bit reversal of log2N bits
  if (c == 0) {  // channel LLRs into level 0, bit-reversed storage
    for (int i = tid; i < N; i += nthr) {
      int r = (log2N && !subtree) ? (int)(__brev((unsigned)i) >> shift) : i;
      fr.sh[r] = in[i];
    }
    frame_sync(nthr);
  }
  SC_PROF_ADD(PROF_COPY_IN, t_frame);

  // An op over at least a frame's threads (F, G, COMBINE, rate-0, HARD) runs
  // on all the frame's warps, between frame barriers; any other op on its
  // first warp alone, which the others wait for at the next wide op.
  bool prev_all = true;
  for (int pc = 0; pc < n_ops; ++pc) {
    SC_PROF_T(t_fetch);
    const int4 op = __ldg(prog + pc);
    const int d = op.y, sz = op.z, boff = op.w;
    const bool all = nthr > kWarp && sz >= nthr && op.x <= OP_HARD;
    if (nthr > kWarp) {
      if (all && !prev_all) frame_sync(nthr);
      prev_all = all;
      if (!all && sub != 0) continue;
    }
    const int t = all ? tid : lane, nt = all ? nthr : kWarp;
    SC_PROF_OP_DECL;
    switch (op.x) {
      case OP_F: {
        SC_PROF_OP(sz >= kWarp ? PROF_F_WIDE : PROF_F_SMALL);
        const bool v4 = sz >= 4 * nt && (d > 0 || vec_in);
        if (d >= c)
          op_f(fr.sh_level(d), fr.sh_level(d + 1), sz, t, nt, v4);
        else if (d + 1 >= c)
          op_f(fr.dev_level(d), fr.sh_level(d + 1), sz, t, nt, v4);
        else
          op_f(fr.dev_level(d), fr.dev_out(d + 1), sz, t, nt, v4);
        break;
      }
      case OP_G: {
        SC_PROF_OP(sz >= kWarp ? PROF_G_WIDE : PROF_G_SMALL);
        const bool v4 = sz >= 4 * nt && (d > 0 || vec_in);
        if (d >= c)
          op_g(fr.sh_level(d), fr.sh_level(d + 1), beta + boff, sz, t, nt, v4);
        else if (d + 1 >= c)
          op_g(fr.dev_level(d), fr.sh_level(d + 1), beta + boff, sz, t, nt, v4);
        else
          op_g(fr.dev_level(d), fr.dev_out(d + 1), beta + boff, sz, t, nt, v4);
        break;
      }
      case OP_COMBINE: {
        SC_PROF_OP(sz >= kWarp ? PROF_COMBINE_WIDE : PROF_COMBINE_SMALL);
        int8_t* b = beta + boff;
        if (sz >= 4 * nt) {  // four partial sums a word
          uint32_t* w = reinterpret_cast<uint32_t*>(b);
          for (int i = t; i < sz / 4; i += nt) w[i] ^= w[i + sz / 4];
        } else {
          for (int i = t; i < sz; i += nt) b[i] ^= b[i + sz];
        }
        break;
      }
      case OP_RATE0: {
        SC_PROF_OP(PROF_RATE0);
        int8_t* b = beta + boff;
        for (int i = t; i < sz; i += nt) b[i] = 0;
        break;
      }
      case OP_HARD: {
        SC_PROF_OP(PROF_HARD);
        const float* src = fr.level(d);
        int8_t* b = beta + boff;
        for (int i = t; i < sz; i += nt) b[i] = src[i] < 0.0f ? 1 : 0;
        break;
      }
      case OP_REP: {
        SC_PROF_OP(PROF_REP);
        // sum by halving adds (the g chain with all partial sums zero):
        // first through the free deeper levels of the stack, then by shuffles
        int dd = d, h = sz;
        while (h > kWarp) {
          h >>= 1;
          const float* src = fr.level(dd);
          float* dst = fr.level(dd + 1);
          for (int i = lane; i < h; i += kWarp) dst[i] = src[i + h] + src[i];
          ++dd;
          __syncwarp();
        }
        const float* src = fr.level(dd);
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
        SC_PROF_OP(PROF_SPC);
        const float* src = fr.level(d);
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
      case OP_NODE:
      case OP_NODE_FAST: {
        SC_PROF_OP(PROF_NODE);
        const int dn = log2N - 5;  // the depth of a size-32 node
        const float a = dn >= c ? fr.sh_level(dn)[lane] : fr.level(dn)[lane];
        beta[boff + lane] = (int8_t)reg_node<kWarp>(a, (uint32_t)op.y, op.x == OP_NODE_FAST, lane);
        break;
      }
      default:
        break;
    }
    if (all)
      frame_sync(nthr);
    else
      __syncwarp();
    SC_PROF_ADD(slot, t_op);
  }
  if (!prev_all) frame_sync(nthr);  // the others wait for the first warp's last ops

  SC_PROF_T(t_out);
  int8_t* out = u + (size_t)frame * N;
  if (subtree) {  // beta in storage order: the host combines and transforms
    for (int i = tid; i < N; i += nthr) out[i] = beta[i];
    SC_PROF_ADD(PROF_COPY_OUT, t_out);
    SC_PROF_ADD(PROF_FRAME, t_frame);
    SC_PROF_FLUSH();
    return;
  }
  // butterfly u = beta * G in storage order (F^(x)n is invariant under the
  // simultaneous row and column bit reversal), then natural order on the way
  // out; from N = 4 on four partial sums a word: the stages 1 and 2 inside
  // each word, the stages 4.. between words, the output a word a store
  if (N < 4) {
    for (int s = 1; s < N; s <<= 1) {
      for (int idx = tid; idx < N / 2; idx += nthr) {
        int j = ((idx / s) * 2 * s) + (idx % s);
        beta[j] ^= beta[j + s];
      }
      frame_sync(nthr);
    }
    for (int i = tid; i < N; i += nthr) out[i] = beta[log2N ? __brev((unsigned)i) >> shift : 0];
  } else {
    uint32_t* w = reinterpret_cast<uint32_t*>(beta);
    const int nw = N / 4;
    for (int i = tid; i < nw; i += nthr) {
      uint32_t x = w[i];
      x ^= (x >> 8) & 0x00ff00ffu;  // bytes 0, 2 ^= bytes 1, 3
      x ^= (x >> 16) & 0x0000ffffu;  // bytes 0, 1 ^= bytes 2, 3
      w[i] = x;
    }
    frame_sync(nthr);
    for (int ls = 0; (1 << ls) < nw; ++ls) {
      for (int idx = tid; idx < nw / 2; idx += nthr) {
        const int j = ((idx >> ls) << (ls + 1)) + (idx & ((1 << ls) - 1));
        w[j] ^= w[j + (1 << ls)];
      }
      frame_sync(nthr);
    }
    uint32_t* out_w = reinterpret_cast<uint32_t*>(out);
    for (int q = tid; q < nw; q += nthr) {
      uint32_t x = 0;
      for (int k = 0; k < 4; ++k)
        x |= (uint32_t)(uint8_t)beta[__brev((unsigned)(4 * q + k)) >> shift] << (8 * k);
      out_w[q] = x;
    }
  }
  SC_PROF_ADD(PROF_COPY_OUT, t_out);
  SC_PROF_ADD(PROF_FRAME, t_frame);
  SC_PROF_FLUSH();
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bytes of shared memory one frame (one warp) needs with the top c levels of
// its level stack in device memory
extern "C" int sc_decode_smem_per_frame(int N, int c) {
  return 4 * shared_levels_floats(N, c) + N;
}

namespace {

// cudaFuncSetAttribute once per device and size: the largest dynamic
// shared-memory size allowed so far on each device
constexpr int kMaxDevices = 64;
std::mutex smem_mu;
size_t smem_allowed[kMaxDevices] = {};

cudaError_t allow_smem(size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(smem_mu);
  if (smem <= smem_allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(sc_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) smem_allowed[dev] = smem;
  return err;
}

int launch(const float* in, int8_t* out, const int* prog, int n_ops, int B, int N,
           int log2N, int frames_per_block, int warps_per_frame, int subtree, float* scratch,
           int c, void* stream) {
  // a frame of several warps synchronises on its block's barrier: one such
  // frame per block
  if (warps_per_frame < 1 || frames_per_block < 1 ||
      (warps_per_frame > 1 && frames_per_block > 1) || frames_per_block * warps_per_frame > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)frames_per_block * sc_decode_smem_per_frame(N, c);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + frames_per_block - 1) / frames_per_block;
  sc_decode_kernel<<<blocks, frames_per_block * warps_per_frame * kWarp, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      in, out, reinterpret_cast<const int4*>(prog), n_ops, B, N, log2N, subtree, scratch, c,
      warps_per_frame);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef SC_PROFILE
extern "C" int sc_profile_reset() {
  static const unsigned long long zeros[2 * kProfSlots] = {};
  return (int)cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros));
}
extern "C" int sc_profile_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
#endif

// Launches on `stream`; returns the cudaGetLastError code (0 = ok).
// llr [B][N] natural order -> u [B][N] natural order; the whole level stack
// in shared memory, one warp per frame.
extern "C" int sc_decode_launch(const float* llr, int8_t* u, const int* prog,
                                int n_ops, int B, int N, int log2N,
                                int frames_per_block, void* stream) {
  return launch(llr, u, prog, n_ops, B, N, log2N, frames_per_block, 1, 0, nullptr, 0, stream);
}

// One hybrid subtree: alpha [B][n] -> beta [B][n], both in storage order,
// `warps_per_frame` warps per frame.  The top `dev_levels` levels of each
// frame's level stack stay in device memory: level 0 is `alpha` itself,
// levels 1..dev_levels-1 a slice of `scratch` (B * dev_scratch_floats(n,
// dev_levels) floats; null when dev_levels <= 1).
extern "C" int sc_decode_sub_launch(const float* alpha, int8_t* beta, const int* prog,
                                    int n_ops, int B, int n, int log2n, int frames_per_block,
                                    int warps_per_frame, float* scratch, int dev_levels,
                                    void* stream) {
  if (dev_levels < 0 || dev_levels > log2n) return (int)cudaErrorInvalidValue;
  return launch(alpha, beta, prog, n_ops, B, n, log2n, frames_per_block, warps_per_frame, 1,
                scratch, dev_levels, stream);
}

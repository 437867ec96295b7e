// Chunked successive-cancellation LIST decoder kernels for Hopper (sm_90a):
// the kernels and their device functions, included by the four sources that
// launch them, one library each so that nvcc builds them in parallel:
// scl_decode.cu (K3, scl_chunk_step), scl_body.cu (K5), scl_last.cu (K4) and
// scl_mega.cu (K6).
//
//   scl_chunk_body   replaces polarcode_and_ldpc_tpu/ops/scl_body_pallas.py
//                    (make_chunk_body_pallas): one size-S subtree list decode
//   scl_chunk_step   replaces ops/scl_superchunk_pallas.py
//                    (make_superchunk_pallas): descend -> body -> pending
//                    composes -> ascend on the level stacks, one chunk
//   scl_last_chunk   replaces ops/scl_superchunk_pallas.py
//                    (make_last_superchunk_pallas): one g, body, ascend to the
//                    root composing R into every pending, final butterfly
//   scl_decode_mega  replaces ops/scl_mega_pallas.py (make_scl_mega_pallas):
//                    the whole chunked list decode in ONE launch; described
//                    above that kernel
//
// What bounds them: per chunk a frame moves a few tens of KB of level stacks
// and does ~S*log2(S)*L cheap operations, so the roofline is the memory rate;
// in practice the list decode is bound by issue and latency: a chain of
// thousands of dependent steps per chunk, most of them narrower than a warp
// (the prune at an info leaf ranks 2L = 16 candidates).  Design, as for the
// SC kernel: ONE WARP PER FRAME.  Frames are independent, every step is
// followed by a __syncwarp (no block-wide barrier anywhere), and many
// independent warps per SM hide each other's latency.  The chunk's working
// set (alpha levels below the top, packed partial sums, saved rank vectors)
// lives in shared memory, the metrics and rank vector in registers; the
// level stacks between launches live in device memory, frame-major:
//
//   llr     [B][N]               channel LLRs, bit-reversed storage
//   alpha   [B][L*(N-S)]         levels 1..t back to back, level l is
//                                [L][N>>l] at offset L*(N - (N>>(l-1)))
//   beta    [B][N-S] words       level l at offset N - (N>>(l-1)); bit p of
//                                a word is path p's left partial sum (32-bit
//                                words; 64-bit for a wide list, L > 32)
//   pend_a, pend_b [B][t][L]     pending rank vectors of the levels
//   pm      [B][L]               path metrics
//
// The kernels update this state IN PLACE.  The descend works directly on the
// global stacks (each level is written, then read by the same warp after a
// __syncwarp; state pointers are therefore NOT const __restrict__, so no load
// goes through the non-coherent path).  One compiled kernel per entry point
// serves every chunk of every code: the chunk's node program and (k, inv, j,
// compose masks) are arguments.  Any batch size; the list runs at full width
// with -inf phantom rows, or (the narrow prefix, LIVE WIDTH) at the live path
// count.
//
// Live width (the TPU kernel's widths= mode of make_superchunk_pallas): the
// list fills 1 -> 2 -> ... -> L, doubling per info leaf, so the early chunks
// of a decode hold fewer live paths than the list.  A narrow chunk step (lv_in
// / lv_out < L; all of them run in one launch, scl_narrow_prefix_kernel)
// runs its descend, body, prunes, composes and ascend over the live rows and
// lanes only, in the same full-width frame-major state: it
// reads and writes exactly the rows and lanes the plain live-width step keeps
// (models/polar/scanscl.py, _make_super_fn with lv_in / lv_out), and leaves
// the others untouched (phantom metrics stay -inf).  A pending rank vector
// that the plain step keeps at width 1 is broadcast there to every live slot;
// the host passes those levels as bit masks (one_a, one_b) and the kernel
// reads lane 0 for every slot.  The last chunk runs at full width.
//
// The chunk step and the whole decode read the chunk's top plane (level t,
// [L][S]) where their own descend wrote it, in device memory (L2-resident,
// written by the same warp), instead of copying it into the context: only
// the chunk's first F and G read it.  A chunk that is one rate-0 or REP node
// works on it in place, so that one copy stays (chunk_top).  The last chunk,
// whose state is read only, descends into a scratch plane in device memory
// and reads it there; the body kernel reads its input plane where it lies
// (read only; the one rate-0 or REP chunk takes its copy the same way).
//
// Launch shape: the warps per block are planned from the SM's limits (the
// occupancy of the compiled kernel at its registers and the context's shared
// memory), the most resident warps per SM, the smaller block on a tie.
//
// Where a warp's chunk context lives: in shared memory when it fits
// (scl::ctx_words; last_ctx_words for the last chunk), else, in
// the same layout, in the warp's slice of a scratch buffer in device memory
// that the wrapper allocates (template argument kDev; a port mode: the JAX
// package runs such chunks in XLA).  Then a grid of a few blocks per SM walks
// the frames, so the scratch does not grow with the batch; in shared-memory
// mode the grid covers the batch and the frame loop runs once.
//
// ONE-HOT PENDINGS (perm_impl="onehot", the default mode of the TPU kernels'
// factories make_superchunk_pallas / make_last_superchunk_pallas /
// make_chunk_body_pallas): the state holds each level's pendings as one-hot
// float planes, pend_a / pend_b [B][t][L][L] with P[l][j] = 1 where slot l
// reads path j, and the chunk body hands its permutation back as such a plane.
// The one-hot algebra selects exactly what the rank algebra selects, so these
// modes run the rank device functions: on load, the warp finds the column of
// the 1 in each row of the level planes the step reads (a rank vector; by
// 16-byte pieces, see onehot_load), the step runs on those rank vectors
// staged in shared memory (2 t L words after the chunk context), and on the
// way out every level the step wrote (its descend resets, its composes, the
// parked level) is stored as a plane of exact 1.0 / +0.0 again, by 16-byte
// pieces.  The one float that differs: a one-hot apply is the SUM
// sum_j P[l][j] * x[j], so when the selected value is a zero, the result is
// -0.0 only if every term is -0.0, i.e. if every row of the column has its
// sign bit set, and +0.0 otherwise (the rank algebra's select keeps the
// selected -0.0).  The descend's g reads its parent through pend_a that way
// (onehot_zero), so the level stacks equal the plain one-hot step's bit for
// bit.  Exact nodes only, full list width only, as in the JAX package.


#pragma once

#include <stddef.h>

#include <mutex>
#include <vector>

#include "scl_device.cuh"

namespace {

using namespace scl;

struct Geometry {
  int B, N, S, L, t, lgS;
};

// W: a position's word of path bits (uint32_t; a 64-bit word for a wide list)
template <typename W>
struct StacksT {
  float* A;  // this frame's alpha levels
  W* Bt;     // this frame's packed beta levels
  int* PA;
  int* PB;
  int N, L;
  __device__ __forceinline__ float* alpha(int l) const { return A + (size_t)L * (N - (N >> (l - 1))); }
  __device__ __forceinline__ W* beta(int l) const { return Bt + (N - (N >> (l - 1))); }
  __device__ __forceinline__ int* pend_a(int l) const { return PA + (l - 1) * L; }
  __device__ __forceinline__ int* pend_b(int l) const { return PB + (l - 1) * L; }
};
using Stacks = StacksT<uint32_t>;

// Each offset is one 32 x 32 -> 64-bit product (a frame's slice, L * (N - S)
// or t * L words, fits an int): with two 64-bit products the whole-decode
// kernel, held to 64 registers, spilled the high word of one.
template <typename W>
__device__ __forceinline__ StacksT<W> frame_stacks(const Geometry& g, int frame, float* alpha,
                                                   W* beta, int* pend_a, int* pend_b) {
  StacksT<W> s;
  s.A = alpha + (size_t)frame * (size_t)(g.L * (g.N - g.S));
  s.Bt = beta + (size_t)frame * (g.N - g.S);
  s.PA = pend_a + (size_t)frame * (size_t)(g.t * g.L);
  s.PB = pend_b + (size_t)frame * (size_t)(g.t * g.L);
  s.N = g.N;
  s.L = g.L;
  return s;
}

// The value of a one-hot apply whose selected element is a zero, in a column
// col[0], col[stride], ... of `rows` rows: -0.0 only if every row of the
// column has its sign bit set, else +0.0.  A selected zero is rare, so the
// descend calls this out of its loop's line (noinline: the scan is not
// compiled into the hot loop).
__device__ __noinline__ float onehot_zero(const float* col, int stride, int rows) {
  for (int q = 0; q < rows; ++q)
    if (!(__float_as_uint(col[(size_t)q * stride]) >> 31)) return 0.0f;
  return -0.0f;
}

// The planes of the one-hot pendings, by level bit: bits 0 .. t-1 are pend_a's
// levels 1 .. t, bits t .. 2t-1 pend_b's, each an [L][L] float plane.  The
// which-th set bit of m: clear the lowest bit `which` times.
__device__ __forceinline__ int nth_level(unsigned m, int which) {
  for (; which > 0; --which) m &= m - 1;
  return __ffs(m) - 1;
}
template <typename T>
__device__ __forceinline__ T* level_plane(T* pa, T* pb, int bit, int t, int L) {
  return bit < t ? pa + (size_t)bit * L * L : pb + (size_t)(bit - t) * L * L;
}
// L a power of two of at least 4: the planes go by 16-byte pieces of four
// columns of a row (piece p: row p >> (lgL - 2), columns 4p & (L - 1) on)
__device__ __forceinline__ bool onehot_vectors(int L) { return L >= 4 && !(L & (L - 1)); }

// Stage the one-hot planes of the levels of mask m as rank vectors: entry
// (bit, row) of ranks [2t][L] is the last column of that row holding a nonzero
// (every row of a pending holds one 1; a row with none reads 0).  With
// vectors, consecutive lanes read consecutive 16-byte pieces of the selected
// planes (coalesced), a lane keeps the last nonzero column of its four (or
// -1), and the L / 4 lanes of a row take the max by xor-shuffles; else one
// row a lane.  Only the levels a step reads are staged (read_levels): the
// parent staged every level of both planes, one float a read, the lanes L * 4
// bytes apart.
__device__ __forceinline__ void onehot_load(const float* pa, const float* pb, int* ranks,
                                            unsigned m, int t, int L, int lane) {
  const int lgL = ilog2(L);
  if (onehot_vectors(L)) {
    const int lgP = 2 * lgL - 2, G = L >> 2, total = __popc(m) << lgP;
    for (int base = 0; base < total; base += kWarp) {  // every lane runs the shuffles
      const int idx = base + lane;
      int v = -1, bit = 0, row = 0;
      if (idx < total) {
        bit = nth_level(m, idx >> lgP);
        const int piece = idx & ((1 << lgP) - 1), col0 = (piece << 2) & (L - 1);
        row = piece >> (lgL - 2);
        const float4 x =
            *reinterpret_cast<const float4*>(level_plane(pa, pb, bit, t, L) + (piece << 2));
        v = x.w != 0.0f   ? col0 + 3
            : x.z != 0.0f ? col0 + 2
            : x.y != 0.0f ? col0 + 1
            : x.x != 0.0f ? col0
                          : -1;
      }
      for (int off = 1; off < G; off <<= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
      if (idx < total && !(idx & (G - 1))) ranks[bit * L + row] = max(v, 0);
    }
  } else {
    for (int q = lane; q < __popc(m) * L; q += kWarp) {
      const int which = q / L, row = q - which * L, bit = nth_level(m, which);
      const float* r = level_plane(pa, pb, bit, t, L) + row * L;
      int k = 0;
      for (int j = 0; j < L; ++j)
        if (r[j] != 0.0f) k = j;
      ranks[bit * L + row] = k;
    }
  }
  __syncwarp();
}

// Rank vectors -> one-hot planes of exact 1.0 / +0.0, for the levels of mask
// m: with vectors a 16-byte store a piece, row and columns by shift and mask;
// else one float a store.
__device__ __forceinline__ void onehot_store(float* pa, float* pb, const int* ranks, unsigned m,
                                             int t, int L, int lane) {
  const int lgL = ilog2(L);
  if (onehot_vectors(L)) {
    const int lgP = 2 * lgL - 2, total = __popc(m) << lgP;
    for (int idx = lane; idx < total; idx += kWarp) {
      const int bit = nth_level(m, idx >> lgP), piece = idx & ((1 << lgP) - 1);
      const int r = ranks[bit * L + (piece >> (lgL - 2))] - ((piece << 2) & (L - 1));
      *reinterpret_cast<float4*>(level_plane(pa, pb, bit, t, L) + (piece << 2)) =
          make_float4(r == 0 ? 1.0f : 0.0f, r == 1 ? 1.0f : 0.0f, r == 2 ? 1.0f : 0.0f,
                      r == 3 ? 1.0f : 0.0f);
    }
  } else {
    const bool pow2 = !(L & (L - 1));
    for (int q = lane; q < __popc(m) * L * L; q += kWarp) {
      const int which = pow2 ? q >> (2 * lgL) : q / (L * L), e = q - which * L * L;
      const int bit = nth_level(m, which), row = pow2 ? e >> lgL : e / L;
      level_plane(pa, pb, bit, t, L)[e] = e - row * L == ranks[bit * L + row] ? 1.0f : 0.0f;
    }
  }
  __syncwarp();
}

// g at level lo over w rows: dst[l][i] = parent[r][M+i] + (1 - 2*left[l][i]) *
// parent[r][i] with the parent read through pend_a (row 0 when `inv`, the
// LLRs at lo = 1) and the left bits through pend_b; a pending whose level bit
// is set in one_a / one_b holds one lane, read by every slot.  dst is [w][M].
// kOneHot: the parent is read as the one-hot apply's sum (a selected zero's
// sign by onehot_zero over the parent's g.L rows).
template <bool kOneHot = false, typename W>
__device__ __forceinline__ void descend_g(const Geometry& g, const StacksT<W>& st, const float* x,
                                          int lo, bool inv, float* dst, int lane, int w,
                                          int one_a, int one_b) {
  const int M = g.N >> lo, lgM = ilog2(M);
  const W* bl = st.beta(lo);
  const int* pb = st.pend_b(lo);
  const bool pb_one = (one_b >> (lo - 1)) & 1;
  const float* parent = lo == 1 ? x : st.alpha(lo - 1);
  const int* pa = lo == 1 ? nullptr : st.pend_a(lo - 1);
  const bool pa_one = lo != 1 && ((one_a >> (lo - 2)) & 1);
  const bool through = lo != 1 && !inv;
  for (int idx = lane; idx < w * M; idx += kWarp) {
    const int l = idx >> lgM, i = idx & (M - 1);
    const float* src = parent;
    if (through) src += (size_t)pa[pa_one ? 0 : l] * 2 * M;
    const float sgn = 1.0f - 2.0f * (float)((bl[i] >> pb[pb_one ? 0 : l]) & 1u);
    float first = src[i], second = src[M + i];
    if (kOneHot && through) {
      if (first == 0.0f) first = onehot_zero(parent + i, 2 * M, g.L);
      if (second == 0.0f) second = onehot_zero(parent + M + i, 2 * M, g.L);
    }
    dst[idx] = second + sgn * first;
  }
}

// The warp's chunk context: its slice of shared memory, or of the scratch
// buffer in device memory (kDev).
template <bool kDev>
__device__ __forceinline__ float* ctx_base(unsigned char* smem_raw, float* ctx_dev,
                                           int per_warp_words) {
  const int warps = blockDim.x / kWarp, warp = threadIdx.x / kWarp;
  return kDev ? ctx_dev + ((size_t)blockIdx.x * warps + warp) * per_warp_words
              : reinterpret_cast<float*>(smem_raw) + (size_t)warp * per_warp_words;
}

// Run `f(frame)` for this warp's frames: its one frame when the grid covers
// the batch (shared-memory context), or frames warp, warp + all warps, ...
// (device-memory context: the scratch has one context per resident warp).
template <bool kDev, typename F>
__device__ __forceinline__ void for_each_frame(int B, F&& f) {
  const int warps = blockDim.x / kWarp;
  const int first = blockIdx.x * warps + threadIdx.x / kWarp;
  if (!kDev) {
    if (first < B) f(first);
    return;
  }
  for (int frame = first; frame < B; frame += gridDim.x * warps) {
    f(frame);
    __syncwarp();
  }
}

// The arguments of one chunk step, as a launch passes them, as a row of the
// narrow prefix's table, or as the whole-decode kernel builds them from a row
// of its step table (at full width); the live widths and one-lane masks are
// read by a narrow step only.
struct StepArgs {
  int k, inv, j, mask_a, mask_b, prog_off, n_ops, has_R;
  int lv_in, lv_out, one_a, one_b;
};

// The plane a chunk body runs on: the level-t plane `top` where the descend
// left it, or, for a chunk that is one rate-0 or REP node (which works on its
// plane in place), a copy of its w rows in the context.
template <typename C>
__device__ __forceinline__ float* chunk_top(const C& c, float* top, const int4* prog, int n_ops,
                                            int w) {
  const int kind = __ldg(&prog->x) & 0xff;
  if (n_ops != 1 || (kind != OP_RATE0 && kind != OP_REP)) return top;
  for (int i = c.lane; i < w * c.S; i += kWarp) c.alpha[i] = top[i];
  __syncwarp();
  return c.alpha;
}

// A wide list's words are 64-bit: paths b .. b + 7 are byte (b / 8) & 3 of
// the word's half b / 32.
template <typename W>
__device__ __forceinline__ uint32_t paths_half(W w, int b) {
  if constexpr (sizeof(W) == 4) return w;
  else return (uint32_t)(w >> (b & 32));
}
template <typename W>
__device__ __forceinline__ uint32_t paths_byte_sel(int b) {
  const int q = sizeof(W) == 4 ? b >> 3 : (b >> 3) & 3;
  return (uint32_t)(q | ((4 + q) << 4));
}

// The body kernel's outputs of one frame, from the packed partial sums in
// c.beta and the metrics and rank vector in the lanes: beta_out [L][S] int8,
// pm_out [L], and r_out, the rank vector [L] as long long or (kOneHot) the
// one-hot plane [L][L] as float.  beta by 16-byte stores when S >= 16: piece
// k of the L S / 16 is path l = k mod L (path fastest: the eight lanes of a
// 16-byte shared-memory read phase share the piece's words, L >= 8), 16
// positions from 16 (k / L); __byte_perm gathers byte l / 8 of four words, a
// shift and mask leaves one 0 / 1 byte a position (root_out's runs): L S / 512
// stores a lane against L S / 32 byte stores, each a shift of a shared word.
// The one-hot plane by 16-byte stores of four exact 1.0 / +0.0 (piece v: row
// v >> (lgL - 2), columns 4v & (L - 1) on), the row's rank shuffled from its
// lane, no division; one float a store when L < 4 or not a power of two.
template <bool kOneHot>
__device__ __forceinline__ void body_out(const Ctx& c, int8_t* beta_out, float* pm_out,
                                         void* r_out, int L, int S, int lgS, float pmr, int R) {
  const int lane = c.lane, lgL = ilog2(L);
  const bool pow2 = !(L & (L - 1));
  if (S >= 16 && !(((uintptr_t)beta_out | (uintptr_t)c.beta) & 15u)) {
#pragma unroll 1
    for (int k = lane; k < (L * S) >> 4; k += kWarp) {
      const int ib = pow2 ? k >> lgL : k / L, l = k - ib * L;
      const uint4* w = reinterpret_cast<const uint4*>(c.beta + 16 * ib);
      const uint32_t sel = (uint32_t)((l >> 3) | ((4 + (l >> 3)) << 4));
      uint32_t x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = w[q];
        x[q] = (__byte_perm(__byte_perm(v.x, v.y, sel), __byte_perm(v.z, v.w, sel), 0x5410) >>
                (l & 7)) &
               0x01010101u;
      }
      *reinterpret_cast<uint4*>(beta_out + (size_t)l * S + 16 * ib) =
          make_uint4(x[0], x[1], x[2], x[3]);
    }
  } else {
    for (int idx = lane; idx < L * S; idx += kWarp)
      beta_out[idx] = (int8_t)((c.beta[idx & (S - 1)] >> (idx >> lgS)) & 1u);
  }
  if (lane < L) pm_out[lane] = pmr;
  if (!kOneHot) {
    if (lane < L) static_cast<long long*>(r_out)[lane] = R;
    return;
  }
  float* ro = static_cast<float*>(r_out);
  if (onehot_vectors(L)) {
    const int n = (L * L) >> 2;
    for (int base = 0; base < n; base += kWarp) {  // every lane runs the shuffle
      const int v = base + lane;
      const int r = __shfl_sync(kFull, R, (v >> (lgL - 2)) & (kWarp - 1)) - ((v << 2) & (L - 1));
      if (v < n)
        *reinterpret_cast<float4*>(ro + 4 * v) =
            make_float4(r == 0 ? 1.0f : 0.0f, r == 1 ? 1.0f : 0.0f, r == 2 ? 1.0f : 0.0f,
                        r == 3 ? 1.0f : 0.0f);
    }
  } else {
    for (int base = 0; base < L * L; base += kWarp) {
      const int idx = base + lane, row = pow2 ? idx >> lgL : idx / L;
      const int r = __shfl_sync(kFull, R, row & (kWarp - 1));
      if (idx < L * L) ro[idx] = idx - row * L == r ? 1.0f : 0.0f;
    }
  }
}

// body_out of a wide list (rank vectors): piece k of beta_out's L S / 16 is
// path l = k mod L, positions 16 (k / L) on, gathered from the 32-bit half of
// each 64-bit word that holds path l (words 2i + l / 32 of c.beta as 32-bit
// words) as body_out gathers; the metrics and rank vector from the slots.
__device__ __forceinline__ void body_out_wide(const CtxWide& c, int8_t* beta_out, float* pm_out,
                                              long long* r_out, int L, int S, int lgS,
                                              const float (&pmr)[2], const int (&R)[2]) {
  const int lane = c.lane;
  if (S >= 16 && !((uintptr_t)beta_out & 15u)) {
    const uint32_t* halves = reinterpret_cast<const uint32_t*>(c.beta);
#pragma unroll 1
    for (int k = lane; k < (L * S) >> 4; k += kWarp) {
      const int ib = k / L, l = k - ib * L;
      const uint32_t* w = halves + 32 * ib + (l >> 5);  // word 16 ib + e at w[2 e]
      const uint32_t sel = paths_byte_sel<WideWord>(l);
      uint32_t x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = (__byte_perm(__byte_perm(w[8 * q], w[8 * q + 2], sel),
                            __byte_perm(w[8 * q + 4], w[8 * q + 6], sel), 0x5410) >>
                (l & 7)) &
               0x01010101u;
      *reinterpret_cast<uint4*>(beta_out + (size_t)l * S + 16 * ib) =
          make_uint4(x[0], x[1], x[2], x[3]);
    }
  } else {
    for (int idx = lane; idx < L * S; idx += kWarp)
      beta_out[idx] = (int8_t)((c.beta[idx & (S - 1)] >> (idx >> lgS)) & 1ull);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (lane + s * kWarp < L) {
      pm_out[lane + s * kWarp] = pmr[s];
      r_out[lane + s * kWarp] = R[s];
    }
}

// K5: one chunk body a frame, on its input plane where it lies in device
// memory (read only, as the chunk step reads level t; a chunk that is one
// rate-0 or REP node takes a copy, chunk_top), on the chunk step's context:
// 4,928 B a flagship frame, rank or one-hot, against 9,024 with a top plane
// of its own (25 warps per SM, 4096 frames in 1.24 waves).  r_out: the rank
// vector [B][L] as long long, or (kOneHot) the one-hot plane [B][L][L] as
// float.  kFast: a fast node program.  The shared-memory variants keep to 64
// registers: 32 warps per SM, 4096 flagship frames in one wave (132 SMs); the
// device-memory ones to 128.  The fast instance at 64 spilled the input
// plane's address (8 B, read back at each depth-0 op: ptxas, nvdisasm
// --print-line-info), so it keeps that address in its context (ctx_top); held
// to 72 registers instead it ran at 28 warps per SM, 1.11 waves, 0.95x its
// parent (NVIDIA H100 80GB HBM3, 700 W, tools/scl_kernel_ab.py).
template <bool kDev, bool kOneHot, bool kFast>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, 4)
    scl_chunk_body_kernel(const float* __restrict__ alpha, const float* __restrict__ pm,
                          int8_t* __restrict__ beta_out, float* __restrict__ pm_out,
                          void* __restrict__ r_out, const int4* __restrict__ prog, int n_ops,
                          int has_R, int B, int S, int L, int lgS, float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  Ctx c = make_ctx(ctx_base<kDev>(smem_raw, ctx_dev, ctx_words(L, S, lgS)), L, S, lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  for_each_frame<kDev>(B, [&](int frame) {
    SCL_PROF_T(t_frame);
    // written only by a chunk that is one rate-0 or REP node, which gets a copy
    float* top = chunk_top(c, const_cast<float*>(alpha) + (size_t)frame * (size_t)(L * S), prog,
                           n_ops, L);
    float pmr = lane < L ? pm[(size_t)frame * (size_t)L + lane] : 0.0f;
    int R = lane;
    if (kFast && lane == 0) {  // the top plane's address, out of the registers
      c.R[0] = (int)(uint32_t)(uintptr_t)top;
      c.R[1] = (int)(uint32_t)((uintptr_t)top >> 32);
    }
    __syncwarp();
    SCL_PROF_ADD(c, PROF_COPY_IN, t_frame);
    SCL_PROF_T(t_body);
    chunk_body<false, kFast, kFast>(c, top, prog, n_ops, has_R, L, pmr, R);
    SCL_PROF_ADD(c, PROF_BODY, t_body);
    SCL_PROF_T(t_out);
    body_out<kOneHot>(c, beta_out + (size_t)frame * (size_t)(L * S),
                      pm_out + (size_t)frame * (size_t)L,
                      kOneHot ? (void*)(static_cast<float*>(r_out) + (size_t)frame * (size_t)(L * L))
                              : (void*)(static_cast<long long*>(r_out) + (size_t)frame * (size_t)L),
                      L, S, lgS, pmr, R);
    SCL_PROF_ADD(c, PROF_OUT, t_out);
    SCL_PROF_ADD(c, PROF_STEP, t_frame);
  });
  SCL_PROF_FLUSH(c);
}

// The parts of one chunk step of one frame: descend -> body -> pending
// composes -> ascend; kNarrow: over lv_in live paths in and lv_out out, else
// at full width (the live widths and one-lane masks of `a` are not read).
// `x` is the frame's LLRs in bit-reversed storage, `pm` its L metrics in
// device memory (read, then written).  kOneHot: the parent of the descend's
// g is read as a one-hot apply (the pendings are rank vectors staged from the
// one-hot planes).  The whole-decode kernel runs the same parts.

// The identity on the first w entries of a pending, kP entries a lane.
template <int kP>
__device__ __forceinline__ void set_identity(int* p, int w, int lane) {
  if (lane < w) p[lane] = lane;
  if (kP == 2 && lane + kWarp < w) p[lane + kWarp] = lane + kWarp;
}

// The descend: one g at level t-k (all f from the LLRs when k == t), then an
// f chain down to level t; every written level's pend_a resets.
template <bool kNarrow, bool kOneHot = false, int kP = 1, typename C, typename W>
__device__ __forceinline__ void step_descend(const C& c, const Geometry& g, const StacksT<W>& st,
                                             const float* x, const StepArgs& a) {
  const int N = g.N, t = g.t, lane = c.lane;
  const int wi = kNarrow ? a.lv_in : g.L;
  const int one_a = kNarrow ? a.one_a : 0, one_b = kNarrow ? a.one_b : 0;
  if (a.k == t) {
    // chunk 0: the planes are path-invariant, compute once, store lv_in rows
    for (int l = 1; l <= t; ++l) {
      const int M = N >> l;
      const float* src = l == 1 ? x : st.alpha(l - 1);  // row 0 of the level above
      float* dst = st.alpha(l);
      for (int i = lane; i < M; i += kWarp) {
        const float v = f_minsum(src[i], src[M + i]);
        for (int r = 0; r < wi; ++r) dst[(size_t)r * M + i] = v;
      }
      set_identity<kP>(st.pend_a(l), wi, lane);
      __syncwarp();
    }
    return;
  }
  const int lo = t - a.k;
  descend_g<kOneHot>(g, st, x, lo, a.inv != 0, st.alpha(lo), lane, wi, one_a, one_b);
  set_identity<kP>(st.pend_a(lo), wi, lane);
  __syncwarp();
  for (int l = lo + 1; l <= t; ++l) {
    const int M = N >> l, lgM = ilog2(M);
    const float* src = st.alpha(l - 1);
    float* dst = st.alpha(l);
    for (int idx = lane; idx < wi * M; idx += kWarp) {
      const int r = idx >> lgM, i = idx & (M - 1);
      dst[idx] = f_minsum(src[(size_t)r * 2 * M + i], src[(size_t)r * 2 * M + M + i]);
    }
    set_identity<kP>(st.pend_a(l), wi, lane);
    __syncwarp();
  }
}

// After the body (metrics pmr and rank vector R in the lanes): the metrics
// out, the chunk's R composed into the live pendings, the ascend.
template <bool kNarrow>
__device__ __forceinline__ void step_ascend(const Ctx& c, const Geometry& g, const Stacks& st,
                                            float* pm, const StepArgs& a, float pmr, int R) {
  const int S = g.S, t = g.t, lane = c.lane;
  const int j = a.j, mask_a = a.mask_a, mask_b = a.mask_b;
  const int wo = kNarrow ? a.lv_out : g.L, one_b = kNarrow ? a.one_b : 0;
  SCL_PROF_T(t_compose);
  if (lane < wo) pm[lane] = pmr;

  // ---- compose the chunk's R into the live pendings: p[l] = p[R[l]]
  for (int l = 1; l <= t; ++l) {
    int va = 0, vb = 0;
    const bool ca = (mask_a >> (l - 1)) & 1, cb = (mask_b >> (l - 1)) & 1;
    if (lane < wo) {
      if (ca) va = st.pend_a(l)[R];
      if (cb) vb = st.pend_b(l)[R];
    }
    __syncwarp();
    if (lane < wo) {
      if (ca) st.pend_a(l)[lane] = va;
      if (cb) st.pend_b(l)[lane] = vb;
    }
  }
  __syncwarp();

  SCL_PROF_ADD(c, PROF_COMPOSE, t_compose);

  // ---- ascend: j combines with the permuted left betas, built from the end
  // of the destination level t-j, then the parked level's pend_b resets; a
  // one-lane pending that this chunk did not compose is read by every slot
  SCL_PROF_T(t_ascend);
  const int D = S << j;
  uint32_t* dest = st.beta(t - j);
  for (int i = lane; i < S; i += kWarp) dest[D - S + i] = c.beta[i];
  __syncwarp();
  for (int s = 0; s < j; ++s) {
    const int lev = t - s, size = S << s;
    const uint32_t* left = st.beta(lev);
    const bool one = ((one_b >> (lev - 1)) & 1) && !((mask_b >> (lev - 1)) & 1);
    if (lane < wo) c.tmp[lane] = st.pend_b(lev)[one ? 0 : lane];
    __syncwarp();
    for (int i = lane; i < size; i += kWarp)
      dest[D - 2 * size + i] = perm_word(left[i], c.tmp, wo) ^ dest[D - size + i];
    __syncwarp();
  }
  if (lane < wo) st.pend_b(t - j)[lane] = lane;
  SCL_PROF_ADD(c, PROF_ASCEND, t_ascend);
}

// step_ascend of a wide list: the metrics and R in the slots (path lane + 32
// s in slot s), 64-bit words.
template <bool kNarrow>
__device__ __forceinline__ void step_ascend_wide(const CtxWide& c, const Geometry& g,
                                                 const StacksT<WideWord>& st, float* pm,
                                                 const StepArgs& a, const float (&pmr)[2],
                                                 const int (&R)[2]) {
  const int S = g.S, t = g.t, lane = c.lane;
  const int j = a.j, mask_a = a.mask_a, mask_b = a.mask_b;
  const int wo = kNarrow ? a.lv_out : g.L, one_b = kNarrow ? a.one_b : 0;
  SCL_PROF_T(t_compose);
#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (lane + s * kWarp < wo) pm[lane + s * kWarp] = pmr[s];

  // ---- compose the chunk's R into the live pendings: p[l] = p[R[l]]
  for (int l = 1; l <= t; ++l) {
    int va[2] = {0, 0}, vb[2] = {0, 0};
    const bool ca = (mask_a >> (l - 1)) & 1, cb = (mask_b >> (l - 1)) & 1;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (lane + s * kWarp < wo) {
        if (ca) va[s] = st.pend_a(l)[R[s]];
        if (cb) vb[s] = st.pend_b(l)[R[s]];
      }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (lane + s * kWarp < wo) {
        if (ca) st.pend_a(l)[lane + s * kWarp] = va[s];
        if (cb) st.pend_b(l)[lane + s * kWarp] = vb[s];
      }
  }
  __syncwarp();
  SCL_PROF_ADD(c, PROF_COMPOSE, t_compose);

  // ---- ascend, as step_ascend
  SCL_PROF_T(t_ascend);
  const int D = S << j;
  WideWord* dest = st.beta(t - j);
  for (int i = lane; i < S; i += kWarp) dest[D - S + i] = c.beta[i];
  __syncwarp();
  for (int s = 0; s < j; ++s) {
    const int lev = t - s, size = S << s;
    const WideWord* left = st.beta(lev);
    const bool one = ((one_b >> (lev - 1)) & 1) && !((mask_b >> (lev - 1)) & 1);
    for (int p = lane; p < wo; p += kWarp) c.tmp[p] = st.pend_b(lev)[one ? 0 : p];
    __syncwarp();
    for (int i = lane; i < size; i += kWarp)
      dest[D - 2 * size + i] = perm_word_wide(left[i], c.tmp, wo) ^ dest[D - size + i];
    __syncwarp();
  }
  set_identity<2>(st.pend_b(t - j), wo, lane);
  SCL_PROF_ADD(c, PROF_ASCEND, t_ascend);
}

// One chunk step of one frame of a wide list (exact nodes, rank vectors).
template <bool kNarrow>
__device__ __forceinline__ void chunk_step_wide(const CtxWide& c, const Geometry& g,
                                                const StacksT<WideWord>& st, const float* x,
                                                float* pm, const int4* prog, const StepArgs& a) {
  const int lane = c.lane, wi = kNarrow ? a.lv_in : g.L;
  SCL_PROF_T(t_step);
  step_descend<kNarrow, false, 2>(c, g, st, x, a);
  SCL_PROF_ADD(c, PROF_DESCEND, t_step);
  SCL_PROF_T(t_copy);
  float* top = chunk_top(c, st.alpha(g.t), prog, a.n_ops, wi);
  float pmr[2];
  int R[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    pmr[s] = lane + s * kWarp < wi ? pm[lane + s * kWarp] : -INFINITY;
    R[s] = lane + s * kWarp;
  }
  SCL_PROF_ADD(c, PROF_COPY_IN, t_copy);
  SCL_PROF_T(t_body);
  chunk_body_wide<kNarrow>(c, top, prog, a.n_ops, a.has_R, wi, pmr, R);
  SCL_PROF_ADD(c, PROF_BODY, t_body);
  step_ascend_wide<kNarrow>(c, g, st, pm, a, pmr, R);
  SCL_PROF_ADD(c, PROF_STEP, t_step);
}

// One chunk step of one frame (see the parts above); kFast: a fast node
// program.
template <bool kNarrow, bool kOneHot, bool kFast>
__device__ __forceinline__ void chunk_step(const Ctx& c, const Geometry& g, const Stacks& st,
                                           const float* x, float* pm, const int4* prog,
                                           const StepArgs& a) {
  const int lane = c.lane, wi = kNarrow ? a.lv_in : g.L;
  SCL_PROF_T(t_step);
  step_descend<kNarrow, kOneHot>(c, g, st, x, a);
  SCL_PROF_ADD(c, PROF_DESCEND, t_step);

  // ---- chunk body on the level-t alpha where the descend left it; a chunk
  // that is one rate-0 or REP node works on a copy in the context
  SCL_PROF_T(t_copy);
  float* top = chunk_top(c, st.alpha(g.t), prog, a.n_ops, wi);
  float pmr = lane < wi ? pm[lane] : -INFINITY;
  int R = lane;
  SCL_PROF_ADD(c, PROF_COPY_IN, t_copy);
  SCL_PROF_T(t_body);
  chunk_body<kNarrow, kFast>(c, top, prog, a.n_ops, a.has_R, wi, pmr, R);
  SCL_PROF_ADD(c, PROF_BODY, t_body);
  step_ascend<kNarrow>(c, g, st, pm, a, pmr, R);
  SCL_PROF_ADD(c, PROF_STEP, t_step);
}

// n-bit reversal of x (0 for n = 0)
__device__ __forceinline__ int brev_bits(int x, int n) {
  return n ? (int)(__brev((unsigned)x) >> (32 - n)) : 0;
}
// four-bit reversal, for offsets known at compile time
__host__ __device__ constexpr int brev4(int r) {
  return ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | ((r & 8) >> 3);
}

// The butterfly u = beta * G on the N packed words of `root` (storage order
// p; natural position i = the n-bit reversal of p, n = log2 N), then u in
// natural order: u is [L][N] int8.  Each stage XORs the words whose index has
// bit k clear with their partner at bit k set, and the stages commute.  The
// stages on bits 0-4 run on one word a lane (word 32 j + lane) by
// xor-shuffles; the higher bits in passes of two stages (four words a lane in
// registers, consecutive lanes on consecutive words: no bank conflict), so
// N = 1024 takes 3 __syncwarp and no index division.  Then each lane writes
// runs of 16 natural positions (run k = lane R + j of N / 16, R = N / 512
// runs a lane): run k's word o sits at p = brev4(o) << (n - 4) | the
// reversal of k, so its 32 lanes read 32 banks; it packs each path's bits of
// the run into one 16-byte store (__byte_perm gathers a byte of four words, a
// shift and mask takes each path's bit of it): N L / 512 stores a lane,
// against 32-way conflicted reads of one word a lane and N L / 32 byte stores
// before.  Few live registers: with 16 or 32 words a lane in registers the
// 64-register kernels spilled, and so did unrolled loops here.  N < 16 takes
// plain loops.  The profile counts the butterfly and the output stores apart.
template <typename W>
__device__ __forceinline__ void root_out(const CtxT<W>& c, W* root, int N, int L, int log2N,
                                         int8_t* u) {
  const int n = log2N, lane = c.lane;
  SCL_PROF_T(t_fly);
#pragma unroll 1
  for (int j = 0; j < N; j += kWarp) {  // bits 0-4 (or 0 .. n-1)
    const bool on = j + lane < N;
    W w = on ? root[j + lane] : (W)0;
    for (int k = 0; k < min(5, n); ++k) {
      const W o = __shfl_xor_sync(kFull, w, 1 << k);
      if (!((lane >> k) & 1)) w ^= o;
    }
    if (on) root[j + lane] = w;
  }
  __syncwarp();
  for (int k = 5; k < n; k += 2) {  // bits k and k + 1 (k alone at the top)
    const int s = 1 << k;
    if (k + 1 < n) {
      for (int q = lane; q < N / 4; q += kWarp) {
        const int p = ((q >> k) << (k + 2)) | (q & (s - 1));
        W a = root[p], b = root[p + s], x = root[p + 2 * s], y = root[p + 3 * s];
        a ^= b;
        x ^= y;
        root[p] = a ^ x;
        root[p + s] = b ^ y;
        root[p + 2 * s] = x;
      }
    } else {
      for (int q = lane; q < N / 2; q += kWarp) {
        const int p = ((q >> k) << (k + 1)) | (q & (s - 1));
        root[p] ^= root[p + s];
      }
    }
    __syncwarp();
  }
  SCL_PROF_ADD(c, PROF_BUTTERFLY, t_fly);
  SCL_PROF_T(t_out);
  if (n < 4) {
    for (int idx = lane; idx < L * N; idx += kWarp)
      u[idx] = (int8_t)((root[brev_bits(idx & (N - 1), n)] >> (idx >> n)) & 1u);
  } else {
    const int runs = N >> 4, per = max(1, runs / kWarp);
#pragma unroll 1
    for (int k = lane * per; k < min(runs, (lane + 1) * per); ++k) {
      const int rk = brev_bits(k, n - 4), hi = n - 4;
      int8_t* run = u + 16 * k;
      for (int b = 0; b < L; b += 8) {
        const uint32_t sel = paths_byte_sel<W>(b);
        uint32_t x[4];  // byte b / 8 of the run's words 4q .. 4q + 3
        const W* r = root + rk;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[q] = __byte_perm(__byte_perm(paths_half(r[brev4(4 * q) << hi], b),
                                         paths_half(r[brev4(4 * q + 1) << hi], b), sel),
                             __byte_perm(paths_half(r[brev4(4 * q + 2) << hi], b),
                                         paths_half(r[brev4(4 * q + 3) << hi], b), sel),
                             0x5410);
#pragma unroll 1
        for (int l = b; l < min(b + 8, L); ++l) {
          const int sh = l - b;
          *reinterpret_cast<uint4*>(run + (size_t)l * N) =
              make_uint4((x[0] >> sh) & 0x01010101u, (x[1] >> sh) & 0x01010101u,
                         (x[2] >> sh) & 0x01010101u, (x[3] >> sh) & 0x01010101u);
        }
      }
    }
  }
  SCL_PROF_ADD(c, PROF_OUT, t_out);
}

// The last chunk after its body (metrics pmr and rank vector R in the lanes,
// at full width): the metrics out, the ascend to the root (the chunk's R
// composes into each pend_b on the way), butterfly and u.  `root` is N
// words: the context's alpha region when N <= L * S, else a plane of the
// last-chunk kernel's own or (whole decode) the frame's bit-reversed LLRs;
// those words are dead once the body has returned.  kWide (the last-chunk
// kernel): four words a lane by 16-byte reads, two reads in flight, each
// pending read from shared memory once for its four words (one word a read,
// the ascend waited on device memory word by word: 5.5 % of the flagship's
// last chunk, NVIDIA H100 80GB HBM3, 700 W, PERF.md); the whole-decode
// kernel reads one word a lane (with the wide reads its long-table instance
// spilled 48 B at 64 registers).
template <bool kWide>
__device__ __forceinline__ void last_ascend(const Ctx& c, uint32_t* root, const Geometry& g,
                                            const Stacks& st, float pmr, int R, int8_t* u,
                                            float* pm_out, int log2N) {
  const int N = g.N, S = g.S, L = g.L, t = g.t, lane = c.lane;
  SCL_PROF_T(t_last);
  if (lane < L) pm_out[lane] = pmr;
  for (int i = lane; i < S; i += kWarp) root[N - S + i] = c.beta[i];
  if constexpr (!kWide) {
    __syncwarp();
    for (int lev = t; lev >= 1; --lev) {
      const int size = N >> lev;
      const uint32_t* left = st.beta(lev);
      if (lane < L) c.tmp[lane] = st.pend_b(lev)[R];
      __syncwarp();
      for (int i = lane; i < size; i += kWarp)
        root[N - 2 * size + i] = perm_word(left[i], c.tmp, L) ^ root[N - size + i];
      __syncwarp();
    }
    SCL_PROF_ADD(c, PROF_LAST, t_last);
    root_out(c, root, N, L, log2N, u);
    return;
  }
  const bool vec = S >= 4 && !(((uintptr_t)root | (uintptr_t)st.Bt) & 15u);
  for (int lev = t; lev >= 1; --lev) {
    const int size = N >> lev;
    const uint32_t* left = st.beta(lev);
    uint32_t* dst = root + N - 2 * size;
    if (lane < L) c.tmp[lane] = st.pend_b(lev)[R];
    __syncwarp();
    if (!vec) {
      for (int i = lane; i < size; i += kWarp)
        dst[i] = perm_word(left[i], c.tmp, L) ^ dst[size + i];
      __syncwarp();
      continue;
    }
    for (int i0 = 4 * lane; i0 < size; i0 += 8 * kWarp) {
      uint4 lw[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (i0 + 4 * kWarp * k < size)
          lw[k] = *reinterpret_cast<const uint4*>(left + i0 + 4 * kWarp * k);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + 4 * kWarp * k;
        if (i >= size) break;
        uint4 o = *reinterpret_cast<const uint4*>(dst + size + i);
        for (int l = 0; l < L; ++l) {
          const int r = c.tmp[l];
          o.x ^= ((lw[k].x >> r) & 1u) << l;
          o.y ^= ((lw[k].y >> r) & 1u) << l;
          o.z ^= ((lw[k].z >> r) & 1u) << l;
          o.w ^= ((lw[k].w >> r) & 1u) << l;
        }
        *reinterpret_cast<uint4*>(dst + i) = o;
      }
    }
    __syncwarp();
  }
  __syncwarp();
  SCL_PROF_ADD(c, PROF_LAST, t_last);

  root_out(c, root, N, L, log2N, u);
}

// last_ascend<true> of a wide list: the metrics and R in the slots, the
// root plane N 64-bit words; four words a lane (two 16-byte reads each of
// the left betas and of the right halves), each pending read once for them.
__device__ __forceinline__ void last_ascend_wide(const CtxWide& c, WideWord* root,
                                                 const Geometry& g, const StacksT<WideWord>& st,
                                                 const float (&pmr)[2], const int (&R)[2],
                                                 int8_t* u, float* pm_out, int log2N) {
  const int N = g.N, S = g.S, L = g.L, t = g.t, lane = c.lane;
  SCL_PROF_T(t_last);
#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (lane + s * kWarp < L) pm_out[lane + s * kWarp] = pmr[s];
  for (int i = lane; i < S; i += kWarp) root[N - S + i] = c.beta[i];
  const bool vec = S >= 4 && !(((uintptr_t)root | (uintptr_t)st.Bt) & 15u);
  for (int lev = t; lev >= 1; --lev) {
    const int size = N >> lev;
    const WideWord* left = st.beta(lev);
    WideWord* dst = root + N - 2 * size;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (lane + s * kWarp < L) c.tmp[lane + s * kWarp] = st.pend_b(lev)[R[s]];
    __syncwarp();
    if (!vec) {
      for (int i = lane; i < size; i += kWarp)
        dst[i] = perm_word_wide(left[i], c.tmp, L) ^ dst[size + i];
      __syncwarp();
      continue;
    }
    for (int i = 4 * lane; i < size; i += 4 * kWarp) {
      const ulonglong2 l0 = *reinterpret_cast<const ulonglong2*>(left + i);
      const ulonglong2 l1 = *reinterpret_cast<const ulonglong2*>(left + i + 2);
      ulonglong2 o0 = *reinterpret_cast<const ulonglong2*>(dst + size + i);
      ulonglong2 o1 = *reinterpret_cast<const ulonglong2*>(dst + size + i + 2);
      for (int l = 0; l < L; ++l) {
        const int r = c.tmp[l];
        o0.x ^= ((l0.x >> r) & 1ull) << l;
        o0.y ^= ((l0.y >> r) & 1ull) << l;
        o1.x ^= ((l1.x >> r) & 1ull) << l;
        o1.y ^= ((l1.y >> r) & 1ull) << l;
      }
      *reinterpret_cast<ulonglong2*>(dst + i) = o0;
      *reinterpret_cast<ulonglong2*>(dst + i + 2) = o1;
    }
    __syncwarp();
  }
  __syncwarp();
  SCL_PROF_ADD(c, PROF_LAST, t_last);
  root_out(c, root, N, L, log2N, u);
}

// The last chunk's context: the chunk step's (its top plane in a scratch
// buffer in device memory, as the chunk step reads level t of the stacks),
// the root plane (on the context's alpha region, dead once the body has
// returned, when N <= L * S, else N words of its own), and for kOneHot the
// 2 t L staged rank vectors.  4,928 B a flagship frame (5,120 one-hot),
// 13,120 (13,312) with a top plane and a root plane of their own: 17 warps
// per SM, and 4096 frames took 1.83 waves.
__host__ __device__ inline int last_root_words(int L, int S, int N) { return N > L * S ? N : 0; }
__host__ __device__ inline int last_ctx_words(int L, int S, int lgS, int N, int t, bool onehot) {
  return ctx_words(L, S, lgS) + last_root_words(L, S, N) + (onehot ? 2 * t * L : 0);
}
// a wide list's: its root plane is N 64-bit words
__host__ __device__ inline int last_root_words_wide(int L, int S, int N) {
  return 2 * N > L * S ? 2 * N : 0;
}
__host__ __device__ inline int last_ctx_words_wide(int L, int S, int lgS, int N) {
  return ctx_words_wide(L, S, lgS) + last_root_words_wide(L, S, N);
}

// The last chunk of one frame, at full width: one g at level t into `top`
// (the frame's [L][S] scratch plane in device memory: the state is read
// only), the body on it as the chunk step's (chunk_top), last_ascend.
// `frame_stacks_of()` gives the frame's stacks, `outputs_of()` its u and
// pm_out: built where they are used, not held through the body (with them
// held, the fast instance spilled at 64 registers).  `pm` may be the same
// memory as pm_out: it is read before it is written.  one_a / one_b: the
// one-lane pendings of the descend.  kFast: a fast node program.
template <bool kOneHot, bool kFast, typename StacksOf, typename OutputsOf>
__device__ __forceinline__ void last_chunk(const Ctx& c, const Geometry& g,
                                           StacksOf frame_stacks_of, OutputsOf outputs_of,
                                           const float* x, const float* pm, float* top,
                                           const int4* prog, int n_ops, int has_R, int log2N,
                                           int one_a, int one_b) {
  const int L = g.L, t = g.t, lane = c.lane;
  SCL_PROF_T(t_frame);
  descend_g<kOneHot>(g, frame_stacks_of(), x, t, false, top, lane, L, one_a, one_b);
  float pmr = lane < L ? pm[lane] : 0.0f;
  int R = lane;
  __syncwarp();
  float* a0 = chunk_top(c, top, prog, n_ops, L);
  SCL_PROF_ADD(c, PROF_DESCEND, t_frame);
  SCL_PROF_T(t_body);
  chunk_body<false, kFast>(c, a0, prog, n_ops, has_R, L, pmr, R);
  SCL_PROF_ADD(c, PROF_BODY, t_body);
  int8_t* u;
  float* pm_out;
  outputs_of(u, pm_out);
  // the root plane: the context's alpha region, else its own after the context
  const int rw = last_root_words(L, g.S, g.N);
  uint32_t* root = reinterpret_cast<uint32_t*>(c.alpha + (rw ? ctx_words(L, g.S, g.lgS) : 0));
  last_ascend<true>(c, root, g, frame_stacks_of(), pmr, R, u, pm_out, log2N);
  SCL_PROF_ADD(c, PROF_STEP, t_frame);
}

// last_chunk of a wide list (exact nodes, rank vectors).
template <typename StacksOf, typename OutputsOf>
__device__ __forceinline__ void last_chunk_wide(const CtxWide& c, const Geometry& g,
                                                StacksOf frame_stacks_of, OutputsOf outputs_of,
                                                const float* x, const float* pm, float* top,
                                                const int4* prog, int n_ops, int has_R,
                                                int log2N, int one_a, int one_b) {
  const int L = g.L, t = g.t, lane = c.lane;
  SCL_PROF_T(t_frame);
  descend_g(g, frame_stacks_of(), x, t, false, top, lane, L, one_a, one_b);
  float pmr[2];
  int R[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    pmr[s] = lane + s * kWarp < L ? pm[lane + s * kWarp] : 0.0f;
    R[s] = lane + s * kWarp;
  }
  __syncwarp();
  float* a0 = chunk_top(c, top, prog, n_ops, L);
  SCL_PROF_ADD(c, PROF_DESCEND, t_frame);
  SCL_PROF_T(t_body);
  chunk_body_wide<false>(c, a0, prog, n_ops, has_R, L, pmr, R);
  SCL_PROF_ADD(c, PROF_BODY, t_body);
  int8_t* u;
  float* pm_out;
  outputs_of(u, pm_out);
  const int rw = last_root_words_wide(L, g.S, g.N);
  WideWord* root =
      reinterpret_cast<WideWord*>(c.alpha + (rw ? ctx_words_wide(L, g.S, g.lgS) : 0));
  last_ascend_wide(c, root, g, frame_stacks_of(), pmr, R, u, pm_out, log2N);
  SCL_PROF_ADD(c, PROF_STEP, t_frame);
}

// The levels a chunk step writes a pending of: pend_a at the descend's
// resets and the composes, pend_b at the composes and the parked level.
__device__ __forceinline__ void written_levels(const StepArgs& a, int t, int* la, int* lb) {
  const int lo = a.k == t ? 1 : t - a.k;
  *la = (((1 << t) - 1) & ~((1 << (lo - 1)) - 1)) | a.mask_a;
  *lb = a.mask_b | (1 << (t - a.j - 1));
}

// The levels a full-width chunk step reads a pending of before it writes it:
// pend_a at the parent of the descend's g (level lo - 1) when the g reads
// through it, and at the composed levels the descend did not reset (it resets
// lo .. t first); pend_b at the g's level lo, the composed levels, and the
// ascend's j levels t - j + 1 .. t.  Chunk 0 (k == t) reads no pending in its
// descend.  Narrow and one-lane masks do not apply: one-hot is full width.
__device__ __forceinline__ void read_levels(const StepArgs& a, int t, int* ra, int* rb) {
  const int full = (1 << t) - 1, ascend = full & ~((1 << (t - a.j)) - 1);
  if (a.k == t) {
    *ra = 0;
    *rb = a.mask_b | ascend;
    return;
  }
  const int lo = t - a.k, reset = full & ~((1 << (lo - 1)) - 1);
  *ra = (lo > 1 && !a.inv ? 1 << (lo - 2) : 0) | (a.mask_a & ~reset);
  *rb = (1 << (lo - 1)) | a.mask_b | ascend;
}

// The levels the last chunk reads: pend_a at the parent of its g (level t -
// 1), every pend_b (its ascend to the root); as level bits of onehot_load.
__device__ __forceinline__ unsigned last_read_levels(int t) {
  return (t > 1 ? 1u << (t - 2) : 0u) | (((1u << t) - 1u) << t);
}

// One chunk step at full width.  kOneHot: pend_a / pend_b are the one-hot
// planes [B][t][L][L] (float); the warp stages the rank vectors of the levels
// the step reads (read_levels) after its chunk context and stores the levels
// it wrote (2 t <= 32 levels in one bit mask; the launcher refuses more).
// kFast: a fast node program (full width, rank vectors), compiled as
// instances of its own so that the exact ones carry no fast code.  The live
// width's narrow steps run in scl_narrow_prefix_kernel.
// The shared-memory variants keep to 64 registers: 32 warps per SM, so that
// 4096 flagship frames are one wave (132 SMs).
template <bool kDev, bool kOneHot, bool kFast>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, kDev ? 1 : 4)
    scl_chunk_step_kernel(const float* __restrict__ llr, float* alpha, uint32_t* beta,
                                      int* pend_a, int* pend_b, float* pm,
                                      const int4* __restrict__ prog, Geometry g, StepArgs a,
                                      float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int cw = ctx_words(g.L, g.S, g.lgS), tl = g.t * g.L;
  float* base = ctx_base<kDev>(smem_raw, ctx_dev, cw + (kOneHot ? 2 * tl : 0));
  Ctx c = make_ctx(base, g.L, g.S, lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  int* ranks = reinterpret_cast<int*>(base + cw);
  for_each_frame<kDev>(g.B, [&](int frame) {
    Stacks st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
    float* pa_planes = reinterpret_cast<float*>(pend_a) + (size_t)frame * tl * g.L;
    float* pb_planes = reinterpret_cast<float*>(pend_b) + (size_t)frame * tl * g.L;
    if (kOneHot) {
      SCL_PROF_T(t_load);
      int ra, rb;
      read_levels(a, g.t, &ra, &rb);
      onehot_load(pa_planes, pb_planes, ranks, (unsigned)ra | ((unsigned)rb << g.t), g.t, g.L,
                  lane);
      st.PA = ranks;
      st.PB = ranks + tl;
      SCL_PROF_ADD(c, PROF_ONEHOT_LOAD, t_load);
    }
    chunk_step<false, kOneHot, kFast>(c, g, st, llr + (size_t)frame * g.N,
                                      pm + (size_t)frame * g.L, prog, a);
    if (kOneHot) {
      SCL_PROF_T(t_store);
      __syncwarp();
      int la, lb;
      written_levels(a, g.t, &la, &lb);
      onehot_store(pa_planes, pb_planes, ranks, (unsigned)la | ((unsigned)lb << g.t), g.t, g.L,
                   lane);
      SCL_PROF_ADD(c, PROF_ONEHOT_STORE, t_store);
    }
  });
  SCL_PROF_FLUSH(c);
}

// The narrow prefix of a live decode (the TPU kernel's widths= mode): its
// chunk steps whose live path counts lv_in / lv_out are below L, in ONE
// launch.  Live path counts only grow, so those steps are the positions 0 ..
// P - 1 of the decode.  At a few live paths a step's device work is tiny and
// a launch of its own cost the host's issue of it (0.04-0.05 ms a launch
// against a 0.002 ms bound, NVIDIA H100 80GB HBM3, 700 W, PERF.md); here the
// warp keeps its frame through every row of the step table, in order, with
// a __syncwarp between rows (frames are independent: no grid-wide sync).
// Each row is one narrow step's StepArgs (its node program at prog_off of the
// rows' programs back to back), in the launch's parameters; a longer prefix
// is split by the host into consecutive launches of at most kPrefixParamRows
// rows.  The body is the narrow chunk step's (chunk_step<true>), whose width
// is a variable: every row is narrow, so no full-width chunk pays for that.
// Compiled inside the row loop, it runs rows where the list grows 5-9 %
// slower than the launch-per-step kernel did (the flagship's two rows: 0.918x
// by device time, NVIDIA H100 80GB HBM3, 700 W; PERF.md lists the variants
// tried).  A table of one row is exactly one narrow step.  The shared-memory
// variant keeps to 64 registers (32 warps per SM at the flagship's context),
// the device-memory one walks the frames of its scratch slices.
constexpr int kPrefixParamRows = 64;
struct PrefixSteps {
  int n;  // rows in use
  StepArgs rows[kPrefixParamRows];
};

template <bool kDev>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, kDev ? 1 : 4)
    scl_narrow_prefix_kernel(const float* __restrict__ llr, float* alpha, uint32_t* beta,
                             int* pend_a, int* pend_b, float* pm, const int4* __restrict__ prog,
                             Geometry g, const __grid_constant__ PrefixSteps steps,
                             float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  Ctx c = make_ctx(ctx_base<kDev>(smem_raw, ctx_dev, ctx_words(g.L, g.S, g.lgS)), g.L, g.S,
                   lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  for_each_frame<kDev>(g.B, [&](int frame) {
    for (int r = 0; r < steps.n; ++r) {
      const StepArgs& a = steps.rows[r];
      // the frame's pointers at every row, not held through a body
      const Stacks st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
      chunk_step<true, false, false>(c, g, st, llr + (size_t)frame * g.N,
                                     pm + (size_t)frame * g.L, prog + a.prog_off, a);
      __syncwarp();
    }
  });
  SCL_PROF_FLUSH(c);
}

// kOneHot: the pendings are one-hot planes, the levels the last chunk reads
// (last_read_levels) staged as rank vectors after the root plane.  kFast: a
// fast node program.  The state is read only; `top` is
// a scratch of [B][L][S] floats.  The shared-memory variants keep to 64
// registers, as the chunk step: 32 warps per SM, so that 4096 flagship frames
// are one wave (132 SMs); the device-memory ones to 128 (16 warps per SM).
template <bool kDev, bool kOneHot, bool kFast>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, 4)
    scl_last_chunk_kernel(const float* __restrict__ llr, const float* __restrict__ alpha,
                          const uint32_t* __restrict__ beta, const int* __restrict__ pend_a,
                          const int* __restrict__ pend_b, const float* pm,
                          int8_t* __restrict__ u, float* __restrict__ pm_out, float* top,
                          const int4* __restrict__ prog, int n_ops, int has_R, Geometry g,
                          int log2N, int one_a, int one_b, float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int cw = ctx_words(g.L, g.S, g.lgS), rw = last_root_words(g.L, g.S, g.N);
  const int tl = g.t * g.L;
  float* base = ctx_base<kDev>(smem_raw, ctx_dev, cw + rw + (kOneHot ? 2 * tl : 0));
  Ctx c = make_ctx(base, g.L, g.S, lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  int* ranks = reinterpret_cast<int*>(base + cw + rw);
  for_each_frame<kDev>(g.B, [&](int frame) {
    if (kOneHot) {
      SCL_PROF_T(t_load);
      onehot_load(reinterpret_cast<const float*>(pend_a) + (size_t)frame * tl * g.L,
                  reinterpret_cast<const float*>(pend_b) + (size_t)frame * tl * g.L, ranks,
                  last_read_levels(g.t), g.t, g.L, lane);
      SCL_PROF_ADD(c, PROF_ONEHOT_LOAD, t_load);
    }
    const auto stacks_of = [&]() {
      Stacks st = frame_stacks(g, frame, const_cast<float*>(alpha), const_cast<uint32_t*>(beta),
                               const_cast<int*>(pend_a), const_cast<int*>(pend_b));
      if (kOneHot) {
        st.PA = ranks;
        st.PB = ranks + tl;
      }
      return st;
    };
    const auto outputs_of = [&](int8_t*& u_f, float*& pm_f) {
      u_f = u + (size_t)frame * g.L * g.N;
      pm_f = pm_out + (size_t)frame * g.L;
    };
    last_chunk<kOneHot, kFast>(c, g, stacks_of, outputs_of, llr + (size_t)frame * g.N,
                               pm + (size_t)frame * g.L, top + (size_t)frame * g.L * g.S,
                               prog, n_ops, has_R, log2N, one_a, one_b);
  });
  SCL_PROF_FLUSH(c);
}

// ---- the wide-list instances (33 <= L <= 64, two paths a lane) -----------
//
// K5, K3, the narrow prefix and K4 for a wide list: the kernels above with
// the wide device functions (chunk_body_wide, step_ascend_wide,
// last_ascend_wide, body_out_wide) on the wide context (ctx_words_wide) and
// 64-bit words of path bits in the state (beta [B][N-S] as 64-bit words).
// Exact node programs on rank vectors only.  A wide frame's context is large
// (36,352 B at L=64, S=128), so shared memory holds a few frames an SM, and
// the launch bounds let the instances take up to 128 registers (the
// device-memory ones likewise).
template <bool kDev>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, kDev ? 4 : 2)
    scl_chunk_body_wide_kernel(const float* __restrict__ alpha, const float* __restrict__ pm,
                               int8_t* __restrict__ beta_out, float* __restrict__ pm_out,
                               long long* __restrict__ r_out, const int4* __restrict__ prog,
                               int n_ops, int has_R, int B, int S, int L, int lgS,
                               float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  CtxWide c =
      make_ctx_wide(ctx_base<kDev>(smem_raw, ctx_dev, ctx_words_wide(L, S, lgS)), L, S, lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  for_each_frame<kDev>(B, [&](int frame) {
    SCL_PROF_T(t_frame);
    float* top = chunk_top(c, const_cast<float*>(alpha) + (size_t)frame * (size_t)(L * S), prog,
                           n_ops, L);
    float pmr[2];
    int R[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      pmr[s] = lane + s * kWarp < L ? pm[(size_t)frame * (size_t)L + lane + s * kWarp] : 0.0f;
      R[s] = lane + s * kWarp;
    }
    __syncwarp();
    SCL_PROF_ADD(c, PROF_COPY_IN, t_frame);
    SCL_PROF_T(t_body);
    chunk_body_wide<false>(c, top, prog, n_ops, has_R, L, pmr, R);
    SCL_PROF_ADD(c, PROF_BODY, t_body);
    SCL_PROF_T(t_out);
    body_out_wide(c, beta_out + (size_t)frame * (size_t)(L * S),
                  pm_out + (size_t)frame * (size_t)L, r_out + (size_t)frame * (size_t)L, L, S,
                  lgS, pmr, R);
    SCL_PROF_ADD(c, PROF_OUT, t_out);
    SCL_PROF_ADD(c, PROF_STEP, t_frame);
  });
  SCL_PROF_FLUSH(c);
}

template <bool kDev>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, kDev ? 4 : 2)
    scl_chunk_step_wide_kernel(const float* __restrict__ llr, float* alpha, WideWord* beta,
                               int* pend_a, int* pend_b, float* pm,
                               const int4* __restrict__ prog, Geometry g, StepArgs a,
                               float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  CtxWide c = make_ctx_wide(ctx_base<kDev>(smem_raw, ctx_dev, ctx_words_wide(g.L, g.S, g.lgS)),
                            g.L, g.S, lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  for_each_frame<kDev>(g.B, [&](int frame) {
    const StacksT<WideWord> st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
    chunk_step_wide<false>(c, g, st, llr + (size_t)frame * g.N, pm + (size_t)frame * g.L, prog,
                           a);
  });
  SCL_PROF_FLUSH(c);
}

template <bool kDev>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, kDev ? 4 : 2)
    scl_narrow_prefix_wide_kernel(const float* __restrict__ llr, float* alpha, WideWord* beta,
                                  int* pend_a, int* pend_b, float* pm,
                                  const int4* __restrict__ prog, Geometry g,
                                  const __grid_constant__ PrefixSteps steps, float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  CtxWide c = make_ctx_wide(ctx_base<kDev>(smem_raw, ctx_dev, ctx_words_wide(g.L, g.S, g.lgS)),
                            g.L, g.S, lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  for_each_frame<kDev>(g.B, [&](int frame) {
    for (int r = 0; r < steps.n; ++r) {
      const StepArgs& a = steps.rows[r];
      const StacksT<WideWord> st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
      chunk_step_wide<true>(c, g, st, llr + (size_t)frame * g.N, pm + (size_t)frame * g.L,
                            prog + a.prog_off, a);
      __syncwarp();
    }
  });
  SCL_PROF_FLUSH(c);
}

template <bool kDev>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, kDev ? 4 : 2)
    scl_last_chunk_wide_kernel(const float* __restrict__ llr, const float* __restrict__ alpha,
                               const WideWord* __restrict__ beta, const int* __restrict__ pend_a,
                               const int* __restrict__ pend_b, const float* pm,
                               int8_t* __restrict__ u, float* __restrict__ pm_out, float* top,
                               const int4* __restrict__ prog, int n_ops, int has_R, Geometry g,
                               int log2N, int one_a, int one_b, float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  CtxWide c = make_ctx_wide(
      ctx_base<kDev>(smem_raw, ctx_dev, last_ctx_words_wide(g.L, g.S, g.lgS, g.N)), g.L, g.S,
      lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  for_each_frame<kDev>(g.B, [&](int frame) {
    const auto stacks_of = [&]() {
      return frame_stacks(g, frame, const_cast<float*>(alpha), const_cast<WideWord*>(beta),
                          const_cast<int*>(pend_a), const_cast<int*>(pend_b));
    };
    const auto outputs_of = [&](int8_t*& u_f, float*& pm_f) {
      u_f = u + (size_t)frame * g.L * g.N;
      pm_f = pm_out + (size_t)frame * g.L;
    };
    last_chunk_wide(c, g, stacks_of, outputs_of, llr + (size_t)frame * g.N,
                    pm + (size_t)frame * g.L, top + (size_t)frame * g.L * g.S, prog, n_ops,
                    has_R, log2N, one_a, one_b);
  });
  SCL_PROF_FLUSH(c);
}

// ---- the XL-list instances (65 <= L <= 256, four or eight paths a lane) --
//
// K5, K3, the narrow prefix and K4 for an XL list: the kernels above with the
// XL device functions (chunk_body_xl, prune_xl, perm_xor_xl) on the XL context
// (ctx_words_xl) and kP 32-bit words of path bits a position in the state
// (beta [B][N-S][kP]).  Exact node programs on rank vectors only.  A frame's
// context is large (72,704 B at L=128, S=128; 76,800 B at L=256, S=64), so
// shared memory holds one to three frames an SM, and the launch bounds let
// the instances take up to 255 registers.  Built apart from the other
// instances (scl_body_xl.cu, scl_decode_xl.cu, scl_last_xl.cu: three more
// nvcc processes beside the others), so that the L <= 64 instances keep their
// build time and their code.

// The level stacks of one frame of an XL list: as StacksT, beta kP words a
// position.
template <int kP>
struct StacksXl {
  float* A;
  uint32_t* Bt;
  int* PA;
  int* PB;
  int N, L;
  __device__ __forceinline__ float* alpha(int l) const {
    return A + (size_t)L * (N - (N >> (l - 1)));
  }
  __device__ __forceinline__ uint32_t* beta(int l) const {
    return Bt + (size_t)kP * (N - (N >> (l - 1)));
  }
  __device__ __forceinline__ int* pend_a(int l) const { return PA + (l - 1) * L; }
  __device__ __forceinline__ int* pend_b(int l) const { return PB + (l - 1) * L; }
};

template <int kP>
__device__ __forceinline__ StacksXl<kP> frame_stacks_xl(const Geometry& g, int frame,
                                                        float* alpha, uint32_t* beta,
                                                        int* pend_a, int* pend_b) {
  StacksXl<kP> s;
  s.A = alpha + (size_t)frame * (size_t)(g.L * (g.N - g.S));
  s.Bt = beta + (size_t)frame * (size_t)(kP * (g.N - g.S));
  s.PA = pend_a + (size_t)frame * (size_t)(g.t * g.L);
  s.PB = pend_b + (size_t)frame * (size_t)(g.t * g.L);
  s.N = g.N;
  s.L = g.L;
  return s;
}

// The identity on the first w entries of a pending, kP entries a lane.
template <int kP>
__device__ __forceinline__ void set_identity_xl(int* p, int w, int lane) {
#pragma unroll
  for (int s = 0; s < kP; ++s)
    if (lane + kWarp * s < w) p[lane + kWarp * s] = lane + kWarp * s;
}

// descend_g of an XL list (rank vectors): path r's left bit is bit r & 31 of
// word r >> 5 of the position.
template <int kP>
__device__ __forceinline__ void descend_g_xl(const Geometry& g, const StacksXl<kP>& st,
                                             const float* x, int lo, bool inv, float* dst,
                                             int lane, int w, int one_a, int one_b) {
  const int M = g.N >> lo, lgM = ilog2(M);
  const uint32_t* bl = st.beta(lo);
  const int* pb = st.pend_b(lo);
  const bool pb_one = (one_b >> (lo - 1)) & 1;
  const float* parent = lo == 1 ? x : st.alpha(lo - 1);
  const int* pa = lo == 1 ? nullptr : st.pend_a(lo - 1);
  const bool pa_one = lo != 1 && ((one_a >> (lo - 2)) & 1);
  const bool through = lo != 1 && !inv;
  for (int idx = lane; idx < w * M; idx += kWarp) {
    const int l = idx >> lgM, i = idx & (M - 1);
    const float* src = parent;
    if (through) src += (size_t)pa[pa_one ? 0 : l] * 2 * M;
    const float sgn =
        1.0f - 2.0f * (float)path_bit_xl<kP>(bl + (size_t)kP * i, pb[pb_one ? 0 : l]);
    dst[idx] = src[M + i] + sgn * src[i];
  }
}

// step_descend of an XL list.
template <bool kNarrow, int kP>
__device__ __forceinline__ void step_descend_xl(int lane, const Geometry& g,
                                                const StacksXl<kP>& st, const float* x,
                                                const StepArgs& a) {
  const int N = g.N, t = g.t;
  const int wi = kNarrow ? a.lv_in : g.L;
  const int one_a = kNarrow ? a.one_a : 0, one_b = kNarrow ? a.one_b : 0;
  if (a.k == t) {
    // chunk 0: the planes are path-invariant, compute once, store lv_in rows
    for (int l = 1; l <= t; ++l) {
      const int M = N >> l;
      const float* src = l == 1 ? x : st.alpha(l - 1);  // row 0 of the level above
      float* dst = st.alpha(l);
      for (int i = lane; i < M; i += kWarp) {
        const float v = f_minsum(src[i], src[M + i]);
        for (int r = 0; r < wi; ++r) dst[(size_t)r * M + i] = v;
      }
      set_identity_xl<kP>(st.pend_a(l), wi, lane);
      __syncwarp();
    }
    return;
  }
  const int lo = t - a.k;
  descend_g_xl<kP>(g, st, x, lo, a.inv != 0, st.alpha(lo), lane, wi, one_a, one_b);
  set_identity_xl<kP>(st.pend_a(lo), wi, lane);
  __syncwarp();
  for (int l = lo + 1; l <= t; ++l) {
    const int M = N >> l, lgM = ilog2(M);
    const float* src = st.alpha(l - 1);
    float* dst = st.alpha(l);
    for (int idx = lane; idx < wi * M; idx += kWarp) {
      const int r = idx >> lgM, i = idx & (M - 1);
      dst[idx] = f_minsum(src[(size_t)r * 2 * M + i], src[(size_t)r * 2 * M + M + i]);
    }
    set_identity_xl<kP>(st.pend_a(l), wi, lane);
    __syncwarp();
  }
}

// step_ascend of an XL list: the metrics and R in the slots, kP words a
// position; each ascend level's pend_b read into the slots (no staging), its
// rank apply kP ballots a position (perm_xor_xl).
template <bool kNarrow, int kP>
__device__ __forceinline__ void step_ascend_xl(const CtxXl<kP>& c, const Geometry& g,
                                               const StacksXl<kP>& st, float* pm,
                                               const StepArgs& a, const float (&pmr)[kP],
                                               const int (&R)[kP]) {
  const int S = g.S, t = g.t, lane = c.lane;
  const int j = a.j, mask_a = a.mask_a, mask_b = a.mask_b;
  const int wo = kNarrow ? a.lv_out : g.L, one_b = kNarrow ? a.one_b : 0;
#pragma unroll
  for (int s = 0; s < kP; ++s)
    if (lane + s * kWarp < wo) pm[lane + s * kWarp] = pmr[s];

  // ---- compose the chunk's R into the live pendings: p[l] = p[R[l]]
  for (int l = 1; l <= t; ++l) {
    int va[kP], vb[kP];
    const bool ca = (mask_a >> (l - 1)) & 1, cb = (mask_b >> (l - 1)) & 1;
#pragma unroll
    for (int s = 0; s < kP; ++s) {
      va[s] = vb[s] = 0;
      if (lane + s * kWarp < wo) {
        if (ca) va[s] = st.pend_a(l)[R[s]];
        if (cb) vb[s] = st.pend_b(l)[R[s]];
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kP; ++s)
      if (lane + s * kWarp < wo) {
        if (ca) st.pend_a(l)[lane + s * kWarp] = va[s];
        if (cb) st.pend_b(l)[lane + s * kWarp] = vb[s];
      }
  }
  __syncwarp();

  // ---- ascend, as step_ascend
  const int D = S << j;
  uint32_t* dest = st.beta(t - j);
  for (int q = lane; q < kP * S; q += kWarp) dest[(size_t)kP * (D - S) + q] = c.beta[q];
  __syncwarp();
  for (int s = 0; s < j; ++s) {
    const int lev = t - s, size = S << s;
    const bool one = ((one_b >> (lev - 1)) & 1) && !((mask_b >> (lev - 1)) & 1);
    int r[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q)
      r[q] = lane + q * kWarp < wo ? st.pend_b(lev)[one ? 0 : lane + q * kWarp] : 0;
    perm_xor_xl<kP>(dest + (size_t)kP * (D - 2 * size), st.beta(lev),
                    dest + (size_t)kP * (D - size), r, wo, size, lane);
    __syncwarp();
  }
  set_identity_xl<kP>(st.pend_b(t - j), wo, lane);
}

// One chunk step of one frame of an XL list (exact nodes, rank vectors).
template <bool kNarrow, int kP>
__device__ __forceinline__ void chunk_step_xl(const CtxXl<kP>& c, const Geometry& g,
                                              const StacksXl<kP>& st, const float* x, float* pm,
                                              const int4* prog, const StepArgs& a) {
  const int lane = c.lane, wi = kNarrow ? a.lv_in : g.L;
  step_descend_xl<kNarrow, kP>(lane, g, st, x, a);
  float* top = chunk_top(c, st.alpha(g.t), prog, a.n_ops, wi);
  float pmr[kP];
  int R[kP];
#pragma unroll
  for (int s = 0; s < kP; ++s) {
    pmr[s] = lane + s * kWarp < wi ? pm[lane + s * kWarp] : -INFINITY;
    R[s] = lane + s * kWarp;
  }
  chunk_body_xl<kNarrow, kP>(c, top, prog, a.n_ops, a.has_R, wi, pmr, R);
  step_ascend_xl<kNarrow, kP>(c, g, st, pm, a, pmr, R);
}

// The butterfly u = beta * G on the N positions of `root` (kP words each,
// storage order p), one stage a pass (words whose position has bit k clear
// XOR their partner at bit k set), then u [L][N] int8 in natural order (the
// n-bit reversal of p), four positions of a path a 4-byte store.
template <int kP>
__device__ __forceinline__ void root_out_xl(uint32_t* root, int N, int L, int log2N, int8_t* u,
                                            int lane) {
  const int n = log2N, lgP = ilog2(kP);
  for (int k = 0; k < n; ++k) {
    const int s = 1 << k;
    for (int q = lane; q < (N / 2) * kP; q += kWarp) {
      const int pair = q >> lgP, wd = q & (kP - 1);
      const int p = ((pair >> k) << (k + 1)) | (pair & (s - 1));
      root[kP * p + wd] ^= root[kP * (p + s) + wd];
    }
    __syncwarp();
  }
  if (n < 2) {
    for (int idx = lane; idx < L * N; idx += kWarp)
      u[idx] = (int8_t)path_bit_xl<kP>(root + kP * brev_bits(idx & (N - 1), n), idx >> n);
    return;
  }
  for (int q = lane; q < (L * N) >> 2; q += kWarp) {
    const int l = q >> (n - 2), i0 = (q & ((N >> 2) - 1)) << 2;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v |= path_bit_xl<kP>(root + kP * brev_bits(i0 + k, n), l) << (8 * k);
    *reinterpret_cast<uint32_t*>(u + (size_t)l * N + i0) = v;
  }
}

// The last chunk's root plane of an XL list: N positions of kP words, on the
// context's alpha region when it holds them, else after the context.
__host__ __device__ inline int last_root_words_xl(int L, int S, int N, int kP) {
  return kP * N > L * S ? kP * N : 0;
}

// last_chunk of an XL list (exact nodes, rank vectors): one g at level t into
// `top`, the body, the ascend to the root (the chunk's R composed into each
// pend_b on the way, in the slots), butterfly and u.
template <int kP, typename StacksOf, typename OutputsOf>
__device__ __forceinline__ void last_chunk_xl(const CtxXl<kP>& c, const Geometry& g,
                                              StacksOf frame_stacks_of, OutputsOf outputs_of,
                                              const float* x, const float* pm, float* top,
                                              const int4* prog, int n_ops, int has_R, int log2N,
                                              int one_a, int one_b) {
  const int N = g.N, S = g.S, L = g.L, t = g.t, lane = c.lane;
  descend_g_xl<kP>(g, frame_stacks_of(), x, t, false, top, lane, L, one_a, one_b);
  float pmr[kP];
  int R[kP];
#pragma unroll
  for (int s = 0; s < kP; ++s) {
    pmr[s] = lane + s * kWarp < L ? pm[lane + s * kWarp] : 0.0f;
    R[s] = lane + s * kWarp;
  }
  __syncwarp();
  float* a0 = chunk_top(c, top, prog, n_ops, L);
  chunk_body_xl<false, kP>(c, a0, prog, n_ops, has_R, L, pmr, R);
  int8_t* u;
  float* pm_out;
  outputs_of(u, pm_out);
#pragma unroll
  for (int s = 0; s < kP; ++s)
    if (lane + s * kWarp < L) pm_out[lane + s * kWarp] = pmr[s];
  const int rw = last_root_words_xl(L, S, N, kP);
  uint32_t* root =
      reinterpret_cast<uint32_t*>(c.alpha + (rw ? ctx_words_xl(L, S, g.lgS, kP) : 0));
  for (int q = lane; q < kP * S; q += kWarp) root[kP * (N - S) + q] = c.beta[q];
  __syncwarp();
  const StacksXl<kP> st = frame_stacks_of();
  for (int lev = t; lev >= 1; --lev) {
    const int size = N >> lev;
    int r[kP];
#pragma unroll
    for (int s = 0; s < kP; ++s) r[s] = lane + s * kWarp < L ? st.pend_b(lev)[R[s]] : 0;
    perm_xor_xl<kP>(root + kP * (N - 2 * size), st.beta(lev), root + kP * (N - size), r, L,
                    size, lane);
    __syncwarp();
  }
  root_out_xl<kP>(root, N, L, log2N, u, lane);
}

// The body kernel's outputs of one frame of an XL list: beta_out [L][S] int8
// (four positions of a path a 4-byte store when S >= 4), pm_out [L] and the
// rank vector r_out [L] from the slots.
template <int kP>
__device__ __forceinline__ void body_out_xl(const CtxXl<kP>& c, int8_t* beta_out, float* pm_out,
                                            long long* r_out, int L, int S, int lgS,
                                            const float (&pmr)[kP], const int (&R)[kP]) {
  const int lane = c.lane;
  if (S >= 4) {
    for (int q = lane; q < (L * S) >> 2; q += kWarp) {
      const int l = q >> (lgS - 2), i0 = (q & ((S >> 2) - 1)) << 2;
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) v |= path_bit_xl<kP>(c.beta + kP * (i0 + k), l) << (8 * k);
      *reinterpret_cast<uint32_t*>(beta_out + (size_t)l * S + i0) = v;
    }
  } else {
    for (int idx = lane; idx < L * S; idx += kWarp)
      beta_out[idx] = (int8_t)path_bit_xl<kP>(c.beta + kP * (idx & (S - 1)), idx >> lgS);
  }
#pragma unroll
  for (int s = 0; s < kP; ++s)
    if (lane + s * kWarp < L) {
      pm_out[lane + s * kWarp] = pmr[s];
      r_out[lane + s * kWarp] = R[s];
    }
}

template <bool kDev, int kP>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, 1)
    scl_chunk_body_xl_kernel(const float* __restrict__ alpha, const float* __restrict__ pm,
                             int8_t* __restrict__ beta_out, float* __restrict__ pm_out,
                             long long* __restrict__ r_out, const int4* __restrict__ prog,
                             int n_ops, int has_R, int B, int S, int L, int lgS, float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const CtxXl<kP> c = make_ctx_xl<kP>(
      ctx_base<kDev>(smem_raw, ctx_dev, ctx_words_xl(L, S, lgS, kP)), L, S, lgS, lane);
  for_each_frame<kDev>(B, [&](int frame) {
    float* top = chunk_top(c, const_cast<float*>(alpha) + (size_t)frame * (size_t)(L * S), prog,
                           n_ops, L);
    float pmr[kP];
    int R[kP];
#pragma unroll
    for (int s = 0; s < kP; ++s) {
      pmr[s] = lane + s * kWarp < L ? pm[(size_t)frame * (size_t)L + lane + s * kWarp] : 0.0f;
      R[s] = lane + s * kWarp;
    }
    __syncwarp();
    chunk_body_xl<false, kP>(c, top, prog, n_ops, has_R, L, pmr, R);
    body_out_xl<kP>(c, beta_out + (size_t)frame * (size_t)(L * S),
                    pm_out + (size_t)frame * (size_t)L, r_out + (size_t)frame * (size_t)L, L, S,
                    lgS, pmr, R);
  });
}

template <bool kDev, int kP>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, 1)
    scl_chunk_step_xl_kernel(const float* __restrict__ llr, float* alpha, uint32_t* beta,
                             int* pend_a, int* pend_b, float* pm, const int4* __restrict__ prog,
                             Geometry g, StepArgs a, float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const CtxXl<kP> c = make_ctx_xl<kP>(
      ctx_base<kDev>(smem_raw, ctx_dev, ctx_words_xl(g.L, g.S, g.lgS, kP)), g.L, g.S, g.lgS,
      lane);
  for_each_frame<kDev>(g.B, [&](int frame) {
    const StacksXl<kP> st = frame_stacks_xl<kP>(g, frame, alpha, beta, pend_a, pend_b);
    chunk_step_xl<false, kP>(c, g, st, llr + (size_t)frame * g.N, pm + (size_t)frame * g.L, prog,
                             a);
  });
}

template <bool kDev, int kP>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, 1)
    scl_narrow_prefix_xl_kernel(const float* __restrict__ llr, float* alpha, uint32_t* beta,
                                int* pend_a, int* pend_b, float* pm,
                                const int4* __restrict__ prog, Geometry g,
                                const __grid_constant__ PrefixSteps steps, float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const CtxXl<kP> c = make_ctx_xl<kP>(
      ctx_base<kDev>(smem_raw, ctx_dev, ctx_words_xl(g.L, g.S, g.lgS, kP)), g.L, g.S, g.lgS,
      lane);
  for_each_frame<kDev>(g.B, [&](int frame) {
    for (int r = 0; r < steps.n; ++r) {
      const StepArgs& a = steps.rows[r];
      const StacksXl<kP> st = frame_stacks_xl<kP>(g, frame, alpha, beta, pend_a, pend_b);
      chunk_step_xl<true, kP>(c, g, st, llr + (size_t)frame * g.N, pm + (size_t)frame * g.L,
                              prog + a.prog_off, a);
      __syncwarp();
    }
  });
}

template <bool kDev, int kP>
__global__ void __launch_bounds__(kDev ? 4 * kWarp : 8 * kWarp, 1)
    scl_last_chunk_xl_kernel(const float* __restrict__ llr, const float* __restrict__ alpha,
                             const uint32_t* __restrict__ beta, const int* __restrict__ pend_a,
                             const int* __restrict__ pend_b, const float* pm,
                             int8_t* __restrict__ u, float* __restrict__ pm_out, float* top,
                             const int4* __restrict__ prog, int n_ops, int has_R, Geometry g,
                             int log2N, int one_a, int one_b, float* ctx_dev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int words = ctx_words_xl(g.L, g.S, g.lgS, kP) + last_root_words_xl(g.L, g.S, g.N, kP);
  const CtxXl<kP> c =
      make_ctx_xl<kP>(ctx_base<kDev>(smem_raw, ctx_dev, words), g.L, g.S, g.lgS, lane);
  for_each_frame<kDev>(g.B, [&](int frame) {
    const auto stacks_of = [&]() {
      return frame_stacks_xl<kP>(g, frame, const_cast<float*>(alpha),
                                 const_cast<uint32_t*>(beta), const_cast<int*>(pend_a),
                                 const_cast<int*>(pend_b));
    };
    const auto outputs_of = [&](int8_t*& u_f, float*& pm_f) {
      u_f = u + (size_t)frame * g.L * g.N;
      pm_f = pm_out + (size_t)frame * g.L;
    };
    last_chunk_xl<kP>(c, g, stacks_of, outputs_of, llr + (size_t)frame * g.N,
                      pm + (size_t)frame * g.L, top + (size_t)frame * g.L * g.S, prog, n_ops,
                      has_R, log2N, one_a, one_b);
  });
}

#ifdef SCL_DECODE_MEGA  // defined by scl_mega.cu, the one source that launches it
// The whole chunked list decode of a frame in ONE launch (replaces
// ops/scl_mega_pallas.py, make_scl_mega_pallas): bit-reverse the LLRs, seed the
// metrics (0 / -inf) and the pendings (identity), then walk the C chunks from
// a step table (one MegaRow per chunk: k, inv, j, compose masks, offset and
// length of the chunk's node program, has_R): the chunk step's descend, body,
// composes and ascend, and for the last chunk the same descend (one g at
// level t) and body, then the ascend to the root, the butterfly and the
// outputs.  These are the device functions of the per-chunk kernels in the
// same order, at full width, so it equals them bit for bit.  A single-chunk
// code (t == 0) is one body on its L x S plane of the LLRs, then the
// butterfly.
//
// What bounds it: the chunk step's instruction issue (a chain of dependent
// sub-warp steps per frame; the SM's issue slots are full from 16 warps on),
// so a whole decode costs about the chunk steps it runs, and the one launch
// saves their gaps only.  The level stacks live in a SCRATCH buffer in device
// memory that the wrapper allocates and that never leaves the launch (the
// bit-reversed LLRs, alpha, packed beta, the pendings), exactly where the
// chunk-step kernel keeps them between launches; only llr is an input and
// only u and pm are outputs, so the bytes bound is 4N + LN + 4L per frame.
// The warp's shared memory is the chunk step's context (no top plane: every
// body reads level t where its descend wrote it), 4,928 B at N=1024, L=8,
// S=128, and the launch bounds hold the kernel to 64 registers: 32 warps per
// SM, so that 4096 flagship frames are one wave on 132 SMs (the same code at
// 20 warps per SM, in two waves, took 18 % longer).  To keep to 64 registers
// without a spill, the kernel inlines ONE chunk body for all its chunks,
// takes its step table in the launch's parameters and reads each argument
// where it is used (the constant bank, not a register, holds it through a
// body), recomputes its frame's pointers (warp_frame) instead of holding
// them, and leaves the single-chunk code to an instance of its own (kSingle).
// The last chunk's N-word root plane takes no shared memory of its own: it
// aliases the context's alpha region when N <= L * S, else the frame's
// bit-reversed LLRs; both are dead once the last body has returned.  Each
// level is written and re-read by the same warp with a __syncwarp between;
// the scratch pointers are plain (no const __restrict__).  One warp per frame.
//
// The early chunks of a decode hold fewer live paths than L, but they run at
// full width here: the narrow body (chunk_body<true>), whose width is a
// variable, ran every full-width chunk 13 % slower inside this kernel, more
// than the two narrow chunks save (NVIDIA H100 80GB HBM3, 700 W).

// One row of the step table in device memory: a chunk step's arguments at
// full width (STEP_TABLE_COLUMNS of ops/scl_cuda.py).
struct MegaRow {
  int k, inv, j, mask_a, mask_b, prog_off, n_ops, has_R;
};

// The step table: in the launch's parameters (the constant bank) up to
// kMegaParamRows chunks, as the full-width StepArgs of each chunk, which the
// kernel reads where it uses them; else in device memory (a long table: each
// row's values are loaded into registers, and the kernel spills a few).
constexpr int kMegaParamRows = 80;
struct ParamSteps {
  StepArgs rows[kMegaParamRows];
  __device__ __forceinline__ const StepArgs& args(int i, int) const { return rows[i]; }
};
struct DeviceSteps {
  const MegaRow* rows;
  __device__ __forceinline__ StepArgs args(int i, int L) const {
    const MegaRow& r = rows[i];
    return StepArgs{r.k, r.inv, r.j, r.mask_a, r.mask_b, r.prog_off, r.n_ops, r.has_R,
                    L, L, 0, 0};
  }
};

// This warp's frame, from the special registers at every call (asm volatile:
// the compiler cannot keep one call's value for the next), so that the
// whole-decode kernel recomputes its frame's pointers where it uses them
// instead of holding them through a chunk body.
__device__ __forceinline__ int warp_frame() {
  unsigned cta, ntid, tid;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
  asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(ntid));
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  return (int)(cta * (ntid / kWarp) + tid / kWarp);
}

// kSingle: a single-chunk code (t == 0), whose one body runs on an L x S
// plane of the LLRs in the scratch.
template <typename Steps, bool kSingle>
__global__ void __launch_bounds__(8 * kWarp, 4)
    scl_decode_mega_kernel(const float* __restrict__ llr, float* llr_rev, float* alpha,
                           uint32_t* beta, int* pend_a, int* pend_b, int8_t* __restrict__ u,
                           float* pm, const int4* __restrict__ prog, const Steps steps, int C,
                           Geometry g, int log2N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  if (warp_frame() >= g.B) return;
  const int N = g.N, S = g.S, L = g.L, t = g.t;
  float* base = reinterpret_cast<float*>(smem_raw) +
                (size_t)(threadIdx.x / kWarp) * ctx_words(L, S, g.lgS);
  Ctx c = make_ctx(base, L, S, lane);
  SCL_PROF_DECL;
  SCL_PROF_BIND(c);
  SCL_PROF_T(t_decode);

  // ---- init: LLRs to bit-reversed storage, one live path, identity pendings
  {
    const int frame = warp_frame();
    float* x = llr_rev + (size_t)frame * N;
    const float* in = llr + (size_t)frame * N;
    const int shift = 32 - log2N;
    for (int i = lane; i < N; i += kWarp)
      x[i] = in[log2N ? (int)(__brev((unsigned)i) >> shift) : 0];
    if (lane < L) pm[(size_t)frame * L + lane] = lane == 0 ? 0.0f : -INFINITY;
    const Stacks st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
    for (int l = 1; l <= t; ++l)
      if (lane < L) {
        st.pend_a(l)[lane] = lane;
        st.pend_b(l)[lane] = lane;
      }
    __syncwarp();
  }

  // ---- the chunks: descend, body, then compose and ascend; one body for
  // every chunk; the last chunk's ascend to the root, butterfly and outputs
  // after the loop, where the loop's own values are dead (inside it, the
  // faster butterfly made the kernel spill at 64 registers)
  float pmr;
  int R;
  for (int ch = 0;; ++ch) {
    const StepArgs& a = steps.args(ch, L);
    // the body's op count and program in registers: the compiler would
    // otherwise read them from the table again, by a register index, at every
    // op (1 % of the flagship decode, NVIDIA H100 80GB HBM3, 700 W)
    int n_ops, prog_off;
    asm volatile("mov.b32 %0, %1;" : "=r"(n_ops) : "r"(a.n_ops));
    asm volatile("mov.b32 %0, %1;" : "=r"(prog_off) : "r"(a.prog_off));
    const int4* p = prog + prog_off;
    float* top;
    {
      SCL_PROF_T(t_descend);
      const int frame = warp_frame();
      const float* x = llr_rev + (size_t)frame * N;
      if (kSingle) {  // a single chunk: its L x S plane of the LLRs in the scratch
        top = alpha + (size_t)frame * L * S;
        for (int idx = lane; idx < L * S; idx += kWarp) top[idx] = x[idx & (S - 1)];
        __syncwarp();
      } else {
        const Stacks st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
        step_descend<false>(c, g, st, x, a);
        top = chunk_top(c, st.alpha(t), p, n_ops, L);
      }
      SCL_PROF_ADD(c, PROF_DESCEND, t_descend);
    }
    pmr = lane < L ? pm[(size_t)warp_frame() * L + lane] : -INFINITY;
    R = lane;
    SCL_PROF_T(t_body);
    chunk_body<false, false>(c, top, p, n_ops, a.has_R, L, pmr, R);
    SCL_PROF_ADD(c, PROF_BODY, t_body);
    if (ch == C - 1) break;
    const int frame = warp_frame();
    const Stacks st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
    step_ascend<false>(c, g, st, pm + (size_t)frame * L, a, pmr, R);
    __syncwarp();
  }
  {
    const int frame = warp_frame();
    float* root = N <= L * S ? base : llr_rev + (size_t)frame * N;
    last_ascend<false>(c, reinterpret_cast<uint32_t*>(root), g,
                frame_stacks(g, frame, alpha, beta, pend_a, pend_b), pmr, R,
                u + (size_t)frame * L * N, pm + (size_t)frame * L, log2N);
  }
  SCL_PROF_ADD(c, PROF_DECODE, t_decode);
  SCL_PROF_FLUSH(c);
}
#endif

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr size_t kBlockSmem = 232448;  // shared memory one block may use on Hopper

// The warps per block (1 .. max_warps, one frame context of per_warp_bytes
// each) that keep the most warps resident on an SM: the occupancy calculator
// at the compiled kernel's registers and that shared memory.  Planned once
// per (kernel, context size, bound) and kept.
int plan_warps(const void* kernel, size_t per_warp_bytes, int max_warps) {
  struct Plan {
    const void* kernel;
    size_t bytes;
    int max_warps, warps;
  };
  static std::mutex mu;
  static std::vector<Plan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const Plan& p : plans)
    if (p.kernel == kernel && p.bytes == per_warp_bytes && p.max_warps == max_warps)
      return p.warps;
  cudaFuncAttributes attr;
  const int bound = cudaFuncGetAttributes(&attr, kernel) == cudaSuccess
                        ? min(max_warps, attr.maxThreadsPerBlock / kWarp)
                        : max_warps;
  int best = 1, most = -1;
  for (int w = 1; w <= bound && w * per_warp_bytes <= kBlockSmem; ++w) {
    int blocks = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(w * per_warp_bytes)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, w * kWarp,
                                                      w * per_warp_bytes) != cudaSuccess)
      break;
    if (blocks * w > most) {
      most = blocks * w;
      best = w;
    }
  }
  cudaGetLastError();  // a refused probe is not the launch's error
  plans.push_back({kernel, per_warp_bytes, max_warps, best});
  return best;
}

// The launch shape of a per-chunk kernel: the context in shared memory
// (`per_warp_bytes` per warp, one warp per frame, the warps per block
// planned up to `max_warps`, the grid covering the batch), or, with
// `ctx_dev`, in device memory (no dynamic shared memory, `grid` blocks of
// `max_warps` warps walking the frames).
template <typename K>
cudaError_t configure(K smem_kernel, K dev_kernel, const float* ctx_dev, size_t per_warp_bytes,
                      int B, int max_warps, int grid, K* kernel, size_t* smem, int* blocks,
                      int* warps) {
  if (ctx_dev) {
    *kernel = dev_kernel;
    *smem = 0;
    *blocks = grid;
    *warps = max_warps;
    return cudaSuccess;
  }
  *kernel = smem_kernel;
  *warps = plan_warps((const void*)smem_kernel, per_warp_bytes, max_warps);
  *smem = (size_t)*warps * per_warp_bytes;
  *blocks = (B + *warps - 1) / *warps;
  return allow_smem(smem_kernel, *smem);
}

// Bytes of shared memory one frame (one warp) of each kernel needs: the
// chunk context (scl::ctx_words, no top plane: the body kernel and the
// one-launch decode take just that); the last chunk adds a root plane only
// when the context's alpha region cannot hold it (last_ctx_words), and the
// one-hot variants of the chunk step and the last chunk the 2 * t * L staged
// rank vectors.  The launchers and the resource report both size the context
// from these.
inline size_t ctx_frame_bytes(int L, int S, int lgS, int, int) {
  return 4 * (size_t)scl::ctx_words(L, S, lgS);
}
template <bool kOneHot>
size_t step_frame_bytes(int L, int S, int lgS, int, int t) {
  return ctx_frame_bytes(L, S, lgS, 0, 0) + (kOneHot ? 8 * (size_t)t * L : 0);
}
template <bool kOneHot>
size_t last_frame_bytes(int L, int S, int lgS, int N, int t) {
  return 4 * (size_t)last_ctx_words(L, S, lgS, N, t, kOneHot);
}
// the wide-list instances' (33 <= L <= 64)
inline size_t ctx_frame_bytes_wide(int L, int S, int lgS, int, int) {
  return 4 * (size_t)scl::ctx_words_wide(L, S, lgS);
}
inline size_t last_frame_bytes_wide(int L, int S, int lgS, int N, int) {
  return 4 * (size_t)last_ctx_words_wide(L, S, lgS, N);
}
// the widest list the one-path instances take (a 32-bit word of path bits)
constexpr int kNarrowListMax = 32;
// the widest list of the wide instances
constexpr int kWideListMax = 64;
// the widest list of the XL instances, and their paths a lane (kP)
constexpr int kXlListMax = 256;
inline int xl_paths_per_lane(int L) { return L <= 128 ? 4 : 8; }
// the XL-list instances' frame bytes (65 <= L <= 256)
template <int kP>
size_t ctx_frame_bytes_xl(int L, int S, int lgS, int, int) {
  return 4 * (size_t)scl::ctx_words_xl(L, S, lgS, kP);
}
template <int kP>
size_t last_frame_bytes_xl(int L, int S, int lgS, int N, int) {
  return 4 * (size_t)(scl::ctx_words_xl(L, S, lgS, kP) + last_root_words_xl(L, S, N, kP));
}

// A compiled kernel variant, for a resource report: its name, its function
// and the bytes of shared memory one frame of it needs (null: a
// device-memory variant, which has none).
struct KernelEntry {
  const char* name;
  const void* fn;
  size_t (*frame_bytes)(int L, int S, int lgS, int N, int t);
};

// The report of one variant at list L, chunk S, code length N, t levels, in
// out[5]: registers per thread, local-memory bytes per thread (spills and
// local arrays), resident warps per SM, warps per block and shared memory per
// block, at the plan its launcher makes (up to `max_warps` warps per block
// with the context in shared memory, `devmem_warps` with it in device memory).
template <size_t n>
int kernel_report(const KernelEntry (&table)[n], int which, int L, int S, int N, int t,
                  int max_warps, int devmem_warps, int* out) {
  const KernelEntry& e = table[which];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, e.fn);
  if (err != cudaSuccess) return (int)err;
  const int lgS = 31 - __builtin_clz((unsigned)S);
  const size_t per_warp = e.frame_bytes ? e.frame_bytes(L, S, lgS, N, t) : 0;
  const int warps = per_warp ? plan_warps(e.fn, per_warp, max_warps) : devmem_warps;
  const size_t smem = (size_t)warps * per_warp;
  err = cudaFuncSetAttribute(e.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, e.fn, warps * kWarp, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks * warps;
  out[3] = warps;
  out[4] = (int)smem;
  return 0;
}

}  // namespace

// The resource report of one library's kernel table (kKernels).
#define SCL_KERNEL_REPORT_EXPORTS                                                          \
  extern "C" int scl_kernel_count() { return (int)(sizeof(kKernels) / sizeof(kKernels[0])); } \
  extern "C" const char* scl_kernel_name(int which) { return kKernels[which].name; }         \
  extern "C" int scl_kernel_report(int which, int L, int S, int N, int t, int max_warps,     \
                                   int devmem_warps, int* out) {                             \
    return kernel_report(kKernels, which, L, S, N, t, max_warps, devmem_warps, out);         \
  }                                                                                          \
  extern "C" const char* pl_error_string(int code) {                                         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                               \
  }

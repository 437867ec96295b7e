// Chunked successive-cancellation LIST decoder kernels for Hopper (sm_90a).
//
//   scl_chunk_body   replaces polarcode_and_ldpc_tpu/ops/scl_body_pallas.py
//                    (make_chunk_body_pallas): one size-S subtree list decode
//   scl_chunk_step   replaces ops/scl_superchunk_pallas.py
//                    (make_superchunk_pallas): descend -> body -> pending
//                    composes -> ascend on the level stacks, one chunk
//   scl_last_chunk   replaces ops/scl_superchunk_pallas.py
//                    (make_last_superchunk_pallas): one g, body, ascend to the
//                    root composing R into every pending, final butterfly
//
// What bounds them: per chunk a frame moves a few tens of KB of level stacks
// and does ~S*log2(S)*L cheap operations, so the roofline is the memory rate;
// in practice the list decode is LATENCY bound: a chain of thousands of
// dependent steps per chunk, most of them narrower than a warp (the prune at
// an info leaf ranks 2L = 16 candidates).  Design, as for the SC kernel: ONE
// WARP PER FRAME.  Frames are independent, every step is followed by a
// __syncwarp (no block-wide barrier anywhere), and many independent warps per
// SM hide each other's latency.  The chunk's working set (alpha levels,
// packed partial sums, metrics, rank vectors) lives in shared memory; the
// level stacks between launches live in device memory, frame-major:
//
//   llr     [B][N]               channel LLRs, bit-reversed storage
//   alpha   [B][L*(N-S)]         levels 1..t back to back, level l is
//                                [L][N>>l] at offset L*(N - (N>>(l-1)))
//   beta    [B][N-S] words       level l at offset N - (N>>(l-1)); bit p of
//                                a word is path p's left partial sum
//   pend_a, pend_b [B][t][L]     pending rank vectors of the levels
//   pm      [B][L]               path metrics
//
// The kernels update this state IN PLACE.  The descend works directly on the
// global stacks (each level is written, then read by the same warp after a
// __syncwarp; state pointers are therefore NOT const __restrict__, so no load
// goes through the non-coherent path).  One compiled kernel per entry point
// serves every chunk of every code: the chunk's node program and (k, inv, j,
// compose masks) are arguments.  Any batch size; the list runs at full width
// with -inf phantom rows.

#include "scl_device.cuh"

namespace {

using namespace scl;

struct Geometry {
  int B, N, S, L, t, lgS;
};

struct Stacks {
  float* A;      // this frame's alpha levels
  uint32_t* Bt;  // this frame's packed beta levels
  int* PA;
  int* PB;
  int N, L;
  __device__ __forceinline__ float* alpha(int l) const { return A + (size_t)L * (N - (N >> (l - 1))); }
  __device__ __forceinline__ uint32_t* beta(int l) const { return Bt + (N - (N >> (l - 1))); }
  __device__ __forceinline__ int* pend_a(int l) const { return PA + (l - 1) * L; }
  __device__ __forceinline__ int* pend_b(int l) const { return PB + (l - 1) * L; }
};

__device__ __forceinline__ Stacks frame_stacks(const Geometry& g, int frame, float* alpha,
                                               uint32_t* beta, int* pend_a, int* pend_b) {
  Stacks s;
  s.A = alpha + (size_t)frame * g.L * (g.N - g.S);
  s.Bt = beta + (size_t)frame * (g.N - g.S);
  s.PA = pend_a + (size_t)frame * g.t * g.L;
  s.PB = pend_b + (size_t)frame * g.t * g.L;
  s.N = g.N;
  s.L = g.L;
  return s;
}

// g at level lo: dst[l][i] = parent[r][M+i] + (1 - 2*left[l][i]) * parent[r][i]
// with the parent read through pend_a (row 0 when `inv`, the LLRs at lo = 1)
// and the left bits through pend_b.  dst is [L][M].
__device__ __forceinline__ void descend_g(const Geometry& g, const Stacks& st, const float* x,
                                          int lo, bool inv, float* dst, int lane) {
  const int M = g.N >> lo, lgM = ilog2(M), L = g.L;
  const uint32_t* bl = st.beta(lo);
  const int* pb = st.pend_b(lo);
  const float* parent = lo == 1 ? x : st.alpha(lo - 1);
  const int* pa = lo == 1 ? nullptr : st.pend_a(lo - 1);
  for (int idx = lane; idx < L * M; idx += kWarp) {
    const int l = idx >> lgM, i = idx & (M - 1);
    const float* src = parent;
    if (lo != 1 && !inv) src += (size_t)pa[l] * 2 * M;
    const float sgn = 1.0f - 2.0f * (float)((bl[i] >> pb[l]) & 1u);
    dst[idx] = src[M + i] + sgn * src[i];
  }
}

__global__ void scl_chunk_body_kernel(const float* __restrict__ alpha, const float* __restrict__ pm,
                                      int8_t* __restrict__ beta_out, float* __restrict__ pm_out,
                                      long long* __restrict__ r_out,
                                      const int4* __restrict__ prog, int n_ops, int has_R,
                                      int B, int S, int L, int lgS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int frame = blockIdx.x * warps + warp;
  if (frame >= B) return;
  const Ctx c = make_ctx(reinterpret_cast<float*>(smem_raw) + (size_t)warp * ctx_words(L, S, lgS),
                         L, S, lgS, lane);
  const float* a = alpha + (size_t)frame * L * S;
  for (int i = lane; i < L * S; i += kWarp) c.alpha[i] = a[i];
  if (lane < L) c.pm[lane] = pm[(size_t)frame * L + lane];
  __syncwarp();
  chunk_body(c, prog, n_ops, has_R);
  int8_t* bo = beta_out + (size_t)frame * L * S;
  for (int idx = lane; idx < L * S; idx += kWarp) {
    const int l = idx >> lgS, i = idx & (S - 1);
    bo[idx] = (int8_t)((c.beta[i] >> l) & 1u);
  }
  if (lane < L) {
    pm_out[(size_t)frame * L + lane] = c.pm[lane];
    r_out[(size_t)frame * L + lane] = c.R[lane];
  }
}

__global__ void scl_chunk_step_kernel(const float* __restrict__ llr, float* alpha, uint32_t* beta,
                                      int* pend_a, int* pend_b, float* pm,
                                      const int4* __restrict__ prog, int n_ops, int has_R,
                                      Geometry g, int k, int inv, int j, int mask_a, int mask_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int frame = blockIdx.x * warps + warp;
  if (frame >= g.B) return;
  const int N = g.N, S = g.S, L = g.L, t = g.t;
  const Ctx c = make_ctx(reinterpret_cast<float*>(smem_raw) + (size_t)warp * ctx_words(L, S, g.lgS),
                         L, S, g.lgS, lane);
  const Stacks st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
  const float* x = llr + (size_t)frame * N;

  // ---- descend: one g at level t-k (all f from the LLRs when k == t), then
  // an f chain down to level t; every written level's pend_a resets
  int lo;
  if (k == t) {
    // chunk 0: the planes are path-invariant, compute once, store L rows
    for (int l = 1; l <= t; ++l) {
      const int M = N >> l;
      const float* src = l == 1 ? x : st.alpha(l - 1);  // row 0 of the level above
      float* dst = st.alpha(l);
      for (int i = lane; i < M; i += kWarp) {
        const float v = f_minsum(src[i], src[M + i]);
        for (int r = 0; r < L; ++r) dst[(size_t)r * M + i] = v;
      }
      if (lane < L) st.pend_a(l)[lane] = lane;
      __syncwarp();
    }
  } else {
    lo = t - k;
    descend_g(g, st, x, lo, inv != 0, st.alpha(lo), lane);
    if (lane < L) st.pend_a(lo)[lane] = lane;
    __syncwarp();
    for (int l = lo + 1; l <= t; ++l) {
      const int M = N >> l, lgM = ilog2(M);
      const float* src = st.alpha(l - 1);
      float* dst = st.alpha(l);
      for (int idx = lane; idx < L * M; idx += kWarp) {
        const int r = idx >> lgM, i = idx & (M - 1);
        dst[idx] = f_minsum(src[(size_t)r * 2 * M + i], src[(size_t)r * 2 * M + M + i]);
      }
      if (lane < L) st.pend_a(l)[lane] = lane;
      __syncwarp();
    }
  }

  // ---- chunk body on a shared-memory copy of the level-t alpha
  {
    const float* a = st.alpha(t);
    for (int i = lane; i < L * S; i += kWarp) c.alpha[i] = a[i];
    if (lane < L) c.pm[lane] = pm[(size_t)frame * L + lane];
    __syncwarp();
  }
  chunk_body(c, prog, n_ops, has_R);
  if (lane < L) pm[(size_t)frame * L + lane] = c.pm[lane];

  // ---- compose the chunk's R into the live pendings: p[l] = p[R[l]]
  for (int l = 1; l <= t; ++l) {
    int va = 0, vb = 0;
    const bool ca = (mask_a >> (l - 1)) & 1, cb = (mask_b >> (l - 1)) & 1;
    if (lane < L) {
      if (ca) va = st.pend_a(l)[c.R[lane]];
      if (cb) vb = st.pend_b(l)[c.R[lane]];
    }
    __syncwarp();
    if (lane < L) {
      if (ca) st.pend_a(l)[lane] = va;
      if (cb) st.pend_b(l)[lane] = vb;
    }
  }
  __syncwarp();

  // ---- ascend: j combines with the permuted left betas, built from the end
  // of the destination level t-j, then the parked level's pend_b resets
  const int D = S << j;
  uint32_t* dest = st.beta(t - j);
  for (int i = lane; i < S; i += kWarp) dest[D - S + i] = c.beta[i];
  __syncwarp();
  for (int s = 0; s < j; ++s) {
    const int lev = t - s, size = S << s;
    const uint32_t* left = st.beta(lev);
    if (lane < L) c.tmp[lane] = st.pend_b(lev)[lane];
    __syncwarp();
    for (int i = lane; i < size; i += kWarp)
      dest[D - 2 * size + i] = perm_word(left[i], c.tmp, L) ^ dest[D - size + i];
    __syncwarp();
  }
  if (lane < L) st.pend_b(t - j)[lane] = lane;
}

__global__ void scl_last_chunk_kernel(const float* __restrict__ llr, float* alpha, uint32_t* beta,
                                      int* pend_a, int* pend_b, const float* pm,
                                      int8_t* __restrict__ u, float* __restrict__ pm_out,
                                      const int4* __restrict__ prog, int n_ops, int has_R,
                                      Geometry g, int log2N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int frame = blockIdx.x * warps + warp;
  if (frame >= g.B) return;
  const int N = g.N, S = g.S, L = g.L, t = g.t;
  const int per_warp = ctx_words(L, S, g.lgS) + N;
  float* base = reinterpret_cast<float*>(smem_raw) + (size_t)warp * per_warp;
  const Ctx c = make_ctx(base, L, S, g.lgS, lane);
  uint32_t* root = reinterpret_cast<uint32_t*>(base + ctx_words(L, S, g.lgS));
  const Stacks st = frame_stacks(g, frame, alpha, beta, pend_a, pend_b);
  const float* x = llr + (size_t)frame * N;

  // ---- descend: a single g at level t, straight into shared memory
  descend_g(g, st, x, t, false, c.alpha, lane);
  if (lane < L) c.pm[lane] = pm[(size_t)frame * L + lane];
  __syncwarp();
  chunk_body(c, prog, n_ops, has_R);

  // ---- ascend to the root; the chunk's R composes into each pend_b on the way
  for (int i = lane; i < S; i += kWarp) root[N - S + i] = c.beta[i];
  __syncwarp();
  for (int lev = t; lev >= 1; --lev) {
    const int size = N >> lev;
    const uint32_t* left = st.beta(lev);
    if (lane < L) c.tmp[lane] = st.pend_b(lev)[c.R[lane]];
    __syncwarp();
    for (int i = lane; i < size; i += kWarp)
      root[N - 2 * size + i] = perm_word(left[i], c.tmp, L) ^ root[N - size + i];
    __syncwarp();
  }

  // ---- butterfly u = beta * G in storage order on the packed words, then
  // natural order on the way out
  for (int s = 1; s < N; s <<= 1) {
    for (int idx = lane; idx < N / 2; idx += kWarp) {
      const int p = ((idx / s) * 2 * s) + (idx % s);
      root[p] ^= root[p + s];
    }
    __syncwarp();
  }
  const int shift = 32 - log2N;
  int8_t* out = u + (size_t)frame * L * N;
  for (int i = lane; i < N; i += kWarp) {
    const uint32_t w = root[log2N ? (int)(__brev((unsigned)i) >> shift) : 0];
    for (int l = 0; l < L; ++l) out[(size_t)l * N + i] = (int8_t)((w >> l) & 1u);
  }
  if (lane < L) pm_out[(size_t)frame * L + lane] = c.pm[lane];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bytes of shared memory one frame (one warp) needs in the body and step
// kernels; the last-chunk kernel adds N words for the root plane
extern "C" int scl_smem_per_frame(int L, int S, int lgS) { return 4 * scl::ctx_words(L, S, lgS); }

// Each launcher runs on `stream` and returns the cudaGetLastError code (0 = ok).

extern "C" int scl_chunk_body_launch(const float* alpha, const float* pm, int8_t* beta_out,
                                     float* pm_out, long long* r_out, const int* prog, int n_ops,
                                     int has_R, int B, int S, int L, int lgS,
                                     int warps_per_block, void* stream) {
  const size_t smem = (size_t)warps_per_block * scl_smem_per_frame(L, S, lgS);
  cudaError_t err = allow_smem(scl_chunk_body_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps_per_block - 1) / warps_per_block;
  scl_chunk_body_kernel<<<blocks, warps_per_block * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      alpha, pm, beta_out, pm_out, r_out, reinterpret_cast<const int4*>(prog), n_ops, has_R,
      B, S, L, lgS);
  return (int)cudaGetLastError();
}

extern "C" int scl_chunk_step_launch(const float* llr, float* alpha, int* beta, int* pend_a,
                                     int* pend_b, float* pm, const int* prog, int n_ops,
                                     int has_R, int B, int N, int S, int L, int t, int lgS,
                                     int k, int inv, int j, int mask_a, int mask_b,
                                     int warps_per_block, void* stream) {
  const size_t smem = (size_t)warps_per_block * scl_smem_per_frame(L, S, lgS);
  cudaError_t err = allow_smem(scl_chunk_step_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  const int blocks = (B + warps_per_block - 1) / warps_per_block;
  scl_chunk_step_kernel<<<blocks, warps_per_block * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, pm,
      reinterpret_cast<const int4*>(prog), n_ops, has_R, g, k, inv, j, mask_a, mask_b);
  return (int)cudaGetLastError();
}

extern "C" int scl_last_chunk_launch(const float* llr, float* alpha, int* beta, int* pend_a,
                                     int* pend_b, const float* pm, int8_t* u, float* pm_out,
                                     const int* prog, int n_ops, int has_R, int B, int N, int S,
                                     int L, int t, int lgS, int log2N, int warps_per_block,
                                     void* stream) {
  const size_t smem = (size_t)warps_per_block * (scl_smem_per_frame(L, S, lgS) + 4 * (size_t)N);
  cudaError_t err = allow_smem(scl_last_chunk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Geometry g{B, N, S, L, t, lgS};
  const int blocks = (B + warps_per_block - 1) / warps_per_block;
  scl_last_chunk_kernel<<<blocks, warps_per_block * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, alpha, reinterpret_cast<uint32_t*>(beta), pend_a, pend_b, pm, u, pm_out,
      reinterpret_cast<const int4*>(prog), n_ops, has_R, g, log2N);
  return (int)cudaGetLastError();
}

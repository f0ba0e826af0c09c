// Attention backward for Hopper (sm_90a): dq, dk, dv of
// softmax(q k^T * sm_scale [+ causal]) v from the output cotangent g, over the
// packed [B, S, H*Hd] bf16 layout.
//
// Replaces the TPU kernel image_search_tpu/ops/attention.py::_attn_bwd_kernel
// (entry point fused_attention_bwd, attention.py:122), which the reference's
// attention cores select for their VJP (_backward_packed). Same math and the
// same rounding points as that kernel:
//   - logits l = (q . k) * sm_scale in f32; causal positions are NEG_INF =
//     finfo(f32).min, whose probability exp(NEG_INF - max) is exactly 0, so
//     they are skipped;
//   - p32 = exp(l - max) / sum, a division (the forward multiplies by 1/sum);
//   - dv = bf16(p32)^T g, accumulated in f32, stored in bf16;
//   - dp = g . v in f32; ds = p32 * (dp - t) with the row term
//     t = sum_k dp * p32 (not the FlashAttention shortcut sum g * o);
//   - dsb = bf16(ds * sm_scale); dq = dsb k and dk = dsb^T q, accumulated in
//     f32, stored in bf16.
//
// Design: two launches on one stream, no atomics, each output written once.
//   1. Row pass, grid (query tile, head, batch row). The block stages its
//      head's K and V ([S, Hd] bf16 each, 66 KB at S = 257, so it opts in
//      above 48 KB). Each warp owns one query row at a time: lanes split the
//      keys for l, p32, dp and ds, and the head dims for dq. It writes the
//      row's (max, sum, t) to an f32 [3, B, H, S] workspace.
//   2. Column pass, grid (key tile, head, batch row). The block stages Q and G
//      and the workspace rows; each warp owns one key row: lanes split the
//      query rows to recompute p32 and ds, then the head dims for dv and dk.
//      Under causal only the query rows at or past the key are used.
//   Both passes take every dot product in the same order (dot_row) and scale
//   it with __fmul_rn (never contracted into an FMA), so the column pass
//   recomputes bit for bit the p32 and ds of the row pass.
// Rows in shared memory are padded to Hd + 2 elements, so lanes reading
// different rows at the same depth hit different banks.
//
// What bounds it: 5 S x S x Hd products per head over 7 [B, S, H*Hd] bf16
// tensors read or written once, ~91 FLOP/byte at S = 257 -- compute-bound on
// tensor cores. This first version does scalar f32 FMAs on the CUDA cores
// (7 S^2 Hd FMAs per head: l and dp are taken in both passes), so the CUDA
// cores' FMA rate bounds it; a wgmma/TMA version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr float kNegInf = -FLT_MAX;  // jnp.finfo(jnp.float32).min
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTileRows = 128;
constexpr int kHd = 64;
constexpr int kLd = kHd + 2;      // padded shared row, bf16 elements
constexpr int kWords = kHd / 2;   // bf16 pairs per head row

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__host__ __device__ inline int pad32(int s) { return (s + 31) / 32 * 32; }

// Rows [tok0, tok0 + n) of one head of a and b into shared rows 0..n-1.
__device__ void stage_pair(const bf16* __restrict__ a, long long a_ld,
                           const bf16* __restrict__ b, long long b_ld,
                           bf16* as, bf16* bs, long long tok0, int n, long long col) {
  for (int i = threadIdx.x; i < n * kWords; i += kThreads) {
    const int j = i / kWords, w = i % kWords;
    const long long tok = tok0 + j;
    *reinterpret_cast<bf162*>(as + j * kLd + 2 * w) =
        *reinterpret_cast<const bf162*>(a + tok * a_ld + col + 2 * w);
    *reinterpret_cast<bf162*>(bs + j * kLd + 2 * w) =
        *reinterpret_cast<const bf162*>(b + tok * b_ld + col + 2 * w);
  }
}

// One warp: the head rows of a and b at token tok into f32 shared rows.
__device__ __forceinline__ void load_rows(const bf16* __restrict__ a, long long a_ld,
                                          const bf16* __restrict__ b, long long b_ld,
                                          long long tok, long long col, float* ar, float* br,
                                          int lane) {
  for (int w = lane; w < kWords; w += 32) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const bf162*>(a + tok * a_ld + col + 2 * w));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const bf162*>(b + tok * b_ld + col + 2 * w));
    ar[2 * w] = fa.x;
    ar[2 * w + 1] = fa.y;
    br[2 * w] = fb.x;
    br[2 * w + 1] = fb.y;
  }
}

// x (f32, 64) . y (bf16 shared row): the one summation order of both passes.
__device__ __forceinline__ float dot_row(const float* x, const bf16* y) {
  const bf162* yr = reinterpret_cast<const bf162*>(y);
  float acc = 0.f;
#pragma unroll 8
  for (int w = 0; w < kWords; ++w) {
    const float2 f = __bfloat1622float2(yr[w]);
    acc = fmaf(x[2 * w], f.x, acc);
    acc = fmaf(x[2 * w + 1], f.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     bf16* __restrict__ dq, float* __restrict__ stats,
                     int S, int H, long long q_ld, long long k_ld, long long v_ld, long long g_ld,
                     int tile, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = pad32(S);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + (size_t)S * kLd;
  float* pbuf = reinterpret_cast<float*>(vs + (size_t)S * kLd);  // [kWarps, sp]
  float* dpbuf = pbuf + kWarps * sp;                              // [kWarps, sp]
  float* rowbuf = dpbuf + kWarps * sp;                            // [kWarps, 2, kHd]

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * tile;
  const int row1 = min(S, row0 + tile);
  const int n_keys = causal ? row1 : S;  // keys any row of this tile can see
  const long long col = (long long)h * kHd;
  const long long tok0 = (long long)b * S;
  const long long out_ld = (long long)H * kHd;
  const size_t bhs = (size_t)gridDim.z * H * S;

  stage_pair(k, k_ld, v, v_ld, ks, vs, tok0, n_keys, col);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = pbuf + warp * sp;
  float* dp = dpbuf + warp * sp;
  float* qr = rowbuf + warp * 2 * kHd;
  float* gr = qr + kHd;
  for (int r = row0 + warp; r < row1; r += kWarps) {
    const long long tok = tok0 + r;
    load_rows(q, q_ld, g, g_ld, tok, col, qr, gr, lane);
    __syncwarp();

    const int kmax = causal ? r + 1 : S;
    float mx = kNegInf;
    for (int j = lane; j < kmax; j += 32) {
      const float l = __fmul_rn(dot_row(qr, ks + j * kLd), sm_scale);
      p[j] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < kmax; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float t = 0.f;
    for (int j = lane; j < kmax; j += 32) {
      const float p32 = p[j] / sum;
      const float d = dot_row(gr, vs + j * kLd);
      p[j] = p32;
      dp[j] = d;
      t += d * p32;
    }
    t = warp_sum(t);
    for (int j = lane; j < kmax; j += 32) p[j] = round_bf16(p[j] * (dp[j] - t) * sm_scale);
    __syncwarp();

    for (int w = lane; w < kWords; w += 32) {
      float a0 = 0.f, a1 = 0.f;
      const bf162* kc = reinterpret_cast<const bf162*>(ks) + w;
#pragma unroll 4
      for (int j = 0; j < kmax; ++j) {
        const float s = p[j];
        const float2 kf = __bfloat1622float2(kc[j * (kLd / 2)]);
        a0 = fmaf(s, kf.x, a0);
        a1 = fmaf(s, kf.y, a1);
      }
      *reinterpret_cast<bf162*>(dq + tok * out_ld + col + 2 * w) = __floats2bfloat162_rn(a0, a1);
    }
    if (lane == 0) {
      const size_t si = ((size_t)b * H + h) * S + r;
      stats[si] = mx;
      stats[bhs + si] = sum;
      stats[2 * bhs + si] = t;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     const float* __restrict__ stats,
                     int S, int H, long long q_ld, long long k_ld, long long v_ld, long long g_ld,
                     int tile, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = pad32(S);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + (size_t)S * kLd;
  float* st = reinterpret_cast<float*>(gs + (size_t)S * kLd);  // [3, S]: max, sum, t
  float* pbuf = st + 3 * S;                                     // [kWarps, sp]: bf16(p32)
  float* dsbuf = pbuf + kWarps * sp;                            // [kWarps, sp]: dsb
  float* rowbuf = dsbuf + kWarps * sp;                          // [kWarps, 2, kHd]

  const int b = blockIdx.z, h = blockIdx.y;
  const int col0 = blockIdx.x * tile;
  const int col1 = min(S, col0 + tile);
  const int i0 = causal ? col0 : 0;  // first query row any key of this tile is seen by
  const int n_rows = S - i0;
  const long long col = (long long)h * kHd;
  const long long tok0 = (long long)b * S;
  const long long out_ld = (long long)H * kHd;
  const size_t bhs = (size_t)gridDim.z * H * S;
  const size_t stat0 = ((size_t)b * H + h) * S + i0;

  stage_pair(q, q_ld, g, g_ld, qs, gs, tok0 + i0, n_rows, col);
  for (int i = threadIdx.x; i < n_rows; i += kThreads) {
    st[i] = stats[stat0 + i];
    st[S + i] = stats[bhs + stat0 + i];
    st[2 * S + i] = stats[2 * bhs + stat0 + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pb = pbuf + warp * sp;
  float* dsb = dsbuf + warp * sp;
  float* kr = rowbuf + warp * 2 * kHd;
  float* vr = kr + kHd;
  for (int j = col0 + warp; j < col1; j += kWarps) {
    const long long tok = tok0 + j;
    load_rows(k, k_ld, v, v_ld, tok, col, kr, vr, lane);
    __syncwarp();

    const int first = (causal ? j : 0) - i0;  // shared row of the first query seeing key j
    for (int i = first + lane; i < n_rows; i += 32) {
      const float l = __fmul_rn(dot_row(kr, qs + i * kLd), sm_scale);
      const float p32 = expf(l - st[i]) / st[S + i];
      const float d = dot_row(vr, gs + i * kLd);
      pb[i] = round_bf16(p32);
      dsb[i] = round_bf16(p32 * (d - st[2 * S + i]) * sm_scale);
    }
    __syncwarp();

    for (int w = lane; w < kWords; w += 32) {
      float v0 = 0.f, v1 = 0.f, k0 = 0.f, k1 = 0.f;
      const bf162* gc = reinterpret_cast<const bf162*>(gs) + w;
      const bf162* qc = reinterpret_cast<const bf162*>(qs) + w;
#pragma unroll 4
      for (int i = first; i < n_rows; ++i) {
        const float pi = pb[i], si = dsb[i];
        const float2 gf = __bfloat1622float2(gc[i * (kLd / 2)]);
        const float2 qf = __bfloat1622float2(qc[i * (kLd / 2)]);
        v0 = fmaf(pi, gf.x, v0);
        v1 = fmaf(pi, gf.y, v1);
        k0 = fmaf(si, qf.x, k0);
        k1 = fmaf(si, qf.y, k1);
      }
      *reinterpret_cast<bf162*>(dv + tok * out_ld + col + 2 * w) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<bf162*>(dk + tok * out_ld + col + 2 * w) = __floats2bfloat162_rn(k0, k1);
    }
    __syncwarp();
  }
}

size_t rows_smem_bytes(int S) {
  return 2 * (size_t)S * kLd * sizeof(bf16) + 2 * (size_t)kWarps * pad32(S) * sizeof(float) +
         (size_t)kWarps * 2 * kHd * sizeof(float);
}

size_t cols_smem_bytes(int S) { return rows_smem_bytes(S) + 3 * (size_t)S * sizeof(float); }

}  // namespace

extern "C" {

// Dynamic shared memory the larger of the two passes needs for sequence
// length S (the wrapper checks it against the card's per-block limit).
size_t isx_attention_bwd_smem_bytes(int S, int head_dim) {
  return head_dim == kHd ? cols_smem_bytes(S) : 0;
}

// q, k, v, g: bf16, element (b, s, h, d) at (b*S + s)*ld + h*head_dim + d.
// dq, dk, dv: bf16, contiguous [B, S, H*head_dim]. stats: f32 [3, B, H, S]
// workspace. Launches both passes on `stream`; returns cudaGetLastError().
int isx_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                      void* dq, void* dk, void* dv, void* stats,
                      int B, int S, int H, int head_dim,
                      long long q_ld, long long k_ld, long long v_ld, long long g_ld,
                      int causal, float sm_scale, void* stream) {
  if (head_dim != kHd || B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (S + kMaxTileRows - 1) / kMaxTileRows;
  const int tile = (S + n_tiles - 1) / n_tiles;
  const dim3 grid(n_tiles, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  float* st = static_cast<float*>(stats);

  const size_t smem_rows = rows_smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_rows);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_rows_kernel<<<grid, kThreads, smem_rows, s>>>(
      qp, kp, vp, gp, static_cast<bf16*>(dq), st, S, H, q_ld, k_ld, v_ld, g_ld, tile, causal,
      sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_cols = cols_smem_bytes(S);
  err = cudaFuncSetAttribute(attn_bwd_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_cols);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_cols_kernel<<<grid, kThreads, smem_cols, s>>>(
      qp, kp, vp, gp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, S, H, q_ld, k_ld, v_ld,
      g_ld, tile, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"

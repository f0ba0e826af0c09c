// Fused LayerNorm -> matmul for Hopper (sm_90a): out = LN(x) @ w^T + b.
//
// Replaces the TPU kernel image_search_tpu/ops/ln_matmul.py::_ln_mm_kernel
// (entry point ln_matmul, kernel B9). Its function, with its rounding points:
//   mean = sum_k x[m, k] / K and var = sum_k (x[m, k] - mean)^2 / K in f32
//   (two passes, as jnp.var), rstd = 1 / sqrt(var + eps);
//   y = ((x - mean) * rstd) * ls + lb in f32, each product and sum rounded on
//   its own (no contraction into an FMA), then rounded to bf16;
//   acc[m, n] = sum_k y[m, k] * w[n, k] in f32 (bf16 products are exact);
//   out = bf16(bf16(acc) + b[n]): the bias is added in the output dtype.
// x [M, K] and w [N, K] (nn.Linear's layout) are bf16 with contiguous rows,
// ls and lb f32 [K], b bf16 [N]; K and N multiples of 8. Rows at or past M
// and columns at or past N are masked.
//
// Design: one CTA of 8 warps per 128 rows x 4 consecutive 128-column tiles;
// grid.x runs over the column groups so that the CTAs in flight share their
// x rows in L2. The CTA first computes its 128 rows' mean and rstd from
// global memory (a warp per row, 16-byte loads, two passes), once for its 4
// tiles. Then, for each tile in turn, the K loop, in 32-deep tiles, double
// buffered in shared memory: w tiles arrive by cp.async; x tiles are loaded
// into registers one tile ahead, normalised there in f32, rounded to bf16
// and stored to shared memory while the tensor cores work on the current
// tile. Warps are laid out 2 x 4, each owning 64 x 32 outputs: 4 x 4 tiles of
// mma.sync.m16n8k16 bf16 with f32 accumulators, fragments read with
// ldmatrix from rows padded to 40 elements (conflict-free).
//
// What bounds it: operations. 2*M*K*N FLOP over (M*K + N*K + M*N)*2 bytes:
// at M = 41,120 (ViT-L/14, B = 160), K = 1024 and N = 3072 or 4096, ~700
// FLOP per byte, far above the card's ~295. The x rows are re-read for the
// statistics by every CTA of their row block (from L2), and from L2 again by
// every tile; 128 x 128 tiles of mma.sync run at a fraction of the tensor
// cores' rate. wgmma, TMA and larger tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kTilesN = 4;  // column tiles per CTA, sharing one pass of row statistics
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kBK + 8;  // smem row stride (bf16): 80 bytes, conflict-free ldmatrix
constexpr int kVecs = kBM * kBK / 8 / kThreads;  // 16-byte vectors per thread per tile: 2

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
ln_matmul_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ls,
                 const float* __restrict__ lb, const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int M, int N, int K, float eps) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 sB[2][kBN * kLds];
  __shared__ float s_mean[kBM], s_rstd[kBM];

  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1. each row's statistics, a warp per row, two passes over global memory
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < M) {
      const __nv_bfloat16* xr = x + (size_t)row * K;
      float s = 0.f;
      for (int k = lane * 8; k < K; k += 256) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          s += f.x;
          s += f.y;
        }
      }
      mean = warp_sum(s) / (float)K;
      float s2 = 0.f;
      for (int k = lane * 8; k < K; k += 256) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          const float d0 = f.x - mean, d1 = f.y - mean;
          s2 += d0 * d0;
          s2 += d1 * d1;
        }
      }
      rstd = 1.0f / sqrtf(warp_sum(s2) / (float)K + eps);
    }
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
    }
  }
  __syncthreads();

  // each thread loads the same two (row, 8-column) slots of every x and w tile
  int ld_r[kVecs], ld_c = (threadIdx.x % 4) * 8;
  float mu[kVecs], rs[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    ld_r[i] = threadIdx.x / 4 + i * (kThreads / 4);
    mu[i] = s_mean[ld_r[i]];
    rs[i] = s_rstd[ld_r[i]];
  }
  uint4 xa[kVecs];
  const int KT = (K + kBK - 1) / kBK;

  for (int tile = 0; tile < kTilesN; ++tile) {
    const int n0 = (blockIdx.x * kTilesN + tile) * kBN;
    if (n0 >= N) break;
    auto load_w = [&](int kt, int buf) {
      const int k = kt * kBK + ld_c;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int n = n0 + ld_r[i];
        const bool ok = n < N && k < K;
        cp_async16(&sB[buf][ld_r[i] * kLds + ld_c], ok ? (const void*)(w + (size_t)n * K + k) : (const void*)w, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    auto load_x = [&](int kt) {
      const int k = kt * kBK + ld_c;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int m = m0 + ld_r[i];
        xa[i] = (m < M && k < K) ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + k) : make_uint4(0, 0, 0, 0);
      }
    };
    auto store_x = [&](int kt, int buf) {
      const int k = kt * kBK + ld_c;
      float g[8], h[8];
      if (k < K) {
        const float4 g0 = *reinterpret_cast<const float4*>(ls + k), g1 = *reinterpret_cast<const float4*>(ls + k + 4);
        const float4 h0 = *reinterpret_cast<const float4*>(lb + k), h1 = *reinterpret_cast<const float4*>(lb + k + 4);
        g[0] = g0.x; g[1] = g0.y; g[2] = g0.z; g[3] = g0.w; g[4] = g1.x; g[5] = g1.y; g[6] = g1.z; g[7] = g1.w;
        h[0] = h0.x; h[1] = h0.y; h[2] = h0.z; h[3] = h0.w; h[4] = h1.x; h[5] = h1.y; h[6] = h1.z; h[7] = h1.w;
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        uint4 y = make_uint4(0, 0, 0, 0);  // columns past K stay 0
        if (k < K) {
          const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xa[i]);
          __nv_bfloat162* yh = reinterpret_cast<__nv_bfloat162*>(&y);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(xh[j]);
            const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.x, mu[i]), rs[i]), g[2 * j]), h[2 * j]);
            const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.y, mu[i]), rs[i]), g[2 * j + 1]), h[2 * j + 1]);
            yh[j] = __floats2bfloat162_rn(y0, y1);
          }
        }
        *reinterpret_cast<uint4*>(&sA[buf][ld_r[i] * kLds + ld_c]) = y;
      }
    };

    const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    load_w(0, 0);
    load_x(0);
    store_x(0, 0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    for (int kt = 0; kt < KT; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < KT;
      if (more) {
        load_w(kt + 1, cur ^ 1);
        load_x(kt + 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(a[mi], &sA[cur][(wm + mi * 16 + lane % 16) * kLds + kk + (lane / 16) * 8]);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldmatrix_x4(b[nj], &sB[cur][(wn + nj * 16 + (lane / 16) * 8 + lane % 8) * kLds + kk + ((lane / 8) % 2) * 8]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2], b[ni / 2][(ni % 2) * 2 + 1]);
      }
      if (more) store_x(kt + 1, cur ^ 1);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
    }

    // epilogue: bf16(acc), then + b in bf16
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      if (col >= N) continue;
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm + mi * 16 + g + half * 8;
          if (row >= M) continue;
          const float v0 = __bfloat162float(__float2bfloat16(acc[mi][ni][2 * half])) + bb.x;
          const float v1 = __bfloat162float(__float2bfloat16(acc[mi][ni][2 * half + 1])) + bb.y;
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }  // the K loop's last __syncthreads frees both buffers for the next tile
}

}  // namespace

extern "C" {

// x [M, K], w [N, K], b [N], out [M, N] bf16 and ls, lb [K] f32, contiguous
// and 16-byte aligned on the device; K % 8 == 0, N % 8 == 0. Launches on
// `stream`; returns cudaGetLastError() (0 on success).
int isx_ln_matmul(const void* x, const void* ls, const void* lb, const void* w, const void* b,
                  void* out, int M, int N, int K, float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN * kTilesN - 1) / (kBN * kTilesN), (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  ln_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), M, N, K, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"

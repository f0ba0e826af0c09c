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
// ls and lb f32 [K] (passed stacked, [2, K]), b bf16 [N]; K and N multiples
// of 8. Rows at or past M and columns at or past N are masked.
//
// What bounds it: operations. 2*M*K*N FLOP over (M*K + N*K + M*N)*2 bytes:
// at M = 41,120 (ViT-L/14, B = 160), K = 1024 and N = 3072 or 4096, ~700
// FLOP per byte, far above the card's ~295. So the design is a Hopper GEMM
// (wgmma fed by TMA) with the LayerNorm applied to the A operand on its way
// from shared memory into the tensor cores; y never reaches device memory.
//
// Two launches per call, on one stream:
// 1. ln_stats_kernel: each row's mean and rstd, once per row (a warp a row,
//    the row's first 1024 values held in registers so the two passes read x
//    once), into a [2, M] f32 scratch the wrapper allocates. It reads M*K*2
//    bytes (84 MB at the vision shape, ~25 us at 3.35 TB/s, about a tenth of
//    the GEMM's bound). The earlier design recomputed the statistics in every
//    CTA of a row block, N/512 times a row.
// 2. ln_matmul_kernel: a persistent grid (one CTA an SM) walks 128 x 256
//    output tiles, row block major, so the CTAs in flight share their x rows
//    and all of w (6-8 MB) stays in L2 while x comes from HBM about once.
//    A CTA is 2 consumer warpgroups and 1 producer warpgroup, of which one
//    thread issues the copies (setmaxnreg hands the producer's registers to
//    the consumers). It keeps a 3-stage ring full by TMA: per 64-deep k step,
//    x [128 x 64] and w [256 x 64] bf16 with 128-byte swizzle and the step's
//    64 values of ls and lb, ~49 KB a stage, completing on the stage's full
//    mbarrier. TMA zero-fills rows past M and columns past K (ls = lb = 0
//    there, so y is 0 past K).
//    Each consumer warpgroup owns 64 rows x 256 columns, 128 f32 accumulators
//    a thread. Per k16 step each warp reads its 16 rows of x with ldmatrix
//    (the swizzle undone in the addresses), normalises them in f32 with its
//    rows' mean / rstd and the columns' ls / lb, rounds to bf16 and holds
//    them as the A fragment (mma.m16n8k16's layout, which is wgmma's for A
//    in registers), then issues one wgmma.m64n256k16 with A from registers
//    and B (w) from shared memory by descriptor, as its own group. The A
//    fragments alternate between two register sets, and each step waits only
//    for the group before it, so a step is normalised while the tensor cores
//    run the one before; a stage is released (its empty mbarrier, one
//    arrival per consumer warp) once its last group has completed. Each x
//    element is normalised N / 256 times (12 or 16), against 24 or 32 before.
//    The epilogue rounds, adds the bias in bf16 and writes the warpgroup's
//    64 x 256 tile into shared memory (four 128-byte-swizzled 64 x 64 boxes:
//    conflict-free), and one thread stores it by TMA (which clips rows past
//    M and columns past N) while the warpgroup goes on to its next tile.
//
// Choices measured on an NVIDIA H100 80GB HBM3 at 700 W (M = 41,120,
// K = 1024):
// - ptxas keeps the consumers at 168 registers (the launch's 384 threads
//   cap them, and setmaxnreg does not raise what it allocates, though the
//   kernel ran slower without it), so a register set of A fragments per
//   k16 step fits, and a set per 64-deep stage (4 wgmmas a group)
//   serialised the wgmmas and spilled.
// - The LN in registers (this form) beat normalising x in place in shared
//   memory and reading both operands by descriptor, whether the consumers or
//   the producer warpgroup's three idle warps did the normalising.
// - Without the normalisation (raw x as A) the same loop ran faster: the
//   LN's cost inside the GEMM is what separates it from cuBLAS's rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 rows each
constexpr int kThreads = (kConsumerWarps + 4) * 32;  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kXBytes = kBM * kBK * 2;                 // 16 KB
constexpr int kWBytes = kBN * kBK * 2;                 // 32 KB
constexpr int kLsbBytes = 2 * kBK * 4;                 // ls and lb of the step
constexpr int kTxBytes = kXBytes + kWBytes + kLsbBytes;
constexpr int kStageBytes = (kTxBytes + 1023) / 1024 * 1024;  // swizzle atoms stay 1024-aligned
constexpr int kOutBytes = 64 * kBN * 2;  // a consumer warpgroup's output tile, staged for the TMA store
constexpr size_t kSmemBytes = 1024 + (size_t)kStages * kStageBytes + 2 * (size_t)kOutBytes + 2 * kStages * 8;
constexpr int kStatsRows = 8;  // rows per block of the statistics pass (a warp a row)
constexpr int kHeldChunks = 4;  // 16-byte chunks a lane holds: rows up to 1024 are read once

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sum8(const uint4& u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s += f.x;
    s += f.y;
  }
  return s;
}

__device__ __forceinline__ float sq8(const uint4& u, float mean) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    const float d0 = f.x - mean, d1 = f.y - mean;
    s += d0 * d0;
    s += d1 * d1;
  }
  return s;
}

// stats[0][m] = mean, stats[1][m] = rstd of row m; one warp a row.
__global__ void __launch_bounds__(kStatsRows * 32)
ln_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int M, int K, float eps) {
  const int row = blockIdx.x * kStatsRows + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  const int chunks = K / 8;
  uint4 held[kHeldChunks];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kHeldChunks; ++i) {
    const int c = lane + 32 * i;
    held[i] = c < chunks ? xr[c] : make_uint4(0, 0, 0, 0);
    s += sum8(held[i]);
  }
  for (int c = lane + 32 * kHeldChunks; c < chunks; c += 32) s += sum8(xr[c]);
  const float mean = warp_sum(s) / (float)K;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kHeldChunks; ++i)
    if (lane + 32 * i < chunks) s2 += sq8(held[i], mean);
  for (int c = lane + 32 * kHeldChunks; c < chunks; c += 32) s2 += sq8(xr[c], mean);
  const float rstd = 1.0f / sqrtf(warp_sum(s2) / (float)K + eps);
  if (lane == 0) {
    stats[row] = mean;
    stats[M + row] = rstd;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two bf16 of x normalised with (mean, rstd) and the columns' (ls, lb), in
// the reference's order of rounding, packed as a bf16 pair.
__device__ __forceinline__ uint32_t norm2(uint32_t xv, float mean, float rstd, float2 g, float2 h) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.x, mean), rstd), g.x), h.x);
  const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.y, mean), rstd), g.y), h.y);
  const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
  return *reinterpret_cast<const uint32_t*>(&y);
}

struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ unsigned char* x(int st) const { return base + st * kStageBytes; }
  __device__ unsigned char* w(int st) const { return x(st) + kXBytes; }
  __device__ float* lsb(int st) const { return reinterpret_cast<float*>(w(st) + kWBytes); }
  __device__ unsigned char* out(int wg) const { return base + kStages * kStageBytes + wg * kOutBytes; }
};

// A consumer warp's A fragment for k16 step kk of the stage's x tile: its 16
// rows read with ldmatrix (xs: the address of the row this lane addresses,
// 128-byte swizzled), normalised, rounded to bf16 pairs.
__device__ __forceinline__ void norm_fragment(uint32_t (&a)[4], uint32_t xs, int xrow, const float* lsb, int kk,
                                              float mean0, float rstd0, float mean1, float rstd1) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  uint32_t xr[4];
  ldmatrix_x4(xr, xs + (((kk * 2 + (lane >> 4)) ^ (xrow & 7)) << 4));
  const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
  const float2 g0 = *reinterpret_cast<const float2*>(lsb + c0), g1 = *reinterpret_cast<const float2*>(lsb + c1);
  const float2 h0 = *reinterpret_cast<const float2*>(lsb + kBK + c0);
  const float2 h1 = *reinterpret_cast<const float2*>(lsb + kBK + c1);
  a[0] = norm2(xr[0], mean0, rstd0, g0, h0);
  a[1] = norm2(xr[1], mean1, rstd1, g0, h0);
  a[2] = norm2(xr[2], mean0, rstd0, g1, h1);
  a[3] = norm2(xr[3], mean1, rstd1, g1, h1);
}

__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 const __grid_constant__ CUtensorMap tmlsb, const __grid_constant__ CUtensorMap tmo,
                 const float* __restrict__ stats, const bf16* __restrict__ bias, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring ring;
  ring.base = smem_raw + ((1024 - sm90::smem_u32(smem_raw) % 1024) % 1024);
  ring.full = reinterpret_cast<uint64_t*>(ring.out(2));
  ring.empty = ring.full + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(&ring.full[st], 1);
      sm90::mbar_init(&ring.empty[st], kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int tiles_n = (N + kBN - 1) / kBN, tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int KT = (K + kBK - 1) / kBK;

  if (warp >= kConsumerWarps) {  // producer warpgroup: one thread feeds the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int st = it % kStages;
          sm90::mbar_wait(&ring.empty[st], ((it / kStages) & 1) ^ 1);
          sm90::mbar_expect_tx(&ring.full[st], kTxBytes);
          sm90::tma_load_2d(ring.x(st), &tmx, kt * kBK, m0, &ring.full[st]);
          sm90::tma_load_2d(ring.w(st), &tmw, kt * kBK, n0, &ring.full[st]);
          sm90::tma_load_2d(ring.lsb(st), &tmlsb, kt * kBK, 0, &ring.full[st]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int xrow = wg * 64 + (warp & 3) * 16 + (lane & 15);  // the row this lane addresses for ldmatrix
  const int r0 = wg * 64 + (warp & 3) * 16 + g;              // the rows of its accumulators: r0, r0 + 8
  float acc[128];
  uint32_t a[2][4];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
    const int ra = m0 + r0, rb = ra + 8;
    const float mean0 = ra < M ? stats[ra] : 0.f, rstd0 = ra < M ? stats[M + ra] : 0.f;
    const float mean1 = rb < M ? stats[rb] : 0.f, rstd1 = rb < M ? stats[M + rb] : 0.f;
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int st = it % kStages;
      sm90::mbar_wait(&ring.full[st], (it / kStages) & 1);
      const uint32_t xs = sm90::smem_u32(ring.x(st)) + xrow * 128;
      // one wgmma group a k16 step; A alternates between two register sets,
      // so step kk + 1 is normalised while the tensor cores run step kk
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        norm_fragment(a[kk & 1], xs, xrow, ring.lsb(st), kk, mean0, rstd0, mean1, rstd1);
        sm90::wgmma_fence();
        sm90::wgmma_m64n256k16_rs(acc, a[kk & 1], sm90::smem_desc(ring.w(st) + kk * 32, sm90::kSw128, 1024),
                                  kt > 0 || kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        // the previous stage's last group is done: its slot is free
        if (kk == 0 && kt > 0 && lane == 0) sm90::mbar_arrive(&ring.empty[prev]);
      }
      prev = st;
    }
    sm90::wgmma_wait<0>();
    if (lane == 0) sm90::mbar_arrive(&ring.empty[prev]);
#pragma unroll
    for (int i = 0; i < 128; ++i) sm90::fence_operand(acc[i]);

    // epilogue: bf16(acc), then + b in bf16, into the warpgroup's staging
    // tile (four 64 x 64 boxes, 128-byte swizzled: conflict-free writes),
    // then one TMA store a box, which clips rows past M and columns past N
    const bool issuer = (warp & 3) == 0 && lane == 0;
    unsigned char* stage_out = ring.out(wg);
    if (issuer) sm90::bulk_wait_read<0>();  // the previous tile's store has read the buffer
    sm90::named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      const float2 bb = col < N ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col))
                                : make_float2(0.f, 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (warp & 3) * 16 + g + half * 8;  // row within the warpgroup's 64
        const float v0 = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * half])) + bb.x;
        const float v1 = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * half + 1])) + bb.y;
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(stage_out + (j / 8) * 8192 + r * 128 + (((j % 8) ^ (r & 7)) << 4) +
                                           t * 4) = v;
      }
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + wg, 128);
    if (issuer && m0 + wg * 64 < M) {
      for (int q = 0; q < 4 && n0 + q * 64 < N; ++q)
        sm90::tma_store_2d(&tmo, stage_out + q * 8192, n0 + q * 64, m0 + wg * 64);
      sm90::bulk_commit();
    }
  }
  if ((warp & 3) == 0 && lane == 0) sm90::bulk_wait<0>();
}

}  // namespace

extern "C" {

// x [M, K], w [N, K], b [N], out [M, N] bf16, lsb [2, K] f32 (ls then lb)
// and stats [2, M] f32 scratch, contiguous and 16-byte aligned on the
// device; K % 8 == 0, N % 8 == 0. Launches the statistics pass and the GEMM
// on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for what it cannot take.
int isx_ln_matmul(const void* x, const void* lsb, const void* w, const void* b, void* out, void* stats, int M,
                  int N, int K, float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tmx, tmw, tmlsb, tmo;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, w_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t l_dims[2] = {(cuuint64_t)K, 2};
  const cuuint64_t bf_stride[1] = {(cuuint64_t)K * 2}, f_stride[1] = {(cuuint64_t)K * 4};
  const cuuint64_t o_dims[2] = {(cuuint64_t)N, (cuuint64_t)M}, o_stride[1] = {(cuuint64_t)N * 2};
  const cuuint32_t x_box[2] = {kBK, kBM}, w_box[2] = {kBK, kBN}, l_box[2] = {kBK, 2}, o_box[2] = {64, 64};
  if (!sm90::tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, bf_stride, x_box,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, bf_stride, w_box,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::tensor_map(&tmlsb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, lsb, l_dims, f_stride, l_box,
                        CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !sm90::tensor_map(&tmo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, o_dims, o_stride, o_box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  ln_stats_kernel<<<(M + kStatsRows - 1) / kStatsRows, kStatsRows * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<float*>(stats), M, K, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ln_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = (int)(tiles < sm90::sm_count() ? tiles : sm90::sm_count());
  ln_matmul_kernel<<<grid, kThreads, kSmemBytes, st>>>(tmx, tmw, tmlsb, tmo, static_cast<const float*>(stats),
                                                       static_cast<const bf16*>(b), M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"

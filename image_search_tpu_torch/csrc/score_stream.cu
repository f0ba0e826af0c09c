// int8 full-scan cosine scores for Hopper (sm_90a): one pass over an int8
// row slab on the int8 tensor cores, with the scale / penalty / valid-row
// epilogue fused.
//
// Replaces the TPU kernel image_search_tpu/ops/score_stream.py::_kernel and
// ::_kernel_pen (entry point stream_scores_int8), the int8 scan behind every
// /search on an --index-quantize int8 index and behind the legacy duplicate
// scan. For query b and row n:
//
//   s = float(sum_d qi[b, d] * rows[n, d])   exact int32 accumulation
//   s = s * qs[b]                             rounded
//   s = s * scales[n]                         rounded
//   s = s + pens[n]                           rounded (penalty variant only)
//   out[b, n] = n < limit ? s : NEG_INF
//
// The reference rounds after every step (score_stream.py:70-74,
// sharded_search.py:51); the epilogue uses __fmul_rn/__fadd_rn so nvcc can
// never contract a multiply and an add into one FMA. The int32 sum is exact
// at any D, and its conversion to f32 rounds once (exact below 2^24, which
// 127 * 127 * D stays under for any operands only at D <= 1040). The plain
// PyTorch version sums exactly too (in f32 at D <= 1040, in f64 above), as
// does the reference's s32 path, so the scores are bitwise equal to both at
// any D, OpenCLIP bigG's 1280 included. The reference's bf16 path
// (score_stream.py:60-64) sums in f32 and matches only while every partial
// sum stays below 2^24, which 127 * 127 * 1280 can exceed.
//
// Design: an int8 tile GEMM, out tile [BM queries x 128 rows] per CTA, on
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (the Pallas kernel feeds s8
// to the MXU with s32 accumulation; this is Hopper's counterpart). The slab's
// [N, D] row-major layout is the MMA's "col" B operand as it stands, and the
// queries' [B, D] its "row" A operand: both tiles go to shared memory by
// cp.async, 64 bytes of D a stage, through a ring of 4 stages, and their
// fragments come out by ldmatrix (an 8 x 8 b16 matrix is 8 rows of 16 int8).
// Each query tile is read once per CTA, beside its rows. BM follows the
// batch (ops/score_stream.py::score_plan): 16 for B <= 16 (the padded queries
// are zero and never stored), 64 up to 64 queries, 128 above; one launch
// covers any B, the CTAs of one row tile run side by side (query tile
// fastest), so a row tile comes from device memory once and from L2 for the
// other query tiles. Ragged edges are masked in the kernel: the K step past
// D, rows past N and queries past B are zero-filled (an int8 zero adds 0); a
// row tile wholly at or past `limit` reads nothing and stores NEG_INF.
//
// What bounds it: bytes. At B <= 8 it is the slab, N * D bytes (768 MB at
// 1M rows x 768: 0.23 ms at 3.35 TB/s), at about 2B integer operations a byte;
// at the legacy duplicate scan's B = 1024 it is the [B, N] f32 output (4 x B
// bytes per row against D), 323 operations a byte against the card's ~590.
// The ring keeps 3 stages of every CTA's rows in flight; the MMAs are far
// below the tensor cores' rate at every B the port runs.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -FLT_MAX;  // jnp.finfo(jnp.float32).min
constexpr int kBN = 128;             // rows of the slab per CTA tile
constexpr int kBK = 64;              // bytes of D per ring stage (two k32 MMA steps)
constexpr int kLds = kBK + 16;       // shared row stride: 80 bytes, 8 ldmatrix rows on distinct banks
constexpr int kStages = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (VEC16) or 4 bytes global -> shared, asynchronously; zero-filled when
// !valid (src is then not read, but must be a mapped address).
template <bool VEC16>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if (VEC16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 32 s8, row) . b (32 x 8 s8, col), exact in s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue of one score, in the reference's order.
template <bool HAS_PEN>
__device__ __forceinline__ float epilogue(int acc, float q_scale, const float* __restrict__ scales,
                                          const float* __restrict__ pens, int n, int limit) {
  if (n >= limit) return kNegInf;
  float s = __fmul_rn(__int2float_rn(acc), q_scale);
  s = __fmul_rn(s, scales[n]);
  if (HAS_PEN) s = __fadd_rn(s, pens[n]);
  return s;
}

// BM = WM * MT * 16 queries by kBN = WN * NT * 8 rows; warps WM x WN, each
// owning MT m16 tiles by NT n8 tiles.
template <int WM, int WN, int MT, int NT, bool HAS_PEN, bool VEC16>
__global__ void __launch_bounds__(WM * WN * 32)
score_int8_kernel(const int8_t* __restrict__ rows, const int8_t* __restrict__ qi,
                  const float* __restrict__ qs, const float* __restrict__ scales,
                  const float* __restrict__ pens, float* __restrict__ out,
                  int N, int D, int B, int limit, int m_tiles) {
  constexpr int kBM = WM * MT * 16;
  constexpr int kThreads = WM * WN * 32;
  static_assert(WN * NT * 8 == kBN, "a CTA tile is kBN rows wide");
  constexpr int kChunk = VEC16 ? 16 : 4;            // bytes per cp.async
  constexpr int kPerRow = kBK / kChunk;             // copies per tile row and stage
  constexpr int kStageBytes = (kBM + kBN) * kLds;   // query tile, then row tile
  extern __shared__ __align__(16) unsigned char smem[];

  const int m0 = (int)(blockIdx.x % (unsigned)m_tiles) * kBM;  // query tiles fastest
  const int n0 = (int)(blockIdx.x / (unsigned)m_tiles) * kBN;
  const int tid = threadIdx.x;

  if (n0 >= limit) {  // the whole tile is masked: read nothing
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int b = m0 + i / kBN, n = n0 + i % kBN;
      if (b < B && n < N) out[(size_t)b * N + n] = kNegInf;
    }
    return;
  }

  const int KT = (D + kBK - 1) / kBK;
  auto load = [&](int kt, int stage) {
    unsigned char* sq = smem + stage * kStageBytes;
    unsigned char* sr = sq + kBM * kLds;
    const int k0 = kt * kBK;
    for (int i = tid; i < (kBM + kBN) * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
      const bool kin = k0 + c < D;  // D % 4 == 0: a 4-byte copy is wholly in or out (16 under VEC16)
      if (r < kBM) {
        const bool ok = kin && m0 + r < B;
        cp_async<VEC16>(sq + r * kLds + c, ok ? (const void*)(qi + (size_t)(m0 + r) * D + k0 + c) : (const void*)qi, ok);
      } else {
        const int rr = r - kBM;
        const bool ok = kin && n0 + rr < N;
        cp_async<VEC16>(sr + rr * kLds + c, ok ? (const void*)(rows + (size_t)(n0 + rr) * D + k0 + c) : (const void*)rows,
                        ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / WN) * MT * 16, wn = (warp % WN) * NT * 8;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  const bool active = m0 + wm < B;  // warp-uniform: some of its queries are real

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    else asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // stage kt has landed for all; stage kt - 1 is free
    if (kt + kStages - 1 < KT) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    else asm volatile("cp.async.commit_group;\n" ::);
    if (active) {
      const unsigned char* sq = smem + (kt % kStages) * kStageBytes;
      const unsigned char* sr = sq + kBM * kLds;
      // the stage's fragments first, then its MMAs back to back (the asm
      // statements keep their order)
      uint32_t a[kBK / 32][MT][4], b[kBK / 32][NT / 2][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(a[kk][i], sq + (wm + i * 16 + lane % 16) * kLds + kk * 32 + (lane / 16) * 16);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          ldmatrix_x4(b[kk][j], sr + (wn + j * 16 + (lane / 16) * 8 + lane % 8) * kLds + kk * 32 + ((lane / 8) % 2) * 16);
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_s8(acc[i][j], a[kk][i], b[kk][j / 2][(j % 2) * 2], b[kk][j / 2][(j % 2) * 2 + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  if (!active) return;
  const int g = lane / 4, t = lane % 4;
  const bool pairs = N % 2 == 0;  // 8-byte stores stay aligned
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = m0 + wm + i * 16 + g + half * 8;
      if (b >= B) continue;
      const float q_scale = qs[b];
      float* orow = out + (size_t)b * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(orow + n) =
              make_float2(epilogue<HAS_PEN>(acc[i][j][2 * half], q_scale, scales, pens, n, limit),
                          epilogue<HAS_PEN>(acc[i][j][2 * half + 1], q_scale, scales, pens, n + 1, limit));
        } else {
          if (n < N) orow[n] = epilogue<HAS_PEN>(acc[i][j][2 * half], q_scale, scales, pens, n, limit);
          if (n + 1 < N) orow[n + 1] = epilogue<HAS_PEN>(acc[i][j][2 * half + 1], q_scale, scales, pens, n + 1, limit);
        }
      }
    }
}

template <int WM, int WN, int MT, int NT, bool HAS_PEN, bool VEC16>
cudaError_t launch(const int8_t* rows, const int8_t* qi, const float* qs, const float* scales,
                   const float* pens, float* out, int N, int D, int B, int limit, cudaStream_t stream) {
  constexpr int kBM = WM * MT * 16;
  const size_t smem = (size_t)kStages * (kBM + kBN) * kLds;
  auto kernel = score_int8_kernel<WM, WN, MT, NT, HAS_PEN, VEC16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long m_tiles = (B + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  if (m_tiles * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)(m_tiles * n_tiles), WM * WN * 32, smem, stream>>>(rows, qi, qs, scales, pens, out, N, D,
                                                                         B, limit, (int)m_tiles);
  return cudaGetLastError();
}

template <bool HAS_PEN, bool VEC16>
cudaError_t launch_bm(int bm, const int8_t* rows, const int8_t* qi, const float* qs, const float* scales,
                      const float* pens, float* out, int N, int D, int B, int limit, cudaStream_t stream) {
  switch (bm) {  // warps: 1 x 4 of 16 x 32, 2 x 2 of 32 x 64, 4 x 2 of 32 x 64
    case 16:
      return launch<1, 4, 1, 4, HAS_PEN, VEC16>(rows, qi, qs, scales, pens, out, N, D, B, limit, stream);
    case 64:
      return launch<2, 2, 2, 8, HAS_PEN, VEC16>(rows, qi, qs, scales, pens, out, N, D, B, limit, stream);
    case 128:
      return launch<4, 2, 2, 8, HAS_PEN, VEC16>(rows, qi, qs, scales, pens, out, N, D, B, limit, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// rows [N, D] int8, qi [B, D] int8, qs [B] f32, scales [N] f32, pens [N] f32 or
// NULL (no-penalty variant), out [B, N] f32; all contiguous on the device.
// D must be a multiple of 4; bm (queries per CTA tile) is 16, 64 or 128.
// One launch on `stream` for any B; returns cudaGetLastError().
int isx_score_int8(const void* rows, const void* qi, const void* qs, const void* scales,
                   const void* pens, void* out, int N, int D, int B, int limit, int bm, void* stream) {
  if (N <= 0 || B <= 0 || D <= 0 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const bool vec16 = D % 16 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(qi) % 16 == 0;
  auto r = static_cast<const int8_t*>(rows);
  auto q = static_cast<const int8_t*>(qi);
  auto a = static_cast<const float*>(qs);
  auto s = static_cast<const float*>(scales);
  auto p = static_cast<const float*>(pens);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p != nullptr)
    err = vec16 ? launch_bm<true, true>(bm, r, q, a, s, p, o, N, D, B, limit, st)
                : launch_bm<true, false>(bm, r, q, a, s, p, o, N, D, B, limit, st);
  else
    err = vec16 ? launch_bm<false, true>(bm, r, q, a, s, p, o, N, D, B, limit, st)
                : launch_bm<false, false>(bm, r, q, a, s, p, o, N, D, B, limit, st);
  return (int)err;
}

}  // extern "C"

// int8 full-scan cosine scores for Hopper (sm_90a): one pass over an int8
// row slab with the scale / penalty / valid-row epilogue fused.
//
// Replaces the TPU kernel image_search_tpu/ops/score_stream.py::_kernel and
// ::_kernel_pen (entry point stream_scores_int8), the int8 scan behind every
// /search on an --index-quantize int8 index. For query b and row n:
//
//   s = float(sum_d qi[b, d] * rows[n, d])   exact int32 accumulation
//   s = s * qs[b]                             rounded
//   s = s * scales[n]                         rounded
//   s = s + pens[n]                           rounded (penalty variant only)
//   out[b, n] = n < limit ? s : NEG_INF
//
// The reference rounds after every step (score_stream.py:70-74,
// sharded_search.py:51); the epilogue uses __fmul_rn/__fadd_rn so nvcc can
// never contract a multiply and an add into one FMA, and the scores are
// bitwise equal to the reference's and to the plain PyTorch version's.
//
// Design: one thread per row, 256 rows per block. The block stages the B int8
// queries in shared memory, each thread reads its row exactly once in 16-byte
// loads and accumulates up to 8 queries at a time with __dp4a (int8 x 4 dot
// products into int32). Stores of out[b, n] are coalesced across the block.
// The ragged edge (N not a multiple of 256, or of the reference's 4096) is
// masked here instead of being required away. A batch whose B x D queries do
// not fit in shared memory is split by the wrapper into launches over query
// chunks (ops/score_stream.py::query_chunks), each of which reads the slab
// again.
//
// What bounds it: reading the slab, N * D bytes (768 MB at 1M rows x 768), at
// B <= 8 -- about 2 * B integer ops per byte, far below the card's ratio of
// compute to bandwidth. int8 mma/wgmma tiles and a fused per-block top-k are
// later work.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -FLT_MAX;  // jnp.finfo(jnp.float32).min
constexpr int kThreads = 256;
constexpr int kQueriesPerPass = 8;

template <bool HAS_PEN, bool VEC16>
__global__ void __launch_bounds__(kThreads)
score_int8_kernel(const int8_t* __restrict__ rows, const int8_t* __restrict__ qi,
                  const float* __restrict__ qs, const float* __restrict__ scales,
                  const float* __restrict__ pens, float* __restrict__ out,
                  int N, int D, int B, int limit) {
  extern __shared__ __align__(16) unsigned char q_smem[];  // [B, D] int8
  const int q_words = B * D / 4;
  for (int i = threadIdx.x; i < q_words; i += kThreads)
    reinterpret_cast<int*>(q_smem)[i] = reinterpret_cast<const int*>(qi)[i];
  __syncthreads();

  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  if (n >= limit) {
    for (int b = 0; b < B; ++b) out[(size_t)b * N + n] = kNegInf;
    return;
  }
  const int8_t* row = rows + (size_t)n * D;
  const float scale = scales[n];
  for (int b0 = 0; b0 < B; b0 += kQueriesPerPass) {
    const int nb = min(kQueriesPerPass, B - b0);
    int acc[kQueriesPerPass];
#pragma unroll
    for (int j = 0; j < kQueriesPerPass; ++j) acc[j] = 0;
    if (VEC16) {
      const int4* r4 = reinterpret_cast<const int4*>(row);
      for (int c = 0; c < D / 16; ++c) {
        const int4 r = r4[c];
#pragma unroll
        for (int j = 0; j < kQueriesPerPass; ++j) {
          if (j < nb) {
            const int4 qv = reinterpret_cast<const int4*>(q_smem + (size_t)(b0 + j) * D)[c];
            acc[j] = __dp4a(r.x, qv.x, acc[j]);
            acc[j] = __dp4a(r.y, qv.y, acc[j]);
            acc[j] = __dp4a(r.z, qv.z, acc[j]);
            acc[j] = __dp4a(r.w, qv.w, acc[j]);
          }
        }
      }
    } else {
      const int* r1 = reinterpret_cast<const int*>(row);
      for (int w = 0; w < D / 4; ++w) {
        const int r = r1[w];
#pragma unroll
        for (int j = 0; j < kQueriesPerPass; ++j) {
          if (j < nb)
            acc[j] = __dp4a(r, reinterpret_cast<const int*>(q_smem + (size_t)(b0 + j) * D)[w],
                            acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQueriesPerPass; ++j) {
      if (j < nb) {
        float s = __fmul_rn(__int2float_rn(acc[j]), qs[b0 + j]);
        s = __fmul_rn(s, scale);
        if (HAS_PEN) s = __fadd_rn(s, pens[n]);
        out[(size_t)(b0 + j) * N + n] = s;
      }
    }
  }
}

template <bool HAS_PEN, bool VEC16>
cudaError_t launch(const int8_t* rows, const int8_t* qi, const float* qs, const float* scales,
                   const float* pens, float* out, int N, int D, int B, int limit,
                   cudaStream_t stream) {
  const size_t smem = (size_t)B * D;
  auto kernel = score_int8_kernel<HAS_PEN, VEC16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, stream>>>(rows, qi, qs, scales, pens, out, N, D, B, limit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows [N, D] int8, qi [B, D] int8, qs [B] f32, scales [N] f32, pens [N] f32 or
// NULL (no-penalty variant), out [B, N] f32; all contiguous on the device.
// D must be a multiple of 4. Launches on `stream`; returns cudaGetLastError().
int isx_score_int8(const void* rows, const void* qi, const void* qs, const void* scales,
                   const void* pens, void* out, int N, int D, int B, int limit, void* stream) {
  if (N <= 0 || B <= 0 || D <= 0 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const bool vec16 = D % 16 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  auto r = static_cast<const int8_t*>(rows);
  auto q = static_cast<const int8_t*>(qi);
  auto a = static_cast<const float*>(qs);
  auto s = static_cast<const float*>(scales);
  auto p = static_cast<const float*>(pens);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p != nullptr)
    err = vec16 ? launch<true, true>(r, q, a, s, p, o, N, D, B, limit, st)
                : launch<true, false>(r, q, a, s, p, o, N, D, B, limit, st);
  else
    err = vec16 ? launch<false, true>(r, q, a, s, p, o, N, D, B, limit, st)
                : launch<false, false>(r, q, a, s, p, o, N, D, B, limit, st);
  return (int)err;
}

}  // extern "C"

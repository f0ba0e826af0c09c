// Attention forward for Hopper (sm_90a): softmax(q k^T * sm_scale [+ causal]) v
// over the packed [B, S, H*Hd] bf16 layout, one head per block.
//
// Replaces the TPU kernel image_search_tpu/ops/attention.py::_attn_kernel_grouped
// (entry point fused_attention_grouped), which runs every attention layer of
// both CLIP towers except the last. Same math and the same rounding points as
// that kernel:
//   - logits = (q . k) * sm_scale in f32 (bf16 products are exact in f32);
//   - masked (causal) logits are NEG_INF = finfo(f32).min, never -inf, so a
//     fully masked row gives exp(0) = 1 everywhere instead of NaN; keys past
//     the causal edge contribute exp(NEG_INF - max) = 0, so they are skipped;
//   - f32 row max, p = exp(l - max) in f32, f32 row sum;
//   - p is rounded to bf16 BEFORE the PV product, PV accumulates in f32, and
//     the accumulator is THEN multiplied by 1/sum and stored as bf16.
//
// Design: grid = (query tile, head, batch row). A block stages its head's K
// and V ([S, Hd] bf16 each, 2 x 257 x 64 x 2 B = 66 KB at the vision tower's
// S = 257) in dynamic shared memory, so it needs the opt-in above 48 KB. Rows
// are padded to Hd + 2 elements so that lanes reading different keys at the
// same depth hit different banks. Each warp owns one query row at a time:
// lanes split the keys for the logits and split the head dims for PV.
//
// What bounds it: per head about 2 * 2 * S^2 * Hd FLOP over about 4 * S * Hd * 2
// bytes of q, k, v and out, i.e. ~64 FLOP/byte at S = 257 -- compute-bound once
// it runs on tensor cores. This first version does scalar f32 FMAs on the CUDA
// cores, so it is bound by FMA issue; a wgmma/TMA version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr float kNegInf = -FLT_MAX;  // jnp.finfo(jnp.float32).min
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTileRows = 128;

__host__ __device__ constexpr int kv_ld(int hd) { return hd + 2; }

template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o,
                int S, long long q_ld, long long k_ld, long long v_ld, long long o_ld,
                int q_tile, int causal, float sm_scale) {
  constexpr int LD = kv_ld(HD);
  constexpr int WORDS = HD / 2;  // bf16 pairs per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s_pad = (S + 31) / 32 * 32;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + (size_t)S * LD;
  float* ps = reinterpret_cast<float*>(vs + (size_t)S * LD);  // [kWarps, s_pad]
  float* qsh = ps + kWarps * s_pad;                             // [kWarps, HD]

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * q_tile;
  const int row1 = min(S, row0 + q_tile);
  const int n_keys = causal ? row1 : S;  // keys any row of this tile can see
  const long long col = (long long)h * HD;

  for (int i = threadIdx.x; i < n_keys * WORDS; i += kThreads) {
    const int j = i / WORDS, w = i % WORDS;
    const long long tok = (long long)b * S + j;
    *reinterpret_cast<__nv_bfloat162*>(ks + j * LD + 2 * w) =
        *reinterpret_cast<const __nv_bfloat162*>(k + tok * k_ld + col + 2 * w);
    *reinterpret_cast<__nv_bfloat162*>(vs + j * LD + 2 * w) =
        *reinterpret_cast<const __nv_bfloat162*>(v + tok * v_ld + col + 2 * w);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * s_pad;
  float* qr = qsh + warp * HD;
  for (int r = row0 + warp; r < row1; r += kWarps) {
    const long long tok = (long long)b * S + r;
    for (int w = lane; w < WORDS; w += 32) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(q + tok * q_ld + col + 2 * w));
      qr[2 * w] = f.x;
      qr[2 * w + 1] = f.y;
    }
    __syncwarp();

    const int kmax = causal ? r + 1 : S;
    float mx = kNegInf;
    for (int j = lane; j < kmax; j += 32) {
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + j * LD);
      float acc = 0.f;
#pragma unroll 8
      for (int w = 0; w < WORDS; ++w) {
        const float2 kf = __bfloat1622float2(kr[w]);
        acc = fmaf(qr[2 * w], kf.x, acc);
        acc = fmaf(qr[2 * w + 1], kf.y, acc);
      }
      const float l = acc * sm_scale;
      p[j] = l;
      mx = fmaxf(mx, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

    float sum = 0.f;
    for (int j = lane; j < kmax; j += 32) {
      const float e = expf(p[j] - mx);
      sum += e;
      p[j] = __bfloat162float(__float2bfloat16(e));  // p.astype(bf16)
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float recip = 1.0f / sum;
    __syncwarp();

    for (int w = lane; w < WORDS; w += 32) {
      float a0 = 0.f, a1 = 0.f;
      const __nv_bfloat162* vc = reinterpret_cast<const __nv_bfloat162*>(vs) + w;
#pragma unroll 4
      for (int j = 0; j < kmax; ++j) {
        const float pj = p[j];
        const float2 vf = __bfloat1622float2(vc[j * (LD / 2)]);
        a0 = fmaf(pj, vf.x, a0);
        a1 = fmaf(pj, vf.y, a1);
      }
      *reinterpret_cast<__nv_bfloat162*>(o + tok * o_ld + col + 2 * w) =
          __floats2bfloat162_rn(a0 * recip, a1 * recip);
    }
    __syncwarp();
  }
}

size_t smem_bytes(int S, int hd) {
  const int s_pad = (S + 31) / 32 * 32;
  return 2 * (size_t)S * kv_ld(hd) * sizeof(__nv_bfloat16) +
         (size_t)kWarps * s_pad * sizeof(float) + (size_t)kWarps * hd * sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for sequence length S (the wrapper
// checks it against the card's per-block limit before launching).
size_t isx_attention_smem_bytes(int S, int head_dim) { return smem_bytes(S, head_dim); }

// q, k, v, o: bf16, element (b, s, h, d) at (b*S + s)*ld + h*head_dim + d.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int isx_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int head_dim,
                      long long q_ld, long long k_ld, long long v_ld, long long o_ld,
                      int causal, float sm_scale, void* stream) {
  if (head_dim != 64 || B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (S + kMaxTileRows - 1) / kMaxTileRows;
  const int q_tile = (S + n_tiles - 1) / n_tiles;
  const size_t smem = smem_bytes(S, head_dim);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<64>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, H, B);
  attn_fwd_kernel<64><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, q_ld, k_ld,
      v_ld, o_ld, q_tile, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"

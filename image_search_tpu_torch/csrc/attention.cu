// Attention forward for Hopper (sm_90a): softmax(q k^T * sm_scale [+ causal]) v
// over the packed [B, S, H*Hd] bf16 layout, one head per block.
//
// Replaces three TPU kernels of image_search_tpu/ops/attention.py, which
// compute one function and differ only in where p is rounded and which keys
// take part:
//   - _attn_kernel_grouped (entry point fused_attention_grouped; the default
//     route of every attention layer of both CLIP towers except the last):
//     p = exp(l - max) is rounded to bf16 BEFORE the PV product, PV
//     accumulates in f32, and the accumulator is THEN multiplied by 1/sum;
//   - _attn_kernel (fused_attention_packed, the route under ISX_ATTN_PIPE=0
//     or a head group that does not divide H): p = exp(l - max) / sum in
//     f32, THEN rounded to bf16; the f32 PV accumulator is stored as it is;
//   - _attn_kernel_split (fused_attention_split and
//     fused_attention_split_padded, the vision routes under ISX_ATTN_SPLIT=1
//     and ISX_VIT_SPAD): p as in _attn_kernel over one shared max and one
//     shared denominator, keys split at s_main into a main block and a tail,
//     the two blocks' PV sums added in f32 (main + tail), and keys at or
//     past s_real masked. Here the key limit skips those keys outright, so
//     a non-finite pad row can never reach a real row; query rows at or
//     past s_real are still computed over the real keys, as the TPU kernel
//     does, so the output holds no uninitialised memory. The TPU kernel's
//     two logit scratch tiles (an aligned 256-lane block plus an 8-lane
//     tail) exist for its 128-lane tiling and have no counterpart here.
// Common to all three:
//   - logits = (q . k) * sm_scale in f32 (bf16 products are exact in f32);
//   - masked (causal) logits are NEG_INF = finfo(f32).min, never -inf, so a
//     fully masked row gives exp(0) = 1 everywhere instead of NaN; keys past
//     the causal edge contribute exp(NEG_INF - max) = 0, so they are skipped;
//   - f32 row max, p = exp(l - max) in f32, f32 row sum.
//
// Design: grid = (query tile, head, batch row). A block stages its head's K
// and V for the keys it can see ([n_keys, Hd] bf16 each, 2 x 257 x 64 x 2 B
// = 66 KB at the vision tower's S = 257) in dynamic shared memory, so it
// needs the opt-in above 48 KB. Rows are padded to Hd + 2 elements so that
// lanes reading different keys at the same depth hit different banks. Each
// warp owns one query row at a time: lanes split the keys for the logits
// and split the head dims for PV.
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

// NORM_P false: the grouped kernel's rounding (bf16(e), accumulator * 1/sum);
// true: the packed and split kernels' (bf16(e / sum), accumulator as is).
// Rows 0..S-1 of q and o are computed; keys 0..n_keys-1 of k and v take part
// (n_keys <= S), summed as [0, s_main) then [s_main, n_keys).
template <int HD, bool NORM_P>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o,
                int S, int n_keys, int s_main,
                long long q_ld, long long k_ld, long long v_ld, long long o_ld,
                int q_tile, int causal, float sm_scale) {
  constexpr int LD = kv_ld(HD);
  constexpr int WORDS = HD / 2;  // bf16 pairs per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s_pad = (n_keys + 31) / 32 * 32;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + (size_t)n_keys * LD;
  float* ps = reinterpret_cast<float*>(vs + (size_t)n_keys * LD);  // [kWarps, s_pad]
  float* qsh = ps + kWarps * s_pad;                                  // [kWarps, HD]

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * q_tile;
  const int row1 = min(S, row0 + q_tile);
  const int n_stage = causal ? min(row1, n_keys) : n_keys;  // keys any row of this tile can see
  const long long col = (long long)h * HD;

  for (int i = threadIdx.x; i < n_stage * WORDS; i += kThreads) {
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

    const int kmax = causal ? min(r + 1, n_keys) : n_keys;
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
      p[j] = NORM_P ? e : __bfloat162float(__float2bfloat16(e));  // grouped: p.astype(bf16)
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float recip = 1.0f / sum;  // the grouped kernel's factor on the accumulator
    if constexpr (NORM_P) {
      // (p / sum).astype(bf16): each lane rewrites only the keys it wrote
      for (int j = lane; j < kmax; j += 32) p[j] = __bfloat162float(__float2bfloat16(p[j] / sum));
    }
    __syncwarp();

    const int k_main = min(kmax, s_main);
    for (int w = lane; w < WORDS; w += 32) {
      float a0 = 0.f, a1 = 0.f;
      const __nv_bfloat162* vc = reinterpret_cast<const __nv_bfloat162*>(vs) + w;
#pragma unroll 4
      for (int j = 0; j < k_main; ++j) {
        const float pj = p[j];
        const float2 vf = __bfloat1622float2(vc[j * (LD / 2)]);
        a0 = fmaf(pj, vf.x, a0);
        a1 = fmaf(pj, vf.y, a1);
      }
      if (kmax > k_main) {  // the split kernels' tail block, summed on its own
        float t0 = 0.f, t1 = 0.f;
        for (int j = k_main; j < kmax; ++j) {
          const float pj = p[j];
          const float2 vf = __bfloat1622float2(vc[j * (LD / 2)]);
          t0 = fmaf(pj, vf.x, t0);
          t1 = fmaf(pj, vf.y, t1);
        }
        a0 += t0;
        a1 += t1;
      }
      *reinterpret_cast<__nv_bfloat162*>(o + tok * o_ld + col + 2 * w) =
          NORM_P ? __floats2bfloat162_rn(a0, a1) : __floats2bfloat162_rn(a0 * recip, a1 * recip);
    }
    __syncwarp();
  }
}

size_t smem_bytes(int n_keys, int hd) {
  const int s_pad = (n_keys + 31) / 32 * 32;
  return 2 * (size_t)n_keys * kv_ld(hd) * sizeof(__nv_bfloat16) +
         (size_t)kWarps * s_pad * sizeof(float) + (size_t)kWarps * hd * sizeof(float);
}

template <bool NORM_P>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int head_dim, long long q_ld, long long k_ld, long long v_ld, long long o_ld,
           int n_keys, int s_main, int causal, float sm_scale, void* stream) {
  if (head_dim != 64 || B <= 0 || S <= 0 || H <= 0 || n_keys <= 0 || n_keys > S ||
      s_main <= 0 || s_main > n_keys)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (S + kMaxTileRows - 1) / kMaxTileRows;
  const int q_tile = (S + n_tiles - 1) / n_tiles;
  const size_t smem = smem_bytes(n_keys, head_dim);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<64, NORM_P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, H, B);
  attn_fwd_kernel<64, NORM_P><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, n_keys, s_main,
      q_ld, k_ld, v_ld, o_ld, q_tile, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs when n_keys keys take part (the
// wrapper checks it against the card's per-block limit before launching).
size_t isx_attention_smem_bytes(int n_keys, int head_dim) { return smem_bytes(n_keys, head_dim); }

// The grouped kernel's function. q, k, v, o: bf16, element (b, s, h, d) at
// (b*S + s)*ld + h*head_dim + d. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int isx_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int head_dim,
                      long long q_ld, long long k_ld, long long v_ld, long long o_ld,
                      int causal, float sm_scale, void* stream) {
  return launch<false>(q, k, v, o, B, S, H, head_dim, q_ld, k_ld, v_ld, o_ld, S, S, causal,
                       sm_scale, stream);
}

// The packed and split kernels' function (p normalised before the bf16
// cast): rows 0..S-1 over keys 0..n_keys-1, PV summed over [0, s_main) and
// then [s_main, n_keys). The packed kernel is n_keys = s_main = S; the split
// kernels are s_main = (S//128)*128 and n_keys = s_real, non-causal.
int isx_attention_fwd_normalized(const void* q, const void* k, const void* v, void* o,
                                 int B, int S, int H, int head_dim,
                                 long long q_ld, long long k_ld, long long v_ld, long long o_ld,
                                 int n_keys, int s_main, int causal, float sm_scale,
                                 void* stream) {
  return launch<true>(q, k, v, o, B, S, H, head_dim, q_ld, k_ld, v_ld, o_ld, n_keys, s_main,
                      causal, sm_scale, stream);
}

}  // extern "C"

// QKV projection fused into attention for Hopper (sm_90a):
// out = attention(x @ w^T + b), the projection never written to device memory.
//
// Replaces the TPU kernel image_search_tpu/ops/attention.py::_qkv_attn_kernel
// (entry point fused_qkv_attention, kernel B8). Its function, with its
// rounding points, for batch row b and head h:
//   qkv = bf16(x[b] @ w^T) in f32 accumulation, then + bias in bf16
//   (bf16(f32(qkv) + f32(b)));
//   q, k, v = the head's columns of the q, k and v blocks of qkv;
//   logits = (q . k) * sm_scale in f32 (q unscaled), masked (causal) logits
//   at NEG_INF = finfo(f32).min; p = exp(l - max) / sum in f32, THEN
//   rounded to bf16; out = bf16(sum_j p_j v_j) with f32 sums: the function
//   of _attn_kernel_packed (B7) and of csrc/attention.cu's normalised route.
// x [B, S, D] bf16 (already layer-normed), w [3D, D] (nn.Linear's layout,
// rows [q | k | v]), b [3D], out [B, S, D]; head dim 64.
//
// Design: one CTA of 16 warps per (head, batch row). Phase 1 projects the
// S x D rows of x against the head's 192 rows of w (64 each of q, k and v)
// in chunks of 64 rows: x and w tiles 32 deep arrive by cp.async, double
// buffered; warps are laid out 4 x 4, each owning 16 rows x 48 columns (six
// mma.sync.m16n8k16 bf16 tiles, fragments by ldmatrix). A warp whose 16
// rows all lie past S skips its products. The epilogue rounds, adds the
// bias and writes the head's q, k and v to shared memory, [S][3 x (64 + 2)]
// bf16 (102 KB at S = 257; the odd word stride keeps lanes that read
// different keys on different banks). Phase 2 is B1p's attention body over
// that buffer: each warp owns one query row at a time, lanes split the keys
// for the logits and the head dims for PV, scalar f32 FMAs. The staging
// tiles of phase 1 and the logits rows of phase 2 share one region.
//
// What bounds it: operations. At ViT-L/14 (B = 160, S = 257, D = 1024, 16
// heads) the projection is 2*B*S*D*3D = 259 GFLOP and attention 43 GFLOP,
// against ~0.17 GB of x, w, b and out. Each CTA re-reads its head's 192 rows
// of w once per 64-row chunk (from L2), and one CTA fills an SM's shared
// memory, so the scalar attention phase runs 16 warps per SM. Tensor cores
// for phase 2, wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -FLT_MAX;  // jnp.finfo(jnp.float32).min
constexpr int kHd = 64;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 64, kBK = 32, kNQ = 3 * kHd;  // projection chunk: 64 rows x 192 columns
constexpr int kLds = kBK + 8;                      // staging row stride (bf16), conflict-free ldmatrix
constexpr int kPart = kHd + 2;                     // q, k and v rows padded to 66 elements
constexpr int kQld = 3 * kPart;                    // 198 elements = 99 words per token

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

__host__ __device__ size_t qkv_bytes(int S) { return ((size_t)S * kQld * sizeof(__nv_bfloat16) + 15) / 16 * 16; }

size_t scratch_bytes(int S) {
  const size_t staging = 2 * (size_t)(kBM + kNQ) * kLds * sizeof(__nv_bfloat16);
  const size_t s_pad = (S + 31) / 32 * 32;
  const size_t attn = (size_t)kWarps * (s_pad + kHd) * sizeof(float);
  return staging > attn ? staging : attn;
}

size_t smem_bytes(int S) { return qkv_bytes(S) + scratch_bytes(S); }

__global__ void __launch_bounds__(kThreads, 1)
qkv_attention_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ o,
                     int S, int D, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qkv = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* scratch = smem_raw + qkv_bytes(S);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(scratch);  // [2][kBM * kLds]
  __nv_bfloat16* sB = sA + 2 * kBM * kLds;                          // [2][kNQ * kLds]

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* xb = x + (size_t)b * S * D;

  // ---- phase 1: the head's q, k and v, [S, 192], into shared memory ----
  const int wm = (warp / 4) * 16, wn = (warp % 4) * 48;
  const int KT = D / kBK;  // D % 32 == 0
  for (int s0 = 0; s0 < S; s0 += kBM) {
    auto load = [&](int kt, int buf) {
      const int k0 = kt * kBK;
      for (int i = threadIdx.x; i < (kBM + kNQ) * 4; i += kThreads) {
        const int r = i / 4, c = (i % 4) * 8;
        if (r < kBM) {
          const int s = s0 + r;
          cp_async16(sA + buf * kBM * kLds + r * kLds + c, s < S ? (const void*)(xb + (size_t)s * D + k0 + c) : (const void*)x,
                     s < S);
        } else {
          const int n = r - kBM;  // 0..191: part n / 64, head dim n % 64
          const size_t wrow = (size_t)(n / kHd) * D + (size_t)h * kHd + n % kHd;
          cp_async16(sB + buf * kNQ * kLds + n * kLds + c, w + wrow * D + k0 + c, true);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };

    float acc[6][4];
#pragma unroll
    for (int ni = 0; ni < 6; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
    const bool active = s0 + wm < S;  // warp-uniform: some of its 16 rows are real

    load(0, 0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    for (int kt = 0; kt < KT; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < KT) load(kt + 1, cur ^ 1);
      if (active) {
        const __nv_bfloat16* a_t = sA + cur * kBM * kLds;
        const __nv_bfloat16* b_t = sB + cur * kNQ * kLds;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          uint32_t a[4], bf[3][4];
          ldmatrix_x4(a, a_t + (wm + lane % 16) * kLds + kk + (lane / 16) * 8);
#pragma unroll
          for (int nj = 0; nj < 3; ++nj)
            ldmatrix_x4(bf[nj], b_t + (wn + nj * 16 + (lane / 16) * 8 + lane % 8) * kLds + kk + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int ni = 0; ni < 6; ++ni)
            mma_bf16(acc[ni], a, bf[ni / 2][(ni % 2) * 2], bf[ni / 2][(ni % 2) * 2 + 1]);
        }
      }
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
    }

    // epilogue: bf16(acc) + bias in bf16, into the [S][q|k|v] buffer
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int ni = 0; ni < 6; ++ni) {
      const int n = wn + ni * 8 + 2 * t;  // 0..191, even
      const int part = n / kHd, d = n % kHd;
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bias + (size_t)part * D + h * kHd + d));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = s0 + wm + g + half * 8;
        if (s >= S) continue;
        const float v0 = __bfloat162float(__float2bfloat16(acc[ni][2 * half])) + bb.x;
        const float v1 = __bfloat162float(__float2bfloat16(acc[ni][2 * half + 1])) + bb.y;
        *reinterpret_cast<__nv_bfloat162*>(qkv + (size_t)s * kQld + part * kPart + d) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();  // the projection is in shared memory; the staging region is free

  // ---- phase 2: B1p's attention body over the buffer ----
  constexpr int WORDS = kHd / 2;  // 32: one bf16 pair per lane
  const int s_pad = (S + 31) / 32 * 32;
  float* p = reinterpret_cast<float*>(scratch) + warp * s_pad;
  float* qr = reinterpret_cast<float*>(scratch) + kWarps * s_pad + warp * kHd;
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qkv);  // token j at word j * 99
  const __nv_bfloat162* k2 = q2 + kPart / 2;
  const __nv_bfloat162* v2 = q2 + kPart;
  constexpr int kRow = kQld / 2;
  for (int r = warp; r < S; r += kWarps) {
    {
      const float2 f = __bfloat1622float2(q2[r * kRow + lane]);
      qr[2 * lane] = f.x;
      qr[2 * lane + 1] = f.y;
    }
    __syncwarp();

    const int kmax = causal ? r + 1 : S;
    float mx = kNegInf;
    for (int j = lane; j < kmax; j += 32) {
      const __nv_bfloat162* kr = k2 + j * kRow;
      float a = 0.f;
#pragma unroll 8
      for (int wd = 0; wd < WORDS; ++wd) {
        const float2 kf = __bfloat1622float2(kr[wd]);
        a = fmaf(qr[2 * wd], kf.x, a);
        a = fmaf(qr[2 * wd + 1], kf.y, a);
      }
      const float l = a * sm_scale;
      p[j] = l;
      mx = fmaxf(mx, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

    float sum = 0.f;
    for (int j = lane; j < kmax; j += 32) {
      const float e = expf(p[j] - mx);
      sum += e;
      p[j] = e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < kmax; j += 32) p[j] = __bfloat162float(__float2bfloat16(p[j] / sum));
    __syncwarp();

    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int j = 0; j < kmax; ++j) {
      const float pj = p[j];
      const float2 vf = __bfloat1622float2(v2[j * kRow + lane]);
      a0 = fmaf(pj, vf.x, a0);
      a1 = fmaf(pj, vf.y, a1);
    }
    *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * S + r) * D + h * kHd + 2 * lane) =
        __floats2bfloat162_rn(a0, a1);
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs at sequence length S (the wrapper
// checks it against the card's per-block limit before launching).
size_t isx_qkv_attention_smem_bytes(int S) { return smem_bytes(S); }

// x [B, S, D], w [3D, D], b [3D], o [B, S, D]: bf16, contiguous and 16-byte
// aligned on the device; D = H * 64, D % 32 == 0. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
int isx_qkv_attention(const void* x, const void* w, const void* b, void* o, int B, int S, int H,
                      int head_dim, int causal, float sm_scale, void* stream) {
  const int D = H * head_dim;
  if (head_dim != kHd || B <= 0 || S <= 0 || H <= 0 || D % kBK != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(qkv_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  qkv_attention_kernel<<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(o), S, D, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"

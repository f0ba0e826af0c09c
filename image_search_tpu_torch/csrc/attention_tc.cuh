// Tensor-core building blocks shared by the attention forward
// (attention.cu: B1, B1p, B6, B7; qkv_attention.cu: B8) and backward
// (attention_bwd.cu: B5), so that all form every logit with the same
// instructions in the same order.
//
// The tile is mma.sync.m16n8k16 (bf16 operands, f32 accumulators): a warp
// owns 16 query rows; keys come in tiles of 16 (two 8-key n-tiles); the
// contraction runs over the head dim in 16-deep k-steps. Fragment layout
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), g = lane / 4, t = lane % 4:
//   A (16 x 16): a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8, cols 2t..),
//                a[2] = (row g, cols 2t+8..), a[3] = (row g+8, cols 2t+8..);
//   B (16 x 8):  b[0] = (k 2t, 2t+1; col g), b[1] = (k 2t+8, 2t+9; col g);
//   C (16 x 8):  c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (row g+8, ..).
// A C tile of two neighbouring n-tiles is, after rounding pairs to bf16, the
// A fragment of the next product over those 16 columns: probabilities go
// from the QK^T accumulators into the PV product without leaving registers.
//
// Head dims that 16 does not divide (bigG's 104) pad the contraction to
// kdim(HD) = 112: the A and B fragments' and the shared rows' columns
// HD..111 are zeros, which no load reads from device memory (in the packed
// [B, S, H*HD] layout they are the next head's), so QK^T (and B5's G V^T)
// sums the same products; PV (and B5's dq, dk, dv) runs HD / 8 output
// n-tiles (13 at 104, the last one on its own) and never stores a column at
// or past HD.
//
// Shared-memory rows of K, V, Q or G are padded to kdim(HD) + 8 bf16 (144
// bytes at HD = 64, 176 at 80, 240 at 104): 16-byte aligned for cp.async and
// ldmatrix, and the 8 rows an ldmatrix phase reads fall on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace attn_tc {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -FLT_MAX;  // jnp.finfo(jnp.float32).min, never -inf
constexpr int kWarps = 4;             // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 16;         // rows per warp tile (the MMA's M)
constexpr int kMaxKeyTiles = 20;      // 16-key tiles a warp holds in registers: 320 keys

// The contraction depth of a head: HD padded to the MMA's k of 16.
__host__ __device__ constexpr int kdim(int hd) { return (hd + 15) / 16 * 16; }
__host__ __device__ constexpr int ksteps(int hd) { return kdim(hd) / 16; }
__host__ __device__ constexpr int row_ld(int hd) { return kdim(hd) + 8; }
__host__ __device__ inline int ceil16(int n) { return (n + 15) / 16 * 16; }

// The register budget of a warp's logits: the smallest instantiated count of
// 16-key tiles that covers n_keys (0 if none does).
__host__ __device__ inline int key_tiles_for(int n_keys) {
  const int need = (n_keys + 15) / 16;
  return need <= 5 ? 5 : need <= 9 ? 9 : need <= 17 ? 17 : need <= kMaxKeyTiles ? kMaxKeyTiles : 0;
}

// CTAs along one (head, batch row) for n_tiles warp tiles: kWarps tiles each,
// the last one also taking the remainder (no CTA stages its operands for a
// lone ragged tile).
__host__ __device__ inline int ctas_for(int n_tiles) { return n_tiles / kWarps > 0 ? n_tiles / kWarps : 1; }

// Warp tiles [first, end) of CTA `cta` among `ctas`.
__device__ __forceinline__ void cta_tiles(int cta, int ctas, int n_tiles, int& first, int& end) {
  first = cta * kWarps;
  end = cta == ctas - 1 ? n_tiles : first + kWarps;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Rows [row0, row0 + n_rows) of one head of x (row stride ld) into shared
// rows 0..ceil16(n_rows)-1 of stride row_ld(HD), zero past n_real rows and
// in the padded columns HD..kdim(HD)-1 (never read from x).
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ x, long long ld,
                                           long long tok0, long long col, int n_real, int n_rows) {
  static_assert(HD % 8 == 0, "a head is whole 16-byte chunks");
  constexpr int CH = HD / 8;         // 16-byte chunks of the head per row
  constexpr int KCH = kdim(HD) / 8;  // chunks per shared row: CH, or CH + 1 zero-filled
  for (int i = threadIdx.x; i < n_rows * KCH; i += kThreads) {
    const int r = i / KCH, c = i % KCH;
    const bool real = r < n_real && (KCH == CH || c < CH);
    const int src_c = KCH == CH ? c : min(c, CH - 1);  // a mapped address even where nothing is read
    cp_async16(dst + r * row_ld(HD) + c * 8, x + (tok0 + (r < n_real ? r : 0)) * ld + col + src_c * 8, real);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two 8 x 8 matrices, transposed: lanes 0-7 address the first, 8-15 the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16) b (16 x 8), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// The A fragments (all ksteps(HD) k-steps) of rows r0..r0+15 of one head of
// x, read straight from global memory (x is read once per tile); rows at or
// past S are zero, and so are the columns at or past HD of a padded last
// k-step (its upper 8 columns at HD = 104), which are never read.
template <int HD>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[ksteps(HD)][4], const bf16* __restrict__ x,
                                            long long ld, long long tok0, long long col, int r0, int S) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool ok0 = r0 + g < S, ok1 = r0 + g + 8 < S;
  const bf16* x0 = x + (tok0 + (ok0 ? r0 + g : 0)) * ld + col + 2 * t;
  const bf16* x1 = x + (tok0 + (ok1 ? r0 + g + 8 : 0)) * ld + col + 2 * t;
#pragma unroll
  for (int ks = 0; ks < ksteps(HD); ++ks) {
    const bool hi = ks * 16 + 8 < HD;  // the k-step's upper 8 columns lie in the head
    a[ks][0] = ok0 ? ld32(x0 + ks * 16) : 0u;
    a[ks][1] = ok1 ? ld32(x1 + ks * 16) : 0u;
    a[ks][2] = ok0 && hi ? ld32(x0 + ks * 16 + 8) : 0u;
    a[ks][3] = ok1 && hi ? ld32(x1 + ks * 16 + 8) : 0u;
  }
}

// The A fragments (all k-steps) of rows r0..r0+15 of a shared tile of
// stride row_ld(HD). A padded last k-step reads the rows' columns
// HD..kdim(HD)-1, which must hold zeros: stage_rows writes them so (B5's Q
// and G rows); B8 builds its q rows at head dims that 16 divides only.
template <int HD>
__device__ __forceinline__ void ldsm_a_rows(uint32_t (&a)[ksteps(HD)][4], const bf16* s, int r0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_ld(HD) + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < ksteps(HD); ++ks) ldmatrix_x4(a[ks], p + ks * 16);
}

// c0, c1 = a . x^T over the head dim for the two 8-row n-tiles of shared
// rows j0..j0+15 of x (x as the B operand: keys or value rows as columns).
// THE one order in which every logit and every dp is formed: both
// accumulators from zero, k-steps 0..ksteps(HD)-1 (a padded last k-step
// multiplies zeros in both operands' columns past HD).
template <int HD>
__device__ __forceinline__ void tile_dot(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[ksteps(HD)][4],
                                         const bf16* xs, int j0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = xs + (j0 + (lane & 7) + ((lane >> 4) << 3)) * row_ld(HD) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int e = 0; e < 4; ++e) c0[e] = c1[e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < ksteps(HD); ++ks) {
    uint32_t b[4];
    ldmatrix_x4(b, p + ks * 16);
    mma_bf16(c0, a[ks], b[0], b[1]);
    mma_bf16(c1, a[ks], b[2], b[3]);
  }
}

// The same product with x's fragments already in registers (b[n][ks] for
// n-tile n, as loaded by load_b_cols): the same instructions in the same
// order as tile_dot, so the same bits. B5's column pass.
template <int HD>
__device__ __forceinline__ void tile_dot_regs(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[ksteps(HD)][4],
                                              const uint32_t (&b)[2][ksteps(HD)][2]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c0[e] = c1[e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < ksteps(HD); ++ks) {
    mma_bf16(c0, a[ks], b[0][ks][0], b[0][ks][1]);
    mma_bf16(c1, a[ks], b[1][ks][0], b[1][ks][1]);
  }
}

// B fragments of rows j0..j0+15 of one head of x as the columns of a . x^T,
// straight from global memory; rows at or past n_real are zero, and so are
// the columns at or past HD of a padded last k-step (never read: in the
// packed layout they are the next head's), as load_a_rows has them.
template <int HD>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[2][ksteps(HD)][2], const bf16* __restrict__ x,
                                            long long ld, long long tok0, long long col, int j0, int n_real) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const bool ok = j0 + n * 8 + g < n_real;
    const bf16* xr = x + (tok0 + (ok ? j0 + n * 8 + g : 0)) * ld + col + 2 * t;
#pragma unroll
    for (int ks = 0; ks < ksteps(HD); ++ks) {
      const bool hi = ks * 16 + 8 < HD;  // the k-step's upper 8 columns lie in the head
      b[n][ks][0] = ok ? ld32(xr + ks * 16) : 0u;
      b[n][ks][1] = ok && hi ? ld32(xr + ks * 16 + 8) : 0u;
    }
  }
}

// acc[2dp], acc[2dp+1] += a (16 x 16 over shared rows j0..j0+15 of x) .
// x[j0..j0+15, dims]: x as the B operand with its rows as the contraction.
// The HD / 8 output n-tiles go two to an ldmatrix.x4.trans; where 16 does
// not divide HD, the last one alone (x2: lanes 0-15's addresses).
template <int HD>
__device__ __forceinline__ void tile_acc(float (&acc)[HD / 8][4], const uint32_t (&a)[4], const bf16* xs, int j0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = xs + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_ld(HD) + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + dp * 16);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
  if constexpr (HD % 16 != 0) {
    uint32_t b[2];
    ldmatrix_x2_trans(b, p + HD / 16 * 16);
    mma_bf16(acc[HD / 8 - 1], a, b[0], b[1]);
  }
}

// One logit from its accumulator: (q . k) * sm_scale in f32, never contracted
// into a later subtraction; NEG_INF where the key is masked.
__device__ __forceinline__ float logit(float acc, float sm_scale, bool masked) {
  return masked ? kNegInf : __fmul_rn(acc, sm_scale);
}

// x / y rounded to nearest, as div.rn.f32 gives it, for a softmax's x in
// [0, 1] and sum y in [1, 2^9], with r = __frcp_rn(y) taken once per row:
// q = RN(x r) lies within an ulp of x / y, the remainder x - q y is then
// exact in one FMA, and RN(q + (x - q y) r) is the correctly rounded
// quotient (Markstein's theorem; Muller et al., Handbook of Floating-Point
// Arithmetic, 2nd ed., section 4.7). The remainder's exactness needs
// x >= 2^-100 (or x = 0): for a tiny x (div_tiny) the caller divides with
// __fdiv_rn instead, so no row pays for that path unless it holds one.
__device__ __forceinline__ float div_fast(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}
__device__ __forceinline__ bool div_tiny(float x) { return x > 0.f && x < 0x1p-100f; }
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  return div_tiny(x) ? __fdiv_rn(x, y) : div_fast(x, y, r);
}

// B5's score gradient, identical in its two passes: ds = p32 * (dp - t).
__device__ __forceinline__ float dscore(float p32, float dp, float t) { return __fmul_rn(p32, __fsub_rn(dp, t)); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The softmax of one warp tile (rows r0..r0+15) over key tiles 0..nkt-1,
// in place in s[2kt], s[2kt+1] (KT tiles of registers, the rest untouched):
//   logits (q . k) * sm_scale, NEG_INF at keys past n_keys and, under
//   causal, past the row -- both only in the last tile, since a tile's
//   rows start at a multiple of 16; the rows' max over all their keys
//   (mx[0] for row g, mx[1] for row g+8); e = exp(l - max) and the rows'
//   f32 sums; with NORM, p = e / sum (the IEEE quotient).
// FULL: nkt == KT, so no tile is guarded and the compiler sees one block.
template <int HD, int KT, bool FULL, bool NORM>
__device__ __forceinline__ void tile_softmax(float (&s)[2 * KT][4], float (&mx)[2], float (&sum)[2],
                                             const uint32_t (&qa)[ksteps(HD)][4], const bf16* ks, int nkt,
                                             int r0, int n_keys, bool causal, float sm_scale) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  mx[0] = mx[1] = kNegInf;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (FULL || kt < nkt) {
      tile_dot<HD>(s[2 * kt], s[2 * kt + 1], qa, ks, kt * 16);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * kt + n][e] = logit(s[2 * kt + n][e], sm_scale, false);
      if (FULL ? kt == KT - 1 : kt == nkt - 1) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kt * 16 + n * 8 + 2 * t + (e & 1), r = r0 + g + (e >> 1) * 8;
            if (j >= n_keys || (causal && j > r)) s[2 * kt + n][e] = kNegInf;
          }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[2 * kt + n][e]);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  bool tiny = false;
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt)
    if (FULL || nt < 2 * nkt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(__fsub_rn(s[nt][e], mx[e >> 1]));
        s[nt][e] = x;
        sum[e >> 1] += x;
        tiny |= div_tiny(x);
      }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  if constexpr (NORM) {
    if (!tiny) {
      const float rcp[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt)
        if (FULL || nt < 2 * nkt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = div_fast(s[nt][e], sum[e >> 1], rcp[e >> 1]);
    } else {
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt)
        if (FULL || nt < 2 * nkt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = __fdiv_rn(s[nt][e], sum[e >> 1]);
    }
  }
}

// PV of one warp tile (rows r0..r0+15) from p in s, key tiles 0..nkt-1 of
// V in shared memory: the main block's tiles (below kt_split) into one f32
// accumulator, the split tail's into another, added main + tail; then the
// grouped route's 1/sum, bf16 rounding and the rows below S stored, columns
// 0..HD-1 of the head only.
template <int HD, bool NORM_P, int KT>
__device__ __forceinline__ void tile_pv_store(const float (&s)[2 * KT][4], const float (&sum)[2], const bf16* vs,
                                              bf16* __restrict__ o, long long o_ld, long long tok0, long long col,
                                              int r0, int S, int nkt, int kt_split) {
  constexpr int DT = HD / 8;  // 8-wide n-tiles of the output
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  const int kt_main = min(nkt, kt_split);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < kt_main) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]), pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
      tile_acc<HD>(acc, pa, vs, kt * 16);
    }
  }
  if (kt_main < nkt) {  // the split kernels' tail block, summed on its own
    float tl[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) tl[d][0] = tl[d][1] = tl[d][2] = tl[d][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt >= kt_main && kt < nkt) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]), pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                                pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
        tile_acc<HD>(tl, pa, vs, kt * 16);
      }
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = __fadd_rn(acc[d][e], tl[d][e]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
    if (r < S) {
      const float f = NORM_P ? 1.f : 1.0f / sum[half];  // the grouped kernel's factor on the accumulator
      bf16* orow = o + (tok0 + r) * o_ld + col + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float x0 = acc[d][2 * half], x1 = acc[d][2 * half + 1];
        *reinterpret_cast<uint32_t*>(orow + d * 8) = NORM_P ? pack_bf16(x0, x1) : pack_bf16(x0 * f, x1 * f);
      }
    }
  }
}

}  // namespace attn_tc

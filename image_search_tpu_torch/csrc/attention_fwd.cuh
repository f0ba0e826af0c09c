// The attention forward kernel (B1, B1p, B6, B7: attention.cu describes the
// function and the design), as a template on the head dim. attention.cu
// builds HD = 64 and dispatches on the head dim; attention_fwd_hd32.cu,
// attention_fwd_hd80.cu and attention_fwd_hd104.cu each build one more head
// dim, so that nvcc compiles the four sets of unrolled kernels in parallel
// processes.
#pragma once

#include "attention_tc.cuh"

namespace attn_fwd {

using namespace attn_tc;

// NORM_P false: the grouped kernel's rounding (bf16(e), accumulator * 1/sum);
// true: the packed and split kernels' (bf16(e / sum), accumulator as is).
// Rows 0..S-1 of q and o are computed; keys 0..n_keys-1 of k and v take part
// (n_keys <= S, at most 16 * KT), summed as [0, s_main) then [s_main, n_keys).
template <int HD, bool NORM_P, int KT>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                bf16* __restrict__ o, int S, int n_keys, int s_main,
                long long q_ld, long long k_ld, long long v_ld, long long o_ld, int causal,
                float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int n_tiles = (S + kTileRows - 1) / kTileRows;
  int tile0, tile1;
  cta_tiles(blockIdx.x, gridDim.x, n_tiles, tile0, tile1);
  const int n_stage = causal ? min(min(tile1 * kTileRows, S), n_keys) : n_keys;  // keys any row here sees
  const int rows = ceil16(n_stage);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + (size_t)ceil16(n_keys) * row_ld(HD);
  const long long tok0 = (long long)b * S, col = (long long)h * HD;

  stage_rows<HD>(ks, k, k_ld, tok0, col, n_stage, rows);
  cp_async_commit();
  stage_rows<HD>(vs, v, v_ld, tok0, col, n_stage, rows);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int kt_split = s_main < n_keys ? s_main / 16 : KT;  // first tail key tile
  float s[2 * KT][4];
  float mx[2], sum[2];
  // every warp runs the same number of rounds, so the barrier of the first is uniform
  const int rounds = (tile1 - tile0 + kWarps - 1) / kWarps;
  cp_async_wait<1>();  // K has landed
  __syncthreads();
  for (int round = 0; round < rounds; ++round) {
    const int tile = tile0 + warp + round * kWarps, r0 = tile * kTileRows;
    const int nkt = (min(causal ? min(r0 + kTileRows, S) : S, n_keys) + 15) / 16;
    if (tile < tile1) {
      uint32_t qa[ksteps(HD)][4];
      load_a_rows<HD>(qa, q, q_ld, tok0, col, r0, S);
      if (nkt == KT)
        tile_softmax<HD, KT, true, NORM_P>(s, mx, sum, qa, ks, nkt, r0, n_keys, causal != 0, sm_scale);
      else
        tile_softmax<HD, KT, false, NORM_P>(s, mx, sum, qa, ks, nkt, r0, n_keys, causal != 0, sm_scale);
    }
    if (round == 0) {
      cp_async_wait<0>();  // V has landed
      __syncthreads();
    }
    if (tile < tile1) tile_pv_store<HD, NORM_P, KT>(s, sum, vs, o, o_ld, tok0, col, r0, S, nkt, kt_split);
  }
}

inline size_t smem_bytes(int n_keys, int hd) { return 2 * (size_t)ceil16(n_keys) * row_ld(hd) * sizeof(bf16); }

template <int HD, bool NORM_P, int KT>
cudaError_t launch_kt(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                      long long q_ld, long long k_ld, long long v_ld, long long o_ld, int n_keys, int s_main,
                      int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_keys, HD);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<HD, NORM_P, KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ctas_for((S + kTileRows - 1) / kTileRows), H, B);
  attn_fwd_kernel<HD, NORM_P, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, n_keys, s_main, q_ld, k_ld, v_ld, o_ld, causal, sm_scale);
  return cudaGetLastError();
}

// ---- The long-key forward: n_keys past the 16 * kMaxKeyTiles that a warp
// holds in registers (OpenCLIP ViT-H/14 at 378 px: 730 tokens) ----
//
// The same function as attn_fwd_kernel, for the grouped and packed kernels
// (s_main == n_keys: no split tail), with its keys streamed: a CTA of 4 or
// 8 warps, one 16-row query tile each (B1's tile and mma.sync fragments,
// the q fragments loaded once from global memory), walks its head's keys in
// blocks of kLongKeys = 64, K and V staged by cp.async into a ring of
// kLongStages shared buffers, so blocks j + 1 .. land while block j is
// multiplied (one barrier a block: the block staged after it goes into the
// buffer every warp has finished with). A warp skips
// the blocks (and 16-key tiles) past its rows' last visible key. The row
// statistics are online, in f32: per block the logits (tile_dot, so each
// logit is formed as the short kernels form it), the block's row max m_j,
// the running max m = max(m, m_j), alpha = exp(m_old - m), and each lane's
// part of the sum rescaled by alpha before the block's exps are added (the
// four lanes of a row combine once, at the end). exp(x) is long_exp: the
// SFU's ex2 of x * log2(e) (__expf, within 2 ulp of expf, a fraction of its
// instructions: 2.83 -> 2.70 ms at B=160 S=730 H=16 Hd=80 on an H100 SXM).
//   NORM_P false (B1): one pass. e = exp(l - m) against the running max,
//     rounded to bf16 for P.V; the f32 accumulator is rescaled by alpha at
//     each block where a row's max moved (a multiply by 1 is skipped); at
//     the end accumulator * (1 / sum), as the short kernel.
//   NORM_P true (B1p, B7): p = e / sum needs the row's whole sum before any
//     P.V, so a first pass stages K alone for the max and the sum; the
//     second recomputes each logit (the same bits), divides exp(l - max) by
//     the sum (div_rn), rounds to bf16 and accumulates P.V unscaled.
// Departures from the short kernels' rounding: B1's e is rounded against
// the running max, not the row's final max (the factor alpha then lands on
// the f32 accumulator); both modes' sums are rescaled partial sums. The
// plain versions in ops/attention.py follow these points
// (attention_long_reference).
// What bounds it: operations. At B=160 S=730 H=16 Hd=80 the function's
// 437 GFLOP take 0.441 ms at the bf16 peak (its 1.2 GB of q, k, v and out
// 0.357 ms at 3.35 TB/s). Per block a warp issues 80 mma.sync against ~32
// exps, rescales and bf16 packs a lane, so the CUDA cores' softmax and the
// mma.sync rate (below wgmma's) hold it at ~16% of the bound; B1p and B7
// run the logits and exps twice (~8%).
// The grid: ceil(tiles / warps) CTAs along each (head, batch row), the last
// one with idle warps where the tiles do not divide; 8 warps (two tiles of
// a head share each staged block) unless that leaves fewer than two CTAs an
// SM, as at B = 1, where 4 warps double the CTAs.
constexpr int kLongKeys = 64;     // keys a staged block
constexpr int kLongStages = 2;    // staged blocks of K (and V) in flight
constexpr int kLongWarpsMax = 8;  // warps a CTA at most (each one 16-row query tile)

__host__ __device__ constexpr int long_block_elems(int hd) { return kLongKeys * row_ld(hd); }

__device__ __forceinline__ float long_exp(float x) { return __expf(x); }

// The ring of K blocks and the ring of V blocks.
inline size_t long_smem_bytes(int hd) { return 2 * kLongStages * (size_t)long_block_elems(hd) * sizeof(bf16); }

// Keys [j0, j0 + kLongKeys) of one head of x into a shared block, zero at
// or past n_real and in the padded columns HD..kdim(HD)-1 (as stage_rows,
// with the CTA's own thread count).
template <int HD>
__device__ __forceinline__ void stage_key_block(bf16* dst, const bf16* __restrict__ x, long long ld,
                                                long long tok0, long long col, int j0, int n_real) {
  constexpr int CH = HD / 8, KCH = kdim(HD) / 8;
  for (int i = threadIdx.x; i < kLongKeys * KCH; i += blockDim.x) {
    const int r = i / KCH, c = i % KCH, j = j0 + r;
    const bool real = j < n_real && (KCH == CH || c < CH);
    const int src_c = KCH == CH ? c : min(c, CH - 1);
    cp_async16(dst + r * row_ld(HD) + c * 8, x + (tok0 + (j < n_real ? j : 0)) * ld + col + src_c * 8, real);
  }
}

// The logits of one warp tile (rows r0..r0+15) against the staged block of
// keys j0..: key tiles 0..nkt-1 into s, NEG_INF past n_keys and, under
// causal, past the row.
template <int HD>
__device__ __forceinline__ void block_logits(float (&s)[2 * kLongKeys / 16][4], const uint32_t (&qa)[ksteps(HD)][4],
                                             const bf16* kb, int nkt, int j0, int r0, int n_keys, bool causal,
                                             float sm_scale) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool edge = j0 + kLongKeys > n_keys || (causal && j0 + kLongKeys > r0 + 1);
#pragma unroll
  for (int kt = 0; kt < kLongKeys / 16; ++kt) {
    if (kt < nkt) {
      tile_dot<HD>(s[2 * kt], s[2 * kt + 1], qa, kb, kt * 16);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + kt * 16 + n * 8 + 2 * t + (e & 1), r = r0 + g + (e >> 1) * 8;
          s[2 * kt + n][e] = logit(s[2 * kt + n][e], sm_scale, edge && (j >= n_keys || (causal && j > r)));
        }
    }
  }
}

// The rows' running max and their lanes' parts of the sum over one block
// (key tiles 0..nkt-1 of s): m = max(m, the block's max), the sum rescaled
// by alpha = exp(m_old - m), then e = exp(l - m) added; s becomes e.
// Returns alpha (per row half) for the accumulator.
template <int NT>
__device__ __forceinline__ void online_stats(float (&s)[NT][4], int nkt, float (&mx)[2], float (&sum)[2],
                                             float (&alpha)[2]) {
  float bm[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < 2 * nkt)
#pragma unroll
      for (int e = 0; e < 4; ++e) bm[e >> 1] = fmaxf(bm[e >> 1], s[nt][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = fmaxf(mx[h], quad_max(bm[h]));
    alpha[h] = long_exp(__fsub_rn(mx[h], m));
    sum[h] = __fmul_rn(sum[h], alpha[h]);
    mx[h] = m;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < 2 * nkt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = long_exp(__fsub_rn(s[nt][e], mx[e >> 1]));
        s[nt][e] = x;
        sum[e >> 1] += x;
      }
}

// acc += bf16(p) V over key tiles 0..nkt-1 of the staged V block.
template <int HD, int NT>
__device__ __forceinline__ void block_pv(float (&acc)[HD / 8][4], const float (&s)[NT][4], const bf16* vb, int nkt) {
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
    if (kt < nkt) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]), pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
      tile_acc<HD>(acc, pa, vb, kt * 16);
    }
  }
}

template <int HD, bool NORM_P>
__global__ void __launch_bounds__(kLongWarpsMax * 32, 2)
attn_fwd_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     bf16* __restrict__ o, int S, int n_keys, long long q_ld, long long k_ld, long long v_ld,
                     long long o_ld, int causal, float sm_scale) {
  constexpr int NT = 2 * kLongKeys / 16;  // 8-key n-tiles of a block
  constexpr int BLK = long_block_elems(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kLongStages][BLK]
  bf16* vs = ks + kLongStages * BLK;             // [kLongStages][BLK]
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (blockIdx.x * warps + warp) * kTileRows;
  const int cta_end = min((blockIdx.x + 1) * warps * kTileRows, S);
  const int n_cta = causal ? min(cta_end, n_keys) : n_keys;  // keys any row of the CTA sees
  // keys this warp's rows see (0 for a warp past the last tile)
  const int n_warp = r0 >= S ? 0 : causal ? min(min(r0 + kTileRows, S), n_keys) : n_keys;
  const int nb = (n_cta + kLongKeys - 1) / kLongKeys;
  const long long tok0 = (long long)b * S, col = (long long)h * HD;

  uint32_t qa[ksteps(HD)][4];
  if (n_warp > 0) load_a_rows<HD>(qa, q, q_ld, tok0, col, r0, S);
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f}, alpha[2];
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float s[NT][4];

  // pass 0 (NORM_P only): K alone, for the rows' max and sum; then the
  // output pass over K and V
#pragma unroll 1
  for (int pass = NORM_P ? 0 : 1; pass < 2; ++pass) {
    const bool with_v = pass == 1;
    auto issue = [&](int blk) {  // one commit group a block; an empty one past the last keeps the count
      const int buf = blk % kLongStages;
      if (blk < nb) {
        stage_key_block<HD>(ks + buf * BLK, k, k_ld, tok0, col, blk * kLongKeys, n_cta);
        if (with_v) stage_key_block<HD>(vs + buf * BLK, v, v_ld, tok0, col, blk * kLongKeys, n_cta);
      }
      cp_async_commit();
    };
    float rcp[2] = {0.f, 0.f};
    if (NORM_P && with_v) {
      sum[0] = quad_sum(sum[0]);
      sum[1] = quad_sum(sum[1]);
      rcp[0] = __frcp_rn(sum[0]);
      rcp[1] = __frcp_rn(sum[1]);
    }
#pragma unroll
    for (int i = 0; i < kLongStages - 1; ++i) issue(i);
#pragma unroll 1
    for (int blk = 0; blk < nb; ++blk) {
      cp_async_wait<kLongStages - 2>();  // block blk has landed
      __syncthreads();                   // ... for every thread, and every warp is done with block blk - 1
      issue(blk + kLongStages - 1);      // into block blk - 1's buffer
      const int j0 = blk * kLongKeys;
      if (j0 < n_warp) {
        const int nkt = min(kLongKeys / 16, (n_warp - j0 + 15) / 16);
        const bf16* kb = ks + (blk % kLongStages) * BLK;
        block_logits<HD>(s, qa, kb, nkt, j0, r0, n_keys, causal != 0, sm_scale);
        if (!NORM_P || !with_v) online_stats<NT>(s, nkt, mx, sum, alpha);
        if (with_v) {
          if (NORM_P) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              if (nt < 2 * nkt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  s[nt][e] = div_rn(long_exp(__fsub_rn(s[nt][e], mx[e >> 1])), sum[e >> 1], rcp[e >> 1]);
          } else if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
            for (int d = 0; d < HD / 8; ++d)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[d][e] = __fmul_rn(acc[d][e], alpha[e >> 1]);
          }
          block_pv<HD, NT>(acc, s, vs + (blk % kLongStages) * BLK, nkt);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass stages into every buffer
  }
  if (n_warp == 0) return;
  if (!NORM_P) {
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
  }
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
    if (r < S) {
      const float f = NORM_P ? 1.f : 1.0f / sum[half];
      bf16* orow = o + (tok0 + r) * o_ld + col + 2 * t;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const float x0 = acc[d][2 * half], x1 = acc[d][2 * half + 1];
        *reinterpret_cast<uint32_t*>(orow + d * 8) = NORM_P ? pack_bf16(x0, x1) : pack_bf16(x0 * f, x1 * f);
      }
    }
  }
}

inline int device_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      sms = n;
  }
  return sms > 0 ? sms : 132;
}

template <int HD, bool NORM_P>
cudaError_t launch_long(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                        long long q_ld, long long k_ld, long long v_ld, long long o_ld, int n_keys, int causal,
                        float sm_scale, cudaStream_t stream) {
  const size_t smem = long_smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_long_kernel<HD, NORM_P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (S + kTileRows - 1) / kTileRows;
  int warps = kLongWarpsMax;
  if ((long long)B * H * ((n_tiles + warps - 1) / warps) < 2LL * device_sms()) warps = kWarps;
  const dim3 grid((n_tiles + warps - 1) / warps, H, B);
  attn_fwd_long_kernel<HD, NORM_P><<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, n_keys, q_ld, k_ld, v_ld, o_ld, causal, sm_scale);
  return cudaGetLastError();
}

// Dynamic shared memory for n_keys keys at head dim hd, on either path.
inline size_t fwd_smem_bytes(int n_keys, int hd) {
  return key_tiles_for(n_keys) ? smem_bytes(n_keys, hd) : long_smem_bytes(hd);
}

// One head dim's kernels, the register budget picked by the key count, and
// past kMaxKeyTiles tiles the long-key kernel (which takes no split tail:
// the caller has checked s_main == n_keys there, and every other argument).
template <int HD, bool NORM_P>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              long long q_ld, long long k_ld, long long v_ld, long long o_ld,
              int n_keys, int s_main, int causal, float sm_scale, cudaStream_t st) {
#define ISX_LAUNCH(KT)                                                                                       \
  case KT:                                                                                                   \
    return (int)launch_kt<HD, NORM_P, KT>(q, k, v, o, B, S, H, q_ld, k_ld, v_ld, o_ld, n_keys, s_main, causal, \
                                          sm_scale, st);
  if (key_tiles_for(n_keys) == 0)
    return (int)launch_long<HD, NORM_P>(q, k, v, o, B, S, H, q_ld, k_ld, v_ld, o_ld, n_keys, causal, sm_scale, st);
  switch (key_tiles_for(n_keys)) {
    ISX_LAUNCH(5)
    ISX_LAUNCH(9)
    ISX_LAUNCH(17)
    ISX_LAUNCH(kMaxKeyTiles)
  }
#undef ISX_LAUNCH
  return (int)cudaErrorInvalidValue;
}

#define ISX_ATTN_FWD_HD(EXTERN, HD)                                                                        \
  EXTERN template int launch_hd<HD, false>(const void*, const void*, const void*, void*, int, int, int,    \
                                           long long, long long, long long, long long, int, int, int, float, \
                                           cudaStream_t);                                                  \
  EXTERN template int launch_hd<HD, true>(const void*, const void*, const void*, void*, int, int, int,     \
                                          long long, long long, long long, long long, int, int, int, float,  \
                                          cudaStream_t);

}  // namespace attn_fwd

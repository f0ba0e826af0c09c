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

// One head dim's kernels, the register budget picked by the key count
// (arguments already checked by the caller).
template <int HD, bool NORM_P>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              long long q_ld, long long k_ld, long long v_ld, long long o_ld,
              int n_keys, int s_main, int causal, float sm_scale, cudaStream_t st) {
#define ISX_LAUNCH(KT)                                                                                       \
  case KT:                                                                                                   \
    return (int)launch_kt<HD, NORM_P, KT>(q, k, v, o, B, S, H, q_ld, k_ld, v_ld, o_ld, n_keys, s_main, causal, \
                                          sm_scale, st);
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

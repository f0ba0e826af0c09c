// The attention backward kernels (B5: attention_bwd.cu describes the
// function and the design), as templates on the head dim. attention_bwd.cu
// builds HD = 64 and dispatches on the head dim; attention_bwd_hd32.cu,
// attention_bwd_hd80.cu and attention_bwd_hd104.cu each build one more head
// dim, so that nvcc compiles the four sets of unrolled kernels in parallel
// processes.
#pragma once

#include "attention_tc.cuh"

namespace attn_bwd {

using namespace attn_tc;

constexpr int kTrLd = 24;  // transposition tile row (bf16): conflict-free ldmatrix and 32-bit stores

// p32 and ds of one (query row, key) into the probe maps [2, B, H, S, S].
__device__ __forceinline__ void probe_put(float* probe, int b, int h, int B, int H, int S, int i, int j,
                                          float p32, float ds) {
  const size_t at = (((size_t)b * H + h) * S + i) * S + j;
  probe[at] = p32;
  probe[(size_t)B * H * S * S + at] = ds;
}

// The row pass's gradients for one warp tile (rows r0..r0+15), p32 in s:
// t = sum dp * p32, then dp again (the same instructions), ds, dsb rounded to
// bf16 as the A fragment of dq += dsb K; dq and the rows' (max, sum, t)
// stored. FULL: nkt == KT, no tile guarded.
template <int HD, int KT, bool FULL, bool PROBE>
__device__ __forceinline__ void row_grads(const float (&s)[2 * KT][4], const float (&mx)[2], const float (&sum)[2],
                                          const bf16* __restrict__ g, long long g_ld, const bf16* ks, const bf16* vs,
                                          bf16* __restrict__ dq, float* __restrict__ stats, float* __restrict__ probe,
                                          long long tok0, long long col, int b, int h, int B, int H, int S, int r0,
                                          int nkt, bool causal, float sm_scale) {
  constexpr int DT = HD / 8;
  const int gi = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  uint32_t ga[ksteps(HD)][4];
  load_a_rows<HD>(ga, g, g_ld, tok0, col, r0, S);
  float tr[2] = {0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (FULL || kt < nkt) {
      float d[2][4];
      tile_dot<HD>(d[0], d[1], ga, vs, kt * 16);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tr[e >> 1] += d[n][e] * s[2 * kt + n][e];
    }
  }
  tr[0] = quad_sum(tr[0]);
  tr[1] = quad_sum(tr[1]);
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (FULL || kt < nkt) {
      float d[2][4], sb[2][4];
      tile_dot<HD>(d[0], d[1], ga, vs, kt * 16);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds = dscore(s[2 * kt + n][e], d[n][e], tr[e >> 1]);
          sb[n][e] = __fmul_rn(ds, sm_scale);
          if constexpr (PROBE) {
            const int i = r0 + gi + (e >> 1) * 8, j = kt * 16 + n * 8 + 2 * t4 + (e & 1);
            if (i < S && j < S && !(causal && j > i)) probe_put(probe, b, h, B, H, S, i, j, s[2 * kt + n][e], ds);
          }
        }
      const uint32_t da[4] = {pack_bf16(sb[0][0], sb[0][1]), pack_bf16(sb[0][2], sb[0][3]),
                              pack_bf16(sb[1][0], sb[1][1]), pack_bf16(sb[1][2], sb[1][3])};
      tile_acc<HD>(acc, da, ks, kt * 16);
    }
  }
  const long long out_ld = (long long)H * HD;
  const size_t bhs = (size_t)B * H * S;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + gi + half * 8;
    if (r < S) {
      bf16* row = dq + (tok0 + r) * out_ld + col + 2 * t4;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<uint32_t*>(row + d * 8) = pack_bf16(acc[d][2 * half], acc[d][2 * half + 1]);
      if (t4 == 0) {
        const size_t si = ((size_t)b * H + h) * S + r;
        stats[si] = mx[half];
        stats[bhs + si] = sum[half];
        stats[2 * bhs + si] = tr[half];
      }
    }
  }
}

template <int HD, int KT, bool PROBE>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ g, bf16* __restrict__ dq, float* __restrict__ stats,
                     float* __restrict__ probe, int S, int H, long long q_ld, long long k_ld, long long v_ld,
                     long long g_ld, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y, B = gridDim.z;
  const int n_tiles = (S + kTileRows - 1) / kTileRows;
  int tile0, tile1;
  cta_tiles(blockIdx.x, gridDim.x, n_tiles, tile0, tile1);
  const int n_stage = causal ? min(tile1 * kTileRows, S) : S;  // keys any row of this CTA sees
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + (size_t)ceil16(S) * row_ld(HD);
  const long long tok0 = (long long)b * S, col = (long long)h * HD;

  stage_rows<HD>(ks, k, k_ld, tok0, col, n_stage, ceil16(n_stage));
  cp_async_commit();
  stage_rows<HD>(vs, v, v_ld, tok0, col, n_stage, ceil16(n_stage));
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  float s[2 * KT][4];  // logits, then p32
  float mx[2], sum[2];
  // every warp runs the same number of rounds, so the barrier of the first is uniform
  const int rounds = (tile1 - tile0 + kWarps - 1) / kWarps;
  cp_async_wait<1>();  // K has landed
  __syncthreads();
  for (int round = 0; round < rounds; ++round) {
    const int tile = tile0 + warp + round * kWarps, r0 = tile * kTileRows;
    const int nkt = ((causal ? min(r0 + kTileRows, S) : S) + 15) / 16;
    if (tile < tile1) {
      uint32_t qa[ksteps(HD)][4];
      load_a_rows<HD>(qa, q, q_ld, tok0, col, r0, S);
      if (nkt == KT)
        tile_softmax<HD, KT, true, true>(s, mx, sum, qa, ks, nkt, r0, S, causal != 0, sm_scale);
      else
        tile_softmax<HD, KT, false, true>(s, mx, sum, qa, ks, nkt, r0, S, causal != 0, sm_scale);
    }
    if (round == 0) {
      cp_async_wait<0>();  // V has landed
      __syncthreads();
    }
    if (tile < tile1) {
      if (nkt == KT)
        row_grads<HD, KT, true, PROBE>(s, mx, sum, g, g_ld, ks, vs, dq, stats, probe, tok0, col, b, h, B, H, S,
                                       r0, nkt, causal != 0, sm_scale);
      else
        row_grads<HD, KT, false, PROBE>(s, mx, sum, g, g_ld, ks, vs, dq, stats, probe, tok0, col, b, h, B, H, S,
                                        r0, nkt, causal != 0, sm_scale);
    }
  }
}

// The column pass's p32 and ds for one (16 queries x 16 keys) tile from its
// l and dp accumulators and the rows' (max, sum, t), each rounded to bf16
// pairs ([n-tile][row half]) for the transposition tile. EDGE: the tile
// holds rows past S, keys past S or the causal diagonal, so it masks.
template <bool EDGE, bool PROBE>
__device__ __forceinline__ void col_probs(const float (&l)[2][4], const float (&dp)[2][4], const float* st, int rows,
                                          int li0, int i0, int j0, int S, bool causal, float sm_scale,
                                          uint32_t (&pw)[2][2], uint32_t (&dw)[2][2], float* __restrict__ probe,
                                          int b, int h, int B, int H) {
  const int gi = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  float x[2][4];
  bool tiny = false;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + gi + hf * 8;
    const float mx = st[li0 + gi + hf * 8];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + n * 8 + 2 * t4 + c;
        const bool masked = EDGE && (j >= S || (causal && j > i));
        float e = expf(__fsub_rn(logit(l[n][2 * hf + c], sm_scale, masked), mx));
        if (EDGE && i >= S) e = 0.f;  // a row past S (its workspace entry is a stand-in)
        x[n][2 * hf + c] = e;
        tiny |= div_tiny(e);
      }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int li = li0 + gi + hf * 8, i = i0 + gi + hf * 8;
    const float sum = st[rows + li], t = st[2 * rows + li], r = __frcp_rn(sum);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p2[2], d2[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = x[n][2 * hf + c];
        const float p32 = tiny ? __fdiv_rn(e, sum) : div_fast(e, sum, r);
        const float ds = dscore(p32, dp[n][2 * hf + c], t);
        if constexpr (PROBE) {
          const int j = j0 + n * 8 + 2 * t4 + c;
          if (i < S && j < S && !(causal && j > i))
            probe_put(probe + 2 * (size_t)B * H * S * S, b, h, B, H, S, i, j, p32, ds);
        }
        p2[c] = p32;
        d2[c] = __fmul_rn(ds, sm_scale);
      }
      pw[n][hf] = pack_bf16(p2[0], p2[1]);
      dw[n][hf] = pack_bf16(d2[0], d2[1]);
    }
  }
}

template <int HD, bool PROBE>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ g, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     const float* __restrict__ stats, float* __restrict__ probe, int S, int H,
                     long long q_ld, long long k_ld, long long v_ld, long long g_ld, int causal,
                     float sm_scale) {
  constexpr int DT = HD / 8;
  constexpr int KS = ksteps(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y, B = gridDim.z;
  const int n_tiles = (S + kTileRows - 1) / kTileRows;
  int tile0, tile1;
  cta_tiles(blockIdx.x, gridDim.x, n_tiles, tile0, tile1);
  const int row_lo = causal ? tile0 * kTileRows : 0;  // first query row any key of this CTA is seen by
  const int n_rows = S - row_lo, rows = ceil16(n_rows);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + (size_t)rows * row_ld(HD);
  float* st = reinterpret_cast<float*>(gs + (size_t)rows * row_ld(HD));  // [3, rows]: max, sum, t
  bf16* tr = reinterpret_cast<bf16*>(st + 3 * rows);                      // [kWarps, 2, 16, kTrLd]
  const long long tok0 = (long long)b * S, col = (long long)h * HD;
  const long long out_ld = (long long)H * HD;
  const size_t bhs = (size_t)B * H * S;
  const size_t stat0 = ((size_t)b * H + h) * S + row_lo;

  stage_rows<HD>(qs, q, q_ld, tok0 + row_lo, col, n_rows, rows);
  stage_rows<HD>(gs, g, g_ld, tok0 + row_lo, col, n_rows, rows);
  cp_async_commit();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool real = i < n_rows;  // rows past S: stand-ins, their probabilities are forced to 0
    st[i] = real ? stats[stat0 + i] : 0.f;
    st[rows + i] = real ? stats[bhs + stat0 + i] : 1.f;
    st[2 * rows + i] = real ? stats[2 * bhs + stat0 + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, t4 = lane & 3;
  bf16* tp = tr + warp * 2 * 16 * kTrLd;  // bf16(p32) tile [16 queries][16 keys]
  bf16* td = tp + 16 * kTrLd;             // dsb tile
  // ldmatrix.trans of a [query][key] tile: the A fragment of its transpose
  const int tr_off = ((lane & 7) + (lane >> 4) * 8) * kTrLd + ((lane >> 3) & 1) * 8;

  for (int tile = tile0 + warp; tile < tile1; tile += kWarps) {
    const int j0 = tile * kTileRows;
    uint32_t kb[2][KS][2], vb[2][KS][2];
    load_b_cols<HD>(kb, k, k_ld, tok0, col, j0, S);
    load_b_cols<HD>(vb, v, v_ld, tok0, col, j0, S);
    float dva[DT][4], dka[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[d][e] = dka[d][e] = 0.f;

    for (int it = causal ? tile : 0; it < n_tiles; ++it) {
      const int i0 = it * kTileRows, li0 = i0 - row_lo;
      float l[2][4], dp[2][4];
      {
        uint32_t a[KS][4];
        ldsm_a_rows<HD>(a, qs, li0);
        tile_dot_regs<HD>(l[0], l[1], a, kb);
        ldsm_a_rows<HD>(a, gs, li0);
        tile_dot_regs<HD>(dp[0], dp[1], a, vb);
      }
      uint32_t pw[2][2], dw[2][2];  // [n-tile][row half] pairs of bf16
      if (j0 + kTileRows > S || i0 + kTileRows > S || (causal && it == tile))
        col_probs<true, PROBE>(l, dp, st, rows, li0, i0, j0, S, causal != 0, sm_scale, pw, dw, probe, b, h, B, H);
      else
        col_probs<false, PROBE>(l, dp, st, rows, li0, i0, j0, S, causal != 0, sm_scale, pw, dw, probe, b, h, B, H);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int at = (gi + hf * 8) * kTrLd + n * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(tp + at) = pw[n][hf];
          *reinterpret_cast<uint32_t*>(td + at) = dw[n][hf];
        }
      __syncwarp();
      uint32_t pa[4], da[4];
      ldmatrix_x4_trans(pa, tp + tr_off);
      ldmatrix_x4_trans(da, td + tr_off);
      tile_acc<HD>(dva, pa, gs, li0);
      tile_acc<HD>(dka, da, qs, li0);
      __syncwarp();  // the next query tile overwrites tp and td
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + gi + half * 8;
      if (j < S) {
        bf16* rv = dv + (tok0 + j) * out_ld + col + 2 * t4;
        bf16* rk = dk + (tok0 + j) * out_ld + col + 2 * t4;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          *reinterpret_cast<uint32_t*>(rv + d * 8) = pack_bf16(dva[d][2 * half], dva[d][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(rk + d * 8) = pack_bf16(dka[d][2 * half], dka[d][2 * half + 1]);
        }
      }
    }
  }
}

inline size_t rows_smem_bytes(int S, int hd) { return 2 * (size_t)ceil16(S) * row_ld(hd) * sizeof(bf16); }

inline size_t cols_smem_bytes(int S, int hd) {
  return rows_smem_bytes(S, hd) + 3 * (size_t)ceil16(S) * sizeof(float) +
         (size_t)kWarps * 2 * 16 * kTrLd * sizeof(bf16);
}

template <int HD, int KT, bool PROBE>
cudaError_t launch_kt(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq, bf16* dk, bf16* dv,
                      float* stats, float* probe, int B, int S, int H, long long q_ld, long long k_ld,
                      long long v_ld, long long g_ld, int causal, float sm_scale, cudaStream_t s) {
  const dim3 grid(ctas_for((S + kTileRows - 1) / kTileRows), H, B);
  const size_t smem_rows = rows_smem_bytes(S, HD);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_rows_kernel<HD, KT, PROBE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_rows);
  if (err != cudaSuccess) return err;
  attn_bwd_rows_kernel<HD, KT, PROBE><<<grid, kThreads, smem_rows, s>>>(
      q, k, v, g, dq, stats, probe, S, H, q_ld, k_ld, v_ld, g_ld, causal, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_cols = cols_smem_bytes(S, HD);
  err = cudaFuncSetAttribute(attn_bwd_cols_kernel<HD, PROBE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_cols);
  if (err != cudaSuccess) return err;
  attn_bwd_cols_kernel<HD, PROBE><<<grid, kThreads, smem_cols, s>>>(
      q, k, v, g, dk, dv, stats, probe, S, H, q_ld, k_ld, v_ld, g_ld, causal, sm_scale);
  return cudaGetLastError();
}

// One head dim's two passes, the register budget picked by S (arguments
// already checked by the caller). The probe is for tests: one
// instantiation, every S the kernel takes.
template <int HD, bool PROBE>
int launch_hd(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq, bf16* dk, bf16* dv,
              float* stats, float* probe, int B, int S, int H, long long q_ld, long long k_ld, long long v_ld,
              long long g_ld, int causal, float sm_scale, cudaStream_t s) {
  if constexpr (PROBE) {
    return (int)launch_kt<HD, kMaxKeyTiles, true>(q, k, v, g, dq, dk, dv, stats, probe, B, S, H, q_ld, k_ld,
                                                  v_ld, g_ld, causal, sm_scale, s);
  } else {
#define ISX_LAUNCH(KT)                                                                                      \
  case KT:                                                                                                  \
    return (int)launch_kt<HD, KT, false>(q, k, v, g, dq, dk, dv, stats, probe, B, S, H, q_ld, k_ld, v_ld,   \
                                         g_ld, causal, sm_scale, s);
    switch (key_tiles_for(S)) {
      ISX_LAUNCH(5)
      ISX_LAUNCH(9)
      ISX_LAUNCH(17)
      ISX_LAUNCH(kMaxKeyTiles)
    }
#undef ISX_LAUNCH
    return (int)cudaErrorInvalidValue;
  }
}

#define ISX_ATTN_BWD_HD(EXTERN, HD)                                                                          \
  EXTERN template int launch_hd<HD, false>(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, bf16*,   \
                                           bf16*, float*, float*, int, int, int, long long, long long,         \
                                           long long, long long, int, float, cudaStream_t);                    \
  EXTERN template int launch_hd<HD, true>(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, bf16*,    \
                                          bf16*, float*, float*, int, int, int, long long, long long,          \
                                          long long, long long, int, float, cudaStream_t);

}  // namespace attn_bwd

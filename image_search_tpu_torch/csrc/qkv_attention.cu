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
// Design: one CTA of 8 warps per (head, batch row), the heads of a batch row
// side by side (x[b] is read from device memory once, then from L2).
//   Phase 1 projects the S rows of x (padded to R = 16 * ceil(S / 16)) against
//   the head's 192 rows of w (64 each of q, k and v) in two column chunks of
//   96, each over all R rows. Thread 0 feeds a ring of 3 stages by TMA (a
//   step is 32 of D: the x tile in two boxes of R / 2 rows, whose tensor
//   map's S bound zero-fills the rows past S, and the chunk's w rows in three
//   boxes of 32), each stage completing on its mbarrier; TMA swizzles the
//   64-byte rows so the 8 rows of an ldmatrix phase fall on distinct banks.
//   One barrier a step frees the stage two steps back; the ring runs on
//   across the chunk boundary. Warps are 4 (rows) x 2 (48 columns): warp
//   group m takes the m16 tiles m, m + 4, ..., ceil(R / 64) of them, a warp
//   whose group has fewer repeating the last tile unstored, so S = 257 (17
//   tiles) costs 3 idle tile slots of 20, not a chunk of 64 rows, and every
//   warp issues one unguarded block a step: all its ldmatrix loads, then its
//   mma.sync.m16n8k16 bf16 tiles back to back (f32 accumulators, at most
//   5 x 6 tiles, 120 registers). Each chunk's epilogue rounds, adds the bias
//   and writes q, k and v into shared memory in attention_tc.cuh's row
//   layout (row_ld(64) = 72 bf16), rows past S holding the bias alone
//   (finite: p is 0 there, and 0 * v stays 0).
//   Phase 2 is B7's attention body over those buffers (attention_tc.cuh:
//   tile_softmax<.., NORM = true> and tile_pv_store, the same instructions
//   in the same order as csrc/attention.cu's normalised route), one 16-row
//   query tile a warp at a time, q fragments by ldmatrix from the q buffer:
//   on the same qkv the output is B7's, bit for bit.
// isx_qkv_attention_probe runs phase 1 alone and writes the head's q, k and
// v rows to a [B, S, 3D] buffer, for the card test (B8 against B7 on it) and
// for chip_smoke.py's split of B8's time.
//
// What bounds it: operations. At ViT-L/14 (B = 160, S = 257, D = 1024, 16
// heads) the projection is 2*B*S*D*3D = 259 GFLOP and attention 43 GFLOP,
// against ~0.17 GB of x, w, b and out. Registers bound the CTA: phase 2 holds
// a row's logits in registers (255 a thread at 17 key tiles), so 8 warps fill
// an SM and phases 1 and 2 of one CTA do not overlap. x is read twice per
// CTA and w once, from L2; mma.sync reaches a fraction of the tensor cores'
// wgmma rate. The copies go by TMA because copies issued by the warps
// themselves (cp.async, 16 bytes a thread) cost them as much time as the
// MMAs and did not overlap them (PERF.md, section 6).
#include "attention_tc.cuh"
#include "sm90.cuh"

namespace {

using namespace attn_tc;

constexpr int kHd = 64;
constexpr int kCtaWarps = 8;
constexpr int kCtaThreads = kCtaWarps * 32;
constexpr int kBK = 32;         // projection k step (bf16): 64-byte staging rows
constexpr int kNC = 96;         // projection columns per chunk: two chunks cover q | k | v
constexpr int kStages = 3;
constexpr int kMaxRowGroups = 5;  // m16 tiles a warp group takes at most: S <= 320 = 4 x 5 x 16

// m16 tiles a warp group takes when a row has KT key tiles (ceil(S / 16) <= KT).
__host__ __device__ constexpr int row_tiles_for(int kt) { return (kt + 3) / 4; }

// Element offset of 16-byte chunk c (0..3) of staging row r.
__device__ __forceinline__ int swz(int r, int c) { return r * kBK + ((c ^ ((r >> 1) & 3)) << 3); }

__host__ __device__ inline int rows_for(int S) { return (S + 15) / 16 * 16; }

// Shared memory: the ring (1024-aligned: TMA's 64-byte swizzle is a function
// of the address, and swz() assumes 512-byte atoms from the stage's start),
// then q, k, v, then one mbarrier a stage.
__host__ __device__ inline size_t ring_bytes(int S) { return (size_t)kStages * (rows_for(S) + kNC) * kBK * sizeof(bf16); }
size_t smem_bytes(int S) {
  return 1024 + ring_bytes(S) + 3 * (size_t)rows_for(S) * row_ld(kHd) * sizeof(bf16) + kStages * 8;
}

// Phase 1: the head's q, k and v rows 0..R-1 into qkv_s ([3][R][row_ld]).
// MTW: m16 tiles a warp takes, ceil(m_tiles / 4); a warp of a group with
// fewer repeats its group's last tile (tile m_tiles - 1) and does not store
// it, so every warp runs one unguarded block of ldmatrix and mma a step.
template <int MTW>
__device__ __forceinline__ void project(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                        const bf16* __restrict__ bias, bf16* qkv_s, bf16* ring, uint64_t* full,
                                        int b, int h, int S, int D) {
  const int R = rows_for(S), m_tiles = R / 16;
  const int stage_elems = (R + kNC) * kBK;
  const int KT = D / kBK, steps = 2 * KT;

  // One thread feeds the ring by TMA: a step's x tile in two boxes of R / 2
  // rows (the tensor map's S bound zero-fills rows past S) and its 96 w rows
  // in three boxes of 32 (chunk c's columns c * 96 .. c * 96 + 95 of the
  // head's [q | k | v]), 64-byte swizzled as swz() reads them, completing
  // on the stage's mbarrier.
  auto load = [&](int i) {
    const int st = i % kStages, c = i >= KT, k0 = (i - c * KT) * kBK;
    bf16* sa = ring + st * stage_elems;
    sm90::mbar_expect_tx(&full[st], (uint32_t)stage_elems * sizeof(bf16));
    sm90::tma_load_3d(sa, tmx, k0, 0, b, &full[st]);
    sm90::tma_load_3d(sa + (R / 2) * kBK, tmx, k0, R / 2, b, &full[st]);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int n0 = c * kNC + q * 32;  // part n0 / 64, head dims n0 % 64 .. + 31
      sm90::tma_load_2d(sa + (R + q * 32) * kBK, tmw, k0, (n0 / kHd) * D + h * kHd + n0 % kHd, &full[st]);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int wg = (warp + warp / 4) & 3;  // row group; the two warps of a sub-partition take different groups
  const int wn = (warp / 4) * 48;        // column half of the chunk
  int a_off[MTW];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) a_off[mi] = min(wg + 4 * mi, m_tiles - 1) * 16 + (lane & 15);
  float acc[MTW][6][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (threadIdx.x == 0)
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) load(s);  // steps >= 2 always
  for (int i = 0; i < steps; ++i) {
    __syncthreads();  // every warp is done with step i - 1: its stage is free
    if (threadIdx.x == 0 && i + kStages - 1 < steps) load(i + kStages - 1);
    sm90::mbar_wait(&full[i % kStages], (i / kStages) & 1);  // step i has landed
    const bf16* sa = ring + (i % kStages) * stage_elems;
    const bf16* sb = sa + R * kBK;
    // both k16 halves' fragments first, then the 12 * MTW MMAs back to back
    // (the asm statements keep their order, so loads interleaved with MMAs
    // would stall each MMA block on its loads)
    uint32_t bw[2][3][4], a[2][MTW][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int n = wn + j * 16 + ((lane >> 4) << 3) + (lane & 7);
        ldmatrix_x4(bw[kk][j], sb + swz(n, kk * 2 + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) ldmatrix_x4(a[kk][mi], sa + swz(a_off[mi], kk * 2 + (lane >> 4)));
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
        for (int nt = 0; nt < 6; ++nt)
          mma_bf16(acc[mi][nt], a[kk][mi], bw[kk][nt / 2][(nt % 2) * 2], bw[kk][nt / 2][(nt % 2) * 2 + 1]);
    if (i % KT == KT - 1) {  // the chunk's epilogue: bf16(acc) + bias in bf16, into its q / k / v columns
      const int c = i / KT, g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        const int n = c * kNC + wn + nt * 8 + 2 * t;  // even
        const int part = n / kHd, d = n % kHd;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + (size_t)part * D + h * kHd + d));
        bf16* dst_s = qkv_s + (size_t)part * R * row_ld(kHd) + d;
#pragma unroll
        for (int mi = 0; mi < MTW; ++mi) {
          const int mt = wg + 4 * mi;
          if (mt < m_tiles) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = mt * 16 + g + half * 8;
              const float v0 = __bfloat162float(__float2bfloat16(acc[mi][nt][2 * half])) + bb.x;
              const float v1 = __bfloat162float(__float2bfloat16(acc[mi][nt][2 * half + 1])) + bb.y;
              *reinterpret_cast<uint32_t*>(dst_s + r * row_ld(kHd)) = pack_bf16(v0, v1);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
        }
      }
    }
  }
  __syncthreads();  // q, k and v are in shared memory
}

// PROBE: phase 1 only, the head's q, k, v rows < S written to qkv_out [B, S, 3D].
template <int KT, bool PROBE>
__global__ void __launch_bounds__(kCtaThreads, 1)
qkv_attention_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                     const bf16* __restrict__ bias, bf16* __restrict__ o, int S, int D, int causal,
                     float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int R = rows_for(S);
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* qkv_s = reinterpret_cast<bf16*>(base + ring_bytes(S));
  uint64_t* full = reinterpret_cast<uint64_t*>(qkv_s + (size_t)3 * R * row_ld(kHd));
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) sm90::mbar_init(&full[st], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  project<row_tiles_for(KT)>(&tmx, &tmw, bias, qkv_s, ring, full, b, h, S, D);

  if constexpr (PROBE) {
    for (int i = threadIdx.x; i < S * 3 * (kHd / 8); i += kCtaThreads) {
      const int r = i / (3 * kHd / 8), part = (i / (kHd / 8)) % 3, c = i % (kHd / 8);
      *reinterpret_cast<uint4*>(o + ((size_t)b * S + r) * 3 * D + (size_t)part * D + h * kHd + c * 8) =
          *reinterpret_cast<const uint4*>(qkv_s + ((size_t)part * R + r) * row_ld(kHd) + c * 8);
    }
    return;
  } else {
    const bf16* qs = qkv_s;
    const bf16* ks = qs + (size_t)R * row_ld(kHd);
    const bf16* vs = ks + (size_t)R * row_ld(kHd);
    const long long tok0 = (long long)b * S, col = (long long)h * kHd;
    float s[2 * KT][4];
    float mx[2], sum[2];
    for (int tile = threadIdx.x / 32; tile < R / 16; tile += kCtaWarps) {
      const int r0 = tile * kTileRows;
      const int nkt = ((causal ? min(r0 + kTileRows, S) : S) + 15) / 16;
      uint32_t qa[kHd / 16][4];
      ldsm_a_rows<kHd>(qa, qs, r0);
      if (nkt == KT)
        tile_softmax<kHd, KT, true, true>(s, mx, sum, qa, ks, nkt, r0, S, causal != 0, sm_scale);
      else
        tile_softmax<kHd, KT, false, true>(s, mx, sum, qa, ks, nkt, r0, S, causal != 0, sm_scale);
      tile_pv_store<kHd, true, KT>(s, sum, vs, o, D, tok0, col, r0, S, nkt, KT);
    }
  }
}

template <int KT, bool PROBE>
cudaError_t launch_kt(const void* x, const void* w, const void* b, void* o, int B, int S, int H,
                      int causal, float sm_scale, cudaStream_t stream) {
  const int D = H * kHd;
  CUtensorMap tmx, tmw;
  const cuuint64_t x_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t x_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t x_box[3] = {kBK, (cuuint32_t)rows_for(S) / 2, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)D, (cuuint64_t)3 * D};
  const cuuint64_t w_strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t w_box[2] = {kBK, 32};
  if (!sm90::tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, x_dims, x_strides, x_box,
                        CU_TENSOR_MAP_SWIZZLE_64B) ||
      !sm90::tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, w_strides, w_box,
                        CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S);
  auto kernel = qkv_attention_kernel<KT, PROBE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kCtaThreads, smem, stream>>>(tmx, tmw, static_cast<const bf16*>(b), static_cast<bf16*>(o), S,
                                                  D, causal, sm_scale);
  return cudaGetLastError();
}

bool valid(int B, int S, int H, int head_dim) {
  return head_dim == kHd && B > 0 && B <= 65535 && S > 0 && H > 0 && key_tiles_for(S) != 0 &&
         rows_for(S) <= 4 * kMaxRowGroups * 16;
}

template <bool PROBE>
int launch(const void* x, const void* w, const void* b, void* o, int B, int S, int H, int head_dim, int causal,
           float sm_scale, void* stream) {
  if (!valid(B, S, H, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (key_tiles_for(S)) {
    case 5:
      return (int)launch_kt<5, PROBE>(x, w, b, o, B, S, H, causal, sm_scale, st);
    case 9:
      return (int)launch_kt<9, PROBE>(x, w, b, o, B, S, H, causal, sm_scale, st);
    case 17:
      return (int)launch_kt<17, PROBE>(x, w, b, o, B, S, H, causal, sm_scale, st);
    case kMaxKeyTiles:
      return (int)launch_kt<kMaxKeyTiles, PROBE>(x, w, b, o, B, S, H, causal, sm_scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs at sequence length S (the wrapper
// checks it against the card's per-block limit before launching).
size_t isx_qkv_attention_smem_bytes(int S) { return smem_bytes(S); }

// x [B, S, D], w [3D, D], b [3D], o [B, S, D]: bf16, contiguous and 16-byte
// aligned on the device; D = H * 64, S <= 320. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
int isx_qkv_attention(const void* x, const void* w, const void* b, void* o, int B, int S, int H,
                      int head_dim, int causal, float sm_scale, void* stream) {
  return launch<false>(x, w, b, o, B, S, H, head_dim, causal, sm_scale, stream);
}

// Phase 1 of isx_qkv_attention alone: qkv [B, S, 3D] bf16 gets the projection
// (bf16(x @ w^T) + b, rounded as the kernel rounds it) that phase 2 reads.
int isx_qkv_attention_probe(const void* x, const void* w, const void* b, void* qkv, int B, int S, int H,
                            int head_dim, void* stream) {
  return launch<true>(x, w, b, qkv, B, S, H, head_dim, 0, 1.0f, stream);
}

}  // extern "C"

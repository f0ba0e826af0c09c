// Attention forward for Hopper (sm_90a): softmax(q k^T * sm_scale [+ causal]) v
// over the packed [B, S, H*Hd] bf16 layout, on the tensor cores.
//
// Replaces four TPU kernels of image_search_tpu/ops/attention.py, which
// compute one function and differ only in where p is rounded and which keys
// take part:
//   - _attn_kernel_grouped (B1, entry point fused_attention_grouped; the
//     default route of every attention layer of both CLIP towers except the
//     last): p = exp(l - max) is rounded to bf16 BEFORE the PV product, PV
//     accumulates in f32, and the accumulator is THEN multiplied by 1/sum;
//   - _attn_kernel (B1p, fused_attention_packed, the route under
//     ISX_ATTN_PIPE=0 or a head group that does not divide H): p =
//     exp(l - max) / sum in f32 (a division), THEN rounded to bf16; the f32
//     PV accumulator is stored as it is;
//   - _attn_kernel_packed (B7, fused_attention_qkv_packed): B1p on the three
//     column views of one packed [B, S, 3D] qkv, q unscaled and sm_scale
//     applied to the f32 logits (so bitwise B1p on (q * 0.125, k, v));
//   - _attn_kernel_split (B6, fused_attention_split and
//     fused_attention_split_padded): p as in B1p over one shared max and one
//     shared denominator, keys split at s_main into a main block and a tail,
//     the two blocks' PV sums added in f32 (main + tail), and keys at or
//     past s_real masked. Here the key limit n_keys skips those keys
//     outright (their K and V rows are never read: a non-finite pad row
//     cannot reach a real row); query rows at or past s_real are still
//     computed over the real keys, as the TPU kernel does, so the output
//     holds no uninitialised memory.
// Common to all: logits = (q . k) * sm_scale in f32 (bf16 products are exact
// in f32), scaled after the product; masked (causal) logits are NEG_INF =
// finfo(f32).min, never -inf; f32 row max over ALL of a row's keys before any
// exp (no online rescaling, so the grouped route's bf16(exp(l - max)) is
// rounded against the row's true max), p = exp(l - max) in f32, f32 sum.
//
// Design: a CTA of 4 warps per 4 consecutive 16-row query tiles of one
// (head, batch row); the last CTA of a (head, batch row) also takes the
// ragged remainder (S = 257 is 16 full tiles plus a 1-row tile: the CTA of
// tiles 12..16 runs tile 16 on warp 0 after tile 12). The grid runs the
// query-tile CTAs of one (head, batch row) side by side, so their K and V
// reloads hit L2. The CTA stages its head's K and V for the keys it can see
// into shared memory by cp.async (16 bytes a thread, rows padded to Hd + 8,
// zero past the key limit), K and V in two groups so the logits start once
// K has landed. Each warp then, for its 16 rows:
//   1. QK^T on the tensor cores (mma.sync.m16n8k16 bf16 -> f32, K fragments
//      by ldmatrix), all of the row's key tiles kept in registers (at most
//      20 tiles, 320 keys: 160 f32 a thread; the kernel is instantiated for
//      5, 9, 17 and 20 tiles, the vision tower's 257 keys taking 17), key
//      tiles past a causal tile's last row skipped, the diagonal masked;
//   2. the full-row max and sum in f32 (the 4 lanes of a row combine by
//      shuffles), exp, B1p's division e / sum (the IEEE quotient, formed from
//      one reciprocal a row and an FMA correction: div_fast), and p rounded
//      to bf16 IN REGISTERS: the C fragments of two 8-key n-tiles are the A
//      fragment of the PV product over 16 keys. A tile's rows start at a
//      multiple of 16, so only a row's last key tile can hold masked keys;
//      and a warp tile that needs all KT key tiles (every non-causal row at
//      257 or 264 keys) takes a copy of steps 1-2 with no tile guarded, so
//      the compiler schedules them as one block;
//   3. PV on the tensor cores (V fragments by ldmatrix.trans), the main
//      block's key tiles into one accumulator and the split tail's (keys at
//      or past s_main, a multiple of 16 there) into another, added in f32;
//   4. the grouped route's 1/sum, bf16 rounding and a 4-byte store per pair.
// Head dims: HD is a template parameter, instantiated for 64 only; 32 and 80
// are multiples of 16 and drop in, 104 (bigG) would pad the contraction to
// 112 and the PV n-tiles to 13.
//
// What bounds it: bytes. At the vision shape (B=160 S=257 H=16) the function
// moves q, k, v and out once, 4 x 160 x 257 x 1024 x 2 B = 337 MB, 0.1006 ms
// at 3.35 TB/s; its 43.3 GFLOP take 0.044 ms at the bf16 peak. The design
// reads q, k and v from device memory once per CTA (K and V again from L2 by
// the other query tiles of their head) and writes out once; p never leaves
// registers. What holds it back is the f32 softmax on the CUDA cores (expf,
// and B1p's division, which makes B1p slower than B1: PERF.md section 6) and
// the serial QK^T -> softmax -> PV of each warp at 8 warps an SM (the logits
// take 136-160 of a thread's 255 registers); mma.sync reaches a fraction of
// the tensor cores' wgmma rate.
#include "attention_tc.cuh"

namespace {

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
      uint32_t qa[HD / 16][4];
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

// div_rn against the card's own division, for a test: out[i] = x[i] / y[i].
__global__ void div_probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = div_rn(x[i], y[i], __frcp_rn(y[i]));
}

size_t smem_bytes(int n_keys, int hd) { return 2 * (size_t)ceil16(n_keys) * row_ld(hd) * sizeof(bf16); }

template <bool NORM_P, int KT>
cudaError_t launch_kt(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                      long long q_ld, long long k_ld, long long v_ld, long long o_ld, int n_keys, int s_main,
                      int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_keys, 64);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<64, NORM_P, KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ctas_for((S + kTileRows - 1) / kTileRows), H, B);
  attn_fwd_kernel<64, NORM_P, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, n_keys, s_main, q_ld, k_ld, v_ld, o_ld, causal, sm_scale);
  return cudaGetLastError();
}

template <bool NORM_P>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int head_dim, long long q_ld, long long k_ld, long long v_ld, long long o_ld,
           int n_keys, int s_main, int causal, float sm_scale, void* stream) {
  if (head_dim != 64 || B <= 0 || S <= 0 || H <= 0 || n_keys <= 0 || n_keys > S ||
      s_main <= 0 || s_main > n_keys || (s_main < n_keys && s_main % 16) || key_tiles_for(n_keys) == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ISX_LAUNCH(KT)                                                                                   \
  case KT:                                                                                               \
    return (int)launch_kt<NORM_P, KT>(q, k, v, o, B, S, H, q_ld, k_ld, v_ld, o_ld, n_keys, s_main, causal, \
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

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs when n_keys keys take part (the
// wrapper checks it against the card's per-block limit before launching).
size_t isx_attention_smem_bytes(int n_keys, int head_dim) { return smem_bytes(n_keys, head_dim); }

// The softmax's division (div_rn, as B1p, B6, B7 and B5 take it) over n
// pairs: out = x / y. For a test against the card's div.rn.f32.
int isx_attention_div_probe(const void* x, const void* y, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  div_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// The grouped kernel's function. q, k, v, o: bf16, element (b, s, h, d) at
// (b*S + s)*ld + h*head_dim + d; k and v rows 16-byte aligned. Launches on
// `stream`; returns cudaGetLastError() (0 on success).
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

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
// Head dims: HD is a template parameter (attention_fwd.cuh), built for 32
// (the learned-retrieval example's towers), 64 (ViT-L/14, and the text
// towers of OpenCLIP H/14 and bigG), 80 (H/14's vision tower) and 104
// (bigG's vision tower: the contraction padded to 112 with zeros, PV in 13
// n-tiles of 8, no store past column 104; see attention_tc.cuh). Each head
// dim's kernels compile in a source of their own (attention_fwd_hd32.cu,
// attention_fwd_hd80.cu, attention_fwd_hd104.cu). At HD = 104 and
// S = 257, K and V take 130.6 KB of shared memory: one CTA an SM.
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
#include "attention_fwd.cuh"

namespace attn_fwd {
ISX_ATTN_FWD_HD(extern, 32)
ISX_ATTN_FWD_HD(extern, 80)
ISX_ATTN_FWD_HD(extern, 104)
}  // namespace attn_fwd

namespace {

using namespace attn_tc;
using attn_fwd::launch_hd;

// div_rn against the card's own division, for a test: out[i] = x[i] / y[i].
__global__ void div_probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = div_rn(x[i], y[i], __frcp_rn(y[i]));
}

template <bool NORM_P>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int head_dim, long long q_ld, long long k_ld, long long v_ld, long long o_ld,
           int n_keys, int s_main, int causal, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || n_keys <= 0 || n_keys > S ||
      s_main <= 0 || s_main > n_keys || (s_main < n_keys && s_main % 16) || key_tiles_for(n_keys) == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_hd<32, NORM_P>(q, k, v, o, B, S, H, q_ld, k_ld, v_ld, o_ld, n_keys, s_main, causal, sm_scale, st);
    case 64:
      return launch_hd<64, NORM_P>(q, k, v, o, B, S, H, q_ld, k_ld, v_ld, o_ld, n_keys, s_main, causal, sm_scale, st);
    case 80:
      return launch_hd<80, NORM_P>(q, k, v, o, B, S, H, q_ld, k_ld, v_ld, o_ld, n_keys, s_main, causal, sm_scale, st);
    case 104:
      return launch_hd<104, NORM_P>(q, k, v, o, B, S, H, q_ld, k_ld, v_ld, o_ld, n_keys, s_main, causal, sm_scale,
                                    st);
  }
  return (int)cudaErrorInvalidValue;  // a head dim not built
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs when n_keys keys take part (the
// wrapper checks it against the card's per-block limit before launching).
size_t isx_attention_smem_bytes(int n_keys, int head_dim) { return attn_fwd::smem_bytes(n_keys, head_dim); }

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

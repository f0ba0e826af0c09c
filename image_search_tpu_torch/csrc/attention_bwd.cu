// Attention backward for Hopper (sm_90a): dq, dk, dv of
// softmax(q k^T * sm_scale [+ causal]) v from the output cotangent g, over the
// packed [B, S, H*Hd] bf16 layout, on the tensor cores.
//
// Replaces the TPU kernel image_search_tpu/ops/attention.py::_attn_bwd_kernel
// (B5, entry point fused_attention_bwd, attention.py:122), which the
// reference's attention cores select for their VJP (_backward_packed). Same
// math and the same rounding points as that kernel:
//   - logits l = (q . k) * sm_scale in f32; causal positions are NEG_INF =
//     finfo(f32).min, whose probability exp(NEG_INF - max) is exactly 0;
//   - p32 = exp(l - max) / sum, a division (the forward multiplies by 1/sum);
//     the IEEE quotient, formed as attention_tc.cuh's div_fast forms it;
//   - dv = bf16(p32)^T g, accumulated in f32, stored in bf16;
//   - dp = g . v in f32; ds = p32 * (dp - t) with the row term
//     t = sum_k dp * p32 (not the FlashAttention shortcut sum g * o);
//   - dsb = bf16(ds * sm_scale); dq = dsb k and dk = dsb^T q, accumulated in
//     f32, stored in bf16.
//
// Design: two launches on one stream, no atomics, each output written once,
// the same bits on every run. Every product is mma.sync.m16n8k16 (bf16 in,
// f32 accumulate), with the fragment helpers of attention_tc.cuh; a CTA is 4
// warps over 4 consecutive 16-row tiles (the last CTA of a head also takes
// the ragged remainder), cp.async staging into rows padded to Hd + 8.
//   1. Row pass, per 16-query tile. The CTA stages its head's K and V for
//      the keys its rows see. Each warp: l = Q K^T into registers for all of
//      its key tiles (the forward's tile_softmax: the same instructions), the
//      f32 max, sum and p32 in place; dp = G V^T one 16-key tile at a time
//      for t = sum dp * p32; then dp again (the same instructions, so the
//      same bits), ds, dsb rounded to bf16 in registers as the A fragment of
//      dq += dsb K (K by ldmatrix.trans). Writes dq and the rows' (max, sum,
//      t) to an f32 [3, B, H, S] workspace.
//   2. Column pass, per 16-key tile. The CTA stages Q, G and the workspace
//      rows of every query that sees its keys; each warp holds its keys' K
//      and V fragments in registers and walks the query tiles: l and dp for
//      the (16 queries x 16 keys) tile with Q and G as the A operand and K
//      and V as the B operand -- the SAME roles, tile positions and k-step
//      order as the row pass -- so p32 and ds come out bit for bit as the
//      row pass formed them. bf16(p32) and dsb go through a 16 x 16 tile in
//      shared memory (a 32-bit store per pair, ldmatrix.trans back) to
//      become the A fragments of dv += bf16(p32)^T G and dk += dsb^T Q.
//   isx_attention_bwd_probe runs both passes with each writing its p32 and
//   ds to an [S, S] map per head, so a test on the card can hold the two
//   passes' maps equal bitwise.
// Head dims: the kernels are templates on HD (attention_bwd.cuh), built for
// 32 (the learned-retrieval example's towers), 64 (ViT-L/14 and every text
// tower), 80 (OpenCLIP H/14's vision tower) and 104 (bigG's), each in a
// source of its own (attention_bwd_hd32.cu, _hd80.cu, _hd104.cu) so that nvcc
// compiles them in parallel. At 104 both passes pad the contraction of
// l = Q K^T and dp = G V^T to 112 (attention_tc.cuh): the fragments loaded
// from device memory (load_a_rows, load_b_cols) and the shared rows that
// ldmatrix reads (stage_rows) hold zeros in columns 104-111, never the next
// head's, so the two passes still form the same bits; dq, dk and dv run 13
// n-tiles of 8 (the 13th by ldmatrix.x2.trans) and no store passes column
// 104. At S = 257 the K and V (or Q and G) rows take 2 x 272 x 120 x 2 B =
// 130.6 KB of shared memory at 104: one CTA an SM.
//
// What bounds it: bytes. Per head 5 S x S x Hd products (QK^T, dp, dq, dk,
// dv; 43.3 GFLOP at B=64 S=257 H=16, 0.044 ms at the bf16 peak) over 7
// [B, S, H*Hd] bf16 tensors read or written once (236 MB, 0.0704 ms at 3.35
// TB/s). The design takes l twice (once per pass) and dp three times (twice
// in the row pass, once in the column pass): 8 products where 5 would do,
// the price of keeping every row's logits in registers and of two passes
// without atomics; mma.sync runs at a fraction of the wgmma rate.
#include "attention_bwd.cuh"

namespace attn_bwd {
ISX_ATTN_BWD_HD(extern, 32)
ISX_ATTN_BWD_HD(extern, 80)
ISX_ATTN_BWD_HD(extern, 104)
}  // namespace attn_bwd

namespace {

using namespace attn_tc;
using attn_bwd::launch_hd;

template <bool PROBE>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk, void* dv,
           void* stats, void* probe, int B, int S, int H, int head_dim, long long q_ld, long long k_ld,
           long long v_ld, long long g_ld, int causal, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || key_tiles_for(S) == 0) return (int)cudaErrorInvalidValue;
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k);
  const bf16 *vp = static_cast<const bf16*>(v), *gp = static_cast<const bf16*>(g);
  bf16 *dqp = static_cast<bf16*>(dq), *dkp = static_cast<bf16*>(dk), *dvp = static_cast<bf16*>(dv);
  float *st = static_cast<float*>(stats), *pr = static_cast<float*>(probe);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ISX_HD(HD)                                                                                           \
  case HD:                                                                                                   \
    return launch_hd<HD, PROBE>(qp, kp, vp, gp, dqp, dkp, dvp, st, pr, B, S, H, q_ld, k_ld, v_ld, g_ld, causal, \
                                sm_scale, s);
  switch (head_dim) {
    ISX_HD(32)
    ISX_HD(64)
    ISX_HD(80)
    ISX_HD(104)
  }
#undef ISX_HD
  return (int)cudaErrorInvalidValue;  // a head dim not built
}

}  // namespace

extern "C" {

// Dynamic shared memory the larger of the two passes needs for sequence
// length S (the wrapper checks it against the card's per-block limit).
size_t isx_attention_bwd_smem_bytes(int S, int head_dim) { return attn_bwd::cols_smem_bytes(S, head_dim); }

// q, k, v, g: bf16, element (b, s, h, d) at (b*S + s)*ld + h*head_dim + d,
// rows 16-byte aligned. dq, dk, dv: bf16, contiguous [B, S, H*head_dim].
// stats: f32 [3, B, H, S] workspace. Launches both passes on `stream`;
// returns cudaGetLastError().
int isx_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                      void* dq, void* dk, void* dv, void* stats,
                      int B, int S, int H, int head_dim,
                      long long q_ld, long long k_ld, long long v_ld, long long g_ld,
                      int causal, float sm_scale, void* stream) {
  return launch<false>(q, k, v, g, dq, dk, dv, stats, nullptr, B, S, H, head_dim, q_ld, k_ld, v_ld, g_ld,
                       causal, sm_scale, stream);
}

// isx_attention_bwd, with each pass also writing the p32 and ds it formed:
// probe f32 [2 passes (rows, columns), 2 (p32, ds), B, H, S, S], entries of
// masked and out-of-range pairs left as they were.
int isx_attention_bwd_probe(const void* q, const void* k, const void* v, const void* g,
                            void* dq, void* dk, void* dv, void* stats, void* probe,
                            int B, int S, int H, int head_dim,
                            long long q_ld, long long k_ld, long long v_ld, long long g_ld,
                            int causal, float sm_scale, void* stream) {
  return launch<true>(q, k, v, g, dq, dk, dv, stats, probe, B, S, H, head_dim, q_ld, k_ld, v_ld, g_ld,
                      causal, sm_scale, stream);
}

}  // extern "C"

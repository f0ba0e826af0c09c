// Block-pair maxima of augmented-sketch dots for Hopper (sm_90a): the phase-1
// sweep of the sketch duplicate scan (index/dupscan.py).
//
// Replaces the TPU kernels image_search_tpu/ops/blockmax.py::_kernel (entry
// point blockpair_mask, kernel B3) and ::_values_kernel (blockpair_values,
// kernel B4). For row block rb of s_rows (global block index
// rowb = row_block0 + rb) and column block cb of s_cols, 128 rows each:
//
//   m[rb, cb] = max_{i in rb, j in cb} sum_k s_rows[i, k] * s_cols[j, k]
//
// with bf16 operands and f32 sums, for cb >= rowb only (the upper triangle
// with the diagonal):
//
//   mask:   bit b of word out[rb, w] is (m[rb, w*32 + b] >= thr), LSB first;
//           built as a uint32 and stored unchanged, so bit 31 makes the int32
//           word negative. Bits below the diagonal are 0.
//   values: out[rb, cb] = m[rb, cb]; -inf below the diagonal.
//
// What bounds it: operations. 2 * 128 * 128 * d_a FLOP per block pair against
// d_a * 2 bytes per row read: far above the card's ratio of operations to
// bytes. The tensor cores take the depth in steps of 16, so d_a = 65 (a
// 64-dim sketch plus its residual norm) costs 80: the padded depth alone puts
// the floor at 65/80 of the tensor cores' rate counted at d_a.
//
// Design: one template, blockpair_kernel<MASK>, for both. Rows of 130 bytes
// (d_a = 65) are not 16-byte aligned, which neither TMA nor cp.async can
// read, so the operands come with their depth padded with zeros to a
// multiple of 16 (dupscan.py::_prep_sketch pads to 80 as it builds the slab;
// the wrapper pads any other operand whose rows are not 16-byte aligned, a
// copy that counts in the call's time). Zero columns change no dot.
// A CTA owns TWO row blocks (256 rows) and up to four words (128 column
// blocks): the 256 row sketches are loaded once by TMA and stay in shared
// memory, so each column byte fetched from L2 feeds 256 rows, and the CTA's
// start-up (barriers, the rows' load, the ring's first fill) is paid once
// for 128 column blocks. A 160-byte row does not fit one 128-byte swizzle
// span, so every 128-row block is loaded as two boxes: columns 0-63 with
// 128-byte swizzle (k steps 0-3) and columns 64-79 with 32-byte swizzle (k
// step 4), each read by its own wgmma descriptor; the tensor map's depth
// bound zero-fills columns past d_a, and the second box is skipped when
// d_a <= 64. A producer warp streams the column blocks on or above the
// CTA's diagonal through a 4-stage ring (20 KB a stage), each completing on
// its full mbarrier. Two consumer warpgroups each own one row block: per
// column block, 2 (64-row halves) x 5 (k steps) wgmma.m64n128k16 with both
// operands from shared memory, 128 f32 accumulators a thread; the stage is
// released (its empty mbarrier) as soon as the group completes, and the
// warpgroup then reduces the 128 x 128 tile to its maximum (in-thread fmaxf,
// warp shuffles, one value a warp in shared memory) while the other
// warpgroup's wgmma keeps the tensor cores busy. Column blocks below a
// warpgroup's diagonal are not computed (nor loaded, below the CTA's), and
// words wholly below both row blocks are only written as zeros or -inf. At
// the end of each word each warpgroup combines its 4 warps' maxima and
// writes its word (mask, no atomics) or its 32 values (one coalesced
// 128-byte store). Consecutive CTAs take consecutive row-block pairs of the
// same words, so the CTAs in flight share their column blocks in L2.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (d_a = 65 padded to 80):
// ~560 TFLOP/s at the padded depth (chip_smoke.py); four words a CTA were
// faster than one; six stages, or reducing one 64-row half while the
// other's wgmmas run, were no faster.
//
// Soundness of a cleared bit (dupscan.py::_pair_slack: 1e-4 up to D = 768): the
// products of bf16 values are exact in f32; the tensor cores' f32 accumulation
// (wgmma's as mma.sync's) may truncate instead of rounding to nearest, which
// at most doubles the rounding error of the 65-term sum:
// 2 * 65 * 2^-23 * ||a_i|| ||a_j|| < 2e-5, far below SLACK.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlock = 128;        // rows per block of the scan
constexpr int kWordBits = 32;      // column blocks per word
constexpr int kWords = 4;          // words a CTA sweeps with its rows resident
constexpr int kRowBlocks = 2;      // row blocks per CTA: one per consumer warpgroup
constexpr int kConsumerWarps = 4 * kRowBlocks;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kStages = 4;
constexpr int kMaxDepth = 80;      // 5 k steps of 16
constexpr int kHiBytes = kBlock * 64 * 2;           // columns 0-63, 128-byte swizzle
constexpr int kLoBytes = kBlock * 16 * 2;           // columns 64-79, 32-byte swizzle
constexpr int kTileBytes = kHiBytes + kLoBytes;     // one 128-row block: 20 KB
constexpr int kRowsBytes = kRowBlocks * kTileBytes;
constexpr size_t kSmemBytes =
    1024 + kRowsBytes + (size_t)kStages * kTileBytes + 2 * kRowBlocks * 4 * kWordBits * 4 + (2 * kStages + 1) * 8;

// A block's k step ks for the 64-row half h: its wgmma descriptor.
__device__ __forceinline__ uint64_t tile_desc(const unsigned char* tile, int h, int ks) {
  return ks < 4 ? sm90::smem_desc(tile + h * 64 * 128 + ks * 32, sm90::kSw128, 1024)
                : sm90::smem_desc(tile + kHiBytes + h * 64 * 32, sm90::kSw32, 256);
}

template <bool MASK>
__global__ void __launch_bounds__(kThreads, 1)
blockpair_kernel(const __grid_constant__ CUtensorMap rows_hi, const __grid_constant__ CUtensorMap rows_lo,
                 const __grid_constant__ CUtensorMap cols_hi, const __grid_constant__ CUtensorMap cols_lo,
                 int N, int ksteps, float thr, int row_block0, void* __restrict__ out) {
  const int rb_first = blockIdx.x * kRowBlocks;  // local row block of warpgroup 0
  const int rowb = row_block0 + rb_first;         // global row block of warpgroup 0
  const int n_words = N / (kBlock * kWordBits);
  const int wc0 = blockIdx.y * kWords, wc_end = min(wc0 + kWords, n_words);  // the CTA's words
  const int cb_begin = max(rowb, wc0 * kWordBits), cb_end = wc_end * kWordBits;  // the column blocks it computes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // words wholly below the diagonal of both row blocks: zeros or -inf only
  const int wc_first = min(cb_begin / kWordBits, wc_end);
  for (int p = warp; p < kRowBlocks * (wc_first - wc0); p += kThreads / 32) {
    const int rb = rb_first + p % kRowBlocks, wc = wc0 + p / kRowBlocks;
    if (MASK) {
      if (lane == 0) static_cast<int*>(out)[(size_t)rb * n_words + wc] = 0;
    } else {
      static_cast<float*>(out)[(size_t)rb * (N / kBlock) + wc * kWordBits + lane] = -INFINITY;
    }
  }
  if (cb_begin >= cb_end) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* rows = smem_raw + ((1024 - sm90::smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* ring = rows + kRowsBytes;
  float* wmax = reinterpret_cast<float*>(ring + kStages * kTileBytes);  // [2 words][kRowBlocks][4 warps][kWordBits]
  uint64_t* full = reinterpret_cast<uint64_t*>(wmax + 2 * kRowBlocks * 4 * kWordBits);
  uint64_t* empty = full + kStages;
  uint64_t* rows_full = empty + kStages;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(&full[st], 1);
      sm90::mbar_init(&empty[st], kConsumerWarps);
    }
    sm90::mbar_init(rows_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const uint32_t tile_tx = ksteps > 4 ? kTileBytes : kHiBytes;

  if (warp == kConsumerWarps) {  // producer: one thread feeds the rows, then the ring
    if (lane == 0) {
      sm90::mbar_expect_tx(rows_full, kRowBlocks * tile_tx);
      for (int r = 0; r < kRowBlocks; ++r) {
        sm90::tma_load_2d(rows + r * kTileBytes, &rows_hi, 0, (rb_first + r) * kBlock, rows_full);
        if (ksteps > 4)
          sm90::tma_load_2d(rows + r * kTileBytes + kHiBytes, &rows_lo, 64, (rb_first + r) * kBlock, rows_full);
      }
      for (int cb = cb_begin, it = 0; cb < cb_end; ++cb, ++it) {
        const int st = it % kStages;
        unsigned char* dst = ring + st * kTileBytes;
        sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], tile_tx);
        sm90::tma_load_2d(dst, &cols_hi, 0, cb * kBlock, &full[st]);
        if (ksteps > 4) sm90::tma_load_2d(dst + kHiBytes, &cols_lo, 64, cb * kBlock, &full[st]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns local row block rb_first + wg
  const int wg = warp / 4, rb = rb_first + wg;
  const unsigned char* arows = rows + wg * kTileBytes;
  float acc[2][64];
  sm90::mbar_wait(rows_full, 0);
  for (int cb = cb_begin, it = 0; cb < cb_end; ++cb, ++it) {
    const int st = it % kStages;
    const unsigned char* tile = ring + st * kTileBytes;
    float* word_max = wmax + (((cb / kWordBits) & 1) * kRowBlocks + wg) * 4 * kWordBits;  // this word's, 4 warps
    sm90::mbar_wait(&full[st], (it / kStages) & 1);
    const bool live = cb >= rowb + wg;  // on or above the warpgroup's diagonal
    if (live) {
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kMaxDepth / 16; ++ks) {
        if (ks < ksteps) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sm90::wgmma_m64n128k16_ss(acc[h], tile_desc(arows, h, ks), tile_desc(tile, 0, ks), ks > 0);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
    if (lane == 0) sm90::mbar_arrive(&empty[st]);  // the stage is free
    if (live) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sm90::fence_operand(acc[0][i]);
        sm90::fence_operand(acc[1][i]);
      }
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 64; ++i) m = fmaxf(m, fmaxf(acc[0][i], acc[1][i]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) word_max[(warp & 3) * kWordBits + cb % kWordBits] = m;
    }
    if (cb % kWordBits == kWordBits - 1) {  // the word is done: warp 0 of the warpgroup writes it
      sm90::named_barrier(1 + wg, 128);  // (maxima of word w - 2 in this buffer were read before the last one)
      if ((warp & 3) == 0) {
        const int wc = cb / kWordBits, c = wc * kWordBits + lane;
        float v = -INFINITY;
        if (c >= rowb + wg) {
#pragma unroll
          for (int w = 0; w < 4; ++w) v = fmaxf(v, word_max[w * kWordBits + lane]);
        }
        if (MASK) {
          const uint32_t word = __ballot_sync(0xffffffffu, v >= thr);
          if (lane == 0) static_cast<uint32_t*>(out)[(size_t)rb * n_words + wc] = word;
        } else {
          static_cast<float*>(out)[(size_t)rb * (N / kBlock) + c] = v;
        }
      }
    }
  }
}

// The two tensor maps of a [rows, depth] bf16 sketch array with row stride ld
// elements: 128-row boxes of columns 0-63 (128-byte swizzle) and of columns
// 64-79 (32-byte swizzle); columns past depth arrive as zeros.
bool sketch_maps(CUtensorMap* hi, CUtensorMap* lo, const void* p, int rows, int depth, int ld) {
  const cuuint64_t dims[2] = {(cuuint64_t)depth, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box_hi[2] = {64, kBlock}, box_lo[2] = {16, kBlock};
  return sm90::tensor_map(hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims, strides, box_hi,
                          CU_TENSOR_MAP_SWIZZLE_128B) &&
         sm90::tensor_map(lo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims, strides, box_lo,
                          CU_TENSOR_MAP_SWIZZLE_32B);
}

template <bool MASK>
cudaError_t launch(const void* s_rows, const void* s_cols, int R, int N, int da, float thr, int row_block0,
                   void* out, void* stream) {
  if (R <= 0 || N <= 0 || R % (kBlock * kRowBlocks) != 0 || N % (kBlock * kWordBits) != 0 || da < 1 ||
      da > kMaxDepth || da % 8 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap rh, rl, ch, cl;
  if (!sketch_maps(&rh, &rl, s_rows, R, da, da) || !sketch_maps(&ch, &cl, s_cols, N, da, da))
    return cudaErrorInvalidValue;
  auto kernel = blockpair_kernel<MASK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_words = N / (kBlock * kWordBits);
  const dim3 grid(R / (kBlock * kRowBlocks), (n_words + kWords - 1) / kWords);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(rh, rl, ch, cl, N, (da + 15) / 16,
                                                                            thr, row_block0, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// s_rows [R, da] bf16, s_cols [N, da] bf16, contiguous and 16-byte aligned
// on the device; R % 256 == 0, N % 4096 == 0, da % 8 == 0, 8 <= da <= 80.
// out [R/128, N/4096] int32. Launches on `stream`; returns cudaGetLastError().
int isx_blockpair_mask(const void* s_rows, const void* s_cols, int R, int N, int da, float thr,
                       int row_block0, void* out, void* stream) {
  return (int)launch<true>(s_rows, s_cols, R, N, da, thr, row_block0, out, stream);
}

// As isx_blockpair_mask, with out [R/128, N/128] f32 block maxima.
int isx_blockpair_values(const void* s_rows, const void* s_cols, int R, int N, int da,
                         int row_block0, void* out, void* stream) {
  return (int)launch<false>(s_rows, s_cols, R, N, da, 0.f, row_block0, out, stream);
}

}  // extern "C"

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
// Design: mma.sync.m16n8k16 bf16 with f32 accumulation; the depth d_a (65 for
// a 64-dim sketch plus its residual norm) is padded with zeros to 80, five
// k-steps, and zero padding changes no dot. One CUDA block of 8 warps owns one
// (row block, word) pair: 128 rows against 32 column blocks. It stages the 128
// row sketches in shared memory once, and each warp keeps the A fragments of
// its 16 rows in registers for the whole sweep. For each of the 32 column
// blocks the block stages 128 column sketches; each warp multiplies its 16 rows
// by the 128 columns (16 n-tiles x 5 k-steps) and reduces the tile to one
// maximum. At the end warp 0 combines the 8 warps' maxima of the 32 column
// blocks and writes the word (mask) or its 32 values (values, one coalesced
// 128-byte store) once, with no atomics. Column blocks below the diagonal are
// not computed, and a block whose 32 column blocks all lie below it only
// writes zeros or -inf. Consecutive CUDA blocks take consecutive row blocks
// of one word, so the blocks in flight share their column sketches in L2.
//
// Soundness of a cleared bit (dupscan.py::_pair_slack, SLACK = 1e-4): the
// products of bf16 values are exact in f32; the tensor cores' f32 accumulation
// may truncate instead of rounding to nearest, which at most doubles the
// rounding error of the 65-term sum: 2 * 65 * 2^-23 * ||a_i|| ||a_j|| < 2e-5,
// far below SLACK.
//
// What bounds it: operations. 2 * 128 * 128 * d_a FLOP per block pair against
// d_a * 2 bytes per row read: far above the card's ratio of operations to
// bytes. Each column tile is staged with 2-byte loads (rows of 65 bf16 are
// not 4-byte aligned) and the depth is padded by 23%; wgmma, TMA and a
// pipelined ring of column tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;       // rows per block of the scan
constexpr int kWordBits = 32;     // column blocks per word / per CUDA block
constexpr int kWarps = 8;         // 8 warps x 16 rows = one row block
constexpr int kThreads = kWarps * 32;
constexpr int kKSteps = 5;        // depth padded to 5 x 16 = 80
constexpr int kKPad = kKSteps * 16;
constexpr int kLds = 88;          // smem row stride (bf16): 44 words, conflict-free fragment loads
constexpr int kNTiles = kBlock / 8;

// Stage rows [0, 128) of a [*, da] bf16 array (row 0 at `src`) into a
// [128, kLds] tile; columns >= da keep the zeros written at kernel start.
__device__ __forceinline__ void stage_tile(uint16_t* dst, const uint16_t* __restrict__ src, int da) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kBlock; r += kWarps) {
    const uint16_t* s = src + (size_t)r * da;
    for (int c = lane; c < da; c += 32) dst[r * kLds + c] = s[c];
  }
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool MASK>
__global__ void __launch_bounds__(kThreads)
blockpair_kernel(const uint16_t* __restrict__ s_rows, const uint16_t* __restrict__ s_cols,
                 int N, int da, float thr, int row_block0, void* __restrict__ out) {
  __shared__ __align__(16) uint16_t sA[kBlock * kLds];
  __shared__ __align__(16) uint16_t sB[kBlock * kLds];
  __shared__ float warp_max[kWarps][kWordBits];

  const int rb = blockIdx.x;                 // local row block
  const int wc = blockIdx.y;                 // word column
  const int rowb = row_block0 + rb;          // global row block
  const int cb0 = wc * kWordBits;            // first global column block of the word
  const int n_words = N / (kBlock * kWordBits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;     // mma group id and thread in group
  const int first = max(rowb - cb0, 0);      // first column block on or above the diagonal

  if (first >= kWordBits) {                  // wholly below the diagonal
    if (MASK) {
      if (threadIdx.x == 0) static_cast<int*>(out)[(size_t)rb * n_words + wc] = 0;
    } else if (threadIdx.x < kWordBits) {
      static_cast<float*>(out)[(size_t)rb * (N / kBlock) + cb0 + threadIdx.x] = -INFINITY;
    }
    return;
  }

  for (int i = threadIdx.x; i < kBlock * kLds / 2; i += kThreads) {
    reinterpret_cast<uint32_t*>(sA)[i] = 0u;
    reinterpret_cast<uint32_t*>(sB)[i] = 0u;
  }
  __syncthreads();
  stage_tile(sA, s_rows + (size_t)rb * kBlock * da, da);
  __syncthreads();

  uint32_t a[kKSteps][4];
  {
    const uint16_t* r0 = sA + (warp * 16 + g) * kLds + t * 2;
    const uint16_t* r8 = r0 + 8 * kLds;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      a[ks][0] = lds32(r0 + ks * 16);
      a[ks][1] = lds32(r8 + ks * 16);
      a[ks][2] = lds32(r0 + ks * 16 + 8);
      a[ks][3] = lds32(r8 + ks * 16 + 8);
    }
  }

  for (int j = first; j < kWordBits; ++j) {
    __syncthreads();  // every warp is done with the previous column tile
    stage_tile(sB, s_cols + (size_t)(cb0 + j) * kBlock * da, da);
    __syncthreads();
    float m = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
      const uint16_t* bp = sB + (nt * 8 + g) * kLds + t * 2;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t b0 = lds32(bp + ks * 16), b1 = lds32(bp + ks * 16 + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
            : "r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]), "r"(a[ks][3]), "r"(b0), "r"(b1));
      }
      m = fmaxf(m, fmaxf(fmaxf(c0, c1), fmaxf(c2, c3)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) warp_max[warp][j] = m;
  }
  __syncthreads();

  if (warp == 0) {
    const int cb = cb0 + lane;
    float v = -INFINITY;
    if (lane >= first) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v = fmaxf(v, warp_max[w][lane]);
    }
    if (MASK) {
      const uint32_t word = __ballot_sync(0xffffffffu, cb >= rowb && v >= thr);
      if (lane == 0) static_cast<uint32_t*>(out)[(size_t)rb * n_words + wc] = word;
    } else {
      static_cast<float*>(out)[(size_t)rb * (N / kBlock) + cb] = cb >= rowb ? v : -INFINITY;
    }
  }
}

template <bool MASK>
cudaError_t launch(const void* s_rows, const void* s_cols, int R, int N, int da, float thr,
                   int row_block0, void* out, void* stream) {
  if (R <= 0 || N <= 0 || R % kBlock != 0 || N % (kBlock * kWordBits) != 0 || da < 1 ||
      da > kKPad)
    return cudaErrorInvalidValue;
  const dim3 grid(R / kBlock, N / (kBlock * kWordBits));
  blockpair_kernel<MASK><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(s_rows), static_cast<const uint16_t*>(s_cols), N, da, thr,
      row_block0, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// s_rows [R, da] bf16, s_cols [N, da] bf16, contiguous on the device;
// R % 128 == 0, N % 4096 == 0, 1 <= da <= 80. out [R/128, N/4096] int32.
// Launches on `stream`; returns cudaGetLastError().
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

// Row normalise-and-quantise for Hopper (sm_90a): the index's append path.
//
// Replaces no Pallas kernel: the JAX package transforms the rows of an append
// in numpy on the host (image_search_tpu/index/index.py::_add_in_memory_locked
// and _quantize_host), as the port did before this kernel. For each raw f32
// row x of width D it writes, into the index's slab slices:
//
//   norm  = sqrt(pairwise_sum(x * x))          numpy's order (see below)
//   y     = x / max(norm, 1e-12)
//   int8: scale = max(max|y|, 1e-12) / 127,  q = clip(rint(y / scale), -127, 127)
//   bf16: y rounded to nearest even;  f32: y
//
// Every step is one IEEE round-to-nearest f32 operation, written with
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn and rintf (half to even), so
// nvcc can never contract the square and the sum into an FMA, which would
// round once where numpy rounds twice: the rows, norms and scales are bitwise
// those of the plain version (ops/row_quant.py::normalize_rows_reference) and
// of numpy's host path. max|y| is computed as max|x| / max(norm, 1e-12): a
// correctly rounded division is monotone in its numerator, so the two are
// equal, and one pass over the row finds it beside the sum of squares.
//
// numpy's pairwise sum (ops/row_quant.py::pairwise_plan) splits a row into
// leaves of at most 128 values; a leaf of 8 or more is summed by 8 strided
// accumulators ("chains": chain j takes values j, j + 8, ... in order), which
// are combined in a fixed tree before the leaf's last D % 8 values are added
// in order; the leaves are added up a binary tree. The shape depends only on
// D, so the host compiles it once per D into a table (the plan) that the
// kernel walks: chains (start, count, stride), leaves (first chain, chains,
// first remaining value, remaining values), combines (node a, node b).
//
// Bound: bytes. A row reads 4 D bytes and writes D (int8), 2 D or 4 D bytes
// and 8 more; at D = 768 int8 that is 3,848 bytes, 1.15 us a 1000 rows at
// 3.35 TB/s. In the index the rows come from the host, so the copy over PCIe
// (4 D bytes a row) takes ~15x the kernel's bound.
// Design: one warp a row, a block of up to 8 warps, a grid-stride loop over
// rows. Lane l sums chains l, l + 32, ...: the 8 chains of a leaf lie on 8
// neighbouring lanes and read 8 neighbouring floats, so every load of the warp
// fills whole 32-byte sectors. The chain sums and the tree's nodes go through
// shared memory (one float each: 316 bytes a warp at D = 768); one lane adds
// up the leaves and the tree (8 leaves and 7 combines at D = 768). The output
// pass reads the row again (from L2) with 16-byte loads and stores 4 values a
// lane at once where D % 4 == 0 and the pointers are aligned, else 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSmemLimit = 48 * 1024;  // ops/row_quant.py::SMEM_LIMIT

enum Format { kF32 = 0, kBF16 = 1, kInt8 = 2 };

__device__ __forceinline__ float sq_add(float s, float v) { return __fadd_rn(s, __fmul_rn(v, v)); }

template <int FMT>
__device__ __forceinline__ void store1(void* out, long long i, float y, float scale) {
  if (FMT == kInt8) {
    float q = rintf(__fdiv_rn(y, scale));
    q = fminf(fmaxf(q, -127.f), 127.f);
    static_cast<int8_t*>(out)[i] = static_cast<int8_t>(static_cast<int>(q));
  } else if (FMT == kBF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(out)[i] = y;
  }
}

template <int FMT>
__device__ __forceinline__ void store4(void* out, long long i, float4 y, float scale) {
  if (FMT == kInt8) {
    float q[4] = {y.x, y.y, y.z, y.w};
    char4 c;
    int8_t* cp = reinterpret_cast<int8_t*>(&c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v = fminf(fmaxf(rintf(__fdiv_rn(q[k], scale)), -127.f), 127.f);
      cp[k] = static_cast<int8_t>(static_cast<int>(v));
    }
    *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + i) = c;
  } else if (FMT == kBF16) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = y;
  }
}

// x [n, D] f32; out [n, D] in FMT; norms [n]; scales [n] (int8 only).
// plan: chains [C][3], leaves [L][4], combines [L - 1][2] (int32).
template <int FMT, bool VEC4>
__global__ void __launch_bounds__(kMaxWarps * 32)
row_quant_kernel(const float* __restrict__ x, void* __restrict__ out, float* __restrict__ norms,
                 float* __restrict__ scales, long long n, int D, const int* __restrict__ plan,
                 int C, int L) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_chain = smem + warp * (C + 2 * L - 1);
  float* s_node = s_chain + C;  // L leaves, then L - 1 combines
  const int* chains = plan;
  const int* leaves = plan + 3 * C;
  const int* combines = leaves + 4 * L;

  for (long long row = (long long)blockIdx.x * warps + warp; row < n;
       row += (long long)gridDim.x * warps) {
    const float* xr = x + row * D;
    float amax = 0.f;
    for (int c = lane; c < C; c += 32) {
      const int start = __ldg(chains + 3 * c), count = __ldg(chains + 3 * c + 1),
                stride = __ldg(chains + 3 * c + 2);
      float v = __ldg(xr + start);
      float s = __fmul_rn(v, v);
      amax = fmaxf(amax, fabsf(v));
      for (int i = 1; i < count; ++i) {
        v = __ldg(xr + start + i * stride);
        s = sq_add(s, v);
        amax = fmaxf(amax, fabsf(v));
      }
      s_chain[c] = s;
    }
    __syncwarp();
    for (int l = lane; l < L; l += 32) {
      const int first = __ldg(leaves + 4 * l), nchain = __ldg(leaves + 4 * l + 1),
                tail = __ldg(leaves + 4 * l + 2), ntail = __ldg(leaves + 4 * l + 3);
      const float* r = s_chain + first;
      float s = nchain == 1 ? r[0]
                            : __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[1]), __fadd_rn(r[2], r[3])),
                                        __fadd_rn(__fadd_rn(r[4], r[5]), __fadd_rn(r[6], r[7])));
      for (int t = 0; t < ntail; ++t) {
        const float v = __ldg(xr + tail + t);
        s = sq_add(s, v);
        amax = fmaxf(amax, fabsf(v));
      }
      s_node[l] = s;
    }
    __syncwarp();
    if (lane == 0)
      for (int j = 0; j < L - 1; ++j)
        s_node[L + j] = __fadd_rn(s_node[__ldg(combines + 2 * j)], s_node[__ldg(combines + 2 * j + 1)]);
    __syncwarp();
    const float total = s_node[2 * L - 2];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    __syncwarp();  // every lane has read s_node before the next row writes it

    const float norm = __fsqrt_rn(total);
    const float denom = norm < 1e-12f ? 1e-12f : norm;  // np.maximum: a NaN norm stays NaN
    float scale = 0.f;
    if (FMT == kInt8) {
      const float a = __fdiv_rn(amax, denom);  // max|y|
      scale = __fdiv_rn(a < 1e-12f ? 1e-12f : a, 127.f);
    }
    if (lane == 0) {
      norms[row] = norm;
      if (FMT == kInt8) scales[row] = scale;
    }
    const long long base = row * D;
    if (VEC4) {
      for (int j = 4 * lane; j < D; j += 128) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr + j));
        const float4 y = make_float4(__fdiv_rn(v.x, denom), __fdiv_rn(v.y, denom),
                                     __fdiv_rn(v.z, denom), __fdiv_rn(v.w, denom));
        store4<FMT>(out, base + j, y, scale);
      }
    } else {
      for (int j = lane; j < D; j += 32) store1<FMT>(out, base + j, __fdiv_rn(__ldg(xr + j), denom), scale);
    }
  }
}

template <int FMT>
cudaError_t launch(const float* x, void* out, float* norms, float* scales, long long n, int D,
                   const int* plan, int C, int L, cudaStream_t stream) {
  const size_t per_warp = sizeof(float) * (size_t)(C + 2 * L - 1);
  int warps = (int)(kSmemLimit / per_warp);
  if (warps < 1) return cudaErrorInvalidValue;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t out_align = FMT == kInt8 ? 4 : FMT == kBF16 ? 8 : 16;
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % out_align == 0;
  long long blocks = (n + warps - 1) / warps;
  if (blocks > 1048576) blocks = 1048576;  // the grid-stride loop takes the rest
  const dim3 grid((unsigned)blocks), block(32 * warps);
  const size_t smem = per_warp * warps;
  if (vec4)
    row_quant_kernel<FMT, true><<<grid, block, smem, stream>>>(x, out, norms, scales, n, D, plan, C, L);
  else
    row_quant_kernel<FMT, false><<<grid, block, smem, stream>>>(x, out, norms, scales, n, D, plan, C, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, D] f32, rows [n, D] (fmt 0 f32, 1 bf16, 2 int8), norms [n] f32, scales
// [n] f32 (int8; NULL otherwise), plan the int32 table of
// ops/row_quant.py::kernel_plan(D) with C chains and L leaves; all contiguous
// on the device. One launch on `stream`; returns cudaGetLastError().
int isx_row_quant(const void* x, void* rows, void* norms, void* scales, long long n, int D, int fmt,
                  const void* plan, int C, int L, void* stream) {
  if (n <= 0 || D <= 0 || C <= 0 || L <= 0 || (fmt == kInt8 && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  auto xp = static_cast<const float*>(x);
  auto np = static_cast<float*>(norms);
  auto sp = static_cast<float*>(scales);
  auto pp = static_cast<const int*>(plan);
  auto st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kF32: return (int)launch<kF32>(xp, rows, np, sp, n, D, pp, C, L, st);
    case kBF16: return (int)launch<kBF16>(xp, rows, np, sp, n, D, pp, C, L, st);
    case kInt8: return (int)launch<kInt8>(xp, rows, np, sp, n, D, pp, C, L, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

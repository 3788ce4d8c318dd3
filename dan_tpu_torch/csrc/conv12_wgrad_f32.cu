// Weight gradient of the packed conv1_2' in float32 for Hopper (sm_90a): a
// register-blocked FFMA GEMM fed by a cp.async ring in shared memory.
//
// Replaces the Pallas TPU kernel dan_tpu/ops/conv12_wgrad_pallas.py::_kernel
// (wrapper conv12_wgrad_pallas, relu_input=True) on float32 operands: the
// TPU kernel takes the operands' own dtype, so a model with compute_dtype
// "float32" trains through it (csrc/conv12_wgrad.cu takes bf16).  It computes
//
//   dW[(kh, kw, gi), go] = sum_{b, y, x} relu(o1)[b, y-1+kh, x-1+kw, gi]
//                                        * dr[b, y, x, go]
//
// for the SAME-padded 2x2 conv over the phase grid: o1 (B, H, W, CI) is the
// pre-relu conv1_1' output, dr (B, H+1, W+1, CO) the cotangent of the conv
// output, both float32 and channels-last (NHWC) in memory; taps that fall
// outside o1 read zero.  The result is written in the port's OIHW layout,
// out[go, gi, kh, kw], float32.
//
// What bounds it: float32 arithmetic.  It is a GEMM with M = 4*CI = 1024,
// N = CO = 256 and K = B*H*W pixels for each tap (3.3 M at B = 32, 640^2):
// 1.72 TFLOP, about 25.6 ms at the 67 TFLOP/s of the CUDA cores, against
// 6.7 GB of operands (2.0 ms).  wgmma has no float32 operands, and TF32 (or
// 3xTF32) is not the float32 arithmetic of the reference, so the products
// are FFMAs, and the rate is the FFMA issue rate.
//
// What the design does about it:
//   * Tile and roles.  A block of 256 threads owns 128 rows of dW (one tap
//     (kh, kw) and 128 input channels) by 128 output channels, and a
//     contiguous range of the pixels; 8 row tiles x 2 column tiles x 16
//     ranges make 256 blocks, two on each of the 132 SMs.  A thread owns an
//     8 x 8 patch of the tile (rows 4 tx + i and 64 + 4 tx + i, columns
//     4 ty + j and 64 + 4 ty + j): each pixel costs it four 16-byte
//     shared-memory loads for 64 FFMAs.
//   * K is cut along the rows of o1, as in the bf16 kernel.  For tap
//     (kh, kw) only the H x W pixels of o1 count, each paired with dr at
//     (y + 1 - kh, x + 1 - kw), so a stage is a segment of 16 pixels of one
//     row of o1 and the 16 pixels of dr shifted by the tap: no padded copy,
//     no negative coordinate.  Where W is not a multiple of 16 the pixels
//     past W are filled with zeros by the copy itself (cp.async with a
//     source size of 0), in both operands.
//   * Loads.  Every thread copies two 16-byte pieces of each operand a
//     stage with cp.async (a pixel's 128 channels are 512 contiguous bytes:
//     a warp copies one pixel), three stages in flight.
//   * The relu.  After its copies of a stage have landed, each thread
//     clears the negative values of its own two pieces of o1 in place
//     (x < 0 ? 0 : x, so a NaN stays NaN as in the plain version), before
//     the block barrier that hands the stage to the products: 8 operations
//     a stage a thread, not one per product.
//   * Accuracy and determinism.  Every 4,096 pixels a thread adds its
//     registers into its block's float32 partial in global memory with
//     ordinary adds and clears them, so no chain of sums is longer than
//     4,096 products.  A second kernel sums the partials of the ranges in a
//     fixed order while it transposes to OIHW.  No float atomics: two runs
//     give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // rows of dW a block owns: one tap, 128 gi
constexpr int kBN = 128;      // columns of dW a block owns: go
constexpr int kSeg = 16;      // pixels a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageFloats = kSeg * (kBM + kBN);        // 16 KB
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 48 KB

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global into shared memory, or 16 zero bytes when !valid
// (a source size of 0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const float *src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's copy groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ float relu(float x) { return x < 0.0f ? 0.0f : x; }

__global__ void __launch_bounds__(kThreads, 2)
wgrad_f32_kernel(const float *__restrict__ o1,  // (B, H, W, CI)
                 const float *__restrict__ dr,  // (B, H+1, W+1, CO)
                 float *__restrict__ partial,   // (ranges, 4*CI, CO)
                 int h, int w, int ci, int co, int segs_x, int total_segs, int segs_per_range,
                 int flush_segs) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tap = m0 / ci, gi0 = m0 % ci;
  const int kh = tap >> 1, kw = tap & 1;
  const int seg_begin = blockIdx.z * segs_per_range;
  const int steps = max(0, min(total_segs, seg_begin + segs_per_range) - seg_begin);

  // This thread's copies: channels 4 q .. 4 q + 3 of pixels p and p + 8 of
  // a stage, in o1 (A) and in dr (B).
  const int q = t & 31, p = t >> 5;
  const float *a_src = o1 + gi0 + 4 * q;
  const float *b_src = dr + n0 + 4 * q;
  const uint32_t ring = smem_u32(smem);
  // The segment that the next copy takes: image row b * H + y of o1, its
  // segment sx, and b.
  int row = seg_begin / segs_x;
  int sx = seg_begin - row * segs_x;
  int b = row / h;
  auto load = [&](int stage) {
    const uint32_t sa = ring + (stage * kStageFloats + 4 * q) * 4;
    const uint32_t sb = sa + kSeg * kBM * 4;
    // dr's image rows are H + 1 to an image: row + b; the tap shifts.
    const size_t dr_row = (size_t)(row + b + 1 - kh) * (w + 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int pj = p + 8 * j;
      const int x = sx * kSeg + pj;
      const bool valid = x < w;
      const int xc = valid ? x : 0;  // an address inside the tensors all the same
      cp_async16(sa + pj * kBM * 4, a_src + ((size_t)row * w + xc) * ci, valid);
      cp_async16(sb + pj * kBN * 4, b_src + (dr_row + xc + 1 - kw) * co, valid);
    }
    if (++sx == segs_x) {
      sx = 0;
      ++row;
      if (row == (b + 1) * h) ++b;
    }
  };

  const int tx = t & 15, ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // Row i of this thread's patch, and the start of its two column groups.
  auto row_of = [&](int i) { return (i < 4 ? 0 : 64) + 4 * tx + (i & 3); };
  float *dst = partial + ((size_t)blockIdx.z * 4 * ci + m0) * co + n0 + 4 * ty;
  bool first = true;
  int since_flush = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    const int stage = it % kStages;
    float *const as = smem + stage * kStageFloats;
    const float *const bs = as + kSeg * kBM;
    cp_async_wait<kStages - 2>();  // this thread's copies of stage `it` landed
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float4 *v = reinterpret_cast<float4 *>(as + (p + 8 * j) * kBM + 4 * q);
      float4 x = *v;
      x.x = relu(x.x);
      x.y = relu(x.y);
      x.z = relu(x.z);
      x.w = relu(x.w);
      *v = x;
    }
    // Every thread's copies of this stage landed and were relu'd, and every
    // thread is done with the stage read in the last step, which the next
    // copy refills.
    __syncthreads();
    if (it + kStages - 1 < steps) load((it + kStages - 1) % kStages);
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      const float4 a0 = *reinterpret_cast<const float4 *>(as + k * kBM + 4 * tx);
      const float4 a1 = *reinterpret_cast<const float4 *>(as + k * kBM + 64 + 4 * tx);
      const float4 b0 = *reinterpret_cast<const float4 *>(bs + k * kBN + 4 * ty);
      const float4 b1 = *reinterpret_cast<const float4 *>(bs + k * kBN + 64 + 4 * ty);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (++since_flush == flush_segs || it == steps - 1) {
      // End this accumulation chain: registers into the block's partial.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          float4 *ptr = reinterpret_cast<float4 *>(dst + (size_t)row_of(i) * co + 64 * g);
          float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                                 acc[i][4 * g + 3]);
          if (!first) {
            const float4 o = *ptr;
            v.x = o.x + v.x;
            v.y = o.y + v.y;
            v.z = o.z + v.z;
            v.w = o.w + v.w;
          }
          *ptr = v;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][4 * g + j] = 0.0f;
        }
      }
      first = false;
      since_flush = 0;
    }
  }
  cp_async_wait<0>();
  if (first) {  // a range without segments still owns a partial
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<float4 *>(dst + (size_t)row_of(i) * co + 64 * g) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// out[go, gi, kh, kw] = sum over the ranges, in order, of
// partial[r, (kh*2 + kw)*CI + gi, go].
__global__ void reduce_partials_f32_kernel(const float *__restrict__ partial,
                                           float *__restrict__ out, int ranges, int ci, int co) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= co * ci * 4) return;
  const int tap = i & 3;  // kh*2 + kw
  const int gi = (i >> 2) % ci;
  const int go = (i >> 2) / ci;
  const size_t m = (size_t)tap * ci + gi;
  const size_t stride = (size_t)4 * ci * co;
  float s = 0.0f;
  for (int r = 0; r < ranges; ++r) s += partial[r * stride + m * co + go];
  out[i] = s;
}

}  // namespace

extern "C" {

// o1 (B, H, W, CI), dr (B, H+1, W+1, CO) float32 contiguous and 16-byte
// aligned; partial holds ranges * 4*CI*CO floats; out (CO, CI, 2, 2) float.
// CI and CO must be multiples of 128.  The pixels of o1 are cut into
// segments of 16 along x (segs_x = ceil(W / 16) a row); range r takes the
// segments [r * segs_per_range, (r + 1) * segs_per_range) and ends an
// accumulation chain every flush_segs segments.
int conv12_wgrad_f32_launch(const float *o1, const float *dr, float *partial, float *out,
                            int b, int h, int w, int ci, int co, int ranges,
                            int segs_per_range, int flush_segs, cudaStream_t stream) {
  if (ci % kBM || co % kBN || ranges < 1 || segs_per_range < 1 || flush_segs < 1 ||
      ranges > 65535)
    return (int)cudaErrorInvalidValue;
  const int segs_x = (w + kSeg - 1) / kSeg;
  const long long total = (long long)b * h * segs_x;
  if (total >= (1LL << 31) || (long long)ranges * segs_per_range < total)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // Two blocks an SM need 96 KB of shared memory: ask for the largest carveout.
  err = cudaFuncSetAttribute(wgrad_f32_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(4 * ci / kBM, co / kBN, ranges);
  wgrad_f32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      o1, dr, partial, h, w, ci, co, segs_x, (int)total, segs_per_range, flush_segs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = co * ci * 4;
  reduce_partials_f32_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, out, ranges, ci, co);
  return (int)cudaGetLastError();
}

}  // extern "C"

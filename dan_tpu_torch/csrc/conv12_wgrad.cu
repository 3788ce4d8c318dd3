// Weight gradient of the packed conv1_2' for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dan_tpu/ops/conv12_wgrad_pallas.py::_kernel
// (wrapper conv12_wgrad_pallas, relu_input=True) and computes
//
//   dW[(kh, kw, gi), go] = sum_{b, y, x} relu(o1)[b, y-1+kh, x-1+kw, gi]
//                                        * dr[b, y, x, go]
//
// for the SAME-padded 2x2 conv over the phase grid: o1 (B, H, W, CI) is the
// pre-relu conv1_1' output, dr (B, H+1, W+1, CO) the cotangent of the conv
// output, both bf16 and channels-last (NHWC) in memory; taps that fall
// outside o1 read zero.  The result is written in the port's OIHW layout,
// out[go, gi, kh, kw], float32.
//
// What bounds it: tensor-core arithmetic.  It is a GEMM with M = 4*CI =
// 1024, N = CO = 256 and K = B*(H+1)*(W+1) (3.3 M at B = 32, 640^2):
// 1.73 TFLOP, about 1.75 ms at the bf16 peak, against 3.4 GB of operands.
// The A operand (the shifted, relu'd o1) is never materialised:
//   * a block owns a 128 x 128 tile of dW (one tap (kh, kw) and 128 input
//     channels, by 128 output channels) and a contiguous range of K, the
//     flattened (b, y, x) pixels of dr (split-K: the grid's z);
//   * per step it stages 32 pixels of both operands in shared memory with
//     16-byte loads, applying the relu and the zero padding as it loads o1;
//   * eight warps multiply the staged tiles with bf16 WMMA (mma.sync) into
//     float32 accumulators;
//   * each split writes its own float32 partial, and a second kernel sums
//     the partials in a fixed order while it transposes to OIHW.
// No float atomics, so two runs give the same bits.  The blocks of one
// split run side by side (the tile index is the fastest grid dimension), so
// the eight tap/channel tiles that read the same pixels of dr find them in
// L2.  This is the simple first design; a TMA + wgmma pipeline comes later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;  // rows of dW per block: (tap, gi)
constexpr int kBN = 128;  // columns of dW per block: go
constexpr int kBK = 32;   // pixels per step
constexpr int kThreads = 256;
constexpr int kLdA = kBM + 8;  // shared row pitch (bf16), keeps 32-B alignment
constexpr int kLdB = kBN + 8;

__device__ __forceinline__ uint4 relu_bf16x8(uint4 v) {
  uint32_t *w = reinterpret_cast<uint32_t *>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // Two bf16 per word: zero each half whose sign bit is set.
    uint32_t x = w[k];
    if (x & 0x8000u) x &= 0xffff0000u;
    if (x & 0x80000000u) x &= 0x0000ffffu;
    w[k] = x;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const __nv_bfloat16 *__restrict__ o1,  // (B, H, W, CI)
             const __nv_bfloat16 *__restrict__ dr,  // (B, H+1, W+1, CO)
             float *__restrict__ partial,           // (S, 4*CI, CO)
             int h, int w, int ci, int co, int k_total, int k_per_split) {
  __shared__ __align__(128) __nv_bfloat16 sa[kBK][kLdA];
  __shared__ __align__(128) __nv_bfloat16 sb[kBK][kLdB];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int tap = m0 / ci, gi0 = m0 % ci;
  const int kh = tap >> 1, kw = tap & 1;
  const int w1 = w + 1;
  const int hw1 = (h + 1) * w1;
  const int k_begin = split * k_per_split;
  const int k_end = min(k_total, k_begin + k_per_split);

  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 64;  // 2 x 4 warps, each 64 x 32 of the tile
  const int wn = (warp & 3) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int kb = k_begin; kb < k_end; kb += kBK) {
    // Stage 32 pixels x 128 channels of each operand: 512 16-byte vectors
    // each, two per thread.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = tid + r * kThreads;
      const int p = v >> 4, c = (v & 15) * 8;
      const int k = kb + p;
      uint4 av = make_uint4(0, 0, 0, 0), bv = make_uint4(0, 0, 0, 0);
      if (k < k_end) {
        const int b = k / hw1, rem = k - b * hw1;
        const int y = rem / w1, x = rem - y * w1;
        const int sy = y - 1 + kh, sx = x - 1 + kw;
        if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
          const size_t off = (((size_t)b * h + sy) * w + sx) * ci + gi0 + c;
          av = relu_bf16x8(*reinterpret_cast<const uint4 *>(o1 + off));
        }
        bv = *reinterpret_cast<const uint4 *>(dr + (size_t)k * co + n0 + c);
      }
      *reinterpret_cast<uint4 *>(&sa[p][c]) = av;
      *reinterpret_cast<uint4 *>(&sb[p][c]) = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A is M x K with M contiguous in shared memory: col_major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &sa[kk][wm + i * 16], kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sb[kk][wn + j * 16], kLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float *out = partial + (size_t)split * 4 * ci * co;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + (size_t)(m0 + wm + i * 16) * co + n0 + wn + j * 16, acc[i][j],
          co, wmma::mem_row_major);
}

// out[go, gi, kh, kw] = sum over splits, in split order, of
// partial[s, (kh*2 + kw)*CI + gi, go].
__global__ void reduce_kernel(const float *__restrict__ partial,
                              float *__restrict__ out, int splits, int ci,
                              int co) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= co * ci * 4) return;
  const int tap = i & 3;  // kh*2 + kw
  const int gi = (i >> 2) % ci;
  const int go = (i >> 2) / ci;
  const size_t m = (size_t)tap * ci + gi;
  const size_t stride = (size_t)4 * ci * co;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * stride + m * co + go];
  out[i] = s;
}

}  // namespace

extern "C" {

// o1 (B, H, W, CI), dr (B, H+1, W+1, CO) bf16 contiguous; partial holds
// splits * 4*CI*CO floats; out (CO, CI, 2, 2) float.  CI and CO must be
// multiples of 128 and B*(H+1)*(W+1) below 2^31.
int conv12_wgrad_launch(const void *o1, const void *dr, float *partial,
                        float *out, int b, int h, int w, int ci, int co,
                        int splits, cudaStream_t stream) {
  if (ci % kBM || co % kBN || splits < 1) return (int)cudaErrorInvalidValue;
  const long long k_total_ll = (long long)b * (h + 1) * (w + 1);
  if (k_total_ll >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int k_total = (int)k_total_ll;
  int k_per_split = (k_total + splits - 1) / splits;
  k_per_split = (k_per_split + kBK - 1) / kBK * kBK;
  dim3 grid(4 * ci / kBM, co / kBN, splits);
  wgrad_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16 *>(o1),
      static_cast<const __nv_bfloat16 *>(dr), partial, h, w, ci, co, k_total,
      k_per_split);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n = co * ci * 4;
  reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, out, splits, ci,
                                                     co);
  return (int)cudaGetLastError();
}

}  // extern "C"

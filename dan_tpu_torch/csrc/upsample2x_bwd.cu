// The gradient of the LFPN's 2x bilinear upsample (half-pixel centres, edge
// clamped) for Hopper (sm_90a): the transpose of the upsample, as a gather.
//
//   g  (P, 2H, 2W) bf16 or float32, the gradient of the upsampled map
//      (P = N * C planes of a contiguous NCHW tensor)
//   gx (P, H, W) in g's dtype:
//     along H:  t[i]  = ((0.25 e0 + 0.75 o0) + 0.75 e1) + 0.25 o1
//               with e0 = g[2i - 1], o0 = g[2i], e1 = g[2i + 1], o1 = g[2i + 2]
//               and the row indices clamped to [0, 2H - 1];
//     along W:  the same over t's columns 2j - 1 .. 2j + 2;
//     then one round to nearest even into the dtype.
//
// It replaces no Pallas kernel: in the JAX package the upsample is
// jax.image.resize (dan_tpu/models/layers.py:94-105), whose transpose XLA
// lowers to dense dots, which are deterministic.  ATen's CUDA backward of
// upsample_bilinear2d scatters with atomic adds, so two train steps from one
// state differed in their last bits; this kernel gathers, each output from
// its own clamped 4x4 patch of g, so every sum has one order.  Every product
// and every sum is one float32 operation rounded to nearest (__fmul_rn,
// __fadd_rn; built with -fmad=false), in the order of the plain version
// (ops/upsample_cuda.py::upsample2x_bwd_plain), so the two agree bit for bit.
//
// What bounds it: bytes.  Each g element is read once and each gx element
// written once (4 + 1 elements of traffic an output, 21 operations).  One
// block takes a band of R output rows of one plane: it copies the band's
// 2R + 2 rows of g (one contiguous span) to shared memory with 16-byte loads,
// makes the H pass into a float32 band in shared memory, then the W pass
// straight to the contiguous span of gx.  Neighbouring bands share two rows
// of g, which the L2 holds.  What is left is instruction issue and shared
// memory traffic: a thread makes two neighbouring H-pass columns from paired
// loads (bf16x2 or float2) and two neighbouring outputs from one float4 of
// the band, and walks its elements with no division a step (one element a
// thread, with two integer divisions each, issued about three times the
// instructions and was slower on the card).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Shared memory a block asks for at most: the wrapper's band height keeps
// it under this, so that several blocks share an SM.
constexpr int kBandBytes = 24 * 1024;
constexpr int kMaxBytes = 200 * 1024;  // one row pair of the widest planes

// Two neighbouring elements as float32, and back (each rounded to nearest
// even: __floats2bfloat162_rn rounds as __float2bfloat16_rn does).
__device__ __forceinline__ float2 load2(const float *p) {
  return *reinterpret_cast<const float2 *>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16 *p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(p));
}
__device__ __forceinline__ void store(float *p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16 *p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float *p, float a, float b) {
  *reinterpret_cast<float2 *>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16 *p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162 *>(p) = __floats2bfloat162_rn(a, b);
}

// ((0.25 a + 0.75 b) + 0.75 c) + 0.25 d, each step rounded as PyTorch's
// float32 tensor ops round it.
__device__ __forceinline__ float adjoint4(float a, float b, float c, float d) {
  float s = __fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.75f, b));
  s = __fadd_rn(s, __fmul_rn(0.75f, c));
  return __fadd_rn(s, __fmul_rn(0.25f, d));
}

// Copy n elements from global src to shared dst, where dst sits at the same
// offset modulo 16 bytes as src: scalars up to the first 16-byte boundary,
// 16-byte vectors, scalars after the last one.
template <typename T>
__device__ __forceinline__ void copy_span(T *dst, const T *__restrict__ src, int n) {
  const int head = min(n, (int)(((16 - ((uintptr_t)src & 15)) & 15) / sizeof(T)));
  for (int k = threadIdx.x; k < head; k += kThreads) dst[k] = src[k];
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = (n - head) / kVec;
  const uint4 *s4 = reinterpret_cast<const uint4 *>(src + head);
  uint4 *d4 = reinterpret_cast<uint4 *>(dst + head);
  for (int k = threadIdx.x; k < vecs; k += kThreads) d4[k] = s4[k];
  for (int k = head + vecs * kVec + threadIdx.x; k < n; k += kThreads) dst[k] = src[k];
}

// Walks the (row, column) pairs r * width + c from threadIdx.x in steps of
// kThreads without a division a step.
struct Walk {
  int r, c, dr, dc, width;
  __device__ explicit Walk(int w) : width(w) {
    r = threadIdx.x / w;
    c = threadIdx.x - r * w;
    dr = kThreads / w;
    dc = kThreads - dr * w;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_bwd_kernel(const T *__restrict__ g, T *__restrict__ gx, int h, int w, int band,
                      int bands) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int plane = blockIdx.x / bands;
  const int i0 = (blockIdx.x - plane * bands) * band;
  const int rows = min(band, h - i0);  // output rows of this block
  const int w2 = 2 * w;
  const int lo = max(2 * i0 - 1, 0);                  // first g row the band reads
  const int hi = min(2 * (i0 + rows), 2 * h - 1);     // last
  const T *src = g + ((size_t)plane * 2 * h + lo) * w2;
  // g's rows at the source's alignment (a row is an even number of
  // elements, so column pairs stay aligned), then the float32 band of the H
  // pass on 16 bytes.
  T *gs = reinterpret_cast<T *>(smem + ((uintptr_t)src & 15));
  float *t = reinterpret_cast<float *>(smem + 16 + (size_t)(2 * band + 2) * w2 * sizeof(T));
  t = reinterpret_cast<float *>(((uintptr_t)t + 15) & ~(uintptr_t)15);
  copy_span(gs, src, (hi - lo + 1) * w2);
  __syncthreads();

  // H pass, two neighbouring columns a thread: t[r][k], t[r][k + 1].
  for (Walk at(w); at.r < rows; at.next()) {
    const int i = i0 + at.r;
    const int k = 2 * at.c;
    auto row = [&](int gr) { return load2(gs + (size_t)(gr - lo) * w2 + k); };
    const float2 e0 = row(max(2 * i - 1, 0)), o0 = row(2 * i), e1 = row(2 * i + 1),
                 o1 = row(min(2 * i + 2, 2 * h - 1));
    *reinterpret_cast<float2 *>(t + (size_t)at.r * w2 + k) =
        make_float2(adjoint4(e0.x, o0.x, e1.x, o1.x), adjoint4(e0.y, o0.y, e1.y, o1.y));
  }
  __syncthreads();

  // W pass straight to gx's span of the band's rows.
  T *dst = gx + ((size_t)plane * h + i0) * w;
  if (w % 2 == 0) {
    // Two outputs a thread, j and j + 1, from t[2j - 1 .. 2j + 4].
    for (Walk at(w / 2); at.r < rows; at.next()) {
      const int j = 2 * at.c;
      const float *tr = t + (size_t)at.r * w2;
      const float4 m = *reinterpret_cast<const float4 *>(tr + 2 * j);
      const float left = tr[max(2 * j - 1, 0)], right = tr[min(2 * j + 4, w2 - 1)];
      store2(dst + (size_t)at.r * w + j, adjoint4(left, m.x, m.y, m.z),
             adjoint4(m.y, m.z, m.w, right));
    }
  } else {
    for (Walk at(w); at.r < rows; at.next()) {
      const int j = at.c;
      const float *tr = t + (size_t)at.r * w2;
      store(dst + (size_t)at.r * w + j, adjoint4(tr[max(2 * j - 1, 0)], tr[2 * j], tr[2 * j + 1],
                                                  tr[min(2 * j + 2, w2 - 1)]));
    }
  }
}

// Shared memory of a block of `band` output rows.
size_t smem_bytes(int band, int w, int elem) {
  const size_t w2 = 2 * (size_t)w;
  return 16 + (2 * (size_t)band + 2) * w2 * elem + 16 + (size_t)band * w2 * 4;
}

template <typename T>
int launch(const void *g, void *gx, long long planes, int h, int w, cudaStream_t stream) {
  const int elem = (int)sizeof(T);
  // Rows a band: as many as fit kBandBytes, then evened out over the bands.
  int band = 1;
  while (band < h && smem_bytes(band + 1, w, elem) <= kBandBytes) ++band;
  const int bands = (h + band - 1) / band;
  band = (h + bands - 1) / bands;
  const size_t smem = smem_bytes(band, w, elem);
  if (smem > kMaxBytes || planes * bands > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(upsample2x_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  upsample2x_bwd_kernel<T><<<(unsigned)(planes * bands), kThreads, smem, stream>>>(
      static_cast<const T *>(g), static_cast<T *>(gx), h, w, band, bands);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest output row the kernel takes (one band row must fit kMaxBytes).
int upsample2x_bwd_max_w(int elem_bytes) {
  int w = 1;
  while (smem_bytes(1, w + 1, elem_bytes) <= kMaxBytes) ++w;
  return w;
}

// g (planes, 2h, 2w) and gx (planes, h, w), contiguous, elem_bytes 2 (bf16)
// or 4 (float32).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int upsample2x_bwd_launch(const void *g, void *gx, long long planes, int h, int w,
                          int elem_bytes, cudaStream_t stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 2) return launch<__nv_bfloat16>(g, gx, planes, h, w, stream);
  if (elem_bytes == 4) return launch<float>(g, gx, planes, h, w, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

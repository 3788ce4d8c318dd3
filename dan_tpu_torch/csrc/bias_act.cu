// Bias (+ ReLU) of a convolution's output, in place, in one pass, for
// Hopper (sm_90a): the epilogue of every bf16 or float32 convolution of an
// inference forward (models/layers.py::conv2d_bias_act, vgg.py::phase_pool).
//
//   y    (P, C) bf16 or float32, C fastest (a channels-last activation of P
//        pixels), overwritten
//   bias (C,) float32 or y's dtype
//   y[p, c] = relu?(round_y(float(y[p, c]) + float(round_y(bias[c]))))
//
// It replaces no Pallas kernel: XLA fuses the bias and ReLU into the
// convolution on the TPU.  It replaces ATen's two passes after cuDNN's
// convolution, the broadcast `output.add_(bias)` (off ATen's vectorised
// kernel on a channels-last output) and `F.relu`'s clamp, with their
// arithmetic: one float32 sum rounded to nearest even, then the clamp as
// ATen writes it (a NaN passes, else fmaxf(v, 0)).  Every output equals
// ATen's bit for bit.
//
// The residual variant (`bias_residual_relu_launch`, kernel
// `residual_relu_kernel`) closes a ResNet bottleneck (models/resnet.py):
//
//   r    (P, C) y's dtype and layout, read only
//   y[p, c] = relu(round_y(round_y(float(y[p, c]) + float(round_y(bias[c])))
//                          + float(r[p, c])))
//
// which is ATen's `relu(add(add(y, b), r))`, each sum rounded to y's dtype,
// in one pass of 3 accesses a value in place of ATen's three passes' 7.
//
// What bounds it: bytes, each value read once and written once.  A thread
// takes 16 bytes (8 bf16 or 4 float32 values of one pixel) when C allows
// and y is 16-byte aligned, else one value; neighbouring threads take
// neighbouring chunks, so every access is coalesced.  The grid strides by a
// whole number of pixels, so a thread's channels never change: it reads its
// bias values once, into registers, and loops over the pixels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// bias[c] as `bias.to(y.dtype)` gives it, widened to float32.
template <typename T>
__device__ __forceinline__ float bias_at(const void *bias, int bias_bytes, int c) {
  const float b = bias_bytes == 4 ? static_cast<const float *>(bias)[c]
                                  : __bfloat162float(static_cast<const __nv_bfloat16 *>(bias)[c]);
  return to_float(from_float<T>(b));
}

template <typename T, bool kRelu>
__device__ __forceinline__ T epilogue(T y, float b) {
  const float v = to_float(from_float<T>(__fadd_rn(to_float(y), b)));
  if (!kRelu || isnan(v)) return from_float<T>(v);
  return from_float<T>(fmaxf(v, 0.f));
}

// V consecutive values of y: one 16-byte access when V * sizeof(T) == 16.
template <typename T, int V>
struct Pack {
  static_assert(V == 1 || V * sizeof(T) == 16, "a pack is one value or 16 bytes");
  union {
    uint4 u;
    T h[V];
  } x;
  __device__ __forceinline__ void load(const T *p) {
    if constexpr (V == 1) {
      x.h[0] = *p;
    } else {
      x.u = *reinterpret_cast<const uint4 *>(p);
    }
  }
  __device__ __forceinline__ void store(T *p) const {
    if constexpr (V == 1) {
      *p = x.h[0];
    } else {
      *reinterpret_cast<uint4 *>(p) = x.u;
    }
  }
};

template <typename T, int V, bool kRelu>
__device__ __forceinline__ void apply(Pack<T, V> &p, const float (&b)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) p.x.h[k] = epilogue<T, kRelu>(p.x.h[k], b[k]);
}

// Thread t takes packs t, t + step, ...; step * V is a multiple of c (the
// launch makes it so), so its channels are (t * V) % c + 0 .. V-1 for good.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(T *__restrict__ y, const void *__restrict__ bias, int bias_bytes, int c,
                long long packs) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= packs) return;
  const long long step = (long long)gridDim.x * kThreads;
  const int c0 = (int)((t * V) % c);
  float b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) b[k] = bias_at<T>(bias, bias_bytes, c0 + k);
  long long i = t;
  // Two packs in flight a thread, then the odd one.
  for (; i + step < packs; i += 2 * step) {
    Pack<T, V> p0, p1;
    p0.load(y + i * V);
    p1.load(y + (i + step) * V);
    apply<T, V, kRelu>(p0, b);
    apply<T, V, kRelu>(p1, b);
    p0.store(y + i * V);
    p1.store(y + (i + step) * V);
  }
  if (i < packs) {
    Pack<T, V> p;
    p.load(y + i * V);
    apply<T, V, kRelu>(p, b);
    p.store(y + i * V);
  }
}

template <typename T>
__device__ __forceinline__ T residual_epilogue(T y, float b, T r) {
  const float s = to_float(from_float<T>(__fadd_rn(to_float(y), b)));
  const float v = to_float(from_float<T>(__fadd_rn(s, to_float(r))));
  if (isnan(v)) return from_float<T>(v);
  return from_float<T>(fmaxf(v, 0.f));
}

template <typename T, int V>
__device__ __forceinline__ void apply_residual(Pack<T, V> &p, const Pack<T, V> &r,
                                               const float (&b)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) p.x.h[k] = residual_epilogue<T>(p.x.h[k], b[k], r.x.h[k]);
}

// bias_act_kernel's walk with the residual r read beside y.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
residual_relu_kernel(T *__restrict__ y, const T *__restrict__ r, const void *__restrict__ bias,
                     int bias_bytes, int c, long long packs) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= packs) return;
  const long long step = (long long)gridDim.x * kThreads;
  const int c0 = (int)((t * V) % c);
  float b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) b[k] = bias_at<T>(bias, bias_bytes, c0 + k);
  long long i = t;
  for (; i + step < packs; i += 2 * step) {
    Pack<T, V> p0, p1, r0, r1;
    p0.load(y + i * V);
    p1.load(y + (i + step) * V);
    r0.load(r + i * V);
    r1.load(r + (i + step) * V);
    apply_residual<T, V>(p0, r0, b);
    apply_residual<T, V>(p1, r1, b);
    p0.store(y + i * V);
    p1.store(y + (i + step) * V);
  }
  if (i < packs) {
    Pack<T, V> p, q;
    p.load(y + i * V);
    q.load(r + i * V);
    apply_residual<T, V>(p, q, b);
    p.store(y + i * V);
  }
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// Blocks of a launch over `packs` packs of V values, c channels a pixel:
// at most kBlocksPerSm an SM, rounded up so that the grid's threads are a
// whole number of pixels; 0 after an error, which *err holds.
template <int V>
long long grid_blocks(int c, long long packs, int *err) {
  // Packs a pixel's channels fill; the grid's threads must be a multiple.
  const long long per_pixel = c / V;
  const long long unit = per_pixel / gcd(per_pixel, kThreads);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    *err = (int)cudaGetLastError();
    return 0;
  }
  long long blocks = (packs + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm) blocks = (long long)sms * kBlocksPerSm;
  blocks = (blocks + unit - 1) / unit * unit;
  if (blocks > 0x7fffffffLL) {
    *err = (int)cudaErrorInvalidConfiguration;
    return 0;
  }
  return blocks;
}

template <typename T, int V>
int launch(T *y, const void *bias, int bias_bytes, int c, long long n, bool relu,
           cudaStream_t stream) {
  const long long packs = n / V;
  int err = 0;
  const long long blocks = grid_blocks<V>(c, packs, &err);
  if (err) return err;
  if (relu) {
    bias_act_kernel<T, V, true><<<(unsigned)blocks, kThreads, 0, stream>>>(y, bias, bias_bytes,
                                                                           c, packs);
  } else {
    bias_act_kernel<T, V, false><<<(unsigned)blocks, kThreads, 0, stream>>>(y, bias, bias_bytes,
                                                                            c, packs);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void *y, const void *bias, int bias_bytes, int c, long long n, bool relu,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  T *p = static_cast<T *>(y);
  if (c % kVec == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0)
    return launch<T, kVec>(p, bias, bias_bytes, c, n, relu, stream);
  return launch<T, 1>(p, bias, bias_bytes, c, n, relu, stream);
}

template <typename T, int V>
int launch_residual(T *y, const T *r, const void *bias, int bias_bytes, int c, long long n,
                    cudaStream_t stream) {
  const long long packs = n / V;
  int err = 0;
  const long long blocks = grid_blocks<V>(c, packs, &err);
  if (err) return err;
  residual_relu_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(y, r, bias, bias_bytes, c,
                                                                       packs);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_residual(void *y, const void *r, const void *bias, int bias_bytes, int c,
                      long long n, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  T *p = static_cast<T *>(y);
  const T *q = static_cast<const T *>(r);
  if (c % kVec == 0 && (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(r)) % 16 == 0)
    return launch_residual<T, kVec>(p, q, bias, bias_bytes, c, n, stream);
  return launch_residual<T, 1>(p, q, bias, bias_bytes, c, n, stream);
}

}  // namespace

extern "C" {

// y (n / c, c) with elem_bytes 2 (bf16) or 4 (float32), contiguous; bias
// (c,) with bias_bytes 4 (float32) or elem_bytes; relu 0 or 1.  Works in
// place on y.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int bias_act_launch(void *y, const void *bias, long long n, int c, int elem_bytes, int bias_bytes,
                    int relu, cudaStream_t stream) {
  if (c <= 0 || n % c || (bias_bytes != 4 && bias_bytes != elem_bytes))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (elem_bytes == 2)
    return dispatch<__nv_bfloat16>(y, bias, bias_bytes, c, n, relu != 0, stream);
  if (elem_bytes == 4) return dispatch<float>(y, bias, bias_bytes, c, n, relu != 0, stream);
  return (int)cudaErrorInvalidValue;
}

// y and r (n / c, c) of one dtype (elem_bytes 2 or 4), contiguous and not
// overlapping; bias as bias_act_launch's.  y = relu((y + bias) + r) in
// place.  Launches on `stream` and returns cudaGetLastError().
int bias_residual_relu_launch(void *y, const void *r, const void *bias, long long n, int c,
                              int elem_bytes, int bias_bytes, cudaStream_t stream) {
  if (c <= 0 || n % c || (bias_bytes != 4 && bias_bytes != elem_bytes))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (elem_bytes == 2)
    return dispatch_residual<__nv_bfloat16>(y, r, bias, bias_bytes, c, n, stream);
  if (elem_bytes == 4) return dispatch_residual<float>(y, r, bias, bias_bytes, c, n, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

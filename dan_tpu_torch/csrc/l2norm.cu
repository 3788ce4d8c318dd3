// L2Norm of a channels-last tap over its channels, in one pass, for Hopper
// (sm_90a): the normalisation of DAN's three shallow taps in every
// inference forward on the card (models/layers.py::L2Norm).
//
//   x     (P, C) bf16 or float32, C fastest (a channels-last tap of P
//         pixels), read only
//   scale (C,) float32
//   out   (P, C) x's dtype
//   s[p]      = sum_c round_f32(float(x[p, c]) * float(x[p, c]))
//   out[p, c] = round_x(round_f32(float(x[p, c]) * rsqrtf(s[p] + eps)) * scale[c])
//
// It replaces no Pallas kernel: XLA fuses L2Norm into one loop on the TPU.
// It replaces ATen's six passes over every value of the tap, with float32
// tensors between them: `x.float()`, `xf * xf`, `.sum(dim=1)`, `xf * norm`,
// `* scale` and `.to(x.dtype)`, about 40 bytes moved a value.  Its
// arithmetic is theirs, operation by operation (float32 products and sums
// rounded to nearest even, `-fmad=false`; rsqrtf, which is what ATen's CUDA
// rsqrt calls for a float; the final round to x's dtype), except the order
// of the sum's terms, which is fixed: each lane sums its own values in
// channel order, then the lanes of a pixel add by a butterfly of shuffles,
// so every lane ends with the same sum and every run gives the same bits.
// NaN and inf propagate as in ATen's expression; an all-zero pixel gives 0.
//
// What bounds it: bytes, each value read once and written once (a pixel's
// squares, its norm and its products stay in registers).  The vector path
// (C a multiple of 16 bytes, x 16-byte aligned) gives each pixel a group of
// lanes (a whole warp for C >= 256 bf16 / 128 float32) that load 16 bytes
// each, K packs a lane, and keeps PIX pixels a group in flight, so that a
// thread has 64 bytes of loads outstanding before its first shuffle.  The
// grid is persistent and strides by whole groups, so a lane's channels
// never change: it reads its scale values once, into registers.  Any other
// C or alignment takes the scalar path: a warp a pixel, one value a lane at
// a time, the pixel read twice (the second time from L1 or L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// 16 bytes of one pixel: 8 bf16 or 4 float32 values.
template <typename T>
struct Pack {
  static constexpr int V = 16 / sizeof(T);
  union {
    uint4 u;
    T h[V];
  };
};

// The sum over the `lanes` lanes of each aligned group (a power of two up
// to 32): a butterfly, so every lane of the group gets the same bits.
__device__ __forceinline__ float group_sum(float s, int lanes) {
  for (int m = lanes >> 1; m > 0; m >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, m));
  return s;
}

// Vector path.  A group of `lanes` lanes takes a pixel; lane `sub` of it
// takes packs sub, sub + lanes, ... (K of them, those past the pixel's
// packs masked).  A warp takes groups_per_warp * PIX neighbouring pixels an
// iteration; the loop bound is the same for every lane of a warp, so the
// shuffles see the whole warp.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
l2norm_kernel(const T *__restrict__ x, const float *__restrict__ scale, T *__restrict__ out,
              long long pixels, int c, int lanes, float eps) {
  constexpr int V = Pack<T>::V;
  constexpr int PIX = K >= 4 ? 1 : 4 / K;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int groups = 32 / lanes;
  const int group = lane / lanes;
  const int packs = c / V;
  float sc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = sub + k * lanes;
#pragma unroll
    for (int v = 0; v < V; ++v) sc[k][v] = j < packs ? scale[j * V + v] : 0.f;
  }
  const long long per_warp = (long long)groups * PIX;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long step = ((long long)gridDim.x * kThreads >> 5) * per_warp;
  for (long long base = warp * per_warp; base < pixels; base += step) {
    Pack<T> d[PIX][K];
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const long long p = base + (long long)i * groups + group;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = sub + k * lanes;
        if (p < pixels && j < packs) {
          d[i][k].u = *reinterpret_cast<const uint4 *>(x + p * c + (long long)j * V);
        } else {
          d[i][k].u = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float n[PIX];
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xv = to_float(d[i][k].h[v]);
          s = __fadd_rn(s, __fmul_rn(xv, xv));
        }
      }
      n[i] = s;
    }
#pragma unroll
    for (int i = 0; i < PIX; ++i) n[i] = rsqrtf(__fadd_rn(group_sum(n[i], lanes), eps));
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const long long p = base + (long long)i * groups + group;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = sub + k * lanes;
        if (p < pixels && j < packs) {
          Pack<T> o;
#pragma unroll
          for (int v = 0; v < V; ++v)
            o.h[v] = from_float<T>(__fmul_rn(__fmul_rn(to_float(d[i][k].h[v]), n[i]), sc[k][v]));
          *reinterpret_cast<uint4 *>(out + p * c + (long long)j * V) = o.u;
        }
      }
    }
  }
}

// Scalar path: any C and alignment, a warp a pixel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
l2norm_kernel_scalar(const T *__restrict__ x, const float *__restrict__ scale,
                     T *__restrict__ out, long long pixels, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kThreads >> 5;
  for (long long p = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5; p < pixels;
       p += warps) {
    const T *row = x + p * c;
    float s = 0.f;
    for (int ch = lane; ch < c; ch += 32) {
      const float xv = to_float(row[ch]);
      s = __fadd_rn(s, __fmul_rn(xv, xv));
    }
    const float n = rsqrtf(__fadd_rn(group_sum(s, 32), eps));
    for (int ch = lane; ch < c; ch += 32)
      out[p * c + ch] = from_float<T>(__fmul_rn(__fmul_rn(to_float(row[ch]), n), scale[ch]));
  }
}

// Blocks of a persistent launch of `kernel`: as many as fit on the card at
// once, no more than `units` (a block's warps each take one unit of work).
template <typename F>
int persistent_blocks(F kernel, long long units, long long *blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long need = (units + kThreads / 32 - 1) / (kThreads / 32);
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = need < most ? need : most;
  return 0;
}

template <typename T, int K>
int launch_vector(const T *x, const float *scale, T *out, long long pixels, int c, int lanes,
                  float eps, cudaStream_t stream) {
  constexpr int PIX = K >= 4 ? 1 : 4 / K;
  const long long per_warp = (long long)(32 / lanes) * PIX;
  long long blocks = 0;
  const int err = persistent_blocks(l2norm_kernel<T, K>, (pixels + per_warp - 1) / per_warp,
                                    &blocks);
  if (err) return err;
  l2norm_kernel<T, K><<<(unsigned)blocks, kThreads, 0, stream>>>(x, scale, out, pixels, c, lanes,
                                                                 eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void *xv, const float *scale, void *outv, long long pixels, int c, float eps,
             cudaStream_t stream) {
  constexpr int V = Pack<T>::V;
  const T *x = static_cast<const T *>(xv);
  T *out = static_cast<T *>(outv);
  const int packs = c / V;
  if (c % V == 0 && packs <= 32 * 8 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0) {
    int lanes = 1;
    while (lanes < packs && lanes < 32) lanes <<= 1;
    const int k = (packs + lanes - 1) / lanes;
    if (k == 1) return launch_vector<T, 1>(x, scale, out, pixels, c, lanes, eps, stream);
    if (k == 2) return launch_vector<T, 2>(x, scale, out, pixels, c, lanes, eps, stream);
    if (k <= 4) return launch_vector<T, 4>(x, scale, out, pixels, c, lanes, eps, stream);
    return launch_vector<T, 8>(x, scale, out, pixels, c, lanes, eps, stream);
  }
  long long blocks = 0;
  const int err = persistent_blocks(l2norm_kernel_scalar<T>, pixels, &blocks);
  if (err) return err;
  l2norm_kernel_scalar<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, scale, out, pixels, c,
                                                                     eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x and out (pixels, c), contiguous and not overlapping, elem_bytes 2
// (bf16) or 4 (float32); scale (c,) float32.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int l2norm_launch(const void *x, const float *scale, void *out, long long pixels, int c,
                  int elem_bytes, float eps, cudaStream_t stream) {
  if (c <= 0 || pixels < 0) return (int)cudaErrorInvalidValue;
  if (pixels == 0) return 0;
  if (elem_bytes == 2)
    return dispatch<__nv_bfloat16>(x, scale, out, pixels, c, eps, stream);
  if (elem_bytes == 4) return dispatch<float>(x, scale, out, pixels, c, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

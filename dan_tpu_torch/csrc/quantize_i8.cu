// relu + symmetric int8 quantization of a channels-last activation, for
// Hopper (sm_90a): the input of the int8 body (quant.py's conv1 block).
//
//   y   (P, C) bf16 or float32, C fastest (an NHWC tensor of P pixels)
//   inv (C,) float32, the reciprocal of the per-channel activation scale
//   q[p, c] = clip(rint(max(y[p, c], 0) * inv[c]), -127, 127)   s8
//
// It replaces no Pallas kernel: in dan_tpu/quant.py XLA fuses the relu of
// conv1_1' and _quantize_act (:383-394, or :400-404 on odd sizes) into one
// pass.  Done with PyTorch operations the same function takes a float32
// copy and four passes over it: at batch 128 the conv1_1' output is 3.4 G
// elements, and those passes move about 150 GB.
//
// What bounds it: bytes (2 or 4 read and 1 written an element, a multiply
// and a round each).  A thread takes 8 channels of one pixel: one 16-byte
// (bf16) or two 16-byte (float32) loads and one 8-byte store; neighbouring
// threads take neighbouring channel chunks, so every access is coalesced.
// The arithmetic is the plain version's, float32, rounded to nearest with
// ties to even (__fmul_rn, __float2int_rn): the result is bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // channels a thread

__device__ __forceinline__ int8_t quantize(float y, float inv) {
  const float r = y > 0.f ? y : 0.f;
  const int q = __float2int_rn(__fmul_rn(r, inv));
  return (int8_t)min(max(q, -127), 127);
}

__device__ __forceinline__ void load8(const __nv_bfloat16 *p, float (&v)[kVec]) {
  union {
    uint4 u;
    __nv_bfloat16 h[kVec];
  } x;
  x.u = *reinterpret_cast<const uint4 *>(p);
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = __bfloat162float(x.h[i]);
}

__device__ __forceinline__ void load8(const float *p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4 *>(p)[0];
  const float4 b = reinterpret_cast<const float4 *>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_i8_kernel(const T *__restrict__ y, const float *__restrict__ inv,
                   int8_t *__restrict__ q, int c_chunks, long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c0 = (int)(i % c_chunks) * kVec;
  float v[kVec];
  load8(y + i * kVec, v);
  union {
    uint2 u;
    int8_t b[kVec];
  } out;
#pragma unroll
  for (int k = 0; k < kVec; ++k) out.b[k] = quantize(v[k], inv[c0 + k]);
  reinterpret_cast<uint2 *>(q)[i] = out.u;
}

}  // namespace

extern "C" {

// y (pixels, c) with elem_bytes 2 (bf16) or 4 (float32), inv (c,) float32,
// q (pixels, c) s8; contiguous and 16-byte aligned, c % 8 == 0.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int quantize_i8_launch(const void *y, const void *inv, void *q, long long pixels, int c,
                       int elem_bytes, cudaStream_t stream) {
  if (c % kVec) return (int)cudaErrorInvalidValue;
  const int c_chunks = c / kVec;
  const long long total = pixels * c_chunks;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (elem_bytes == 2) {
    quantize_i8_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16 *>(y), static_cast<const float *>(inv),
        static_cast<int8_t *>(q), c_chunks, total);
  } else if (elem_bytes == 4) {
    quantize_i8_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float *>(y), static_cast<const float *>(inv),
        static_cast<int8_t *>(q), c_chunks, total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

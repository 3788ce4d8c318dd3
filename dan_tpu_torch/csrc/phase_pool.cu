// Backward of the phase-packed pool1 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dan_tpu/ops/phase_pool_pallas.py::_kernel
// (wrapper phase_pool_bwd_pallas) and computes what the JAX package's XLA
// assembly models/vgg.py::_phase_pool_bwd_xla computes: the pool1
// cotangent g (B, H, W, C) is routed into the cotangent of the packed
// conv1_2' output (B, H+1, W+1, 4C),
//
//   gr[b, y, x, go*C + c] = g[b, y-py, x-px, c]   if win[b, y-py, x-px, c] == go
//                                                  and that pixel exists,
//                           0                      otherwise,
//
// with go = py*2 + px.  win is the uint8 index of the first phase that
// reached the max in the forward, 255 where the relu clamped (never equal
// to a group, so it routes nothing).  Both tensors are channels-last in
// memory, as the port's activations are.
//
// What bounds it: bytes.  At B = 32 it writes 1.69 GB and reads 0.63 GB,
// about 0.7 ms at 3.35 TB/s; there is no arithmetic.  So each thread moves
// 16 bytes: 8 channels of one output pixel of one group, read as one
// 16-byte load of g (bf16) and one 8-byte load of win, written as one
// 16-byte store.  Neighbouring threads take neighbouring channel chunks, so
// loads and stores are coalesced.  The TPU kernel's VMEM row carry and its
// batch blocking answer the TPU's sequential grid and scoped VMEM; a
// Hopper grid runs in parallel and needs neither.
//
// The routing copies bits (or writes +0.0), so the result is bit-identical
// to the plain version for any element type; the kernel is generic over
// the element size (2 bytes for bf16/f16, 4 for f32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // channels per thread

struct alignas(32) Vec32 {
  uint4 lo, hi;
};

// E: the element as an unsigned integer of its size; V: kVec elements as
// one vector (uint4 for 2-byte elements, Vec32 for 4-byte ones).
template <typename E, typename V>
__global__ void __launch_bounds__(kThreads)
phase_pool_bwd_kernel(const V *__restrict__ g,         // (B, H, W, C)
                      const uint2 *__restrict__ win,   // (B, H, W, C) u8
                      V *__restrict__ gr,              // (B, H+1, W+1, 4C)
                      int h, int w, int c_chunks, long long total) {
  static_assert(sizeof(V) == kVec * sizeof(E), "vector of kVec elements");
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  // i enumerates (b, y, x, go, chunk) of the output, chunk fastest.
  const int chunk = (int)(i % c_chunks);
  long long t = i / c_chunks;
  const int go = (int)(t & 3);
  t >>= 2;
  const int x = (int)(t % (w + 1));
  t /= (w + 1);
  const int y = (int)(t % (h + 1));
  const long long b = t / (h + 1);
  const int sy = y - (go >> 1);
  const int sx = x - (go & 1);
  union {
    V v;
    E e[kVec];
  } out;
#pragma unroll
  for (int k = 0; k < kVec; ++k) out.e[k] = 0;
  if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
    const long long src = ((b * h + sy) * w + sx) * c_chunks + chunk;
    union {
      uint2 v;
      uint8_t b[kVec];
    } wv;
    wv.v = win[src];
    union {
      V v;
      E e[kVec];
    } gv;
    gv.v = g[src];
#pragma unroll
    for (int k = 0; k < kVec; ++k) out.e[k] = wv.b[k] == go ? gv.e[k] : E(0);
  }
  gr[i] = out.v;
}

}  // namespace

extern "C" {

// g, gr: element size elem_bytes (2 or 4); c % 8 == 0; all pointers from
// contiguous tensors (16-byte aligned by the caching allocator).
int phase_pool_bwd_launch(const void *g, const void *win, void *gr, int b,
                          int h, int w, int c, int elem_bytes,
                          cudaStream_t stream) {
  const int c_chunks = c / kVec;
  const long long total = (long long)b * (h + 1) * (w + 1) * 4 * c_chunks;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (elem_bytes == 2) {
    phase_pool_bwd_kernel<uint16_t, uint4><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint4 *>(g), static_cast<const uint2 *>(win),
        static_cast<uint4 *>(gr), h, w, c_chunks, total);
  } else if (elem_bytes == 4) {
    phase_pool_bwd_kernel<uint32_t, Vec32><<<blocks, kThreads, 0, stream>>>(
        static_cast<const Vec32 *>(g), static_cast<const uint2 *>(win),
        static_cast<Vec32 *>(gr), h, w, c_chunks, total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

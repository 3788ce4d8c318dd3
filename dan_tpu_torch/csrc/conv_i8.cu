// s8 x s8 -> s32 convolution with a fused dequant / bias / relu / requant
// epilogue, for Hopper (sm_90a): the int8 body of the quantized detector.
//
// Replaces no Pallas kernel.  On the TPU the JAX package leaves this to XLA:
// dan_tpu/quant.py::_conv_i8 (a conv with preferred_element_type=int32) and
// the elementwise chain XLA fuses into its output (quant.py:396-397 for the
// packed conv1_2', :412-418 for the body convs).  PyTorch has no int8
// convolution on CUDA, so the port writes it.
//
//   x   s8 (B, H, W, Ci), NHWC            k  s8 (Co, kh, kw, Ci)
//   acc[b, oy, ox, co] = sum_{ky, kx, ci} x[b, oy*s - pt + ky*d,
//                                            ox*s - pl + kx*d, ci] * k[co, ky, kx, ci]
//   (a position outside the image reads 0: TF 'SAME' padding, which may be
//   asymmetric: pt/pl before, the rest after)
//   z   = acc * deq[co] + bias[co]            (float32, rounded each step)
//   y   = z > 0 ? z : +0                      (relu)
//   tap = y                                   (float32 or bf16, optional)
//   q   = clip(rint(y * inv_next[co]), -127, 127)   (s8, optional)
//   acc itself as s32 (optional: the check of the integer product)
//
// Every output is bit-identical to the plain version in
// ops/conv_i8.py: the s32 sum is exact in any order (|acc| <= 127 * 127 *
// 4608 = 74.3 M < 2^31 for the largest reduction, fc6), and the epilogue is
// the plain version's float32 operations in its order, with explicit
// round-to-nearest intrinsics (no contraction into a fused multiply-add)
// and rint's ties to even (__float2int_rn).
//
// What bounds it: operations.  At batch 128 and 640x640 the 18 convolutions
// of a forward are about 35.6 T int8 operations (2 per multiply-add), about
// 18 ms at the card's 1,979 TOPS; they move a few GB.  This first design is
// a plain implicit GEMM on the mma.sync tensor-core path:
//   M = B * Ho * Wo output pixels, N = Co, K = kh * kw * Ci.
//   A block computes a 128 x 128 output tile with 8 warps (2 along M x 4
//   along N, 64 x 32 each) from K tiles of 64 bytes:
//   mma.sync.m16n8k32 (s8 x s8 -> s32) on fragments read with ldmatrix.
//   The operands stream through a 4-stage cp.async ring of 16-byte chunks
//   in shared memory; each chunk of A is the 16 channels of one input pixel
//   of one tap (Ci % 16 == 0), so the im2col gather is the address of the
//   copy and padding is a copy of 0 source bytes (zero fill).  Rows of 64
//   bytes are swizzled (chunk ^ ((row >> 1) & 3)) so that ldmatrix reads
//   eight rows without bank conflicts.
// wgmma with s8, TMA and a persistent schedule are left for a later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // output pixels a block
constexpr int kBN = 128;     // output channels a block
constexpr int kBK = 64;      // reduction bytes a stage
constexpr int kStages = 4;   // cp.async ring depth
constexpr int kThreads = 256;
constexpr int kWarpM = 64;   // a warp's tile: 64 x 32
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16;  // m16 tiles a warp
constexpr int kNT = kWarpN / 8;   // n8 tiles a warp
constexpr int kTileBytes = kBM * kBK;  // A (and B) bytes a stage
constexpr int kSmemBytes = kStages * 2 * kTileBytes;

enum TapKind { kTapNone = 0, kTapF32 = 1, kTapBF16 = 2 };

struct Params {
  const int8_t *x;
  const int8_t *k;
  const float *deq;
  const float *bias;
  const float *inv_next;
  void *tap;
  int8_t *q;
  int32_t *acc;
  int tap_kind;
  int b, h, w, ci, co, kh, kw, stride, dil, pt, pl, ho, wo;
  int m, kdim;  // M = b*ho*wo, K = kh*kw*ci
};

// Byte offset of 16-byte chunk `chunk` (0..3) of row `row` in a stage tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kBK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void *src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t &r0, uint32_t &r1,
                                            uint32_t &r2, uint32_t &r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output element's epilogue, in the plain version's order.
struct Out {
  float y;
  int q;
};

__device__ __forceinline__ Out epilogue(int32_t acc, float deq, float bias, float inv) {
  const float z = __fadd_rn(__fmul_rn(__int2float_rn(acc), deq), bias);
  const float y = z > 0.f ? z : 0.f;
  int q = __float2int_rn(__fmul_rn(y, inv));
  q = min(max(q, -127), 127);
  return {y, q};
}

__global__ void __launch_bounds__(kThreads)
conv_i8_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t smem_base = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 1;   // 2 warps along M
  const int warp_n = warp >> 1;  // 4 warps along N

  const int n_tiles = (p.co + kBN - 1) / kBN;
  const int m0 = (int)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (int)(blockIdx.x % n_tiles) * kBN;

  // The rows this thread copies: r and r + 64 of the A and B tiles, its
  // 16-byte chunk `lc` of each 64-byte row.
  const int lr = tid >> 2;
  const int lc = tid & 3;
  long long a_base[2];
  int a_iy[2], a_ix[2];
  bool a_ok[2];
  const int hw_out = p.ho * p.wo;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + lr + i * 64;
    a_ok[i] = m < p.m;
    const int mm = a_ok[i] ? m : 0;
    const int bb = mm / hw_out;
    const int rem = mm - bb * hw_out;
    const int oy = rem / p.wo;
    const int ox = rem - oy * p.wo;
    a_base[i] = (long long)bb * p.h * p.w;
    a_iy[i] = oy * p.stride - p.pt;
    a_ix[i] = ox * p.stride - p.pl;
  }
  const int8_t *b_row[2];
  bool b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + lr + i * 64;
    b_ok[i] = n < p.co;
    b_row[i] = p.k + (long long)(b_ok[i] ? n : 0) * p.kdim;
  }

  auto load_stage = [&](int stage, int kt) {
    const uint32_t a_dst = smem_base + stage * 2 * kTileBytes;
    const uint32_t b_dst = a_dst + kTileBytes;
    const int kk = kt * kBK + lc * 16;
    const bool k_ok = kk < p.kdim;
    int ci = 0, ky = 0, kx = 0;
    if (k_ok) {
      const int tap = kk / p.ci;
      ci = kk - tap * p.ci;
      ky = tap / p.kw;
      kx = tap - ky * p.kw;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lr + i * 64;
      const int iy = a_iy[i] + ky * p.dil;
      const int ix = a_ix[i] + kx * p.dil;
      const bool ok = k_ok && a_ok[i] && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
      const int8_t *src = ok ? p.x + ((a_base[i] + (long long)iy * p.w + ix) * p.ci + ci) : p.x;
      cp_async16(a_dst + swz(row, lc), src, ok ? 16 : 0);
      const bool okb = k_ok && b_ok[i];
      cp_async16(b_dst + swz(row, lc), okb ? b_row[i] + kk : p.k, okb ? 16 : 0);
    }
  };

  int32_t acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int k_tiles = (p.kdim + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    {
      const int nk = kt + kStages - 1;
      if (nk < k_tiles) load_stage(nk % kStages, nk);
      cp_async_commit();
    }
    const uint32_t a_tile = smem_base + (kt % kStages) * 2 * kTileBytes;
    const uint32_t b_tile = a_tile + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[kMT][4];
      uint32_t bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // Matrices: rows 0-7 / 8-15 at bytes 0-15, then at bytes 16-31.
        const int row = warp_m * kWarpM + i * 16 + (lane & 15);
        const int chunk = ks * 2 + (lane >> 4);
        ldmatrix_x4(a_tile + swz(row, chunk), af[i][0], af[i][1], af[i][2], af[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        // Matrices: n 0-7 at bytes 0-15 and 16-31, then n 8-15.
        const int row = warp_n * kWarpN + j * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int chunk = ks * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(b_tile + swz(row, chunk), bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from the accumulator fragments: thread (g, t) of a
  // m16n8 tile holds rows g and g + 8, columns 2t and 2t + 1.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n0 + warp_n * kWarpN + j * 8 + 2 * t;
    if (n >= p.co) continue;  // Co % 8 == 0: n + 1 < Co whenever n < Co
    const float deq0 = p.deq[n], deq1 = p.deq[n + 1];
    const float bias0 = p.bias[n], bias1 = p.bias[n + 1];
    const float inv0 = p.inv_next ? p.inv_next[n] : 0.f;
    const float inv1 = p.inv_next ? p.inv_next[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + warp_m * kWarpM + i * 16 + g + half * 8;
        if (m >= p.m) continue;
        const long long o = (long long)m * p.co + n;
        const int32_t a0 = acc[i][j][half * 2], a1 = acc[i][j][half * 2 + 1];
        if (p.acc) *reinterpret_cast<int2 *>(p.acc + o) = make_int2(a0, a1);
        const Out e0 = epilogue(a0, deq0, bias0, inv0);
        const Out e1 = epilogue(a1, deq1, bias1, inv1);
        if (p.tap_kind == kTapF32) {
          *reinterpret_cast<float2 *>(static_cast<float *>(p.tap) + o) = make_float2(e0.y, e1.y);
        } else if (p.tap_kind == kTapBF16) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(e0.y);
          v.y = __float2bfloat16_rn(e1.y);
          *reinterpret_cast<__nv_bfloat162 *>(static_cast<__nv_bfloat16 *>(p.tap) + o) = v;
        }
        if (p.q) {
          char2 v;
          v.x = (char)e0.q;
          v.y = (char)e1.q;
          *reinterpret_cast<char2 *>(p.q + o) = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a block asks for (ptxas reports static memory only).
int conv_i8_smem_bytes() { return kSmemBytes; }

// x (b, h, w, ci) and k (co, kh, kw, ci) s8, deq / bias / inv_next f32 (co,),
// all contiguous and 16-byte aligned; ci % 32 == 0, co % 8 == 0.  Outputs
// (b, ho, wo, co), each optional (a null pointer, or tap_kind 0): tap in
// float32 (tap_kind 1) or bf16 (2), q s8 (needs inv_next), acc s32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int conv_i8_launch(const void *x, const void *k, const void *deq, const void *bias,
                   const void *inv_next, void *tap, int tap_kind, void *q, void *acc, int b,
                   int h, int w, int ci, int co, int kh, int kw, int stride, int dil, int pt,
                   int pl, int ho, int wo, cudaStream_t stream) {
  Params p;
  p.x = static_cast<const int8_t *>(x);
  p.k = static_cast<const int8_t *>(k);
  p.deq = static_cast<const float *>(deq);
  p.bias = static_cast<const float *>(bias);
  p.inv_next = static_cast<const float *>(inv_next);
  p.tap = tap;
  p.q = static_cast<int8_t *>(q);
  p.acc = static_cast<int32_t *>(acc);
  p.tap_kind = tap_kind;
  p.b = b, p.h = h, p.w = w, p.ci = ci, p.co = co, p.kh = kh, p.kw = kw;
  p.stride = stride, p.dil = dil, p.pt = pt, p.pl = pl, p.ho = ho, p.wo = wo;
  const long long m = (long long)b * ho * wo;
  if (ci % 32 || co % 8 || m >= (1LL << 31) || (q && !inv_next)) return (int)cudaErrorInvalidValue;
  p.m = (int)m;
  p.kdim = kh * kw * ci;
  if (m == 0) return 0;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long blocks = ((m + kBM - 1) / kBM) * ((co + kBN - 1) / kBN);
  conv_i8_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Weight gradient of the packed conv1_2' for Hopper (sm_90a): TMA loads into
// a shared-memory ring, wgmma from shared memory, one producer warp and two
// consumer warpgroups.
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
// 1024, N = CO = 256 and K = B*H*W pixels for each tap (3.3 M at B = 32,
// 640^2): 1.72 TFLOP, about 1.74 ms at the bf16 peak, against 3.4 GB of
// operands.  Only wgmma reaches that rate, and only if the tensor cores
// never wait for a load.
//
// What the design does about it:
//   * Tile and roles.  A block owns 128 rows of dW (one tap (kh, kw) and 128
//     input channels) by all 256 output channels, and a contiguous range of
//     the pixels; 8 row tiles x 16 ranges put one block on 128 of the 132
//     SMs.  Warpgroup 2 is the producer: one thread keeps TMA loads in flight
//     into a ring of four 48 KB stages (three timed the same, two clearly
//     slower).  Warpgroups 0 and 1 are consumers: each multiplies its 64
//     rows by the 256 columns with wgmma.m64n256k16 into 128 float32
//     registers a thread (setmaxnreg moves registers from the producer to
//     them).  Full/empty mbarriers hand the stages over; there is no block
//     barrier in the loop.
//   * K is cut along the rows of o1, not of dr.  A padded tap position
//     multiplies by zero, so for tap (kh, kw) only the H x W pixels of o1
//     count, each paired with dr at (y + 1 - kh, x + 1 - kw).  A stage is a
//     segment of 64 pixels of one row of o1 (fixed b and y) and the 64
//     pixels of dr shifted by the tap: two boxes with plain coordinates, no
//     division in the loop, no negative coordinate, and none of the zero
//     work that segments of the 321-pixel rows of dr would add (6 x 64 =
//     384 for 321).  Where W is not a multiple of 64 the last segment of a
//     row runs past it and TMA fills the rest of the o1 box with zeros.
//   * Operand layout.  Both operands arrive with the channel contiguous and
//     the pixel (K) along rows: MN-major for A and for B.  TMA writes boxes
//     of 64 channels x 64 pixels (128-byte rows) with the 128-byte swizzle,
//     and wgmma reads them transposed through descriptors of that layout
//     (k-slices advance by 16 rows = 2 KB; the four 64-channel boxes of B
//     are 8 KB apart, the leading byte offset).
//   * The relu.  TMA copies raw o1.  Each consumer warpgroup clears the
//     negative values of its own 8 KB A box in place in shared memory (16
//     bytes a thread, four times), executes fence.proxy.async so that wgmma's
//     reads see the writes, and meets its warpgroup at a named barrier.  It
//     does so for the NEXT stage while the tensor cores work on this one.
//     Three other routes were built and timed beside this one on the H100,
//     each in one call, and each was slower, so none is kept: A through
//     registers (ldmatrix.trans, relu on the fragments, wgmma with A from
//     registers; it spilled); the relu by the three idle warps of the
//     producer's warpgroup with one wgmma batch kept in flight; a cluster of
//     two blocks sharing dr by TMA multicast.  Variants that skipped the
//     relu or the MMA showed the relu's shared-memory traffic as the largest
//     single cost after the wgmma pipeline itself.
//   * Accuracy.  The error of a tensor-core accumulation grows with the
//     length of the chain (measured: 69k pixels 7.2e-5 relative L2, 16k
//     1.6e-5).  A block walks about 200k pixels, so every `flush_segs`
//     segments (16k pixels) it adds its registers into its own float32
//     partial in global memory with ordinary adds and clears them.  A second
//     kernel sums the partials of the ranges in a fixed order while it
//     transposes to OIHW.  No float atomics: two runs give the same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // rows of dW a block owns: one tap, 128 gi
constexpr int kBN = 256;      // columns of dW a block owns: go
constexpr int kSeg = 64;      // pixels a stage
constexpr int kChunk = 64;    // channels a TMA box: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kBoxBytes = kSeg * kChunk * 2;         // 8 KB
constexpr int kABytes = (kBM / kChunk) * kBoxBytes;  // 16 KB
constexpr int kBBytes = (kBN / kChunk) * kBoxBytes;  // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;       // 48 KB
constexpr int kSliceBytes = 16 * kChunk * 2;         // one k16 slice: 2 KB
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;  // two consumer warpgroups and the producer's
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spin until the barrier's phase differs from `parity`.  A wait here lasts
// microseconds; one that outlasts 2^28 polls is a lost arrival, and a trap
// (the launch then fails) is better than a block that never ends.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 28)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One box of the 3-D tensor (channel, x, image row) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map, uint32_t bar,
                                         int c, int x, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(row)
      : "memory");
}

// Shared-memory matrix descriptor of an MN-major operand in the 128-byte
// swizzle: 64-element chunks of M/N `lbo` bytes apart, groups of 8 k-rows
// 1024 bytes apart.
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += A^T-major (64 x 16) * B (16 x 256), both from shared memory, bf16.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"  // scale-d, +A, +B, A and B MN-major
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Zero the negative halves of eight packed bf16.
__device__ __forceinline__ uint4 relu_bf16x8(uint4 v) {
  uint32_t *w = reinterpret_cast<uint32_t *>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t neg = (w[k] >> 15) & 0x00010001u;  // the two sign bits
    w[k] &= ~(neg * 0xffffu);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap map_o1,  // (CI, W, B*H)
             const __grid_constant__ CUtensorMap map_dr,  // (CO, W+1, B*(H+1))
             float *__restrict__ partial,                 // (ranges, 4*CI, CO)
             int h, int ci, int co, int segs_x, int total_segs, int segs_per_range,
             int flush_segs) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  // The swizzle is a function of the address: stages sit on 1 KB boundaries.
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tap = m0 / ci, gi0 = m0 % ci;
  const int kh = tap >> 1, kw = tap & 1;
  const int seg_begin = blockIdx.z * segs_per_range;
  const int steps = max(0, min(total_segs, seg_begin + segs_per_range) - seg_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer ---------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      int row = seg_begin / segs_x;        // image row of o1: b * H + y
      int sx = seg_begin - row * segs_x;   // segment of that row
      int b = row / h;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < steps; ++it) {
        const uint32_t full = smem_u32(&full_bar[stage]);
        mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1u);
        mbar_expect_tx(full, kStageBytes);
        const uint32_t a = ring + stage * kStageBytes, bb = a + kABytes;
        const int x = sx * kSeg;
        // dr's image rows are H + 1 to an image: row + b; the tap shifts.
        const int dr_row = row + b + 1 - kh, dr_x = x + 1 - kw;
#pragma unroll
        for (int j = 0; j < kBM / kChunk; ++j)
          tma_load(a + j * kBoxBytes, &map_o1, full, gi0 + j * kChunk, x, row);
#pragma unroll
        for (int j = 0; j < kBN / kChunk; ++j)
          tma_load(bb + j * kBoxBytes, &map_dr, full, n0 + j * kChunk, dr_x, dr_row);
        if (++sx == segs_x) {
          sx = 0;
          ++row;
          if (row == (b + 1) * h) ++b;
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    // This thread's accumulators: rows r0 and r0 + 8, columns 8 j + c0, + 1.
    const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
    float *dst = partial + ((size_t)blockIdx.z * 4 * ci + m0 + 64 * wg + r0) * co + n0 + c0;
    bool first = true;
    int since_flush = 0;
    int stage = 0;
    uint32_t phase = 0;
    // relu in place on this warpgroup's A box of a stage that has landed;
    // the fence makes the writes visible to wgmma's reads.
    auto relu_stage = [&](int st) {
      const uint32_t a = ring + st * kStageBytes + wg * kBoxBytes;
#pragma unroll
      for (int j = 0; j < kBoxBytes / 16 / 128; ++j) {
        const uint32_t p = a + (t + 128 * j) * 16;
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(p)
                     : "memory");
        v = relu_bf16x8(v);
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(p), "r"(v.x),
                     "r"(v.y), "r"(v.z), "r"(v.w)
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    auto warpgroup_barrier = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };
    if (steps > 0) {
      mbar_wait(smem_u32(&full_bar[0]), 0);
      relu_stage(0);
      warpgroup_barrier();
    }
    for (int it = 0; it < steps; ++it) {
      const uint32_t a = ring + stage * kStageBytes + wg * kBoxBytes;
      const uint32_t bb = ring + stage * kStageBytes + kABytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint64_t da = mn_major_desc(a, kBoxBytes), db = mn_major_desc(bb, kBoxBytes);
#pragma unroll
      for (int k = 0; k < kSeg / 16; ++k)
        wgmma_m64n256k16(acc, da + (uint64_t)(k * (kSliceBytes >> 4)),
                         db + (uint64_t)(k * (kSliceBytes >> 4)));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      const int released = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
      // While the tensor cores work on this stage, the relu of the next.
      const bool more = it + 1 < steps;
      if (more) {
        mbar_wait(smem_u32(&full_bar[stage]), phase);
        relu_stage(stage);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[released]));
      if (more) warpgroup_barrier();
      if (++since_flush == flush_segs || it == steps - 1) {
        // End this accumulation chain: registers into the block's partial.
#pragma unroll
        for (int j = 0; j < 32; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float2 *p = reinterpret_cast<float2 *>(dst + (size_t)(8 * hh) * co + 8 * j);
            float2 v = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
            if (!first) {
              const float2 o = *p;
              v.x = o.x + v.x;
              v.y = o.y + v.y;
            }
            *p = v;
            acc[4 * j + 2 * hh] = 0.0f;
            acc[4 * j + 2 * hh + 1] = 0.0f;
          }
        }
        first = false;
        since_flush = 0;
      }
    }
    if (first) {  // a range without segments still owns a partial
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2 *>(dst + (size_t)(8 * hh) * co + 8 * j) =
              make_float2(0.0f, 0.0f);
    }
  }
}

// out[go, gi, kh, kw] = sum over the ranges, in order, of
// partial[r, (kh*2 + kw)*CI + gi, go].
__global__ void reduce_kernel(const float *__restrict__ partial,
                              float *__restrict__ out, int ranges, int ci,
                              int co) {
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

typedef CUresult (*EncodeTiled)(CUtensorMap *, CUtensorMapDataType, cuuint32_t, void *,
                                const cuuint64_t *, const cuuint64_t *, const cuuint32_t *,
                                const cuuint32_t *, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has already
// loaded into the process, so it is looked up there, not linked.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void *lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The map of a contiguous bf16 (rows, width, channels) tensor as (channel,
// x, row), boxes of 64 channels x 64 pixels of one row, 128-byte swizzle,
// zeros outside the tensor.
bool make_map(CUtensorMap *map, const void *base, int channels, int width, long long rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)channels, (cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)channels * 2, (cuuint64_t)width * channels * 2};
  const cuuint32_t box[3] = {kChunk, kSeg, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void *>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// o1 (B, H, W, CI), dr (B, H+1, W+1, CO) bf16 contiguous and 16-byte aligned;
// partial holds ranges * 4*CI*CO floats; out (CO, CI, 2, 2) float.  CI must
// be a multiple of 128 and CO of 256.  The pixels of o1 are cut into
// segments of 64 along x (segs_x = ceil(W / 64) a row); range r takes the
// segments [r * segs_per_range, (r + 1) * segs_per_range) and ends an
// accumulation chain every flush_segs segments.
int conv12_wgrad_launch(const void *o1, const void *dr, float *partial,
                        float *out, int b, int h, int w, int ci, int co,
                        int ranges, int segs_per_range, int flush_segs,
                        cudaStream_t stream) {
  if (ci % kBM || co % kBN || ranges < 1 || segs_per_range < 1 || flush_segs < 1)
    return (int)cudaErrorInvalidValue;
  const int segs_x = (w + kSeg - 1) / kSeg;
  const long long total = (long long)b * h * segs_x;
  if (total >= (1LL << 31) || (long long)ranges * segs_per_range < total)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_o1, map_dr;
  if (!make_map(&map_o1, o1, ci, w, (long long)b * h) ||
      !make_map(&map_dr, dr, co, w + 1, (long long)b * (h + 1)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(4 * ci / kBM, co / kBN, ranges);
  wgrad_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      map_o1, map_dr, partial, h, ci, co, segs_x, (int)total, segs_per_range, flush_segs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = co * ci * 4;
  reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, out, ranges, ci, co);
  return (int)cudaGetLastError();
}

}  // extern "C"

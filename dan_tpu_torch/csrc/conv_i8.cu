// s8 x s8 -> s32 convolution with a fused dequant / bias / relu / requant
// epilogue, for Hopper (sm_90a): the int8 body of the quantized detector.
//
// Replaces no Pallas kernel.  On the TPU the JAX package leaves this to XLA:
// dan_tpu/quant.py::_conv_i8 (a conv with preferred_element_type=int32) and
// the elementwise chain XLA fuses into its output (quant.py:387-397 for the
// packed conv1_2' with its phase max, :412-418 for the body convs).  PyTorch
// has no int8 convolution on CUDA, so the port writes it.
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
// and a fourth mode for the packed conv1_2' (2x2 kernel, padding 1, Co = 4
// phase groups of 64): pool1[b, y, x, c] = max over the groups g = py*2+px of
// q[b, y + py, x + px, 64 g + c], the phase max of quant.py::phase_max_i8
// (max and requant commute: dan_tpu/quant.py:387-397), so the conv's own
// output never reaches memory.
//
// Every output is bit-identical to the plain version in ops/conv_i8.py: the
// s32 sum is exact in any order (|acc| <= 127 * 127 * 4608 = 74.3 M < 2^31
// for the largest reduction, fc6), and the epilogue is the plain version's
// float32 operations in its order, with explicit round-to-nearest
// intrinsics (no contraction into a fused multiply-add; the source is also
// built with -fmad=false) and rint's ties to even (__float2int_rn).
//
// What bounds it: operations.  At batch 128 and 640x640 the 18 convolutions
// of a forward are 32.54 T int8 operations (2 per multiply-add, conv1_2'
// counted as the 3x3 conv it computes), 16.5 ms at the card's 1,979 TOPS;
// only wgmma reaches that rate.  The design:
//   * Implicit GEMM, M = output pixels, N = Co, K = taps x Ci.  A tile is a
//     rectangle of rows x cols = 128 output pixels of one image (256 when
//     BN = 128; chosen per layer from Wo by ops/conv_i8_cuda.py::plan) by
//     BN = 256 or 128 channels.  K runs over k-steps: one tap (ky, kx) and
//     one slice of 64 or 128 channels (bytes).  A k-step is two TMA boxes:
//     A = the 4-D box
//     (slice, cols, rows, 1) of x at (ci0, ox0*s + kx*d - pl, oy0*s + ky*d -
//     pt, b) with element strides (1, s, s, 1), so padding (also negative
//     coordinates) is TMA's zero fill, dilation the tap's offset and the
//     stride the map's element stride; B = the 2-D box (slice, BN) of k seen
//     as (kh*kw*Ci, Co).  Both land K-major with the 128- or 64-byte swizzle,
//     the only layout wgmma takes for 8-bit operands.  The step table comes
//     from the plan, coordinates relative to the tile's origin.
//   * Roles.  One producer thread (warpgroup 2) keeps a ring of up to eight
//     mbarrier stages full (a stage is one A box and the B boxes of its
//     k-steps: one, or in phase mode up to four; 16-48 KB).
//     Two consumer warpgroups each own 64 of the tile's pixels and run
//     wgmma.m64nBNk32.s32.s8.s8 chains into 128 s32 registers a thread
//     (setmaxnreg: producer 40, consumers 232), one commit group kept in
//     flight: stage i is released when stage i+1's products are issued.
//     With BN = 128 (Co <= 128: conv2_x) a tile is 256 pixels, 128 a
//     warpgroup in two m64 chains, so that a loaded byte feeds as many
//     products as in a 128 x 256 tile (two warpgroups taking alternate
//     128 x 128 tiles, so that one's epilogue ran under the other's
//     products, measured no faster; PERF.md has the times).
//   * Persistent.  gridDim = min(tiles, SMs); block i walks tiles i, i +
//     grid, ... with the channel tile fastest, so the blocks that run at one
//     time share their A boxes in L2.  The producer runs ahead into the next
//     tile while the consumers run the epilogue.
//   * Epilogue.  Each output is converted from the registers in the plain
//     version's order, staged in shared memory 128 bytes of channels a row
//     (pitch 144: no bank conflicts for the s8 and bf16 writes), and leaves
//     as 16-byte stores, one pixel's channels contiguous; pixels past Ho/Wo
//     and channels past Co are masked there.  It does not overlap the
//     products, and is the largest cost left, the tap layers' most
//     (PERF.md: the kernel timed without it, tools/conv_i8_variants.py).
//   * conv1_2' + phase max.  A tile is 128 pixels of pool1 by the 4 groups'
//     64 channels.  Group g = (py, px) is its own GEMM into registers 32 g ..
//     whose A boxes are shifted by (py, px).  The k-steps where the packed
//     kernel is zero by construction (7 of 16 (tap, input phase) blocks a
//     group) are left out, and the 36 that remain read only 16 distinct A
//     boxes (64-byte slices: one input phase at one offset): a stage is one
//     A box and the B boxes of the 1, 2 or 4 groups it feeds, multiplied by
//     a wgmma of N = 64, 128 or 256 whose columns are those groups'
//     registers (`phase_mma`).  The 16 stages are a static schedule
//     (phase_mask), so the
//     registers are static in the consumer; the launch checks the plan's
//     table against it.  The epilogue requantizes each group, keeps the max.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kTileM = 128;  // output pixels a tile: two consumer warpgroups of 64 (of 128
                             // with N tiles of 128)
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr int kMaxSteps = 128;
constexpr int kMaxRing = 8;
constexpr int kPitch = 144;  // a staging row: 128 bytes of channels + 16
constexpr int kStagingBytes = 2 * 64 * kPitch;
constexpr int kAlign = 1024;  // the swizzle is a function of the address
// Dynamic shared memory a block may ask for: 227 KB less room for the
// static barriers.
constexpr int kSmemLimit = 232448 - 1024;

enum TapKind { kTapNone = 0, kTapF32 = 1, kTapBF16 = 2 };

// One k-step: an A box and a B box, coordinates relative to the tile.
struct Step {
  int16_t c, dx, dy, n;  // A: channel, x and y offsets; B: channel offset
  int32_t k;             // B: reduction coordinate (tap * Ci + channel)
};

// A stage is one A box and the B boxes of its k-steps (one; in phase mode
// the steps of the groups that share the A box, up to four).
struct Params {
  CUtensorMap map_x;  // (Ci, W, H, B)
  CUtensorMap map_k;  // (kh*kw*Ci, Co)
  const float *deq, *bias, *inv;
  void *tap;
  int8_t *q;
  int32_t *acc;
  int tap_kind;
  int ho, wo, co_out;  // the output tensor (B, ho, wo, co_out): pool1 in phase mode
  int co;              // the conv's channels (the epilogue vectors' length)
  int stride, rows, cols;
  int tiles_y, tiles_x, n_tiles, total_tiles, bn;
  int slice, n_steps, b_slots, stages_per_tile, ring;
  uint32_t a_bytes, b_bytes, stage_bytes;
  Step steps[kMaxSteps];
  uint8_t stage_steps[kMaxSteps];  // k-steps (B boxes) of each stage
};

// The phase-max schedule.  Along one axis, the A box at offset d (-1, 0, 1)
// of input phase r feeds the output phases p with 2 d + r in [p - 1, p + 1]
// (the taps the packed form fills): axis_phases(i) is that set, as bits, for
// (d, r) = (-1, 1), (0, 0), (0, 1), (1, 0); the other two feed none.  Stage
// s = 4 i + j pairs entry i along y with entry j along x, and multiplies its
// one A box by the B boxes of every group (py, px) both feed: 16 A boxes, 36
// group k-steps a tile (the 9 nonzero (tap, input phase) blocks of each of
// the 4 groups).  ops/conv_i8_cuda.py::_phase_steps makes the same table.
constexpr int kPhaseStages = 16;

__host__ __device__ constexpr int axis_phases(int i) { return i == 0 ? 1 : i == 3 ? 2 : 3; }

__host__ __device__ constexpr int phase_mask(int s) {
  int m = 0;
  for (int py = 0; py < 2; ++py)
    for (int px = 0; px < 2; ++px)
      if (((axis_phases(s / 4) >> py) & 1) && ((axis_phases(s % 4) >> px) & 1))
        m |= 1 << (py * 2 + px);
  return m;
}

__host__ __device__ constexpr int low_bit(int m) { return (m & 1) ? 0 : 1 + low_bit(m >> 1); }
__host__ __device__ constexpr int high_bit(int m) { return m > 1 ? 1 + high_bit(m >> 1) : 0; }
__host__ __device__ constexpr int bit_count(int m) { return m ? (m & 1) + bit_count(m >> 1) : 0; }

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spin until the barrier's phase differs from `parity`.  A wait here lasts
// microseconds; one that outlasts 10 s of the global timer is a lost arrival
// or a schedule fault, and a trap (the launch then fails) is better than a
// block that never ends.  (A poll count is no bound: try_wait may suspend
// the thread for an unspecified time on each poll.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  uint64_t start = 0;
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
    if (!done && (++polls & 255) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) {
        start = now;
      } else if (now - start > 10000000000ull) {
        __trap();
      }
    }
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap *map, uint32_t bar,
                                            int c, int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap *map, uint32_t bar,
                                            int k, int n) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(n)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand with rows of `slice`
// bytes in the matching swizzle (128 bytes: layout 1, 64 bytes: layout 2):
// groups of 8 rows 8 * slice bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr, int slice) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * slice) >> 4) << 32) | ((uint64_t)(slice == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d[OFF ..] += A (64 x 32 bytes, K-major) * B (32 bytes x 256, K-major), s8 -> s32.
template <int OFF, int NACC>
__device__ __forceinline__ void wgmma_n256(int32_t (&d)[NACC], uint64_t da, uint64_t db) {
  static_assert(OFF + 128 <= NACC, "accumulator range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
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
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[OFF + 0]), "+r"(d[OFF + 1]), "+r"(d[OFF + 2]), "+r"(d[OFF + 3]),
        "+r"(d[OFF + 4]), "+r"(d[OFF + 5]), "+r"(d[OFF + 6]), "+r"(d[OFF + 7]),
        "+r"(d[OFF + 8]), "+r"(d[OFF + 9]), "+r"(d[OFF + 10]), "+r"(d[OFF + 11]),
        "+r"(d[OFF + 12]), "+r"(d[OFF + 13]), "+r"(d[OFF + 14]), "+r"(d[OFF + 15]),
        "+r"(d[OFF + 16]), "+r"(d[OFF + 17]), "+r"(d[OFF + 18]), "+r"(d[OFF + 19]),
        "+r"(d[OFF + 20]), "+r"(d[OFF + 21]), "+r"(d[OFF + 22]), "+r"(d[OFF + 23]),
        "+r"(d[OFF + 24]), "+r"(d[OFF + 25]), "+r"(d[OFF + 26]), "+r"(d[OFF + 27]),
        "+r"(d[OFF + 28]), "+r"(d[OFF + 29]), "+r"(d[OFF + 30]), "+r"(d[OFF + 31]),
        "+r"(d[OFF + 32]), "+r"(d[OFF + 33]), "+r"(d[OFF + 34]), "+r"(d[OFF + 35]),
        "+r"(d[OFF + 36]), "+r"(d[OFF + 37]), "+r"(d[OFF + 38]), "+r"(d[OFF + 39]),
        "+r"(d[OFF + 40]), "+r"(d[OFF + 41]), "+r"(d[OFF + 42]), "+r"(d[OFF + 43]),
        "+r"(d[OFF + 44]), "+r"(d[OFF + 45]), "+r"(d[OFF + 46]), "+r"(d[OFF + 47]),
        "+r"(d[OFF + 48]), "+r"(d[OFF + 49]), "+r"(d[OFF + 50]), "+r"(d[OFF + 51]),
        "+r"(d[OFF + 52]), "+r"(d[OFF + 53]), "+r"(d[OFF + 54]), "+r"(d[OFF + 55]),
        "+r"(d[OFF + 56]), "+r"(d[OFF + 57]), "+r"(d[OFF + 58]), "+r"(d[OFF + 59]),
        "+r"(d[OFF + 60]), "+r"(d[OFF + 61]), "+r"(d[OFF + 62]), "+r"(d[OFF + 63]),
        "+r"(d[OFF + 64]), "+r"(d[OFF + 65]), "+r"(d[OFF + 66]), "+r"(d[OFF + 67]),
        "+r"(d[OFF + 68]), "+r"(d[OFF + 69]), "+r"(d[OFF + 70]), "+r"(d[OFF + 71]),
        "+r"(d[OFF + 72]), "+r"(d[OFF + 73]), "+r"(d[OFF + 74]), "+r"(d[OFF + 75]),
        "+r"(d[OFF + 76]), "+r"(d[OFF + 77]), "+r"(d[OFF + 78]), "+r"(d[OFF + 79]),
        "+r"(d[OFF + 80]), "+r"(d[OFF + 81]), "+r"(d[OFF + 82]), "+r"(d[OFF + 83]),
        "+r"(d[OFF + 84]), "+r"(d[OFF + 85]), "+r"(d[OFF + 86]), "+r"(d[OFF + 87]),
        "+r"(d[OFF + 88]), "+r"(d[OFF + 89]), "+r"(d[OFF + 90]), "+r"(d[OFF + 91]),
        "+r"(d[OFF + 92]), "+r"(d[OFF + 93]), "+r"(d[OFF + 94]), "+r"(d[OFF + 95]),
        "+r"(d[OFF + 96]), "+r"(d[OFF + 97]), "+r"(d[OFF + 98]), "+r"(d[OFF + 99]),
        "+r"(d[OFF + 100]), "+r"(d[OFF + 101]), "+r"(d[OFF + 102]), "+r"(d[OFF + 103]),
        "+r"(d[OFF + 104]), "+r"(d[OFF + 105]), "+r"(d[OFF + 106]), "+r"(d[OFF + 107]),
        "+r"(d[OFF + 108]), "+r"(d[OFF + 109]), "+r"(d[OFF + 110]), "+r"(d[OFF + 111]),
        "+r"(d[OFF + 112]), "+r"(d[OFF + 113]), "+r"(d[OFF + 114]), "+r"(d[OFF + 115]),
        "+r"(d[OFF + 116]), "+r"(d[OFF + 117]), "+r"(d[OFF + 118]), "+r"(d[OFF + 119]),
        "+r"(d[OFF + 120]), "+r"(d[OFF + 121]), "+r"(d[OFF + 122]), "+r"(d[OFF + 123]),
        "+r"(d[OFF + 124]), "+r"(d[OFF + 125]), "+r"(d[OFF + 126]), "+r"(d[OFF + 127])
      : "l"(da), "l"(db), "r"(1));
}

// d[LO ..] (columns 0-63) and d[HI ..] (64-127) += A (64 x 32 bytes, K-major)
// * B (32 bytes x 128, K-major), s8 -> s32.
template <int LO, int HI, int NACC>
__device__ __forceinline__ void wgmma_n128(int32_t (&d)[NACC], uint64_t da, uint64_t db) {
  static_assert(LO + 32 <= NACC && HI + 32 <= NACC, "accumulator range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[LO + 0]), "+r"(d[LO + 1]), "+r"(d[LO + 2]), "+r"(d[LO + 3]),
        "+r"(d[LO + 4]), "+r"(d[LO + 5]), "+r"(d[LO + 6]), "+r"(d[LO + 7]),
        "+r"(d[LO + 8]), "+r"(d[LO + 9]), "+r"(d[LO + 10]), "+r"(d[LO + 11]),
        "+r"(d[LO + 12]), "+r"(d[LO + 13]), "+r"(d[LO + 14]), "+r"(d[LO + 15]),
        "+r"(d[LO + 16]), "+r"(d[LO + 17]), "+r"(d[LO + 18]), "+r"(d[LO + 19]),
        "+r"(d[LO + 20]), "+r"(d[LO + 21]), "+r"(d[LO + 22]), "+r"(d[LO + 23]),
        "+r"(d[LO + 24]), "+r"(d[LO + 25]), "+r"(d[LO + 26]), "+r"(d[LO + 27]),
        "+r"(d[LO + 28]), "+r"(d[LO + 29]), "+r"(d[LO + 30]), "+r"(d[LO + 31]),
        "+r"(d[HI + 0]), "+r"(d[HI + 1]), "+r"(d[HI + 2]), "+r"(d[HI + 3]),
        "+r"(d[HI + 4]), "+r"(d[HI + 5]), "+r"(d[HI + 6]), "+r"(d[HI + 7]),
        "+r"(d[HI + 8]), "+r"(d[HI + 9]), "+r"(d[HI + 10]), "+r"(d[HI + 11]),
        "+r"(d[HI + 12]), "+r"(d[HI + 13]), "+r"(d[HI + 14]), "+r"(d[HI + 15]),
        "+r"(d[HI + 16]), "+r"(d[HI + 17]), "+r"(d[HI + 18]), "+r"(d[HI + 19]),
        "+r"(d[HI + 20]), "+r"(d[HI + 21]), "+r"(d[HI + 22]), "+r"(d[HI + 23]),
        "+r"(d[HI + 24]), "+r"(d[HI + 25]), "+r"(d[HI + 26]), "+r"(d[HI + 27]),
        "+r"(d[HI + 28]), "+r"(d[HI + 29]), "+r"(d[HI + 30]), "+r"(d[HI + 31])
      : "l"(da), "l"(db), "r"(1));
}

// d[OFF ..] += A (64 x 32 bytes, K-major) * B (32 bytes x 64, K-major), s8 -> s32.
template <int OFF, int NACC>
__device__ __forceinline__ void wgmma_n64(int32_t (&d)[NACC], uint64_t da, uint64_t db) {
  static_assert(OFF + 32 <= NACC, "accumulator range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[OFF + 0]), "+r"(d[OFF + 1]), "+r"(d[OFF + 2]), "+r"(d[OFF + 3]),
        "+r"(d[OFF + 4]), "+r"(d[OFF + 5]), "+r"(d[OFF + 6]), "+r"(d[OFF + 7]),
        "+r"(d[OFF + 8]), "+r"(d[OFF + 9]), "+r"(d[OFF + 10]), "+r"(d[OFF + 11]),
        "+r"(d[OFF + 12]), "+r"(d[OFF + 13]), "+r"(d[OFF + 14]), "+r"(d[OFF + 15]),
        "+r"(d[OFF + 16]), "+r"(d[OFF + 17]), "+r"(d[OFF + 18]), "+r"(d[OFF + 19]),
        "+r"(d[OFF + 20]), "+r"(d[OFF + 21]), "+r"(d[OFF + 22]), "+r"(d[OFF + 23]),
        "+r"(d[OFF + 24]), "+r"(d[OFF + 25]), "+r"(d[OFF + 26]), "+r"(d[OFF + 27]),
        "+r"(d[OFF + 28]), "+r"(d[OFF + 29]), "+r"(d[OFF + 30]), "+r"(d[OFF + 31])
      : "l"(da), "l"(db), "r"(1));
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

__device__ __forceinline__ void tile_origin(const Params &p, int t, int &b, int &oy0, int &ox0,
                                            int &n0) {
  const int nt = t % p.n_tiles;
  int m = t / p.n_tiles;
  const int tx = m % p.tiles_x;
  m /= p.tiles_x;
  const int ty = m % p.tiles_y;
  b = m / p.tiles_y;
  oy0 = ty * p.rows;
  ox0 = tx * p.cols;
  n0 = nt * p.bn;
}

// Write one output of 64 of the tile's pixels (pix0 ..) x NOUT channels,
// from the registers of warpgroup wg.  value(j,
// v) gives the elements at columns 8 j + c0 and + 1 of the accumulator
// layout, packed (first in the low bits): v[0] of row r0, v[1] of row r0 + 8
// (one call a column pair, so its vectors are loaded once).  They pass
// through the warpgroup's staging rows, 128 bytes of channels at a time, and
// leave as 16-byte stores.
template <int ESIZE, int NOUT, class Value>
__device__ __forceinline__ void store_tile(const Params &p, uint8_t *out, uint8_t *stg, int wg,
                                           int t128, int pix0, int b, int oy0, int ox0, int n0,
                                           Value value) {
  constexpr int CH = (128 / ESIZE < NOUT) ? 128 / ESIZE : NOUT;  // channels a chunk
  constexpr int VPR = CH * ESIZE / 16;                            // 16-byte vectors a row
  const int lane = t128 & 31;
  const int r0 = 16 * (t128 >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < NOUT / CH; ++c) {
#pragma unroll
    for (int jj = 0; jj < CH / 8; ++jj) {
      uint64_t v[2];
      value(c * (CH / 8) + jj, v);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint8_t *dst = stg + (r0 + 8 * h) * kPitch + (8 * jj + c0) * ESIZE;
        if (ESIZE == 1) *reinterpret_cast<uint16_t *>(dst) = (uint16_t)v[h];
        if (ESIZE == 2) *reinterpret_cast<uint32_t *>(dst) = (uint32_t)v[h];
        if (ESIZE == 4)
          *reinterpret_cast<uint2 *>(dst) = make_uint2((uint32_t)v[h], (uint32_t)(v[h] >> 32));
      }
    }
    bar_sync(1 + wg);
    for (int v = t128; v < 64 * VPR; v += 128) {
      const int r = v / VPR, cv = v - r * VPR;
      const int pix = pix0 + r;
      const int oy = oy0 + pix / p.cols, ox = ox0 + pix % p.cols;
      const int ch = n0 + c * CH + cv * (16 / ESIZE);
      if (oy < p.ho && ox < p.wo && ch < p.co_out) {
        const uint4 val = *reinterpret_cast<const uint4 *>(stg + r * kPitch + cv * 16);
        *reinterpret_cast<uint4 *>(
            out + ((((size_t)b * p.ho + oy) * p.wo + ox) * p.co_out + ch) * ESIZE) = val;
      }
    }
    bar_sync(1 + wg);
  }
}

__device__ __forceinline__ uint64_t pack2(uint32_t lo, uint32_t hi) {
  return (uint64_t)lo | ((uint64_t)hi << 32);
}

// The epilogue vectors of columns n and n + 1 (n even), from the block's
// copy in shared memory (from global memory they cost the epilogue a
// fifth of its time on conv2_x: tools/conv_i8_variants.py, no_vec).
struct Vec2 {
  float2 deq, bias, inv;
};

__device__ __forceinline__ Vec2 vec2(const float *vecs, int co, int n) {
  Vec2 v;
  v.deq = *reinterpret_cast<const float2 *>(vecs + n);
  v.bias = *reinterpret_cast<const float2 *>(vecs + co + n);
  v.inv = *reinterpret_cast<const float2 *>(vecs + 2 * co + n);
  return v;
}

// The epilogue of accumulators a0 (column n) and a1 (column n + 1).
__device__ __forceinline__ void epilogue2(int32_t a0, int32_t a1, const Vec2 &v, Out &o0,
                                          Out &o1) {
  o0 = epilogue(a0, v.deq.x, v.bias.x, v.inv.x);
  o1 = epilogue(a1, v.deq.y, v.bias.y, v.inv.y);
}

// The products of phase stage S: its A box (64 rows of this warpgroup) by
// the B boxes of its groups (64 rows of 64 bytes each, in group order), into
// each group's 32 registers.  A wgmma's accumulators are one contiguous
// register range, so one instruction takes groups whose registers adjoin
// (all four; an x pair (py, 0) + (py, 1)); a y pair takes one a group (an
// instruction across registers 0-31 and 64-95 made ptxas copy them around
// every product and spill).
template <int S>
__device__ __forceinline__ void phase_mma(int32_t (&acc)[128], uint32_t a, uint32_t bb) {
  constexpr int m = phase_mask(S);
  constexpr int lo = low_bit(m), hi = high_bit(m);
  constexpr uint32_t kBox = 64 * 64;  // bytes of one group's B box
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {  // 64-byte slices: two k32 steps
    const uint64_t da = k_major_desc(a + 32 * kk, 64), db = k_major_desc(bb + 32 * kk, 64);
    if constexpr (bit_count(m) == 4) {
      wgmma_n256<0>(acc, da, db);
    } else if constexpr (bit_count(m) == 2 && hi == lo + 1) {
      wgmma_n128<32 * lo, 32 * hi>(acc, da, db);
    } else if constexpr (bit_count(m) == 2) {
      wgmma_n64<32 * lo>(acc, da, db);
      wgmma_n64<32 * hi>(acc, da, k_major_desc(bb + kBox + 32 * kk, 64));
    } else {
      wgmma_n64<32 * lo>(acc, da, db);
    }
  }
}

// f(integral_constant<S>) for each S, in order.
template <class F, int... S>
__device__ __forceinline__ void for_each_index(F f, std::integer_sequence<int, S...>) {
  (f(std::integral_constant<int, S>{}), ...);
}

// BN: channels a tile (normal mode); PHASE: the conv1_2' phase max; SLICE:
// bytes of K a k-step (the swizzle), static so that the wgmma chain has no
// runtime loop (ptxas then keeps the accumulators in flight between them).
template <int BN, bool PHASE, int SLICE>
__global__ void __launch_bounds__(kThreads, 1) conv_i8_kernel(const __grid_constant__ Params p) {
  // TALL (N tiles of 128): a tile is 256 pixels, 128 a warpgroup in two m64
  // chains, so that a byte loaded feeds as many products as with N = 256.
  constexpr bool TALL = !PHASE && BN == 128;
  constexpr int MW = TALL ? 128 : 64;  // pixels a consumer warpgroup
  constexpr int NACC = 128;            // s32 registers a consumer thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxRing];
  __shared__ __align__(8) uint64_t empty_bar[kMaxRing];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  uint8_t *staging = smem_raw + (ring - raw) + p.ring * p.stage_bytes;
  // The epilogue's vectors, copied once a block: deq, bias, inv_next (Co each).
  float *vecs = reinterpret_cast<float *>(staging + kStagingBytes);
  for (int i = threadIdx.x; i < p.co; i += kThreads) {
    vecs[i] = p.deq[i];
    vecs[p.co + i] = p.bias[i];
    vecs[2 * p.co + i] = p.inv ? p.inv[i] : 0.f;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ring; ++s) {
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
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.total_tiles; t += gridDim.x) {
        int b, oy0, ox0, n0;
        tile_origin(p, t, b, oy0, ox0, n0);
        const int y0 = oy0 * p.stride, x0 = ox0 * p.stride;
        int first = 0;
        for (int s = 0; s < p.stages_per_tile; ++s) {
          const int n_b = p.stage_steps[s];
          const uint32_t full = smem_u32(&full_bar[stage]);
          mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1u);
          mbar_expect_tx(full, p.a_bytes + n_b * p.b_bytes);
          const uint32_t a = ring + stage * p.stage_bytes;
          const Step st0 = p.steps[first];
          tma_load_4d(a, &p.map_x, full, st0.c, x0 + st0.dx, y0 + st0.dy, b);
          for (int u = 0; u < n_b; ++u) {
            const Step st = p.steps[first + u];
            tma_load_2d(a + p.a_bytes + u * p.b_bytes, &p.map_k, full, st.k, n0 + st.n);
          }
          first += n_b;
          if (++stage == p.ring) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }
  // ---- consumers: warpgroup wg owns the tile's pixels MW wg .. MW wg + MW-1 --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t128 = threadIdx.x & 127;
  const int lane = t128 & 31;
  const int c0 = 2 * (lane & 3);
  uint8_t *stg = staging + wg * 64 * kPitch;
  int stage = 0;
  uint32_t phase = 0;
  int held = -1;
  // One ring stage: wait for it, issue its products, and hand back the stage
  // before it once those have been read (one commit group stays in flight).
  auto run_stage = [&](auto issue) {
    mbar_wait(smem_u32(&full_bar[stage]), phase);
    const uint32_t a = ring + stage * p.stage_bytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    issue(a + wg * MW * SLICE, a + p.a_bytes);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (held >= 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[held]));
    }
    held = stage;
    if (++stage == p.ring) {
      stage = 0;
      phase ^= 1u;
    }
  };
  for (int t = blockIdx.x; t < p.total_tiles; t += gridDim.x) {
    int32_t acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0;
    if constexpr (PHASE) {
      for_each_index(
          [&](auto s) {
            run_stage([&](uint32_t a, uint32_t bb) { phase_mma<decltype(s)::value>(acc, a, bb); });
          },
          std::make_integer_sequence<int, kPhaseStages>{});
    } else {
      for (int s = 0; s < p.stages_per_tile; ++s) {
        run_stage([&](uint32_t a, uint32_t bb) {
#pragma unroll
          for (int kk = 0; kk < SLICE / 32; ++kk) {
            const uint64_t da = k_major_desc(a + 32 * kk, SLICE);
            const uint64_t db = k_major_desc(bb + 32 * kk, SLICE);
            if constexpr (BN == 256) {
              wgmma_n256<0>(acc, da, db);
            } else {  // TALL: the warpgroup's pixels 0-63 and 64-127
              wgmma_n128<0, 32>(acc, da, db);
              wgmma_n128<64, 96>(acc, k_major_desc(a + 64 * SLICE + 32 * kk, SLICE), db);
            }
          }
        });
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[held]));
    held = -1;

    // ---- epilogue ------------------------------------------------------------
    int b, oy0, ox0, n0;
    tile_origin(p, t, b, oy0, ox0, n0);
    if constexpr (PHASE) {
      // pool1 = max over the four groups of the requantized conv output,
      // group by group, so that each group's 32 registers die as the max
      // (4 s8 lanes a register: (h, e) = (0, 0), (0, 1), (1, 0), (1, 1) of
      // column pair j) takes them in.
      uint32_t best[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) best[j] = 0x81818181u;  // -127 in each lane
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const Vec2 vv = vec2(vecs, p.co, 64 * g + 8 * j + c0);
          uint32_t packed = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Out o0, o1;
            epilogue2(acc[32 * g + 4 * j + 2 * h], acc[32 * g + 4 * j + 2 * h + 1], vv, o0, o1);
            packed |= ((uint32_t)(uint8_t)o0.q | ((uint32_t)(uint8_t)o1.q << 8)) << (16 * h);
          }
          best[j] = __vmaxs4(best[j], packed);
        }
      }
      store_tile<1, 64>(p, reinterpret_cast<uint8_t *>(p.q), stg, wg, t128, 64 * wg, b, oy0,
                        ox0, 0, [&](int j, uint64_t(&v)[2]) {
                          v[0] = best[j] & 0xFFFFu;
                          v[1] = best[j] >> 16;
                        });
    } else {
      // The vectors of column pair j; a pair past Co reads the last one
      // (its outputs are masked at the store).
      auto vec = [&](int j) { return vec2(vecs, p.co, min(n0 + 8 * j + c0, p.co_out - 2)); };
      // The warpgroup's pixels MW wg + R .. are its registers R .., 64 at a time.
      for_each_index(
          [&](auto half) {
            constexpr int R = 64 * decltype(half)::value;
            const int pix0 = MW * wg + R;
            if (p.acc)
              store_tile<4, BN>(p, reinterpret_cast<uint8_t *>(p.acc), stg, wg, t128, pix0, b,
                                oy0, ox0, n0, [&](int j, uint64_t(&v)[2]) {
#pragma unroll
                                  for (int h = 0; h < 2; ++h)
                                    v[h] = pack2((uint32_t)acc[R + 4 * j + 2 * h],
                                                 (uint32_t)acc[R + 4 * j + 2 * h + 1]);
                                });
            if (p.tap_kind == kTapF32)
              store_tile<4, BN>(p, reinterpret_cast<uint8_t *>(p.tap), stg, wg, t128, pix0, b,
                                oy0, ox0, n0, [&](int j, uint64_t(&v)[2]) {
                                  const Vec2 vv = vec(j);
#pragma unroll
                                  for (int h = 0; h < 2; ++h) {
                                    Out o0, o1;
                                    epilogue2(acc[R + 4 * j + 2 * h], acc[R + 4 * j + 2 * h + 1],
                                              vv, o0, o1);
                                    v[h] = pack2(__float_as_uint(o0.y), __float_as_uint(o1.y));
                                  }
                                });
            if (p.tap_kind == kTapBF16)
              store_tile<2, BN>(p, reinterpret_cast<uint8_t *>(p.tap), stg, wg, t128, pix0, b,
                                oy0, ox0, n0, [&](int j, uint64_t(&v)[2]) {
                                  const Vec2 vv = vec(j);
#pragma unroll
                                  for (int h = 0; h < 2; ++h) {
                                    Out o0, o1;
                                    epilogue2(acc[R + 4 * j + 2 * h], acc[R + 4 * j + 2 * h + 1],
                                              vv, o0, o1);
                                    const uint32_t lo =
                                        __bfloat16_as_ushort(__float2bfloat16_rn(o0.y));
                                    const uint32_t hi =
                                        __bfloat16_as_ushort(__float2bfloat16_rn(o1.y));
                                    v[h] = lo | (hi << 16);
                                  }
                                });
            if (p.q)
              store_tile<1, BN>(p, reinterpret_cast<uint8_t *>(p.q), stg, wg, t128, pix0, b,
                                oy0, ox0, n0, [&](int j, uint64_t(&v)[2]) {
                                  const Vec2 vv = vec(j);
#pragma unroll
                                  for (int h = 0; h < 2; ++h) {
                                    Out o0, o1;
                                    epilogue2(acc[R + 4 * j + 2 * h], acc[R + 4 * j + 2 * h + 1],
                                              vv, o0, o1);
                                    v[h] = (uint32_t)(uint8_t)o0.q | ((uint32_t)(uint8_t)o1.q << 8);
                                  }
                                });
          },
          std::make_integer_sequence<int, MW / 64>{});
    }
  }
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

bool encode(CUtensorMap *map, const void *base, int rank, const cuuint64_t *dims,
            const cuuint64_t *strides, const cuuint32_t *box, const cuuint32_t *elem, int slice) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void *>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            slice == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool PHASE, int SLICE>
int launch(const Params &p, int grid, int smem, cudaStream_t stream) {
  // Per launch, not once per process: the attribute belongs to the current
  // device, and a second card in the process needs its own.
  cudaError_t err = cudaFuncSetAttribute(conv_i8_kernel<BN, PHASE, SLICE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_i8_kernel<BN, PHASE, SLICE><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch with `ring` stages of `stage_bytes` and
// Co channels: the aligned ring, the staging rows, the epilogue's vectors.
int smem_bytes(int ring, int stage_bytes, int co) {
  return kAlign + ring * stage_bytes + kStagingBytes + 3 * 4 * co;
}

}  // namespace

extern "C" {

// x (b, h, w, ci) and k (co, kh, kw, ci) s8, deq / bias / inv_next f32 (co,),
// contiguous and 16-byte aligned.  Outputs, each optional (a null pointer,
// or tap_kind 0): tap in float32 (1) or bf16 (2), q s8 (needs inv_next), acc
// s32, all (b, ho, wo, co_out); in phase mode only q, pool1.  `cfg` holds
// the 26 ints of ops/conv_i8_cuda.py::Plan.launch_ints, in this order:
//   b h w ci co kh kw ho wo co_out stride rows cols tiles_y tiles_x n_tiles
//   bn nb slice n_steps b_slots stages_per_tile ring grid phase smem
// `steps` n_steps x 5 ints (c, dx, dy, n, k), and `stage_steps` the number of
// k-steps of each of the stages_per_tile stages.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int conv_i8_launch(const void *x, const void *k, const void *deq, const void *bias,
                   const void *inv_next, void *tap, int tap_kind, void *q, void *acc,
                   const int *cfg, const int *steps, const int *stage_steps,
                   cudaStream_t stream) {
  const int b = cfg[0], h = cfg[1], w = cfg[2], ci = cfg[3], co = cfg[4], kh = cfg[5],
            kw = cfg[6];
  const int nb = cfg[17], grid = cfg[23], phase = cfg[24], smem = cfg[25];
  Params p;
  p.deq = static_cast<const float *>(deq);
  p.bias = static_cast<const float *>(bias);
  p.inv = static_cast<const float *>(inv_next);
  p.tap = tap;
  p.q = static_cast<int8_t *>(q);
  p.acc = static_cast<int32_t *>(acc);
  p.tap_kind = tap_kind;
  p.ho = cfg[7], p.wo = cfg[8], p.co_out = cfg[9], p.stride = cfg[10], p.co = co;
  p.rows = cfg[11], p.cols = cfg[12], p.tiles_y = cfg[13], p.tiles_x = cfg[14];
  p.n_tiles = cfg[15], p.bn = cfg[16], p.slice = cfg[18], p.n_steps = cfg[19];
  p.b_slots = cfg[20], p.stages_per_tile = cfg[21], p.ring = cfg[22];
  p.total_tiles = b * p.tiles_y * p.tiles_x * p.n_tiles;
  const int tile_m = (!phase && p.bn == 128) ? 2 * kTileM : kTileM;
  p.a_bytes = tile_m * p.slice;
  p.b_bytes = nb * p.slice;
  p.stage_bytes = p.a_bytes + p.b_slots * p.b_bytes;
  const long long tiles = (long long)b * p.tiles_y * p.tiles_x * p.n_tiles;
  bool ok = (p.slice == 64 || p.slice == 128) && ci % p.slice == 0 && co % 64 == 0 &&
            p.rows * p.cols == tile_m && p.cols * p.stride <= 256 && p.rows * p.stride <= 256 &&
            p.n_steps >= 1 && p.n_steps <= kMaxSteps && p.b_slots >= 1 && p.b_slots <= 4 &&
            p.stages_per_tile >= 1 && p.stages_per_tile <= p.n_steps && p.ring >= 1 &&
            p.ring <= kMaxRing && tiles < (1LL << 31) && grid >= 1 &&
            smem == smem_bytes(p.ring, p.stage_bytes, co) && smem <= kSmemLimit &&
            (!q || inv_next) && nb <= 256;
  if (phase)
    ok = ok && p.slice == 64 && nb == 64 && p.b_slots == 4 && p.stages_per_tile == kPhaseStages &&
         q && !tap && !acc && tap_kind == kTapNone && p.n_tiles == 1 && p.co_out == 64 &&
         co == 256;
  else
    ok = ok && (p.bn == 128 || p.bn == 256) && nb == p.bn && p.co_out == co && p.b_slots == 1 &&
         p.stages_per_tile == p.n_steps;
  if (!ok) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < p.n_steps; ++i) {
    const int *s = steps + 5 * i;
    for (int j = 0; j < 4; ++j)
      if (s[j] < -32768 || s[j] > 32767) return (int)cudaErrorInvalidValue;
    p.steps[i] = Step{(int16_t)s[0], (int16_t)s[1], (int16_t)s[2], (int16_t)s[3], s[4]};
  }
  // Each stage's k-steps; in phase mode they must be the consumer's static
  // schedule: stage s holds the groups of phase_mask(s), in order, on one A box.
  int first = 0;
  for (int s = 0; s < p.stages_per_tile; ++s) {
    const int n_b = stage_steps[s];
    if (n_b < 1 || n_b > p.b_slots || first + n_b > p.n_steps) return (int)cudaErrorInvalidValue;
    p.stage_steps[s] = (uint8_t)n_b;
    if (phase) {
      const int m = phase_mask(s);
      int g = 0;
      for (int u = 0; u < n_b; ++u, ++g) {
        while (g < 4 && !((m >> g) & 1)) ++g;
        const Step &st = p.steps[first + u];
        const Step &st0 = p.steps[first];
        if (g == 4 || st.n != 64 * g || st.c != st0.c || st.dx != st0.dx || st.dy != st0.dy)
          return (int)cudaErrorInvalidValue;
      }
      if (n_b != bit_count(m)) return (int)cudaErrorInvalidValue;
    }
    first += n_b;
  }
  if (first != p.n_steps) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return 0;
  const int stride = p.stride;
  const cuuint64_t xdims[4] = {(cuuint64_t)ci, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t xstrides[3] = {(cuuint64_t)ci, (cuuint64_t)w * ci, (cuuint64_t)h * w * ci};
  const cuuint32_t xbox[4] = {(cuuint32_t)p.slice, (cuuint32_t)(p.cols * stride),
                              (cuuint32_t)(p.rows * stride), 1};
  const cuuint32_t xelem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  const cuuint64_t kdims[2] = {(cuuint64_t)kh * kw * ci, (cuuint64_t)co};
  const cuuint64_t kstrides[1] = {(cuuint64_t)kh * kw * ci};
  const cuuint32_t kbox[2] = {(cuuint32_t)p.slice, (cuuint32_t)nb};
  const cuuint32_t kelem[2] = {1, 1};
  if (!encode(&p.map_x, x, 4, xdims, xstrides, xbox, xelem, p.slice) ||
      !encode(&p.map_k, k, 2, kdims, kstrides, kbox, kelem, p.slice))
    return (int)cudaErrorInvalidValue;
  if (phase) return launch<64, true, 64>(p, grid, smem, stream);
  if (p.bn == 256)
    return p.slice == 128 ? launch<256, false, 128>(p, grid, smem, stream)
                          : launch<256, false, 64>(p, grid, smem, stream);
  return p.slice == 128 ? launch<128, false, 128>(p, grid, smem, stream)
                        : launch<128, false, 64>(p, grid, smem, stream);
}

}  // extern "C"

// Blocked (bitmask) greedy NMS over score-sorted boxes for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   K9  dan_tpu/ops/nms_blocked_pallas.py::_kernel
// and computes what it computes: given N boxes in descending score order,
// greedy NMS -- box i is kept unless an earlier kept box has IoU strictly
// greater than the threshold with it; boxes whose score is <= score_threshold
// are never kept and never suppress.  The kept set equals that of the
// argmax-loop kernel (nms.cu) on the same input.  The output is the
// selection rank of each box (k for the k-th kept box, -1 otherwise, and -1
// for every kept box past max_out), as nms.cu writes it.
//
// What bounds it: operations, not bytes (100 KB in, 4 N bytes out at
// N = 5000): N^2 / 2 IoUs, then a scan whose serial depth is the number of
// 64-box tiles.  The TPU kernel walked the blocks as sequential grid steps
// and carried a `removed` vector from one step to the next in scratch
// memory; thread blocks on this card run in no order, so the work is split
// in two launches:
//   pass 1  a 2-D grid of 64 x 64 tiles, one block each, only tiles on or
//           above the diagonal: thread t of tile (r, c) tests box 64 r + t
//           against the 64 boxes of tile c (held in shared memory; the test
//           is box_iou.cuh's iou_passes, which pays the IEEE division only
//           near the threshold) and writes one 64-bit word of the mask (N
//           rows of `ld` words; ld is the tile count rounded up to even, so
//           every row starts on 16 bytes), bit b set when box 64 c + b comes
//           later in the order and overlaps with IoU > threshold;
//   pass 2  one block, the chain over the tiles.  Its time is the chain's
//           length times one step's latency.  The first design's two
//           passes took 4.4 us a step at N = 5000 (79 steps): the diagonal
//           words and every kept box's words read from L2 on the chain, a
//           serial walk over all 64 bits, three block barriers.  Here a step
//           is about 1 us:
//           * a producer warp streams each tile's mask rows into a ring of
//             up to 4 stages in shared memory with 1-D TMA bulk copies
//             (cp.async.bulk, completion on an mbarrier), ahead of the
//             chain: the whole rows in one copy where three stages of them
//             fit (N <= 8,192), else the columns from the tile's own up to
//             a cap, one copy a row (the columns past it come from L2);
//           * the chain warp walks only the tile's alive bits (__ffs over
//             ~removed, in 32-bit halves; about 9 a tile on the bench rows,
//             not 64), one broadcast shared-memory load of the diagonal
//             word a kept box;
//           * it ORs the kept boxes' words into the next tile's `removed`
//             word itself (lane l takes boxes l and l + 32, a warp
//             reduction), publishes the tile's kept word, writes the ranks
//             (the count so far plus the popcount below the bit) and stops
//             at the max_out-th kept box, so the wrapper launches no
//             cumsum;
//           * six helper warps OR the kept words into every tile from the
//             one after next on (shared-memory atomics: OR does not depend
//             on their order), off the chain.  Each helper publishes the
//             tiles it is done with; the chain reads tile r once every one
//             of them is done with tile r - 2.  (A count over all helpers
//             is not enough: the helpers with no later tiles to OR run
//             ahead and would make up for one that lags.)
//           The stages return to the producer when the chain and the
//           helpers have arrived on their mbarrier; no block barrier is on
//           the chain.
// The mask scratch (N x ld x 8 bytes, 3.2 MB at N = 5000) is allocated by the
// wrapper and stays in L2 between the passes.
//
// IoU arithmetic as in nms.cu (box_iou.cuh): areas first, (area_i +
// area_j) - inter, IEEE division, union > 0 guard, NaN-propagating max / min
// (a box with a NaN coordinate has IoU 0 with every box); build with
// -fmad=false.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "box_iou.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kMaxTiles = 1024;         // N <= 65,536
constexpr int kScanThreads = 256;       // all set up; warp 0 scans, warp 1 copies,
constexpr int kHelpers = 6;             // and warps 2-7 OR kept boxes into later tiles
constexpr int kMaxStages = 4;
constexpr int kStageBudget = 192 * 1024;  // shared memory for the ring

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float *__restrict__ boxes,  // (N, 4), score-descending
                unsigned long long *__restrict__ mask,  // (N, ld)
                int n, int ld, float iou_thr) {
  const int r = blockIdx.y;
  const int c = blockIdx.x;
  if (c < r) return;
  __shared__ float cb[kTile][5];  // x1 y1 x2 y2 area of the column tile
  const int t = threadIdx.x;
  const int cj = c * kTile + t;
  if (cj < n) {
    float x1 = boxes[4 * cj], y1 = boxes[4 * cj + 1];
    float x2 = boxes[4 * cj + 2], y2 = boxes[4 * cj + 3];
    cb[t][0] = x1;
    cb[t][1] = y1;
    cb[t][2] = x2;
    cb[t][3] = y2;
    cb[t][4] = box_area(x1, y1, x2, y2);
  }
  __syncthreads();
  const int i = r * kTile + t;
  if (i >= n) return;
  const float x1 = boxes[4 * i], y1 = boxes[4 * i + 1];
  const float x2 = boxes[4 * i + 2], y2 = boxes[4 * i + 3];
  const float area = box_area(x1, y1, x2, y2);
  const int cols = min(kTile, n - c * kTile);
  unsigned long long word = 0ull;
  for (int b = (r == c ? t + 1 : 0); b < cols; ++b) {
    // box_iou(...) > iou_thr, decided as the IEEE quotient decides it.
    if (iou_passes<false>(overlap_w(x1, x2, cb[b][0], cb[b][2]),
                          overlap_w(y1, y2, cb[b][1], cb[b][3]), area, cb[b][4], iou_thr))
      word |= 1ull << b;
  }
  mask[(size_t)i * ld + c] = word;
}

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the barrier's phase differs from `parity`.  A wait here lasts
// microseconds; one that outlasts 2^28 polls is a lost arrival, and a trap
// (the launch then fails) is better than a block that never ends.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t polls = 0;
  while (!mbar_try_wait(bar, parity))
    if (++polls == (1u << 28)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void *src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A 64-bit word of shared memory.  Volatile asm: the loads of one step are
// issued in the order written, all before the ORs that use them, so they are
// in flight together (left to itself the compiler reused one register for
// every load and waited for each in turn: 3.5x slower).
__device__ __forceinline__ unsigned long long lds64(const unsigned long long *p) {
  unsigned long long v;
  asm volatile("ld.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(smem_u32(p)));
  return v;
}

struct ScanShared {
  unsigned long long full[kMaxStages];   // a stage's rows have landed
  unsigned long long empty[kMaxStages];  // the chain and the helpers are done with it
  unsigned long long removed[kMaxTiles];
  unsigned long long kept[kMaxTiles];    // a tile's kept boxes, once resolved
  int resolved;         // tiles the chain has resolved
  int done[kHelpers];   // per helper warp: tiles whose ORs are in `removed`
  int stop;             // the chain ended: the producer and the helpers stop
};

__device__ __forceinline__ int load_volatile(const int *p) {
  return *reinterpret_cast<const volatile int *>(p);
}

// Spin until *p >= target or the chain has stopped; false if it stopped.
__device__ __forceinline__ bool wait_count(const int *p, int target, const int *stop) {
  uint32_t polls = 0;
  while (load_volatile(p) < target) {
    if (load_volatile(stop)) return false;
    if (++polls == (1u << 28)) __trap();
  }
  __threadfence_block();
  return true;
}

// Spin until every helper warp is done with tiles 0 .. target - 1.  Every
// lane reads every helper's count itself, so what a helper wrote before its
// count is visible to each lane after the fence.
__device__ __forceinline__ void wait_helpers(const int *done, int target) {
  uint32_t polls = 0;
  for (;;) {
    int least = load_volatile(&done[0]);
#pragma unroll
    for (int h = 1; h < kHelpers; ++h) least = min(least, load_volatile(&done[h]));
    if (least >= target) break;
    if (++polls == (1u << 28)) __trap();
  }
  __threadfence_block();
}

// The chain over the tiles.  Shared memory: ScanShared, then `stages`
// stages of 64 rows x `sw` words.  With `whole`, a stage is the tile's 64
// mask rows as they lie in memory (sw = ld), one bulk copy; else each row
// holds mask columns c0 .. c0 + w - 1 of one box, c0 = the tile's column
// rounded down to even and w = min(wcap, ld - c0), one bulk copy a row.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float *__restrict__ scores,  // (N,)
                const unsigned long long *__restrict__ mask,  // (N, ld)
                int *__restrict__ rank,  // (N,) out
                int n, int ld, int wcap, int sw, int stages, int whole, float score_thr,
                int max_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ScanShared &sh = *reinterpret_cast<ScanShared *>(smem_raw);
  unsigned long long *ring = reinterpret_cast<unsigned long long *>(
      smem_raw + ((sizeof(ScanShared) + 127) & ~(size_t)127));
  const int tiles = (n + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Set-up, every thread: all ranks -1; the bits of boxes that never take
  // part (score <= threshold, or beyond N), a ballot of 32 boxes a warp.
  for (int i = threadIdx.x; i < n; i += kScanThreads) rank[i] = -1;
  for (int i = threadIdx.x; i < tiles * kTile; i += kScanThreads) {
    const unsigned out = __ballot_sync(0xffffffffu, i >= n || scores[i] <= score_thr);
    if (lane == 0) reinterpret_cast<unsigned *>(sh.removed)[i / 32] = out;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&sh.full[s]), 1);
      mbar_init(smem_u32(&sh.empty[s]), 1 + kHelpers);
    }
    sh.resolved = sh.stop = 0;
    for (int h = 0; h < kHelpers; ++h) sh.done[h] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (max_out <= 0) return;

  if (warp == 1) {
    // Producer: tile r's rows into stage r % stages once the chain has
    // released the tile that held it before.
    int issued = 0;
    for (int r = 0; r < tiles; ++r) {
      const int s = r % stages;
      const uint32_t full = smem_u32(&sh.full[s]);
      int go = 1;
      if (lane == 0 && r >= stages) {
        const uint32_t empty = smem_u32(&sh.empty[s]), parity = ((r / stages) - 1) & 1;
        uint32_t polls = 0;
        while (!mbar_try_wait(empty, parity)) {
          if (*reinterpret_cast<volatile int *>(&sh.stop)) {
            go = 0;
            break;
          }
          if (++polls == (1u << 28)) __trap();
        }
      }
      if (!__shfl_sync(0xffffffffu, go, 0)) break;
      const int rows = min(kTile, n - r * kTile);
      unsigned long long *stage = ring + (size_t)s * kTile * sw;
      const unsigned long long *first = mask + (size_t)r * kTile * ld;
      if (whole) {
        if (lane == 0) {
          mbar_expect_tx(full, (uint32_t)(rows * ld * 8));
          bulk_copy(smem_u32(stage), first, (uint32_t)(rows * ld * 8), full);
        }
      } else {
        const int c0 = r & ~1;
        const int w = min(wcap, ld - c0);
        if (lane == 0) mbar_expect_tx(full, (uint32_t)(rows * w * 8));
        __syncwarp();
        for (int b = lane; b < rows; b += 32)
          bulk_copy(smem_u32(stage + (size_t)b * sw), first + (size_t)b * ld + c0,
                    (uint32_t)(w * 8), full);
      }
      issued = r + 1;
    }
    // Every copy in flight lands before the block ends.
    if (lane == 0)
      for (int r = max(issued - stages, 0); r < issued; ++r)
        mbar_wait(smem_u32(&sh.full[r % stages]), (r / stages) & 1);
    return;
  }
  if (warp >= 2) {
    // Helpers: tile r's kept boxes OR their words into every tile from r + 2
    // on (the chain itself ORs into r + 1, the tile it resolves next), a
    // lane a tile; then the warp marks itself done with tile r and releases
    // its stage.  The chain reads tile t's word once every helper is done
    // with tile t - 2: it runs up to two tiles ahead of the slowest.
    const int g = (warp - 2) * 32 + lane;
    for (int r = 0; r + 2 < tiles; ++r) {
      if (!wait_count(&sh.resolved, r + 1, &sh.stop)) return;
      const unsigned long long kept =
          *reinterpret_cast<volatile unsigned long long *>(&sh.kept[r]);
      const int s = r % stages;
      const unsigned long long *stage = ring + (size_t)s * kTile * sw;
      const int c0 = whole ? 0 : r & ~1;
      const int split = min(tiles, c0 + (whole ? ld : min(wcap, ld - c0)));
      for (int t = r + 2 + g; t < tiles; t += 32 * kHelpers) {
        unsigned long long acc = 0ull;
        // Four kept boxes a step, their loads in flight together (a missing
        // box repeats the first: OR is idempotent).
        for (unsigned long long k = kept; k;) {
          int b[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            b[q] = k ? __ffsll((long long)k) - 1 : b[0];
            k &= k - 1ull;
          }
          unsigned long long v[4];
          if (t < split) {
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = lds64(stage + (size_t)b[q] * sw + (t - c0));
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = mask[(size_t)(r * kTile + b[q]) * ld + t];
          }
          acc |= (v[0] | v[1]) | (v[2] | v[3]);
        }
        if (acc) atomicOr(&sh.removed[t], acc);
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *reinterpret_cast<volatile int *>(&sh.done[warp - 2]) = r + 1;
        mbar_arrive(smem_u32(&sh.empty[s]));
      }
    }
    return;
  }

  // Consumer: the chain, one warp.  Bit sets are handled as 32-bit halves:
  // a 64-bit shift, find-first-set or test is several dependent
  // instructions on this card, and the chain is made of them.
  int count = 0;  // boxes kept so far
  for (int r = 0; r < tiles; ++r) {
    const int s = r % stages;
    mbar_wait(smem_u32(&sh.full[s]), (r / stages) & 1);
    const unsigned long long *stage = ring + (size_t)s * kTile * sw;
    const int c0 = whole ? 0 : r & ~1;
    const int w = whole ? ld : min(wcap, ld - c0);
    // Box b's diagonal word: stage[b * sw + r - c0], read by every lane (one
    // broadcast load a kept box).
    const unsigned long long *diag = stage + (r - c0);
    // Tile r's word holds the ORs of tiles 0 .. r - 2 once every helper
    // is done with tile r - 2; tile r - 1's the chain made itself.
    if (r >= 2) wait_helpers(sh.done, r - 1);
    const unsigned long long rem0 =
        *reinterpret_cast<volatile unsigned long long *>(&sh.removed[r]);
    unsigned rem[2] = {(unsigned)rem0, (unsigned)(rem0 >> 32)};
    unsigned kept[2] = {0u, 0u};
    int nk = 0;
    const int need = max_out - count;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (unsigned alive = ~rem[h]; alive && nk < need;) {
        const int b = __ffs(alive) - 1;
        kept[h] |= 1u << b;
        ++nk;
        const unsigned long long d = diag[(size_t)(b + 32 * h) * sw];
        rem[0] |= (unsigned)d;
        rem[1] |= (unsigned)(d >> 32);
        alive = ~rem[h] & (0xfffffffeu << b);
      }
    }
    // Ranks of the tile's kept boxes (every other box stays -1).
    const unsigned below = (1u << lane) - 1u;
    if ((kept[0] >> lane) & 1u) rank[r * kTile + lane] = count + __popc(kept[0] & below);
    if ((kept[1] >> lane) & 1u)
      rank[r * kTile + 32 + lane] = count + __popc(kept[0]) + __popc(kept[1] & below);
    count += nk;
    const bool last = count >= max_out || r + 1 == tiles;
    if (!last) {
      // Publish the tile's kept boxes to the helpers, then OR them into the
      // next tile's word: lane l takes boxes l and l + 32, the warp
      // reduces.
      if (lane == 0) {
        sh.kept[r] = ((unsigned long long)kept[1] << 32) | kept[0];
        __threadfence_block();
        *reinterpret_cast<volatile int *>(&sh.resolved) = r + 1;
      }
      const int t = r + 1;
      unsigned long long v = 0ull;
      if (t < min(tiles, c0 + w)) {
        const unsigned long long *col = stage + (t - c0);
        if ((kept[0] >> lane) & 1u) v |= lds64(col + (size_t)lane * sw);
        if ((kept[1] >> lane) & 1u) v |= lds64(col + (size_t)(lane + 32) * sw);
      } else {
        const unsigned long long *col = mask + (size_t)r * kTile * ld + t;
        if ((kept[0] >> lane) & 1u) v |= col[(size_t)lane * ld];
        if ((kept[1] >> lane) & 1u) v |= col[(size_t)(lane + 32) * ld];
      }
      const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
      const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
      if (lane == 0) atomicOr(&sh.removed[t], ((unsigned long long)hi << 32) | lo);
    }
    __syncwarp();
    if (last) {
      if (lane == 0) *reinterpret_cast<volatile int *>(&sh.stop) = 1;
      break;
    }
    if (lane == 0) mbar_arrive(smem_u32(&sh.empty[s]));
  }
}

// The ring's shape for N boxes: whole rows, one bulk copy a stage, where
// three stages of them fit (N <= 8,192); else staged columns a row (wcap), a
// row's stride in words (sw: even, so rows start on 16 bytes; sw / 2 odd, so
// the lanes' diagonal reads spread over the banks), one bulk copy a row.
// Then the stages and the bytes.
struct Ring {
  int ld, wcap, sw, stages, whole;
  size_t bytes;
};

Ring ring_for(int n) {
  Ring g;
  const int tiles = (n + kTile - 1) / kTile;
  g.ld = (tiles + 1) & ~1;
  g.whole = (size_t)3 * kTile * g.ld * 8 <= (size_t)kStageBudget;
  g.wcap = g.ld;
  auto stride = [](int w) { return (w / 2) % 2 ? w : w + 2; };
  if (g.whole) {
    g.sw = g.ld;
  } else {
    // As many columns as leave two stages.
    while ((size_t)2 * kTile * stride(g.wcap) * 8 > (size_t)kStageBudget) g.wcap -= 2;
    g.sw = stride(g.wcap);
  }
  const size_t stage = (size_t)kTile * g.sw * 8;
  g.stages = (int)(kStageBudget / stage);
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.bytes = ((sizeof(ScanShared) + 127) & ~(size_t)127) + g.stages * stage;
  return g;
}

}  // namespace

extern "C" {

// Largest N the scan takes (1,024 tiles of 64 boxes).
int nms_blocked_max_n() { return kMaxTiles * kTile; }

// Number of 64-bit mask words the wrapper must provide as scratch.
long long nms_blocked_mask_words(int n) { return (long long)n * ring_for(n).ld; }

// The two passes, launched in turn on one stream; each returns
// cudaGetLastError() (0 on success).
// Pass 1: the mask.
int nms_blocked_mask_launch(const float *boxes, unsigned long long *mask, int n, float iou_thr,
                            void *stream) {
  const int tiles = (n + kTile - 1) / kTile;
  nms_mask_kernel<<<dim3(tiles, tiles), kTile, 0, (cudaStream_t)stream>>>(
      boxes, mask, n, ring_for(n).ld, iou_thr);
  return (int)cudaGetLastError();
}

// Pass 2: the ranks from the mask of pass 1.
int nms_blocked_scan_launch(const float *scores, const unsigned long long *mask, int *rank,
                            int n, float score_thr, int max_out, void *stream) {
  const Ring g = ring_for(n);
  cudaError_t err = cudaFuncSetAttribute(nms_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)g.bytes);
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<1, kScanThreads, g.bytes, (cudaStream_t)stream>>>(
      scores, mask, rank, n, g.ld, g.wcap, g.sw, g.stages, g.whole, score_thr, max_out);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Blocked (bitmask) greedy NMS over score-sorted boxes for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   K9  dan_tpu/ops/nms_blocked_pallas.py::_kernel
// and computes what it computes: given N boxes in descending score order,
// the kept mask of greedy NMS -- box i is kept unless an earlier kept box
// has IoU strictly greater than the threshold with it; boxes whose score is
// <= score_threshold are never kept and never suppress.  The kept set
// equals that of the argmax-loop kernel (nms.cu) on the same input.
//
// What bounds it: operations, not bytes (100 KB in, N bytes out at
// N = 5000): N^2 / 2 IoUs, then a scan whose serial depth is the number of
// 64-box tiles.  The TPU kernel walked the blocks as sequential grid steps
// and carried a `removed` vector from one step to the next in scratch
// memory; thread blocks on this card run in no order, so the work is split
// the usual CUDA way:
//   pass 1  a 2-D grid of 64 x 64 tiles, one block each, only tiles on or
//           above the diagonal: thread t of tile (r, c) tests box 64 r + t
//           against the 64 boxes of tile c (held in shared memory) and
//           writes one 64-bit word, bit b set when box 64 c + b comes
//           later in the order and overlaps with IoU > threshold;
//   pass 2  one block, thread t owning the `removed` word of tile t in a
//           register.  Tile by tile: the 64 diagonal words go to shared
//           memory, thread 0 resolves the tile serially (64 cheap steps),
//           then every thread of a later tile ORs in the words of the
//           tile's kept boxes (coalesced reads), and a barrier hands over
//           to the next tile.
// The mask scratch (N x tiles x 8 bytes, 3.2 MB at N = 5000) is allocated
// by the wrapper and stays in L2 between the passes.
//
// IoU arithmetic as in nms.cu (box_iou.cuh): areas first, (area_i +
// area_j) - inter, IEEE division, union > 0 guard, NaN-propagating max / min
// (a box with a NaN coordinate has IoU 0 with every box); build with
// -fmad=false.
#include <cuda_runtime.h>
#include <math.h>

#include "box_iou.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kMaxTiles = 1024;  // pass 2 is one block of one thread per tile

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float *__restrict__ boxes,  // (N, 4), score-descending
                unsigned long long *__restrict__ mask,  // (N, tiles)
                int n, int tiles, float iou_thr) {
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
    const float iou = box_iou(x1, y1, x2, y2, area, cb[b][0], cb[b][1], cb[b][2], cb[b][3],
                              cb[b][4]);
    if (iou > iou_thr) word |= 1ull << b;
  }
  mask[(size_t)i * tiles + c] = word;
}

__global__ void __launch_bounds__(kMaxTiles)
nms_scan_kernel(const float *__restrict__ scores,  // (N,)
                const unsigned long long *__restrict__ mask,
                unsigned char *__restrict__ kept,  // (N,) out 0 / 1
                int n, int tiles, float score_thr) {
  __shared__ unsigned long long diag[kTile];
  __shared__ unsigned long long kept_word;
  const int t = threadIdx.x;  // owns tile t (threads >= tiles only help load)
  // Bits of boxes that never take part: score <= threshold, or beyond N.
  unsigned long long removed = 0ull;
  if (t < tiles) {
    for (int b = 0; b < kTile; ++b) {
      int k = t * kTile + b;
      if (k >= n || scores[k] <= score_thr) removed |= 1ull << b;
    }
  }
  for (int r = 0; r < tiles; ++r) {
    if (t < kTile) {
      int i = r * kTile + t;
      diag[t] = i < n ? mask[(size_t)i * tiles + r] : 0ull;
    }
    __syncthreads();
    if (t == r) {
      // Serial resolution inside the tile: a box suppressed earlier never
      // suppresses a later one.
      unsigned long long rem = removed;
      for (int b = 0; b < kTile; ++b)
        if (!((rem >> b) & 1ull)) rem |= diag[b];
      removed = rem;
      kept_word = ~rem;
    }
    __syncthreads();
    const unsigned long long kw = kept_word;
    if (t < kTile) {
      int i = r * kTile + t;
      if (i < n) kept[i] = (unsigned char)((kw >> t) & 1ull);
    }
    if (t > r && t < tiles) {
      for (int b = 0; b < kTile; ++b)
        if ((kw >> b) & 1ull)
          removed |= mask[(size_t)(r * kTile + b) * tiles + t];
    }
    // diag and kept_word are rewritten at the top of the next iteration:
    // hold until every thread has read them.
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest N the scan takes (one thread per 64-box tile in one block).
int nms_blocked_max_n() { return kMaxTiles * kTile; }

// Number of 64-bit mask words the wrapper must provide as scratch.
long long nms_blocked_mask_words(int n) {
  long long tiles = (n + kTile - 1) / kTile;
  return (long long)n * tiles;
}

// Launches both passes on `stream`; returns cudaGetLastError().
int nms_blocked_launch(const float *boxes, const float *scores,
                       unsigned long long *mask, unsigned char *kept, int n,
                       float iou_thr, float score_thr, void *stream) {
  const int tiles = (n + kTile - 1) / kTile;
  cudaStream_t st = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3(tiles, tiles), kTile, 0, st>>>(boxes, mask, n, tiles, iou_thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = (((tiles > kTile ? tiles : kTile) + 31) / 32) * 32;
  nms_scan_kernel<<<1, threads, 0, st>>>(scores, mask, kept, n, tiles, score_thr);
  return (int)cudaGetLastError();
}

}  // extern "C"

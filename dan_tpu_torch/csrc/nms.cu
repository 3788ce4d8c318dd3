// Batched greedy NMS for Hopper (sm_90a): one thread block per image row.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  dan_tpu/ops/nms_batched_pallas.py::_kernel   (B rows in lockstep)
//   K2  dan_tpu/ops/nms_pallas.py::_nms_kernel       (one image; here B = 1)
// and computes what they compute: per row, repeatedly take the active box of
// highest score (lowest index on ties), give it the next selection rank,
// and deactivate it and every active box whose IoU with it is strictly
// greater than the threshold; stop after max_out selections or when no box
// is active.  rank[b, n] = k if box n was the k-th selected, else -1.  The
// input need not be sorted.
//
// What bounds it: not bytes.  One row reads 20 N bytes once (100 KB at
// N = 5000) and writes 4 N.  The cost is the serial depth of the greedy
// selection: a box can be kept only once every better box has been decided.
// A TPU core ran all rows in lockstep as (B, N) vector ops, one dependent
// step for every box kept (up to max_out = 750); here the rows are
// independent thread blocks spread over the SMs (B = 128 rows on 132 SMs),
// with boxes, areas and the masked scores (-inf once inactive) in shared
// memory for the whole row: 6 floats a box, 120 KB at N = 5000, which needs
// the opt-in above 48 KB of dynamic shared memory.
//
// What the design does about the depth.  While it loads the row the block
// tests whether the scores are non-increasing (one __syncthreads_or).  Every
// caller on the detect and TTA paths hands over rows that a stable sort has
// put in that order, and then the greedy order is the index order, so the
// argmax is not needed and the chain shrinks from one step a kept box to one
// step a TILE of 64 boxes:
//   a. all threads compute the 64 x 64 suppression bits of the tile (row i,
//      bit j > i: IoU(i, j) > threshold), a warp ballot packing each word;
//   b. every thread walks the 64 bits in order on the same shared words (a
//      box removed earlier never suppresses), counting kept boxes up to
//      max_out -- redundantly in each thread, which saves a barrier;
//   c. a kept box's rank is the row's running count plus the popcount of
//      the kept word below its bit;
//   d. one sweep: each thread tests one later box that is still active
//      against the tile's kept boxes and drops it at the first hit.
// A tile is the next 64 boxes that are still ACTIVE: the row's key array
// becomes the ordered list of active boxes, and the sweep compacts it (a
// ballot and a scan of the warps' counts), so a row that thins out takes
// fewer tiles (15-16 at N = 5000 with about 690 kept on an H100 run, not 79)
// and the sweep's warps stay full -- one SM's rate of IoUs is what is left
// of the cost.
// The IoUs are those the selection needs plus each tile's 2016 pairs.  Boxes
// with score <= the threshold are a tail of a sorted row and never enter
// the list.  A row that is not sorted takes the argmax loop: per step a
// block argmax over (score, -index) by warp shuffles and one sweep that
// suppresses and keeps a running argmax of the survivors.  Both are this
// kernel, chosen per row on the device; `path` reports which one a row took
// (1 = tile scan) and `tiles` the scan's dependent steps.
//
// Bit-exactness with the plain version (dan_tpu_torch/ops/nms_cuda.py):
// areas and IoU use the operation order of nms_batched_pallas.py:52,70-77,
// IEEE division, and the union > 0 guard, with NaN-propagating max / min
// (box_iou.cuh), so a box with a NaN coordinate has IoU 0 with every box as
// in the plain version.  The tile scan decides each pair as that expression
// does (`iou_passes`).
// Build with -fmad=false: an FMA contraction of (barea + area) - inter would
// change roundings and could flip a decision that sits right at the
// threshold.
#include <cuda_runtime.h>
#include <math.h>

#include "box_iou.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // boxes a dependent step of the tile scan resolves

// (v, i) beats (w, j): higher score, or equal score and lower index.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_argmax(float &v, int &i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, off);
    int j = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
}

struct Row {
  const float *x1, *y1, *x2, *y2, *area;
  float *key;  // score while active, -inf once inactive
  int n;
};

// The argmax loop, for a row in any order: one dependent step a kept box.
// my_v / my_i are this thread's best active (key, index) from the load.
__device__ __forceinline__ void argmax_loop(const Row s, int *__restrict__ r, int max_out,
                            float iou_thr, float my_v, int my_i) {
  const float *sx1 = s.x1, *sy1 = s.y1, *sx2 = s.x2, *sy2 = s.y2, *sarea = s.area;
  float *skey = s.key;
  const int n = s.n;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float best_v;
  __shared__ int best_i;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float neg_inf = -INFINITY;

  for (int step = 0; step < max_out; ++step) {
    // Block argmax of the per-thread bests.  The first barrier also makes
    // the previous sweep's shared writes visible.
    float v = my_v;
    int i = my_i;
    warp_argmax(v, i);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = warp_v[lane];
      i = warp_i[lane];
      warp_argmax(v, i);
      if (lane == 0) {
        best_v = v;
        best_i = i;
      }
    }
    __syncthreads();
    if (best_v == neg_inf) break;  // no active box is left in this row
    const int j = best_i;
    if (tid == 0) r[j] = step;

    const float bx1 = sx1[j], by1 = sy1[j], bx2 = sx2[j], by2 = sy2[j];
    const float barea = sarea[j];
    my_v = neg_inf;
    my_i = n;
    for (int k = tid; k < n; k += kThreads) {
      float key = skey[k];
      if (key == neg_inf) continue;
      const float iou = box_iou(bx1, by1, bx2, by2, barea, sx1[k], sy1[k], sx2[k], sy2[k],
                                sarea[k]);
      if (k == j || iou > iou_thr) {
        skey[k] = neg_inf;
      } else if (beats(key, k, my_v, my_i)) {
        my_v = key;
        my_i = k;
      }
    }
  }
}

// Whether the selected box j suppresses box k.
__device__ __forceinline__ bool suppresses(const Row &s, int j, int k, float iou_thr) {
  return iou_passes<false>(overlap_w(s.x1[j], s.x2[j], s.x1[k], s.x2[k]),
                           overlap_w(s.y1[j], s.y2[j], s.y1[k], s.y2[k]), s.area[j], s.area[k],
                           iou_thr);
}

// The tile scan, for a row whose scores are non-increasing: the greedy order
// is the index order, so one dependent step resolves a tile -- the next 64
// boxes that are still active.  n_live is the length of the prefix with
// score > the score threshold.  The row's key array is not needed on this
// path and holds the list of active boxes, in order, instead: the sweep
// compacts it, so tiles and warps stay dense while the row thins out.
__device__ __forceinline__ void tile_scan(const Row s, int *__restrict__ r, int max_out,
                          float iou_thr, int n_live, int *__restrict__ tiles_out) {
  __shared__ unsigned long long sup[kTile];  // bit j of sup[i]: i suppresses j > i
  __shared__ float4 kept_box[kTile];         // the tile's kept boxes, packed
  __shared__ float kept_area[kTile];
  __shared__ int warp_total[2][kWarps];
  int *act = reinterpret_cast<int *>(s.key);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int k = tid; k < n_live; k += kThreads) act[k] = k;
  __syncthreads();

  int m = n_live;  // active boxes left; like count, the same in every thread
  int count = 0;   // boxes kept so far
  int tiles = 0;
  while (m > 0 && count < max_out) {
    ++tiles;
    const int tn = min(kTile, m);
    // a. The tile's suppression words: warp w makes rows w and w + 32, a
    // lane the bits lane and lane + 32.
#pragma unroll
    for (int h = 0; h < kTile / kWarps; ++h) {
      const int i = warp + h * kWarps;
      unsigned lo = 0, hi = 0;
      if (i < tn) {  // uniform in the warp
        const int bi = act[i];
        lo = __ballot_sync(0xffffffffu, lane > i && lane < tn &&
                                            suppresses(s, bi, act[lane], iou_thr));
        hi = __ballot_sync(0xffffffffu, 32 + lane > i && 32 + lane < tn &&
                                            suppresses(s, bi, act[32 + lane], iou_thr));
      }
      if (lane == 0) sup[i] = ((unsigned long long)hi << 32) | lo;
    }
    __syncthreads();

    // b. Resolve the tile in order; every thread does the same walk on the
    // same words (a box removed earlier never suppresses).
    unsigned long long alive = tn == kTile ? ~0ull : (1ull << tn) - 1ull, kept = 0;
    const int base = count;
    while (alive && count < max_out) {
      const int i = __ffsll((long long)alive) - 1;
      kept |= 1ull << i;
      ++count;
      alive &= ~(sup[i] | (1ull << i));
    }

    // c. Ranks of the tile's kept boxes, and the boxes packed for the sweep.
    if (tid < tn && ((kept >> tid) & 1ull)) {
      const int c = __popcll(kept & ((1ull << tid) - 1ull));
      const int b = act[tid];
      r[b] = base + c;
      kept_box[c] = make_float4(s.x1[b], s.y1[b], s.x2[b], s.y2[b]);
      kept_area[c] = s.area[b];
    }
    const int n_kept = __popcll(kept);
    __syncthreads();
    if (count >= max_out) break;

    // d. One sweep over the rest of the list: a box that a kept box of this
    // tile suppresses drops out, the others move up in order (a ballot and a
    // scan of the warps' counts for every 1024 entries).
    int out = 0;
    int par = 0;
    for (int e0 = tn; e0 < m; e0 += kThreads, par ^= 1) {
      const int e = e0 + tid;
      bool live = false;
      int b = 0;
      if (e < m) {
        b = act[e];
        const float x1 = s.x1[b], y1 = s.y1[b], x2 = s.x2[b], y2 = s.y2[b];
        const float area = s.area[b];
        live = true;
        for (int c = 0; c < n_kept; ++c) {
          // suppresses(), with the kept box from its packed copy.
          const float4 kb = kept_box[c];
          if (iou_passes<false>(overlap_w(kb.x, kb.z, x1, x2), overlap_w(kb.y, kb.w, y1, y2),
                                kept_area[c], area, iou_thr)) {
            live = false;
            break;
          }
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (lane == 0) warp_total[par][warp] = __popc(bal);
      __syncthreads();
      int scan = warp_total[par][lane];  // inclusive scan over the 32 warps
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, scan, off);
        if (lane >= off) scan += up;
      }
      const int before = __shfl_sync(0xffffffffu, scan, max(warp - 1, 0));
      const int total = __shfl_sync(0xffffffffu, scan, 31);
      // Lands below e: in entries this chunk or an earlier one has read.
      if (live) act[out + (warp ? before : 0) + __popc(bal & ((1u << lane) - 1u))] = b;
      out += total;
    }
    __syncthreads();
    m = out;
  }
  if (tid == 0) *tiles_out = tiles;
}

__global__ void __launch_bounds__(kThreads, 1)
nms_rank_kernel(const float *__restrict__ boxes,   // (B, N, 4)
                const float *__restrict__ scores,  // (B, N)
                int *__restrict__ rank,            // (B, N) out
                unsigned char *__restrict__ path,  // (B,) out: 1 = tile scan
                int *__restrict__ tiles,           // (B,) out: the scan's steps
                int n, int max_out, float iou_thr, float score_thr) {
  extern __shared__ float smem[];
  float *sx1 = smem;
  float *sy1 = sx1 + n;
  float *sx2 = sy1 + n;
  float *sy2 = sx2 + n;
  float *sarea = sy2 + n;
  float *skey = sarea + n;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float *b = boxes + (size_t)row * n * 4;
  const float *s = scores + (size_t)row * n;
  int *r = rank + (size_t)row * n;
  const float neg_inf = -INFINITY;

  // In a sorted row the boxes with score > score_thr are a prefix; the one
  // box at its end writes its length (an unsorted row does not use it).
  __shared__ int live_prefix;
  if (tid == 0) live_prefix = 0;
  __syncthreads();

  float my_v = neg_inf;
  int my_i = n;
  int out_of_order = 0;
  for (int k = tid; k < n; k += kThreads) {
    float x1 = b[4 * k], y1 = b[4 * k + 1], x2 = b[4 * k + 2], y2 = b[4 * k + 3];
    sx1[k] = x1;
    sy1[k] = y1;
    sx2[k] = x2;
    sy2[k] = y2;
    sarea[k] = box_area(x1, y1, x2, y2);
    float sc = s[k];
    float key = sc > score_thr ? sc : neg_inf;
    skey[k] = key;
    r[k] = -1;
    if (beats(key, k, my_v, my_i)) {
      my_v = key;
      my_i = k;
    }
    if (k + 1 < n) {
      const float next = s[k + 1];
      // Sorted means s[k] >= s[k + 1] for every k; a NaN fails the test.
      if (!(sc >= next)) out_of_order = 1;
      if (key != neg_inf && !(next > score_thr)) live_prefix = k + 1;
    } else if (key != neg_inf) {
      live_prefix = n;
    }
  }
  // A barrier too: the row is in shared memory after it.
  const bool sorted = __syncthreads_or(out_of_order) == 0;
  const int n_live = live_prefix;
  if (tid == 0) {
    path[row] = sorted ? 1 : 0;
    tiles[row] = 0;
  }

  const Row sm = {sx1, sy1, sx2, sy2, sarea, skey, n};
  if (sorted) {
    tile_scan(sm, r, max_out, iou_thr, n_live, tiles + row);
  } else {
    argmax_loop(sm, r, max_out, iou_thr, my_v, my_i);
  }
}

}  // namespace

extern "C" {

// Largest row length the kernel takes: six floats a box in shared memory,
// within the 227 KB a block may use on sm_90 (3 KB are the static arrays).
int nms_rank_max_n() { return (227 * 1024 - 3072) / (6 * (int)sizeof(float)); }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int nms_rank_launch(const float *boxes, const float *scores, int *rank,
                    unsigned char *path, int *tiles, int batch, int n, int max_out,
                    float iou_thr, float score_thr, void *stream) {
  size_t smem = (size_t)6 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_rank_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      boxes, scores, rank, path, tiles, n, max_out, iou_thr, score_thr);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Anchor matching for Hopper (sm_90a): the two passes of the S3FD matcher
// over a whole batch in three kernels.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K3  dan_tpu/ops/matching_pallas.py::_stats_kernel   (pass 1, stats)
//   K4  dan_tpu/ops/matching_pallas.py::_assign_kernel  (pass 2, assign)
// and computes what dan_tpu/box/matching.py::match_anchors computes, image
// by image, with the same tie-breaks:
//   pass 1a (per anchor): the raw best IoU over the valid gts and its gt,
//           lowest gt index on ties;
//   pass 1b (per gt): the best anchor (lowest index on ties; an all-zero
//           column claims anchor 0), the count of anchors whose pass-1a gt
//           is this gt with IoU >= threshold and > 0, and the k-th entry of
//           the column under the order (IoU desc, anchor index asc), which
//           is what lax.top_k selects;
//   pass 2  (per anchor): aug = iou + 2*forced + min(comp, 1) over the gts,
//           argmax with the lowest gt index, and the matched gt's
//           (cx, cy, w, h).
// `needs` (count < k and valid) is computed between the passes by the
// wrapper, as the JAX package does outside its kernels.
//
// What bounds it: not bytes.  The inputs are a few hundred KB; the cost is
// the A x G IoUs (34,125 x 256 an image at 640) and, in pass 1b, k = 6
// ordered selections per gt.  Two things keep it small:
//   * a masked gt has IoU 0 against every anchor and can never win a
//     lowest-index tie against gt 0, so every pass walks only the image's
//     valid gts (compacted into shared memory in ascending order), and
//     pass 1b returns at once for a masked gt;
//   * pass 1b caches its gt's IoU column in shared memory (136 KB at
//     A = 34,125) when it fits, so the k selection rounds re-read shared
//     memory instead of recomputing IoUs.
// There are no float atomics: every reduction is a block reduction in a
// fixed order, so the result never depends on block scheduling.
//
// Bit-exactness with the plain version (dan_tpu_torch/box/matching.py):
// areas and IoU use the operation order of matching_pallas.py:76-84 and
// box/iou.py (areas first, (a_area + g_area) - inter, IEEE division, the
// union > 0 guard), aug uses the order of matching_pallas.py:241-248, and
// the file is built with -fmad=false so that no product is fused into an
// addition.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxG = 512;  // gts an image may carry (shared memory lists)
constexpr int kAnchorThreads = 256;
constexpr int kGtThreads = 512;
constexpr int kGtWarps = kGtThreads / 32;

// (v, i) beats (w, j): higher value, or equal value and lower index.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ float box_iou(float ax1, float ay1, float ax2,
                                         float ay2, float a_area, float gx1,
                                         float gy1, float gx2, float gy2,
                                         float g_area) {
  const float ix1 = fmaxf(ax1, gx1);
  const float iy1 = fmaxf(ay1, gy1);
  const float ix2 = fminf(ax2, gx2);
  const float iy2 = fminf(ay2, gy2);
  const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
  const float uni = (a_area + g_area) - inter;
  return uni > 0.0f ? inter / uni : 0.0f;
}

__device__ __forceinline__ float area(float x1, float y1, float x2, float y2) {
  return fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
}

// The valid gts of one image, in ascending index order, in shared memory.
struct GtList {
  float x1[kMaxG], y1[kMaxG], x2[kMaxG], y2[kMaxG], area[kMaxG];
  int idx[kMaxG];
  int n;
};

// Warp 0 compacts the valid gts of image b into `s` (ballot + popc keeps
// ascending order); the caller syncs.
__device__ void load_valid_gts(const float *__restrict__ gt,
                               const float *__restrict__ valid, int b, int g_n,
                               GtList &s) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int count = 0;
  for (int base = 0; base < g_n; base += 32) {
    const int g = base + lane;
    const bool v = g < g_n && valid[(size_t)b * g_n + g] > 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (v) {
      const int pos = count + __popc(m & ((1u << lane) - 1u));
      const float *p = gt + ((size_t)b * g_n + g) * 4;
      s.x1[pos] = p[0];
      s.y1[pos] = p[1];
      s.x2[pos] = p[2];
      s.y2[pos] = p[3];
      s.area[pos] = area(p[0], p[1], p[2], p[3]);
      s.idx[pos] = g;
    }
    count += __popc(m);
  }
  if (lane == 0) s.n = count;
}

// Pass 1a: per anchor, the raw best IoU and its gt.
__global__ void __launch_bounds__(kAnchorThreads)
anchor_best_kernel(const float *__restrict__ anchors,  // (4, A) corner rows
                   const float *__restrict__ gt,       // (B, G, 4)
                   const float *__restrict__ valid,    // (B, G) 1.0 / 0.0
                   float *__restrict__ best_iou,       // (B, A) out
                   int *__restrict__ best_gt,          // (B, A) out
                   int a_n, int g_n) {
  __shared__ GtList s;
  const int b = blockIdx.y;
  load_valid_gts(gt, valid, b, g_n, s);
  __syncthreads();
  const int a = blockIdx.x * kAnchorThreads + threadIdx.x;
  if (a >= a_n) return;
  const float ax1 = anchors[a], ay1 = anchors[a_n + a];
  const float ax2 = anchors[2 * a_n + a], ay2 = anchors[3 * a_n + a];
  const float a_area = area(ax1, ay1, ax2, ay2);
  // Every gt scores >= 0 and gt 0 scores at least 0, so starting from
  // (0, gt 0) and taking strict improvements over the valid gts in order
  // is the argmax over all G gts with the lowest index on ties.
  float best = 0.0f;
  int arg = 0;
  for (int j = 0; j < s.n; ++j) {
    const float v = box_iou(ax1, ay1, ax2, ay2, a_area, s.x1[j], s.y1[j],
                            s.x2[j], s.y2[j], s.area[j]);
    if (v > best) {
      best = v;
      arg = s.idx[j];
    }
  }
  best_iou[(size_t)b * a_n + a] = best;
  best_gt[(size_t)b * a_n + a] = arg;
}

// Block-wide (value desc, index asc) argmax of every thread's (v, i); every
// thread gets the result.  Uses the two shared arrays and syncs.
__device__ void block_argmax(float &v, int &i, float *wv, int *wi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  v = wv[0];
  i = wi[0];
  for (int k = 1; k < kGtWarps; ++k) {
    if (beats(wv[k], wi[k], v, i)) {
      v = wv[k];
      i = wi[k];
    }
  }
  __syncthreads();  // the arrays are reused by the next call
}

// Pass 1b: one block per (gt, image).
__global__ void __launch_bounds__(kGtThreads)
gt_stats_kernel(const float *__restrict__ anchors,   // (4, A)
                const float *__restrict__ gt,        // (B, G, 4)
                const float *__restrict__ valid,     // (B, G)
                const float *__restrict__ best_iou,  // (B, A) from pass 1a
                const int *__restrict__ best_gt,     // (B, A) from pass 1a
                int *__restrict__ gt_best_anchor,    // (B, G) out
                int *__restrict__ gt_count,          // (B, G) out
                float *__restrict__ kth_v,           // (B, G) out
                int *__restrict__ kth_i,             // (B, G) out
                int a_n, int g_n, int k, float match_threshold,
                int cache_column) {
  extern __shared__ float column[];  // A IoUs when cache_column
  __shared__ float wv[kGtWarps];
  __shared__ int wi[kGtWarps];
  __shared__ int wc[kGtWarps];
  const int g = blockIdx.x, b = blockIdx.y;
  const size_t gb = (size_t)b * g_n + g;
  if (!(valid[gb] > 0.0f)) {
    // A masked column is all zeros: its argmax is anchor 0 and its k-th
    // entry (0, k-1).  Neither reaches the targets (forced and comp are
    // masked), but the values are defined.
    if (threadIdx.x == 0) {
      gt_best_anchor[gb] = 0;
      gt_count[gb] = 0;
      kth_v[gb] = 0.0f;
      kth_i[gb] = k - 1;
    }
    return;
  }
  const float *p = gt + gb * 4;
  const float gx1 = p[0], gy1 = p[1], gx2 = p[2], gy2 = p[3];
  const float g_area = area(gx1, gy1, gx2, gy2);
  const float *bi = best_iou + (size_t)b * a_n;
  const int *bg = best_gt + (size_t)b * a_n;

  // Sweep 1: the IoUs (cached), the count, and the first selection.
  float lv = -1.0f;
  int li = INT_MAX;
  int count = 0;
  for (int a = threadIdx.x; a < a_n; a += kGtThreads) {
    const float ax1 = anchors[a], ay1 = anchors[a_n + a];
    const float ax2 = anchors[2 * a_n + a], ay2 = anchors[3 * a_n + a];
    const float v = box_iou(ax1, ay1, ax2, ay2, area(ax1, ay1, ax2, ay2), gx1,
                            gy1, gx2, gy2, g_area);
    if (cache_column) column[a] = v;
    if (beats(v, a, lv, li)) {
      lv = v;
      li = a;
    }
    const float ab = bi[a];
    count += (bg[a] == g && ab >= match_threshold && ab > 0.0f) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) wc[threadIdx.x >> 5] = count;
  block_argmax(lv, li, wv, wi);  // syncs, so wc is complete
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kGtWarps; ++w) total += wc[w];
    gt_best_anchor[gb] = li;
    gt_count[gb] = total;
  }
  // Rounds 2..k: the best entry strictly after the previous selection.
  for (int round = 1; round < k; ++round) {
    const float pv = lv;
    const int pi = li;
    lv = -1.0f;
    li = INT_MAX;
    for (int a = threadIdx.x; a < a_n; a += kGtThreads) {
      float v;
      if (cache_column) {
        v = column[a];
      } else {
        const float ax1 = anchors[a], ay1 = anchors[a_n + a];
        const float ax2 = anchors[2 * a_n + a], ay2 = anchors[3 * a_n + a];
        v = box_iou(ax1, ay1, ax2, ay2, area(ax1, ay1, ax2, ay2), gx1, gy1,
                    gx2, gy2, g_area);
      }
      if (beats(pv, pi, v, a) && beats(v, a, lv, li)) {
        lv = v;
        li = a;
      }
    }
    block_argmax(lv, li, wv, wi);
  }
  if (threadIdx.x == 0) {
    kth_v[gb] = lv;
    kth_i[gb] = li;
  }
}

// Pass 2: per anchor, the augmented argmax over the gts.
__global__ void __launch_bounds__(kAnchorThreads)
assign_kernel(const float *__restrict__ anchors,       // (4, A)
              const float *__restrict__ gt,            // (B, G, 4)
              const float *__restrict__ valid,         // (B, G)
              const int *__restrict__ gt_best_anchor,  // (B, G)
              const float *__restrict__ needs,         // (B, G) 1.0 / 0.0
              const float *__restrict__ kth_v,         // (B, G)
              const int *__restrict__ kth_i,           // (B, G)
              const float *__restrict__ centers,       // (B, G, 4) cx cy w h
              int *__restrict__ matched_gt,            // (B, A) out
              float *__restrict__ matched_aug,         // (B, A) out
              float *__restrict__ matched_center,      // (B, A, 4) out
              int a_n, int g_n, float scale_comp_iou) {
  __shared__ GtList s;
  __shared__ int s_best[kMaxG];
  __shared__ float s_needs[kMaxG], s_kv[kMaxG];
  __shared__ int s_ki[kMaxG];
  const int b = blockIdx.y;
  load_valid_gts(gt, valid, b, g_n, s);
  __syncthreads();
  for (int j = threadIdx.x; j < s.n; j += kAnchorThreads) {
    const size_t gb = (size_t)b * g_n + s.idx[j];
    s_best[j] = gt_best_anchor[gb];
    s_needs[j] = needs[gb];
    s_kv[j] = kth_v[gb];
    s_ki[j] = kth_i[gb];
  }
  __syncthreads();
  const int a = blockIdx.x * kAnchorThreads + threadIdx.x;
  if (a >= a_n) return;
  const float ax1 = anchors[a], ay1 = anchors[a_n + a];
  const float ax2 = anchors[2 * a_n + a], ay2 = anchors[3 * a_n + a];
  const float a_area = area(ax1, ay1, ax2, ay2);
  // As in pass 1a: a masked gt scores exactly 0, so (0, gt 0) plus strict
  // improvements over the valid gts is the lowest-index argmax over all G.
  float best = 0.0f;
  int arg = 0;
  for (int j = 0; j < s.n; ++j) {
    const float iou = box_iou(ax1, ay1, ax2, ay2, a_area, s.x1[j], s.y1[j],
                              s.x2[j], s.y2[j], s.area[j]);
    const float forced = a == s_best[j] ? 1.0f : 0.0f;
    const bool in_topk = iou > s_kv[j] || (iou == s_kv[j] && a <= s_ki[j]);
    const float comp =
        (s_needs[j] > 0.0f && in_topk && iou > scale_comp_iou) ? 1.0f : 0.0f;
    const float aug = (iou + 2.0f * forced) + fminf(comp, 1.0f);
    if (aug > best) {
      best = aug;
      arg = s.idx[j];
    }
  }
  const size_t ba = (size_t)b * a_n + a;
  matched_gt[ba] = arg;
  matched_aug[ba] = best;
  const float *c = centers + ((size_t)b * g_n + arg) * 4;
  float *o = matched_center + ba * 4;
  o[0] = c[0];
  o[1] = c[1];
  o[2] = c[2];
  o[3] = c[3];
}

}  // namespace

extern "C" {

int match_max_gt() { return kMaxG; }

// Pass 1 (K3): anchor_best_kernel then gt_stats_kernel on `stream`.
int match_stats_launch(const float *anchors, const float *gt,
                       const float *valid, float *best_iou, int *best_gt,
                       int *gt_best_anchor, int *gt_count, float *kth_v,
                       int *kth_i, int b, int a_n, int g_n, int k,
                       float match_threshold, cudaStream_t stream) {
  if (g_n > kMaxG || k < 1 || k > a_n) return (int)cudaErrorInvalidValue;
  if (b == 0 || a_n == 0 || g_n == 0) return 0;
  dim3 grid_a((a_n + kAnchorThreads - 1) / kAnchorThreads, b);
  anchor_best_kernel<<<grid_a, kAnchorThreads, 0, stream>>>(
      anchors, gt, valid, best_iou, best_gt, a_n, g_n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // Cache the IoU column in dynamic shared memory when it fits.
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t static_bytes = kGtWarps * (2 * sizeof(float) + sizeof(int));
  const size_t col_bytes = (size_t)a_n * sizeof(float);
  const int cache = col_bytes + static_bytes + 1024 <= (size_t)optin;
  const size_t dyn = cache ? col_bytes : 0;
  if (dyn > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(gt_stats_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)dyn);
    if (err) return err;
  }
  dim3 grid_g(g_n, b);
  gt_stats_kernel<<<grid_g, kGtThreads, dyn, stream>>>(
      anchors, gt, valid, best_iou, best_gt, gt_best_anchor, gt_count, kth_v,
      kth_i, a_n, g_n, k, match_threshold, cache);
  return (int)cudaGetLastError();
}

// Pass 2 (K4).
int match_assign_launch(const float *anchors, const float *gt,
                        const float *valid, const int *gt_best_anchor,
                        const float *needs, const float *kth_v,
                        const int *kth_i, const float *centers,
                        int *matched_gt, float *matched_aug,
                        float *matched_center, int b, int a_n, int g_n,
                        float scale_comp_iou, cudaStream_t stream) {
  if (g_n > kMaxG) return (int)cudaErrorInvalidValue;
  if (b == 0 || a_n == 0 || g_n == 0) return 0;
  dim3 grid((a_n + kAnchorThreads - 1) / kAnchorThreads, b);
  assign_kernel<<<grid, kAnchorThreads, 0, stream>>>(
      anchors, gt, valid, gt_best_anchor, needs, kth_v, kth_i, centers,
      matched_gt, matched_aug, matched_center, a_n, g_n, scale_comp_iou);
  return (int)cudaGetLastError();
}

}  // extern "C"

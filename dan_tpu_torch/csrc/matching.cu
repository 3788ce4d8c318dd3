// Anchor matching for Hopper (sm_90a): the two passes of the S3FD matcher
// over a whole batch in three kernels behind one C entry point.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K3  dan_tpu/ops/matching_pallas.py::_stats_kernel   (pass 1, stats)
//   K4  dan_tpu/ops/matching_pallas.py::_assign_kernel  (pass 2, assign)
// and computes what dan_tpu/box/matching.py::match_anchors computes, image
// by image, with the same tie-breaks, down to the four MatchTargets leaves:
//   pass 1a (per anchor): the raw best IoU over the valid gts and its gt,
//           lowest gt index on ties (the raw best IoU is `matched_iou`);
//   pass 1b (per valid gt): the best anchor (lowest index on ties), the
//           count of anchors whose pass-1a gt is this gt with IoU >=
//           threshold and > 0, and the k-th entry of the column under the
//           order (IoU desc, anchor index asc), which is what lax.top_k
//           selects;
//   pass 2  (per anchor): needs = count < k (a masked gt never reaches
//           this pass); aug = iou + 2*forced + min(comp, 1) over the gts,
//           argmax with the lowest gt index; then the targets, in the
//           operation order of box/matching.py::finish_targets /
//           encode_boxes and box/anchors.py::corner_to_center: cls_target
//           (1 positive, -1 in the ignore band, else 0), loc_target
//           (centre offsets over the anchor size and the prior scaling,
//           log size ratios with the gt size clamped at 1e-6, zeros off the
//           positives) and matched_gt.
// The anchors come in centre format, (A, 4), and every pass makes their
// corners in center_to_corner's operation order; the gt mask comes as the
// bool bytes it is.  match_launch enqueues the three kernels on one stream
// with nothing in between.
//
// What bounds it: not bytes.  The inputs are a few hundred KB and the
// outputs 28 bytes an anchor (30 MB at B = 32, A = 34,125); the cost is the
// A x G IoUs and, in pass 1b, k = 6 ordered selections a gt.  What keeps it
// small:
//   * a masked gt has IoU 0 against every anchor and can never win a
//     lowest-index tie against gt 0, so every pass walks only the image's
//     valid gts (compacted into shared memory in ascending order);
//   * pass 1b has one block an SM, and the blocks take the batch's valid
//     gts round-robin in (image, gt) order: its grid depends on neither the
//     padded G nor the batch, and a padded gt costs no block;
//   * pass 1b caches its gt's IoU column in shared memory (136 KB at
//     A = 34,125) when it fits, so the k selection rounds re-read shared
//     memory instead of recomputing IoUs;
//   * the device attributes are read once a process.
// There are no float atomics: every reduction is a block reduction in a
// fixed order, so the result never depends on block scheduling.
//
// Bit-exactness with the plain version (dan_tpu_torch/box/matching.py):
// areas and IoU use the operation order of matching_pallas.py:76-84 and
// box/iou.py (box_iou.cuh: areas first, (a_area + g_area) - inter, IEEE
// division, the union > 0 guard, NaN-propagating max / min), aug uses the
// order of matching_pallas.py:241-248, the targets use IEEE division and
// logf, and the file is built with -fmad=false so that no product is fused
// into an addition.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "box_iou.cuh"

namespace {

constexpr int kMaxG = 512;  // gts an image may carry (shared memory lists)
constexpr int kAnchorThreads = 256;
constexpr int kGtThreads = 512;
constexpr int kGtWarps = kGtThreads / 32;

// (v, i) beats (w, j): higher value, or equal value and lower index.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Anchor a's corners from its centre form, as center_to_corner computes
// them: (cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5).
struct Anchor {
  float cx, cy, w, h, x1, y1, x2, y2, area;
};

__device__ __forceinline__ Anchor load_anchor(const float4 *__restrict__ anchors, int a) {
  const float4 c = __ldg(anchors + a);
  Anchor r;
  r.cx = c.x;
  r.cy = c.y;
  r.w = c.z;
  r.h = c.w;
  r.x1 = c.x - c.z * 0.5f;
  r.y1 = c.y - c.w * 0.5f;
  r.x2 = c.x + c.z * 0.5f;
  r.y2 = c.y + c.w * 0.5f;
  r.area = box_area(r.x1, r.y1, r.x2, r.y2);
  return r;
}

__device__ __forceinline__ float anchor_iou(const Anchor &a, float gx1, float gy1, float gx2,
                                            float gy2, float g_area) {
  return box_iou(a.x1, a.y1, a.x2, a.y2, a.area, gx1, gy1, gx2, gy2, g_area);
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
                               const unsigned char *__restrict__ mask, int b, int g_n,
                               GtList &s) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int count = 0;
  for (int base = 0; base < g_n; base += 32) {
    const int g = base + lane;
    const bool v = g < g_n && mask[(size_t)b * g_n + g] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (v) {
      const int pos = count + __popc(m & ((1u << lane) - 1u));
      const float *p = gt + ((size_t)b * g_n + g) * 4;
      s.x1[pos] = p[0];
      s.y1[pos] = p[1];
      s.x2[pos] = p[2];
      s.y2[pos] = p[3];
      s.area[pos] = box_area(p[0], p[1], p[2], p[3]);
      s.idx[pos] = g;
    }
    count += __popc(m);
  }
  if (lane == 0) s.n = count;
}

// Pass 1a: per anchor, the raw best IoU (matched_iou) and its gt.
__global__ void __launch_bounds__(kAnchorThreads)
anchor_best_kernel(const float4 *__restrict__ anchors,       // (A,) cx cy w h
                   const float *__restrict__ gt,             // (B, G, 4)
                   const unsigned char *__restrict__ mask,   // (B, G)
                   float *__restrict__ best_iou,             // (B, A) out
                   int *__restrict__ best_gt,                // (B, A) out
                   int a_n, int g_n) {
  __shared__ GtList s;
  const int b = blockIdx.y;
  load_valid_gts(gt, mask, b, g_n, s);
  __syncthreads();
  const int a = blockIdx.x * kAnchorThreads + threadIdx.x;
  if (a >= a_n) return;
  const Anchor an = load_anchor(anchors, a);
  // Every gt scores >= 0 and gt 0 scores at least 0, so starting from
  // (0, gt 0) and taking strict improvements over the valid gts in order
  // is the argmax over all G gts with the lowest index on ties.
  float best = 0.0f;
  int arg = 0;
  for (int j = 0; j < s.n; ++j) {
    const float v = anchor_iou(an, s.x1[j], s.y1[j], s.x2[j], s.y2[j], s.area[j]);
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

// Per-gt statistics of pass 1b, (B, G) each; only valid gts are written.
struct GtStats {
  int *best_anchor;
  int *count;
  float *kth_v;
  int *kth_i;
};

// Pass 1b for gt f = b * G + g of the batch: the whole block takes part.
__device__ void gt_stats(const float4 *__restrict__ anchors, const float *__restrict__ gt,
                         const float *__restrict__ best_iou, const int *__restrict__ best_gt,
                         GtStats st, float *column, float *wv, int *wi, int *wc, int f,
                         int a_n, int g_n, int k, float match_threshold, bool cache_column) {
  const int b = f / g_n, g = f % g_n;
  const float *p = gt + (size_t)f * 4;
  const float gx1 = p[0], gy1 = p[1], gx2 = p[2], gy2 = p[3];
  const float g_area = box_area(gx1, gy1, gx2, gy2);
  const float *bi = best_iou + (size_t)b * a_n;
  const int *bg = best_gt + (size_t)b * a_n;

  // Sweep 1: the IoUs (cached), the count, and the first selection.
  float lv = -1.0f;
  int li = INT_MAX;
  int count = 0;
  for (int a = threadIdx.x; a < a_n; a += kGtThreads) {
    const float v = anchor_iou(load_anchor(anchors, a), gx1, gy1, gx2, gy2, g_area);
    if (cache_column) column[a] = v;
    if (beats(v, a, lv, li)) {
      lv = v;
      li = a;
    }
    const float ab = bi[a];
    count += (bg[a] == g && ab >= match_threshold && ab > 0.0f) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) wc[threadIdx.x >> 5] = count;
  block_argmax(lv, li, wv, wi);  // syncs, so wc is complete
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kGtWarps; ++w) total += wc[w];
    st.best_anchor[f] = li;
    st.count[f] = total;
  }
  // Rounds 2..k: the best entry strictly after the previous selection.
  for (int round = 1; round < k; ++round) {
    const float pv = lv;
    const int pi = li;
    lv = -1.0f;
    li = INT_MAX;
    for (int a = threadIdx.x; a < a_n; a += kGtThreads) {
      const float v = cache_column
                          ? column[a]
                          : anchor_iou(load_anchor(anchors, a), gx1, gy1, gx2, gy2, g_area);
      if (beats(pv, pi, v, a) && beats(v, a, lv, li)) {
        lv = v;
        li = a;
      }
    }
    block_argmax(lv, li, wv, wi);
  }
  if (threadIdx.x == 0) {
    st.kth_v[f] = lv;
    st.kth_i[f] = li;
  }
}

// Pass 1b: one block an SM; the batch's valid gts, in (image, gt) order,
// go round-robin to the blocks.  The mask is scanned a chunk of 512 pairs
// at a time: a block lists the valid pairs of the chunk whose rank is its
// own, then works through them.
__global__ void __launch_bounds__(kGtThreads)
gt_stats_kernel(const float4 *__restrict__ anchors, const float *__restrict__ gt,
                const unsigned char *__restrict__ mask, const float *__restrict__ best_iou,
                const int *__restrict__ best_gt, GtStats st, int bsz, int a_n, int g_n, int k,
                float match_threshold, int cache_column) {
  extern __shared__ float column[];  // A IoUs when cache_column
  __shared__ float wv[kGtWarps];
  __shared__ int wi[kGtWarps];
  __shared__ int wc[kGtWarps];
  __shared__ int items[kGtThreads];
  __shared__ int n_items;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pairs = bsz * g_n;
  int ranked = 0;  // valid pairs before this chunk
  for (int c0 = 0; c0 < pairs; c0 += kGtThreads) {
    const int f = c0 + tid;
    const bool v = f < pairs && mask[f] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) wc[warp] = __popc(bal);
    if (tid == 0) n_items = 0;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kGtWarps; ++w) {
      before += w < warp ? wc[w] : 0;
      total += wc[w];
    }
    const int rank = ranked + before + __popc(bal & ((1u << lane) - 1u));
    if (v && rank % gridDim.x == blockIdx.x) items[atomicAdd(&n_items, 1)] = f;
    ranked += total;
    __syncthreads();
    // The items' order in the list does not matter: each gt's statistics
    // are its own.
    const int n = n_items;
    for (int it = 0; it < n; ++it) {
      gt_stats(anchors, gt, best_iou, best_gt, st, column, wv, wi, wc, items[it], a_n, g_n, k,
               match_threshold, cache_column != 0);
    }
    __syncthreads();  // wc, items and n_items are rewritten by the next chunk
  }
}

struct Targets {
  int *cls;       // (B, A)
  float4 *loc;    // (B, A)
  int *gt;        // (B, A)
  const float *iou;  // (B, A): pass 1a's raw best IoU
};

struct TargetParams {
  float match_threshold, ignore_threshold, scale_comp_iou;
  float s0, s1, s2, s3;  // prior scaling, rounded to float32
  int k_needs;           // a gt needs compensation when its count < k_needs
};

// Pass 2: per anchor, the augmented argmax over the gts and the targets.
__global__ void __launch_bounds__(kAnchorThreads)
assign_kernel(const float4 *__restrict__ anchors, const float *__restrict__ gt,
              const unsigned char *__restrict__ mask, GtStats st, Targets out,
              TargetParams tp, int a_n, int g_n) {
  __shared__ GtList s;
  __shared__ int s_best[kMaxG];
  __shared__ bool s_needs[kMaxG];
  __shared__ float s_kv[kMaxG];
  __shared__ int s_ki[kMaxG];
  const int b = blockIdx.y;
  load_valid_gts(gt, mask, b, g_n, s);
  __syncthreads();
  for (int j = threadIdx.x; j < s.n; j += kAnchorThreads) {
    const size_t gb = (size_t)b * g_n + s.idx[j];
    s_best[j] = st.best_anchor[gb];
    s_needs[j] = st.count[gb] < tp.k_needs;
    s_kv[j] = st.kth_v[gb];
    s_ki[j] = st.kth_i[gb];
  }
  __syncthreads();
  const int a = blockIdx.x * kAnchorThreads + threadIdx.x;
  if (a >= a_n) return;
  const Anchor an = load_anchor(anchors, a);
  // As in pass 1a: a masked gt scores exactly 0, so (0, gt 0) plus strict
  // improvements over the valid gts is the lowest-index argmax over all G.
  float best = 0.0f;
  int arg = 0;
  for (int j = 0; j < s.n; ++j) {
    const float iou = anchor_iou(an, s.x1[j], s.y1[j], s.x2[j], s.y2[j], s.area[j]);
    const float forced = a == s_best[j] ? 1.0f : 0.0f;
    const bool in_topk = iou > s_kv[j] || (iou == s_kv[j] && a <= s_ki[j]);
    const float comp = (s_needs[j] && in_topk && iou > tp.scale_comp_iou) ? 1.0f : 0.0f;
    const float aug = (iou + 2.0f * forced) + fminf(comp, 1.0f);
    if (aug > best) {
      best = aug;
      arg = s.idx[j];
    }
  }
  const size_t ba = (size_t)b * a_n + a;
  const float raw = out.iou[ba];
  const bool positive = best >= tp.match_threshold;
  const bool ignore = raw >= tp.ignore_threshold && raw < tp.match_threshold && !positive;
  out.cls[ba] = positive ? 1 : (ignore ? -1 : 0);
  out.gt[ba] = arg;
  float4 loc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (positive) {
    // corner_to_center of the matched gt, then encode_boxes.
    const float *p = gt + ((size_t)b * g_n + arg) * 4;
    const float gx1 = p[0], gy1 = p[1], gx2 = p[2], gy2 = p[3];
    const float gcx = (gx1 + gx2) * 0.5f;
    const float gcy = (gy1 + gy2) * 0.5f;
    const float gw = max_nan(gx2 - gx1, 1e-6f);
    const float gh = max_nan(gy2 - gy1, 1e-6f);
    loc.x = (gcx - an.cx) / an.w / tp.s0;
    loc.y = (gcy - an.cy) / an.h / tp.s1;
    loc.z = logf(gw / an.w) / tp.s2;
    loc.w = logf(gh / an.h) / tp.s3;
  }
  out.loc[ba] = loc;
}

// Read once a process: the SM count and the opt-in shared memory a block
// may have on the current device, and the dynamic shared memory the pass-1b
// kernel has been allowed so far.
int g_sms = 0, g_optin = 0, g_stats_smem = 48 * 1024;

int device_limits() {
  if (g_sms > 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&g_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

}  // namespace

extern "C" {

// Ints of scratch match_launch needs: pass 1a's best gt an anchor and four
// statistics a gt.
long long match_scratch_ints(int b, int a_n, int g_n) {
  return (long long)b * a_n + 4LL * b * g_n;
}

// Passes 1a, 1b (K3) and 2 (K4) on `stream`, one after the other; returns
// cudaGetLastError() (0 on success).  A gt needs scale compensation when
// its count is < k_needs (k, or 0 when compensation is off).
int match_launch(const float *anchors, const float *gt, const unsigned char *mask,
                 int *cls_target, float *loc_target, int *matched_gt, float *matched_iou,
                 int *scratch, int b, int a_n, int g_n, int k, int k_needs,
                 float match_threshold, float ignore_threshold, float scale_comp_iou, float s0,
                 float s1, float s2, float s3, cudaStream_t stream) {
  if (g_n < 1 || g_n > kMaxG || k < 1 || k > a_n) return (int)cudaErrorInvalidValue;
  if (b == 0 || a_n == 0) return 0;
  int err = device_limits();
  if (err) return err;
  const float4 *anc = reinterpret_cast<const float4 *>(anchors);
  int *best_gt = scratch;
  int *stats = scratch + (size_t)b * a_n;
  const size_t bg = (size_t)b * g_n;
  const GtStats st = {stats, stats + bg, reinterpret_cast<float *>(stats + 2 * bg),
                      stats + 3 * bg};

  const dim3 grid_a((a_n + kAnchorThreads - 1) / kAnchorThreads, b);
  anchor_best_kernel<<<grid_a, kAnchorThreads, 0, stream>>>(anc, gt, mask, matched_iou,
                                                            best_gt, a_n, g_n);
  err = (int)cudaGetLastError();
  if (err) return err;

  // Cache the IoU column in dynamic shared memory when it fits.
  const size_t static_bytes = kGtWarps * (2 * sizeof(float) + 2 * sizeof(int)) +
                              kGtThreads * sizeof(int) + 64;
  const size_t col_bytes = (size_t)a_n * sizeof(float);
  const int cache = col_bytes + static_bytes + 1024 <= (size_t)g_optin;
  const size_t dyn = cache ? col_bytes : 0;
  if ((int)dyn > g_stats_smem) {
    err = (int)cudaFuncSetAttribute(gt_stats_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err) return err;
    g_stats_smem = (int)dyn;
  }
  gt_stats_kernel<<<g_sms, kGtThreads, dyn, stream>>>(anc, gt, mask, matched_iou, best_gt, st,
                                                      b, a_n, g_n, k, match_threshold, cache);
  err = (int)cudaGetLastError();
  if (err) return err;

  const Targets out = {cls_target, reinterpret_cast<float4 *>(loc_target), matched_gt,
                       matched_iou};
  const TargetParams tp = {match_threshold, ignore_threshold, scale_comp_iou,
                           s0, s1, s2, s3, k_needs};
  assign_kernel<<<grid_a, kAnchorThreads, 0, stream>>>(anc, gt, mask, st, out, tp, a_n, g_n);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// N = 5000) and writes 4 N.  The cost is the serial depth: up to max_out
// (750) dependent steps, each a block-wide argmax and a suppression sweep.
// A TPU core ran all rows in lockstep as (B, N) vector ops; here the rows
// are independent thread blocks spread over the SMs (B = 128 rows on 132
// SMs), and inside a block each step is
//   1. a block argmax over (score, -index): warp shuffles, one shared
//      memory pass over the warp results, and a broadcast;
//   2. one sweep in which each thread, over its strided share of the row,
//      deactivates the boxes the winner suppresses and keeps a running
//      argmax of the survivors -- so the next step's argmax needs no
//      second pass over the row.
// Boxes, areas and the masked scores (-inf once inactive) sit in shared
// memory for the whole loop: 6 floats a box, 120 KB at N = 5000, which
// needs the opt-in above 48 KB of dynamic shared memory.
//
// Bit-exactness with the plain version (dan_tpu_torch/ops/nms_cuda.py):
// areas and IoU use the operation order of nms_batched_pallas.py:52,70-77,
// IEEE division, and the union > 0 guard.  Build with -fmad=false: an FMA
// contraction of (barea + area) - inter would change roundings and could
// flip a decision that sits right at the threshold.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

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

__global__ void __launch_bounds__(kThreads)
nms_rank_kernel(const float *__restrict__ boxes,   // (B, N, 4)
                const float *__restrict__ scores,  // (B, N)
                int *__restrict__ rank,            // (B, N) out
                int n, int max_out, float iou_thr, float score_thr) {
  extern __shared__ float smem[];
  float *sx1 = smem;
  float *sy1 = sx1 + n;
  float *sx2 = sy1 + n;
  float *sy2 = sx2 + n;
  float *sarea = sy2 + n;
  float *skey = sarea + n;  // score while active, -inf once inactive
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float best_v;
  __shared__ int best_i;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float *b = boxes + (size_t)row * n * 4;
  const float *s = scores + (size_t)row * n;
  int *r = rank + (size_t)row * n;
  const float neg_inf = -INFINITY;

  float my_v = neg_inf;
  int my_i = n;
  for (int k = tid; k < n; k += kThreads) {
    float x1 = b[4 * k], y1 = b[4 * k + 1], x2 = b[4 * k + 2], y2 = b[4 * k + 3];
    sx1[k] = x1;
    sy1[k] = y1;
    sx2[k] = x2;
    sy2[k] = y2;
    sarea[k] = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
    float sc = s[k];
    float key = sc > score_thr ? sc : neg_inf;
    skey[k] = key;
    r[k] = -1;
    if (beats(key, k, my_v, my_i)) {
      my_v = key;
      my_i = k;
    }
  }

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
      float ix1 = fmaxf(bx1, sx1[k]);
      float iy1 = fmaxf(by1, sy1[k]);
      float ix2 = fminf(bx2, sx2[k]);
      float iy2 = fminf(by2, sy2[k]);
      float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
      float uni = (barea + sarea[k]) - inter;
      float iou = uni > 0.0f ? inter / uni : 0.0f;
      if (k == j || iou > iou_thr) {
        skey[k] = neg_inf;
      } else if (beats(key, k, my_v, my_i)) {
        my_v = key;
        my_i = k;
      }
    }
  }
}

}  // namespace

extern "C" {

// Largest row length the kernel takes: six floats a box in shared memory,
// within the 227 KB a block may use on sm_90.
int nms_rank_max_n() { return (227 * 1024 - 1024) / (6 * (int)sizeof(float)); }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int nms_rank_launch(const float *boxes, const float *scores, int *rank, int batch,
                    int n, int max_out, float iou_thr, float score_thr,
                    void *stream) {
  size_t smem = (size_t)6 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_rank_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      boxes, scores, rank, n, max_out, iou_thr, score_thr);
  return (int)cudaGetLastError();
}

}  // extern "C"

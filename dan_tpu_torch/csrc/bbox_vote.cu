// Batched bbox-vote for Hopper (sm_90a): one thread block per image.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K7  dan_tpu/ops/bbox_vote_pallas.py::_vote_kernel_batched  (B images in lockstep)
//   K8  dan_tpu/ops/bbox_vote_pallas.py::_vote_kernel          (one image; here B = 1)
// and computes what they and dan_tpu/ops/bbox_vote.py compute.  Per image:
// a detection is active when it is valid and its score is > 0; up to
// max_out times, take the active detection of highest score (lowest index
// on ties), merge every active detection whose IoU with it is >= the
// threshold (the selected one always merges), write the score-weighted
// mean of the merged boxes and the selected score into the next output
// slot, and deactivate what was merged.  Stop when nothing is active; the
// slots that were not reached are zero with valid = 0.
//
// What bounds it: not bytes.  One image reads 21 R bytes once (126 KB at
// R = 6000) and writes 21 max_out.  The cost is the serial depth: one
// dependent step per output, each a block argmax, an IoU sweep and five
// sums.  The TPU kernel ran all images in lockstep as (B, R) vector ops,
// for all max_out steps, padded B to 8 sublanes and wrote outputs through
// one-hot masks because its stores are full rows.  Here
//   * images are independent blocks (128 images on 132 SMs), each ending
//     its loop when its own row is exhausted;
//   * the row sits in shared memory for the whole loop (x1, y1, x2, y2,
//     area, and the score while active / -inf once merged: 6 floats a
//     detection, 144 KB at R = 6000, opt-in dynamic shared memory);
//   * only the prefix of the row up to its last active detection is
//     walked (the TTA runner packs valid detections to the front, so that
//     prefix is the number of detections the image really has);
//   * one sweep per step does the IoU test, accumulates the five weighted
//     sums of what merges, and keeps a running argmax of what survives,
//     so the next step's argmax needs no second pass; the block reduction
//     of the sums and of the argmax share two barriers;
//   * thread 0 writes output slot i directly.
//
// Agreement with the plain version (dan_tpu_torch/ops/bbox_vote.py): the
// merge decision uses the operation order of box/iou.py::iou_one_to_many,
// IEEE division and the union > 0 guard, and the source is built with
// -fmad=false, so selection, scores, valid flags and output counts are
// bit-identical.  The weighted sums are float additions in another order
// than torch.sum (per-thread strided partial sums, then a fixed shuffle
// tree: no atomics, so two runs give the same bits); the fused boxes agree
// to rounding and never feed back into selection.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (v, i) beats (w, j): higher score, or equal score and lower index.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_argmax(float &v, int &i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float w = __shfl_xor_sync(kFull, v, off);
    int j = __shfl_xor_sync(kFull, i, off);
    if (beats(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
bbox_vote_kernel(const float *__restrict__ boxes,          // (B, R, 4)
                 const float *__restrict__ scores,         // (B, R)
                 const unsigned char *__restrict__ valid,  // (B, R) 0 / 1
                 float *__restrict__ out_boxes,            // (B, M, 4)
                 float *__restrict__ out_scores,           // (B, M)
                 unsigned char *__restrict__ out_valid,    // (B, M)
                 int r, int max_out, float iou_thr) {
  extern __shared__ float smem[];
  float *sx1 = smem;
  float *sy1 = sx1 + r;
  float *sx2 = sy1 + r;
  float *sy2 = sx2 + r;
  float *sarea = sy2 + r;
  float *skey = sarea + r;  // score while active, -inf otherwise
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float warp_s[5][kWarps];
  __shared__ float best_v;
  __shared__ int best_i;
  __shared__ int n_walk;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float *b = boxes + (size_t)row * r * 4;
  const float *s = scores + (size_t)row * r;
  const unsigned char *va = valid + (size_t)row * r;
  float *ob = out_boxes + (size_t)row * max_out * 4;
  float *os = out_scores + (size_t)row * max_out;
  unsigned char *ov = out_valid + (size_t)row * max_out;
  const float neg_inf = -INFINITY;

  for (int k = tid; k < max_out; k += kThreads) {
    ob[4 * k] = 0.0f;
    ob[4 * k + 1] = 0.0f;
    ob[4 * k + 2] = 0.0f;
    ob[4 * k + 3] = 0.0f;
    os[k] = 0.0f;
    ov[k] = 0;
  }

  // Load the row; each thread keeps the argmax of its own share and the
  // last active index it saw.
  float my_v = neg_inf;
  int my_i = r;
  int my_last = -1;
  for (int k = tid; k < r; k += kThreads) {
    float x1 = b[4 * k], y1 = b[4 * k + 1], x2 = b[4 * k + 2], y2 = b[4 * k + 3];
    sx1[k] = x1;
    sy1[k] = y1;
    sx2[k] = x2;
    sy2[k] = y2;
    sarea[k] = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
    float sc = s[k];
    bool active = va[k] != 0 && sc > 0.0f;
    float key = active ? sc : neg_inf;
    skey[k] = key;
    if (active) my_last = k;
    if (beats(key, k, my_v, my_i)) {
      my_v = key;
      my_i = k;
    }
  }
  {
    float v = my_v;
    int i = my_i;
    warp_argmax(v, i);
    int last = warp_max(my_last);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
      warp_s[0][warp] = __int_as_float(last);
    }
    __syncthreads();
    if (warp == 0) {
      v = warp_v[lane];
      i = warp_i[lane];
      last = __float_as_int(warp_s[0][lane]);
      warp_argmax(v, i);
      last = warp_max(last);
      if (lane == 0) {
        best_v = v;
        best_i = i;
        n_walk = last + 1;
      }
    }
    __syncthreads();
  }
  const int n = n_walk;

  for (int step = 0; step < max_out; ++step) {
    const float bscore = best_v;
    if (bscore == neg_inf) break;  // the row is exhausted
    const int j = best_i;
    const float bx1 = sx1[j], by1 = sy1[j], bx2 = sx2[j], by2 = sy2[j];
    const float barea = sarea[j];

    // One sweep: merge, accumulate, and keep the survivors' argmax.
    float a_w = 0.0f, a_x1 = 0.0f, a_y1 = 0.0f, a_x2 = 0.0f, a_y2 = 0.0f;
    my_v = neg_inf;
    my_i = r;
    for (int k = tid; k < n; k += kThreads) {
      float key = skey[k];
      if (key == neg_inf) continue;
      float x1 = sx1[k], y1 = sy1[k], x2 = sx2[k], y2 = sy2[k];
      float inter = fmaxf(fminf(bx2, x2) - fmaxf(bx1, x1), 0.0f) *
                    fmaxf(fminf(by2, y2) - fmaxf(by1, y1), 0.0f);
      float uni = (barea + sarea[k]) - inter;
      float iou = uni > 0.0f ? inter / uni : 0.0f;
      if (k == j || iou >= iou_thr) {
        a_w += key;
        a_x1 += x1 * key;
        a_y1 += y1 * key;
        a_x2 += x2 * key;
        a_y2 += y2 * key;
        skey[k] = neg_inf;
      } else if (beats(key, k, my_v, my_i)) {
        my_v = key;
        my_i = k;
      }
    }

    // Block reduction of the five sums and of the next argmax, in a fixed
    // order: shuffle tree inside each warp, then warp 0 over the 32 warps.
    float v = my_v;
    int i = my_i;
    warp_argmax(v, i);
    a_w = warp_sum(a_w);
    a_x1 = warp_sum(a_x1);
    a_y1 = warp_sum(a_y1);
    a_x2 = warp_sum(a_x2);
    a_y2 = warp_sum(a_y2);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
      warp_s[0][warp] = a_w;
      warp_s[1][warp] = a_x1;
      warp_s[2][warp] = a_y1;
      warp_s[3][warp] = a_x2;
      warp_s[4][warp] = a_y2;
    }
    __syncthreads();  // every thread has read best_v / best_i by now
    if (warp == 0) {
      v = warp_v[lane];
      i = warp_i[lane];
      warp_argmax(v, i);
      a_w = warp_sum(warp_s[0][lane]);
      a_x1 = warp_sum(warp_s[1][lane]);
      a_y1 = warp_sum(warp_s[2][lane]);
      a_x2 = warp_sum(warp_s[3][lane]);
      a_y2 = warp_sum(warp_s[4][lane]);
      if (lane == 0) {
        float wsum = fmaxf(a_w, 1e-12f);
        ob[4 * step] = a_x1 / wsum;
        ob[4 * step + 1] = a_y1 / wsum;
        ob[4 * step + 2] = a_x2 / wsum;
        ob[4 * step + 3] = a_y2 / wsum;
        os[step] = bscore;
        ov[step] = 1;
        best_v = v;
        best_i = i;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest row length the kernel takes: six floats a detection in shared
// memory, within the 227 KB a block may use on sm_90.
int bbox_vote_max_rows() { return (227 * 1024 - 2048) / (6 * (int)sizeof(float)); }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int bbox_vote_launch(const float *boxes, const float *scores,
                     const unsigned char *valid, float *out_boxes,
                     float *out_scores, unsigned char *out_valid, int batch,
                     int r, int max_out, float iou_thr, void *stream) {
  size_t smem = (size_t)6 * r * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bbox_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bbox_vote_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      boxes, scores, valid, out_boxes, out_scores, out_valid, r, max_out, iou_thr);
  return (int)cudaGetLastError();
}

}  // extern "C"

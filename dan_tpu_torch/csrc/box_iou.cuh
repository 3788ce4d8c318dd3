// IoU arithmetic shared by the port's CUDA sources (nms.cu, nms_blocked.cu,
// matching.cu, bbox_vote.cu).  Every source that includes it is built with
// -fmad=false, so a product is never fused into an addition and each IoU
// rounds as its plain PyTorch version (box/iou.py) rounds it.
//
// NaN.  torch.maximum / torch.minimum / clamp_min (and jnp.maximum /
// jnp.minimum in the JAX package) return NaN when either operand is NaN;
// CUDA's fmaxf / fminf return the other operand.  With the helpers below a
// box with a NaN coordinate has a NaN intersection and a NaN union, so the
// union > 0 guard makes its IoU with any box exactly 0, as in the plain
// version: it suppresses or merges only what an IoU of 0 passes.
#pragma once

#include <math.h>

// max(a, b) and min(a, b), NaN when either is NaN (PTX .NaN, sm_80 and up).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// box/iou.py::box_area: clamp_min(x2 - x1, 0) * clamp_min(y2 - y1, 0).
__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return max_nan(x2 - x1, 0.0f) * max_nan(y2 - y1, 0.0f);
}

// The clamped width and height of the intersection of box a (the selected
// one) and box b, in the operand order of iou_one_to_many.
__device__ __forceinline__ float overlap_w(float ax1, float ax2, float bx1, float bx2) {
  return max_nan(min_nan(ax2, bx2) - max_nan(ax1, bx1), 0.0f);
}

// Whether IoU > thr (IoU >= thr when kInclusive), from the clamped width w
// and height h of the intersection and the two areas (the selected box's
// first).  It decides as the plain expression does,
//   inter = w * h;  uni = (barea + area) - inter;
//   (uni > 0 ? inter / uni : 0) > thr   (>= when kInclusive),
// for every input, but pays the IEEE division only where it must:
//   * w or h 0: the expression gives 0 (inter is 0, or NaN when the other
//     side is infinite or NaN, and then uni is NaN too);
//   * w or h NaN (a NaN coordinate): inter and uni are NaN, so 0;
//   * an approximate quotient (2 ulp for a divisor in this range) that is
//     farther from the threshold than its own error decides as the rounded
//     one does.
template <bool kInclusive>
__device__ __forceinline__ bool iou_passes(float w, float h, float barea, float area,
                                           float thr) {
  if (w == 0.0f || h == 0.0f) return kInclusive ? 0.0f >= thr : 0.0f > thr;
  const float inter = w * h;
  const float uni = (barea + area) - inter;
  if (!(uni > 0.0f)) return kInclusive ? 0.0f >= thr : 0.0f > thr;
  if (uni > 1e-30f && uni < 1e30f) {
    const float q = __fdividef(inter, uni);
    if (fabsf(q - thr) > 1e-5f * fmaxf(1.0f, fabsf(q))) return kInclusive ? q >= thr : q > thr;
  }
  const float iou = inter / uni;
  return kInclusive ? iou >= thr : iou > thr;
}

// The IoU itself, in the plain operation order (areas first, (a + b) -
// inter, IEEE division, the union > 0 guard).
__device__ __forceinline__ float box_iou(float ax1, float ay1, float ax2, float ay2, float a_area,
                                         float bx1, float by1, float bx2, float by2,
                                         float b_area) {
  const float inter = overlap_w(ax1, ax2, bx1, bx2) * overlap_w(ay1, ay2, by1, by2);
  const float uni = (a_area + b_area) - inter;
  return uni > 0.0f ? inter / uni : 0.0f;
}

// Native host-side kernels for the WIDER FACE AP protocol.
//
// The official widerface_evaluate tool ships a Cython `bbox_overlaps`
// extension — the only native code in the reference's ecosystem
// (SURVEY.md §2 'Native components').  This is its C++ equivalent plus the
// greedy per-image matcher (`image_eval`), the two host-bound hot loops of
// the eval protocol (3226 images x up to 750 dets x up to ~1000 gts).
//
// The port's copy of dan_tpu/native/overlaps.cc.  Built on demand by
// dan_tpu_torch.native with g++ -O3 -march=native -ffp-contract=off: without
// the last flag g++ contracts the products and sums below into FMAs on an
// FMA CPU, and the IoU then differs from numpy's (the oracle,
// dan_tpu_torch.eval.widerface_ap._bbox_overlaps) in its last bit.  Loaded
// via ctypes; dan_tpu_torch.eval.widerface_ap falls back to numpy when the
// library is unavailable.

#include <algorithm>
#include <cstdint>

extern "C" {

// dets: (n, 4) [x1 y1 x2 y2], gts: (m, 4) -> out: (n, m) IoU, row-major.
void bbox_overlaps(const double* dets, int64_t n, const double* gts,
                   int64_t m, double* out) {
  for (int64_t j = 0; j < m; ++j) {
    const double gx1 = gts[j * 4 + 0], gy1 = gts[j * 4 + 1];
    const double gx2 = gts[j * 4 + 2], gy2 = gts[j * 4 + 3];
    const double garea =
        std::max(gx2 - gx1, 0.0) * std::max(gy2 - gy1, 0.0);
    for (int64_t i = 0; i < n; ++i) {
      const double x1 = dets[i * 4 + 0], y1 = dets[i * 4 + 1];
      const double x2 = dets[i * 4 + 2], y2 = dets[i * 4 + 3];
      const double iw = std::min(x2, gx2) - std::max(x1, gx1);
      const double ih = std::min(y2, gy2) - std::max(y1, gy1);
      double iou = 0.0;
      if (iw > 0 && ih > 0) {
        const double inter = iw * ih;
        const double darea =
            std::max(x2 - x1, 0.0) * std::max(y2 - y1, 0.0);
        const double uni = darea + garea - inter;
        if (uni > 0) iou = inter / uni;
      }
      out[i * m + j] = iou;
    }
  }
}

// Official per-image greedy matching (see widerface_ap._image_eval):
// dets (n, 5) score-descending; ignore[j] != 0 -> gt j outside the subset.
// Outputs pred_recall (n,) and proposal (n,).
void image_eval(const double* dets, int64_t n, const double* gts, int64_t m,
                const uint8_t* ignore, double iou_thresh,
                int64_t* pred_recall, int64_t* proposal) {
  // gt_matched flags
  bool* matched = new bool[m]();
  int64_t recall = 0;
  for (int64_t i = 0; i < n; ++i) {
    proposal[i] = 1;
    if (m > 0) {
      const double x1 = dets[i * 5 + 0], y1 = dets[i * 5 + 1];
      const double x2 = dets[i * 5 + 2], y2 = dets[i * 5 + 3];
      const double darea =
          std::max(x2 - x1, 0.0) * std::max(y2 - y1, 0.0);
      double best = -1.0;
      int64_t best_j = 0;
      for (int64_t j = 0; j < m; ++j) {
        const double gx1 = gts[j * 4 + 0], gy1 = gts[j * 4 + 1];
        const double gx2 = gts[j * 4 + 2], gy2 = gts[j * 4 + 3];
        const double iw = std::min(x2, gx2) - std::max(x1, gx1);
        const double ih = std::min(y2, gy2) - std::max(y1, gy1);
        double iou = 0.0;
        if (iw > 0 && ih > 0) {
          const double inter = iw * ih;
          const double garea =
              std::max(gx2 - gx1, 0.0) * std::max(gy2 - gy1, 0.0);
          const double uni = darea + garea - inter;
          if (uni > 0) iou = inter / uni;
        }
        if (iou > best) {
          best = iou;
          best_j = j;
        }
      }
      if (best >= iou_thresh) {
        if (ignore[best_j]) {
          // Official rule: every det whose best-overlap gt is outside the
          // subset is excluded from the proposal pool (no matched gate).
          proposal[i] = 0;
        } else if (!matched[best_j]) {
          matched[best_j] = true;
          ++recall;
        }
      }
    }
    pred_recall[i] = recall;
  }
  delete[] matched;
}

}  // extern "C"

// Host-side native code of the PyTorch port: the greedy loops that run on
// the CPU (the model-level NMS of case consolidation, the host WBC and the
// COCO matching of the evaluator), with a plain C ABI for ctypes.
//
// The port's own copy of the JAX package's host library, with the same entry
// points and arguments. ops/_build.py::build_host compiles it with the host
// C++ compiler at first use (-ffp-contract=off, so that the float64 IoU rounds
// as the NumPy box_iou_np does); ops/native.py binds it.
//
// One change against that library: a WBC seed that does not overlap itself
// (zero volume, or a threshold >= its self-IoU of 1) leaves the pool with an
// empty cluster, instead of being drawn again forever.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Boxes use the interleaved corner format (x1, y1, x2, y2, z1, z2).
static inline double vol3(const double* b) {
  return (b[2] - b[0]) * (b[3] - b[1]) * (b[5] - b[4]);
}

static inline double iou3(const double* a, const double* b) {
  const double x1 = std::max(a[0], b[0]);
  const double y1 = std::max(a[1], b[1]);
  const double x2 = std::min(a[2], b[2]);
  const double y2 = std::min(a[3], b[3]);
  const double z1 = std::max(a[4], b[4]);
  const double z2 = std::min(a[5], b[5]);
  const double inter = std::max(0.0, x2 - x1) * std::max(0.0, y2 - y1) *
                       std::max(0.0, z2 - z1);
  const double uni = vol3(a) + vol3(b) - inter;
  return uni > 0.0 ? inter / uni : 0.0;
}

// Pairwise IoU matrix [n, m].
void iou_matrix_3d(const double* boxes1, int64_t n, const double* boxes2,
                   int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double* a = boxes1 + 6 * i;
    for (int64_t j = 0; j < m; ++j) {
      out[i * m + j] = iou3(a, boxes2 + 6 * j);
    }
  }
}

// Greedy NMS. Returns the number of kept indices written to `keep`
// (descending score; equal scores keep their index order). O(n^2) worst
// case, the IoU computed on the fly (no matrix).
int64_t nms_3d(const double* boxes, const double* scores, int64_t n,
               double iou_thresh, int64_t* keep) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });
  std::vector<char> suppressed(n, 0);
  int64_t n_keep = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep[n_keep++] = i;
    const double* bi = boxes + 6 * i;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (suppressed[j]) continue;
      if (iou3(bi, boxes + 6 * j) > iou_thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// Weighted box clustering, greedy from the highest score. Outputs at most n
// clusters in the order they formed; returns the cluster count.
int64_t wbc_3d(const double* boxes, const double* scores, const double* weights,
               const double* n_exp_preds, int64_t n, double iou_thresh,
               double score_thresh, double missing_weight, int use_area,
               double* out_boxes, double* out_scores) {
  std::vector<double> w(n);
  for (int64_t i = 0; i < n; ++i)
    w[i] = use_area ? weights[i] * vol3(boxes + 6 * i) : weights[i];

  std::vector<int64_t> pool(n);
  std::iota(pool.begin(), pool.end(), 0);
  std::stable_sort(pool.begin(), pool.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });

  int64_t n_out = 0;
  std::vector<int64_t> cluster;
  std::vector<int64_t> rest;
  while (!pool.empty()) {
    const int64_t seed = pool[0];
    const double* bs = boxes + 6 * seed;
    cluster.clear();
    rest.clear();
    for (const int64_t idx : pool) {
      if (iou3(bs, boxes + 6 * idx) > iou_thresh)
        cluster.push_back(idx);
      else if (idx != seed)
        rest.push_back(idx);
    }
    double msw_sum = 0.0, ms_sum = 0.0, nexp_sum = 0.0;
    double box_acc[6] = {0, 0, 0, 0, 0, 0};
    for (const int64_t idx : cluster) {
      const double iou = iou3(bs, boxes + 6 * idx);
      const double msw = iou * w[idx];
      const double ms = msw * scores[idx];
      msw_sum += msw;
      ms_sum += ms;
      nexp_sum += n_exp_preds[idx];
      for (int d = 0; d < 6; ++d) box_acc[d] += boxes[6 * idx + d] * ms;
    }
    const double n_found = static_cast<double>(cluster.size());
    const double n_expected = nexp_sum / std::max(n_found, 1.0);
    const double n_missing = std::max(0.0, n_expected - n_found);
    const double msw_mean = msw_sum / std::max(n_found, 1.0);
    const double denom = msw_sum + n_missing * msw_mean * missing_weight;
    const double new_score = denom > 0.0 ? ms_sum / denom : 0.0;
    if (!cluster.empty() && new_score > score_thresh) {
      for (int d = 0; d < 6; ++d)
        out_boxes[6 * n_out + d] = ms_sum > 0.0 ? box_acc[d] / ms_sum : bs[d];
      out_scores[n_out] = new_score;
      ++n_out;
    }
    pool.swap(rest);
  }
  return n_out;
}

// COCO greedy matching for one image and class. Predictions sorted by
// descending score, ground truth with the ignored ones last (the caller
// sorts). ious: [n_pred, n_gt]; thresholds: [n_thr].
void coco_match(const double* ious, int64_t n_pred, int64_t n_gt,
                const uint8_t* gt_ignore, const double* thresholds,
                int64_t n_thr, double* dt_match, double* gt_match,
                double* dt_ignore) {
  std::memset(dt_match, 0, sizeof(double) * n_thr * n_pred);
  std::memset(gt_match, 0, sizeof(double) * n_thr * n_gt);
  std::memset(dt_ignore, 0, sizeof(double) * n_thr * n_pred);
  for (int64_t t = 0; t < n_thr; ++t) {
    double* gtm = gt_match + t * n_gt;
    double* dtm = dt_match + t * n_pred;
    double* dti = dt_ignore + t * n_pred;
    for (int64_t d = 0; d < n_pred; ++d) {
      double best = std::min(thresholds[t], 1.0 - 1e-10);
      int64_t m = -1;
      for (int64_t g = 0; g < n_gt; ++g) {
        if (gtm[g] > 0) continue;
        if (m > -1 && gt_ignore[m] == 0 && gt_ignore[g] == 1) break;
        const double iou = ious[d * n_gt + g];
        if (iou < best) continue;
        best = iou;
        m = g;
      }
      if (m == -1) continue;
      dti[d] = static_cast<double>(gt_ignore[m]);
      dtm[d] = 1.0;
      gtm[m] = 1.0;
    }
  }
}

}  // extern "C"

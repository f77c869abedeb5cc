// Weighted box clustering, the cluster loop, for Hopper (sm_90a): one
// thread block per class.
//
// Replaces: the lax.while_loop of nndetection_tpu/core/boxes/wbc.py:61-104
// (wbc, called per class by batched_wbc), which JAX compiles into one device
// program. It is not a TPU kernel, but its straightforward PyTorch form is a
// Python loop with a host synchronisation per cluster and ~10 small launches,
// launch-bound by construction at up to 1000 clusters per WBC.
//
// Per class c, over the boxes that are valid, of label c and of finite
// score ("remaining"), until none remain:
//   seed    = arg-max of the remaining scores (lowest index on ties, as
//             jnp.argmax)
//   cluster = remaining boxes j with IoU(seed, j) > iou_thr
//   msw_j   = IoU(seed, j) * w_j,  ms_j = msw_j * s_j
//   n_found = |cluster|, n_expected = sum(n_exp_j) / max(n_found, 1)
//   score   = sum(ms) / max(sum(msw) + max(0, n_expected - n_found) *
//             (sum(msw) / max(n_found, 1)) * missing_weight, 1e-12)
//   box     = sum(box_j * ms_j) / max(sum(ms), 1e-12)
//   emitted at the running count if score > score_thr; the cluster leaves.
// One guard the JAX loop lacks: the seed always leaves, also when it is not
// in its own cluster (a zero-volume seed has IoU 0 with itself). There the
// JAX loop never ends; here the seed is dropped without output.
//
// What bounds it: the chain of clusters. Each cluster is one block-wide
// arg-max and one masked pass over the seed's IoU row, ~10 flops and 4-40 B
// per box, a few microseconds of barrier and reduction latency; the N x N
// IoU matrix (iou_matrix.cu) is read one row per cluster, from L2 (4 MB at
// N = 1000). The design keeps the loop in one launch: the scores of the
// remaining boxes (-inf once gone) and the running count live in shared
// memory, each thread owns the boxes j = tid (mod 256) in both passes, so no
// box is touched by two threads, and classes run as independent blocks.
// Determinism: each thread sums its boxes in index order, warps combine by a
// fixed shuffle tree and thread 0 adds the warps in order, so two runs give
// the same bits; the plain version (ops/wbc_cluster.py) sums in this same
// order and, with -fmad=false here, gives the same bits too.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// n_found, sum n_exp, sum msw, sum ms, six coordinate sums
constexpr int kSums = 10;

__device__ __forceinline__ bool better(float s, int i, float best, int bi) {
  return s > best || (s == best && i < bi);
}

__global__ void __launch_bounds__(kThreads)
wbc_cluster_kernel(const float* __restrict__ ious,     // [N, N]
                   const float* __restrict__ boxes,    // [N, 6]
                   const float* __restrict__ scores,   // [N]
                   const float* __restrict__ weights,  // [N]
                   const float* __restrict__ n_exp,    // [N]
                   const int32_t* __restrict__ labels, // [N]
                   const uint8_t* __restrict__ valid,  // [N]
                   int n, float iou_thr, float score_thr, float missing_weight,
                   float* __restrict__ out_boxes,      // [C, N, 6]
                   float* __restrict__ out_scores,     // [C, N]
                   uint8_t* __restrict__ out_valid) {  // [C, N]
  extern __shared__ float s_live[];  // score while remaining, else -inf
  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ int s_seed;
  __shared__ int s_count;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ob = out_boxes + static_cast<size_t>(c) * n * 6;
  float* os = out_scores + static_cast<size_t>(c) * n;
  uint8_t* ov = out_valid + static_cast<size_t>(c) * n;

  for (int i = tid; i < n; i += kThreads) {
    const float s = scores[i];
    s_live[i] = (valid[i] && labels[i] == c && isfinite(s)) ? s : -INFINITY;
    os[i] = 0.0f;
    ov[i] = 0;
  }
  for (int i = tid; i < n * 6; i += kThreads) ob[i] = 0.0f;
  if (tid == 0) s_count = 0;
  __syncthreads();

  for (;;) {
    // 1. seed: block-wide (max score, lowest index among ties)
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float s = s_live[i];
      if (s > best) {
        best = s;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s = __shfl_down_sync(0xffffffffu, best, off);
      const int i = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(s, i, best, bi)) {
        best = s;
        bi = i;
      }
    }
    if (lane == 0) {
      warp_best[warp] = best;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      best = warp_best[0];
      bi = warp_idx[0];
      for (int w = 1; w < kWarps; ++w) {
        if (better(warp_best[w], warp_idx[w], best, bi)) {
          best = warp_best[w];
          bi = warp_idx[w];
        }
      }
      s_seed = best > -INFINITY ? bi : -1;
    }
    __syncthreads();
    const int seed = s_seed;
    if (seed < 0) break;  // nothing remains (uniform across the block)

    // 2. the cluster: remaining boxes above the threshold leave, and sum
    const float* row = ious + static_cast<size_t>(seed) * n;
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    for (int j = tid; j < n; j += kThreads) {
      if (s_live[j] == -INFINITY) continue;
      const float iou = row[j];
      const bool member = iou > iou_thr;
      if (!member && j != seed) continue;
      s_live[j] = -INFINITY;
      if (!member) continue;  // a seed outside its own cluster leaves alone
      const float msw = iou * weights[j];
      const float ms = msw * scores[j];
      acc[0] += 1.0f;
      acc[1] += n_exp[j];
      acc[2] += msw;
      acc[3] += ms;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc[4 + k] += boxes[static_cast<size_t>(j) * 6 + k] * ms;
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) warp_sums[warp][k] = acc[k];
    }
    __syncthreads();

    // 3. the cluster's box and score, emitted at the running count
    if (tid == 0) {
      float sum[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        sum[k] = warp_sums[0][k];
        for (int w = 1; w < kWarps; ++w) sum[k] += warp_sums[w][k];
      }
      const float n_found = sum[0];
      const float n_expected = sum[1] / fmaxf(n_found, 1.0f);
      const float n_missing = fmaxf(0.0f, n_expected - n_found);
      const float msw_mean = sum[2] / fmaxf(n_found, 1.0f);
      const float denom = sum[2] + (n_missing * msw_mean) * missing_weight;
      const float new_score = sum[3] / fmaxf(denom, 1e-12f);
      if (new_score > score_thr) {
        const int k = s_count;
        const float ms_sum = fmaxf(sum[3], 1e-12f);
        for (int d = 0; d < 6; ++d) ob[static_cast<size_t>(k) * 6 + d] = sum[4 + d] / ms_sum;
        os[k] = new_score;
        ov[k] = 1;
        s_count = k + 1;
      }
    }
    // the next arg-max reads s_live only at this thread's own boxes, and
    // warp_best / s_seed are rewritten after the barrier inside step 1
  }
}

}  // namespace

// ious [N, N], boxes [N, 6], scores, weights, n_exp [N] float32, labels [N]
// int32, valid [N] uint8; out_boxes [C, N, 6], out_scores [C, N] float32,
// out_valid [C, N] uint8; contiguous on the device, N > 0. Launches one block
// per class on `stream` and returns cudaGetLastError().
extern "C" int wbc_cluster_launch(const void* ious, const void* boxes,
                                  const void* scores, const void* weights,
                                  const void* n_exp, const void* labels,
                                  const void* valid, int n, int num_classes,
                                  float iou_thr, float score_thr,
                                  float missing_weight, void* out_boxes,
                                  void* out_scores, void* out_valid,
                                  void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wbc_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wbc_cluster_kernel<<<num_classes, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ious), static_cast<const float*>(boxes),
      static_cast<const float*>(scores), static_cast<const float*>(weights),
      static_cast<const float*>(n_exp), static_cast<const int32_t*>(labels),
      static_cast<const uint8_t*>(valid), n, iou_thr, score_thr,
      missing_weight, static_cast<float*>(out_boxes),
      static_cast<float*>(out_scores), static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

// Box geometry and the key sort shared by the NMS (nms_topk.cu), IoU matrix
// (iou_matrix.cu), suppression (suppression_matrix.cu) and WBC cluster
// (wbc_cluster.cu) kernels.
//
// A box is (x1, y1, x2, y2, z1, z2); where a kernel holds it in registers it
// carries its volume as a seventh float. The IoU is the Pallas formula in
// its order of operations, the row (selected, seed) box first:
//   inter = (max(dx, 0) * max(dy, 0)) * max(dz, 0)
//   union = max((vol_row + vol_col) - inter, 1e-12),  iou = inter / union
// in IEEE float32; the build passes -fmad=false so that no product is fused
// into an add. Every max and min carries NaN, as torch.maximum,
// torch.minimum and torch.clamp (and the Pallas kernels' jnp.maximum) do,
// so that every kernel gets the plain PyTorch version's bits: a box with a
// NaN coordinate has IoU NaN with every box, above no threshold.
#pragma once

#include <cstdint>

namespace {

constexpr int kSeg = 64;  // keys a warp sorts in registers: two per lane
constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ float volume(const float* b) {
  return ((b[2] - b[0]) * (b[3] - b[1])) * (b[5] - b[4]);
}

// max and min that return NaN where either operand is NaN (fmaxf and fminf
// return the other operand); otherwise as fmaxf and fminf, +0 above -0
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

// the intersection of row box a and column box b: +0 where they do not
// meet, NaN where a coordinate is NaN
__device__ __forceinline__ float box_inter(const float* a, const float* b) {
  const float ix = max_nan(min_nan(a[2], b[2]) - max_nan(a[0], b[0]), 0.0f);
  const float iy = max_nan(min_nan(a[3], b[3]) - max_nan(a[1], b[1]), 0.0f);
  const float iz = max_nan(min_nan(a[5], b[5]) - max_nan(a[4], b[4]), 0.0f);
  return (ix * iy) * iz;
}

// the clamped union of a and b (volumes a[6], b[6]) with intersection inter
__device__ __forceinline__ float box_union(const float* a, const float* b, float inter) {
  return max_nan((a[6] + b[6]) - inter, 1e-12f);
}

// IoU of row box a and column box b, each 6 coordinates and the volume
__device__ __forceinline__ float box_iou(const float* a, const float* b) {
  const float inter = box_inter(a, b);
  return inter / box_union(a, b, inter);
}

__device__ __forceinline__ bool iou_above(const float* a, const float* b, float thr) {
  return box_iou(a, b) > thr;
}

// whether boxes a and b overlap along every axis (min - max > 0 on each,
// which for floats with gradual underflow is min > max); where they do not,
// box_iou(a, b) is 0 (or NaN for infinite coordinates), above no threshold
// >= 0. A NaN coordinate makes its comparison false: the boxes do not
// overlap, and their IoU, NaN, is above no threshold either, as in the
// plain version (NaN > thr is false)
__device__ __forceinline__ bool boxes_overlap(const float* a, const float* b) {
  return (min_nan(a[2], b[2]) > max_nan(a[0], b[0])) &
         (min_nan(a[3], b[3]) > max_nan(a[1], b[1])) &
         (min_nan(a[5], b[5]) > max_nan(a[4], b[4]));
}

// ascending order of the key: score descending, then index ascending; -0
// compares equal to +0, so both take the index order
__device__ __forceinline__ unsigned long long sort_key(float s, int i) {
  if (s == 0.0f) s = 0.0f;
  const uint32_t u = __float_as_uint(s);
  const uint32_t asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(~asc) << 32) | static_cast<uint32_t>(i);
}

// one bitonic compare-exchange of keys e and e ^ j held by lanes of a warp
// (j < 32) or by one lane (j = 32: a holds e, b holds e + 32)
__device__ __forceinline__ void bitonic_step(unsigned long long& a, unsigned long long& b,
                                             int e0, int k, int j, int lane) {
  if (j == 32) {
    if ((a > b) == ((e0 & k) == 0)) {
      const unsigned long long t = a;
      a = b;
      b = t;
    }
    return;
  }
  const unsigned long long pa = __shfl_xor_sync(kAllLanes, a, j);
  const unsigned long long pb = __shfl_xor_sync(kAllLanes, b, j);
  const bool lower = (lane & j) == 0;
  // the lower element of an ascending pair keeps the min, and so on
  a = (lower == ((e0 & k) == 0)) ? (a < pa ? a : pa) : (a < pa ? pa : a);
  b = (lower == (((e0 + 32) & k) == 0)) ? (b < pb ? b : pb) : (b < pb ? pb : b);
}

// ascending bitonic sort of keys[0, n_pad), n_pad a power of two >= kSeg, by
// a block of kThreads threads: the strides below 64 in registers with warp
// shuffles, the larger ones through `keys` (shared or global memory), one
// barrier each
template <int kThreads>
__device__ void sort_keys(unsigned long long* keys, int n_pad, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int n_seg = n_pad / kSeg;
  // k = 2 .. 64: every pair inside one warp's 64 keys
  for (int seg = warp; seg < n_seg; seg += kThreads / 32) {
    const int e0 = seg * kSeg + lane;
    unsigned long long a = keys[e0], b = keys[e0 + 32];
    for (int k = 2; k <= kSeg; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) bitonic_step(a, b, e0, k, j, lane);
    }
    keys[e0] = a;
    keys[e0 + 32] = b;
  }
  __syncthreads();
  for (int k = 2 * kSeg; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= kSeg; j >>= 1) {
      for (int p = tid; p < (n_pad >> 1); p += kThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        const unsigned long long a = keys[i], c = keys[l];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[l] = a;
        }
      }
      __syncthreads();
    }
    for (int seg = warp; seg < n_seg; seg += kThreads / 32) {
      const int e0 = seg * kSeg + lane;
      unsigned long long a = keys[e0], b = keys[e0 + 32];
      for (int j = 32; j > 0; j >>= 1) bitonic_step(a, b, e0, k, j, lane);
      keys[e0] = a;
      keys[e0 + 32] = b;
    }
    __syncthreads();
  }
}

}  // namespace

// Truncated greedy 3D NMS, one thread block per image, for Hopper (sm_90a).
//
// Replaces: nndetection_tpu/ops/pallas_ops.py::_nms_topk_kernel (called by
// nms_topk_pallas), the JAX package's default NMS on the TPU. Same
// semantics: max_out steps, each taking the highest remaining score (the
// lowest index among ties), then suppressing every box whose IoU with it is
// strictly greater than the threshold. Step i writes the selected index and a
// valid flag; once no box is alive, the remaining steps write index 0, flag 0.
//
// What bounds it on the H100: latency, not bandwidth or arithmetic: the
// selections form a dependent chain. The TPU kernel takes an arg-max over all
// N scores at every step and then an IoU pass over all N boxes. Here:
// * sort once: the candidates' order never changes, so the block sorts the
//   image's 64-bit keys (an order-preserving map of the score, inverted so
//   that higher scores come first, above the index), a bitonic sort over N padded to a power of two (at least 64); the strides
//   below 64 run in registers with warp shuffles, without a block barrier.
//   -inf sorts last, tied scores by index, -0 ties +0 as the comparison does;
// * greedy NMS selects a candidate iff no box selected before it overlaps
//   it above the threshold. So the block walks the sorted candidates in
//   chunks of 32: every warp tests the chunk against its share of the boxes
//   selected so far, and against the chunk's earlier candidates (a 32 x 32
//   bit matrix); then one warp resolves the chunk in order with __ffs over a
//   32-bit mask, ~40 cycles per selection, and appends the selected boxes.
//   An eager pass over every remaining box after each selection, kept in an
//   alive bitmask, took ~2,200 cycles per selection at N = 1000 on the
//   H100, most of them 16 warps issuing IoUs; the walk does the IoUs of the
//   chunks it reaches only, and stops once max_out boxes are selected;
// * the boxes: read from the input by index, only for the chunks the walk
//   reaches. A copy of the sorted boxes into shared memory saved ~1 us of
//   device time in 25 at 16 x 1000 on the H100, within the spread of runs;
// * the scratch (the sort keys and the selected boxes' references: 8 B per
//   padded box, 4 B per selection) sits in shared memory behind a fixed
//   header where it fits (N up to 16384 at max_out 100), else in a global
//   workspace the caller provides, one slice per image, where the same code
//   runs through the same generic pointers (each barrier also orders the
//   block's global writes). The caller's plan (ops/nms.py::plan_nms_topk)
//   reads kHeaderWords from this file and kSeg from box_geometry.cuh, whose
//   sort network and IoU this kernel shares with iou_matrix.cu and
//   wbc_cluster.cu, and sizes both.
//
// Rounding: the IoU is computed exactly as the Pallas kernel writes it, the
// selected box first: inter = max(dx,0)*max(dy,0)*max(dz,0), union =
// max((vol_k + vol) - inter, 1e-12), iou = inter/union, in IEEE float32 with
// IEEE division, every max and min carrying NaN (box_geometry.cuh); the
// build passes -fmad=false so that no product is fused into an add. The
// selected indices are therefore identical to the plain PyTorch version's; a
// box with a NaN coordinate suppresses nothing and is suppressed by nothing.
// A NaN score makes the plain version's arg-max pick it and find nothing
// alive at every step; the kernel then selects nothing too.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "box_geometry.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // candidates per chunk: one per lane
constexpr int kFields = 7;        // a box in registers: x1, y1, x2, y2, z1, z2, volume
constexpr int kHeaderWords = 64;  // shared memory ahead of the scratch: counts, masks
static_assert(2 + kWarps + kChunk <= kHeaderWords, "the header holds the block's counts and masks");
constexpr unsigned kAll = kAllLanes;

// keys and selected references in shared memory behind the header, or in
// ws + img * ws_words when ws is not null
__global__ void __launch_bounds__(kThreads)
nms_topk_kernel(const float* __restrict__ boxes,   // [I, N, 6]
                const float* __restrict__ scores,  // [I, N], -inf = invalid
                int n, int n_pad, int max_out, float thr,
                unsigned long long* ws, long long ws_words,
                int64_t* __restrict__ out_idx,     // [I, max_out]
                bool* __restrict__ out_valid) {    // [I, max_out]
  extern __shared__ __align__(16) unsigned char smem[];
  int& s_valid = reinterpret_cast<int*>(smem)[0];
  int& s_count = reinterpret_cast<int*>(smem)[1];
  uint32_t* s_supp = reinterpret_cast<uint32_t*>(smem) + 2;
  uint32_t* s_mat = s_supp + kWarps;
  const int img = blockIdx.x;
  unsigned long long* keys =
      ws ? ws + img * ws_words : reinterpret_cast<unsigned long long*>(smem) + kHeaderWords / 2;
  int* s_ref = reinterpret_cast<int*>(keys + n_pad);  // the selected boxes
  const float* bx = boxes + static_cast<size_t>(img) * n * 6;
  const float* sc = scores + static_cast<size_t>(img) * n;
  int64_t* oi = out_idx + static_cast<size_t>(img) * max_out;
  bool* ov = out_valid + static_cast<size_t>(img) * max_out;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  auto load_box = [&](int i, float* o) {
    const float* b = bx + static_cast<size_t>(i) * 6;
#pragma unroll
    for (int f = 0; f < 6; ++f) o[f] = b[f];
    o[6] = volume(o);
  };

  // 1. keys, the count of valid scores, and whether any score is NaN
  if (tid == 0) s_valid = 0;
  __syncthreads();
  int valid = 0, has_nan = 0;
  for (int i = tid; i < n_pad; i += kThreads) {
    if (i < n) {
      const float s = sc[i];
      valid += s > -INFINITY;
      has_nan |= isnan(s);
      keys[i] = sort_key(s, i);
    } else {
      keys[i] = ~0ull;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) valid += __shfl_xor_sync(kAll, valid, off);
  if (lane == 0 && valid) atomicAdd(&s_valid, valid);
  has_nan = __syncthreads_or(has_nan);

  // 2. sort once
  sort_keys<kThreads>(keys, n_pad, tid);
  const int n_valid = has_nan ? 0 : s_valid;

  // 3. the sorted candidates, a chunk of 32 at a time
  int s = 0;
  for (int cursor = 0; s < max_out && cursor < n_valid; cursor += kChunk) {
    const int c = cursor + lane;
    const bool vc = c < n_valid;
    const int ref = vc ? static_cast<int>(static_cast<uint32_t>(keys[c])) : 0;
    float own[kFields];
    if (vc) {
      load_box(ref, own);
    } else {
#pragma unroll
      for (int f = 0; f < kFields; ++f) own[f] = 0.0f;
    }
    // suppressed by a box selected in an earlier chunk: warp w takes
    // selections w, w + 16, ...
    bool hit = false;
    if (vc) {
      for (int k = warp; k < s; k += kWarps) {
        float sel[kFields];
        load_box(s_ref[k], sel);
        hit |= iou_above(sel, own, thr);
      }
    }
    const uint32_t supp = __ballot_sync(kAll, hit);
    if (lane == 0) s_supp[warp] = supp;
    // row i: the later candidates of the chunk that candidate i suppresses
    for (int i = warp; i < kChunk; i += kWarps) {
      float bi[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) bi[f] = __shfl_sync(kAll, own[f], i);
      const uint32_t row = __ballot_sync(kAll, vc && lane > i && iou_above(bi, own, thr));
      if (lane == 0) s_mat[i] = row;
    }
    __syncthreads();
    if (warp == 0) {
      // in order: the first candidate left is selected, and drops its row
      const uint32_t sup = __reduce_or_sync(kAll, lane < kWarps ? s_supp[lane] : 0u);
      uint32_t left = __ballot_sync(kAll, vc) & ~sup;
      const uint32_t row = s_mat[lane];
      uint32_t sel = 0;
      int room = max_out - s;
      while (left && room > 0) {
        const int f = __ffs(left) - 1;
        sel |= 1u << f;
        --room;
        left &= ~(1u << f) & ~__shfl_sync(kAll, row, f);
      }
      if ((sel >> lane) & 1u) {
        const int slot = s + __popc(sel & ((1u << lane) - 1u));
        oi[slot] = static_cast<int64_t>(ref);
        ov[slot] = true;
        s_ref[slot] = ref;
      }
      if (lane == 0) s_count = s + __popc(sel);
    }
    __syncthreads();
    s = s_count;
  }
  for (int j = s + tid; j < max_out; j += kThreads) {
    oi[j] = 0;
    ov[j] = false;
  }
}

}  // namespace

// boxes [I, N, 6] f32, scores [I, N] f32, out_idx [I, max_out] int64,
// out_valid [I, max_out] bool; all contiguous on device `device`. n_pad the
// power of two >= max(N, kSeg) the sort runs over. The scratch of an image is
// n_pad keys and min(max_out, N) int32 references: in shared memory when ws
// is null (smem >= 4 * kHeaderWords + 8 * n_pad + 4 * min(max_out, N)), else
// in ws, I slices of ws_words >= n_pad + ceil(min(max_out, N) / 2) 8-byte
// words (smem >= 4 * kHeaderWords). Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments out of range); the
// caller's current device is restored.
extern "C" int nms_topk_launch(const void* boxes, const void* scores, int num_images, int n,
                               int n_pad, int max_out, float thr, void* ws, long long ws_words,
                               int smem, void* out_idx, void* out_valid, void* stream,
                               int device) {
  const long long s_cap = max_out < n ? max_out : n;
  const long long need = 4LL * kHeaderWords + (ws ? 0 : 8LL * n_pad + 4 * s_cap);
  if (n < 1 || n_pad < n || n_pad < kSeg || (n_pad & (n_pad - 1)) || max_out < 1 ||
      num_images < 1 || smem < need || (ws && ws_words < n_pad + (s_cap + 1) / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // raise the dynamic shared memory limit of this device once per size above
  // the last one
  static int set_bytes[64] = {};
  if (device < 0 || device >= 64) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && smem > 48 * 1024 && smem > set_bytes[device]) {
    err = cudaFuncSetAttribute(nms_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) set_bytes[device] = smem;
  }
  if (err == cudaSuccess) {
    nms_topk_kernel<<<num_images, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores), n, n_pad, max_out,
        thr, static_cast<unsigned long long*>(ws), ws_words, static_cast<int64_t*>(out_idx),
        static_cast<bool*>(out_valid));
    err = cudaGetLastError();
  }
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}

// Truncated greedy 3D NMS, one thread block per image, for Hopper (sm_90a).
//
// Replaces: nndetection_tpu/ops/pallas_ops.py::_nms_topk_kernel (called by
// nms_topk_pallas), the JAX package's default NMS on the TPU. Same
// semantics: max_out steps, each taking the highest remaining score (the
// lowest index among ties), then suppressing every box whose IoU with it is
// strictly greater than the threshold. Step i writes the selected index and a
// valid flag; once no box is alive, the remaining steps write index 0, flag 0.
//
// What bounds it on the H100: latency, not bandwidth or arithmetic. Each of
// the max_out steps is a block-wide arg-max followed by one pass of IoU over
// N boxes, separated by barriers: 100 steps over N = 1000 boxes is ~1e5 IoUs
// per image, microseconds of arithmetic, so the barrier and reduction latency
// of the serial steps dominates. The design answers that by keeping the whole
// scan in one launch (no host round trip per step) and the scores, which
// every step reads twice and writes, in shared memory (4 B per box: 40 KB at
// N = 10000). The boxes (24 B per box, 240 KB at N = 10000, more than a
// block's 227 KB of shared memory) stay in global memory, where after the
// first step they are served from L2. Images run as independent blocks, so a
// batch of tiles x flips fills the SMs in one launch.
//
// Rounding: the IoU is computed exactly as the Pallas kernel writes it,
// inter = max(dx,0)*max(dy,0)*max(dz,0), union = max(vol_k + vol - inter,
// 1e-12), iou = inter/union, in IEEE float32 with IEEE division; the build
// passes -fmad=false so that no product is fused into an add. The selected
// indices are therefore identical to the plain PyTorch version's.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// (score, index) order of the arg-max: higher score first, then lower index
__device__ __forceinline__ bool better(float s, int i, float best, int bi) {
  return s > best || (s == best && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& best, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(s, i, best, bi)) {
      best = s;
      bi = i;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nms_topk_kernel(const float* __restrict__ boxes,   // [I, N, 6]
                const float* __restrict__ scores,  // [I, N], -inf = invalid
                int n, int max_out, float thr,
                int32_t* __restrict__ out_idx,     // [I, max_out]
                uint8_t* __restrict__ out_valid) { // [I, max_out]
  extern __shared__ float s_scores[];
  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ int sel_idx;
  __shared__ int sel_alive;

  const int img = blockIdx.x;
  const float* b = boxes + static_cast<size_t>(img) * n * 6;
  const float* sc = scores + static_cast<size_t>(img) * n;
  int32_t* oi = out_idx + static_cast<size_t>(img) * max_out;
  uint8_t* ov = out_valid + static_cast<size_t>(img) * max_out;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < n; i += kThreads) s_scores[i] = sc[i];
  __syncthreads();

  for (int step = 0; step < max_out; ++step) {
    // 1. block-wide (max score, lowest index among ties); each thread walks
    //    its strided share in increasing index, so it keeps the first max
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float s = s_scores[i];
      if (s > best) {
        best = s;
        bi = i;
      }
    }
    warp_argmax(best, bi);
    if (lane == 0) {
      warp_best[warp] = best;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? warp_best[lane] : -INFINITY;
      bi = lane < kWarps ? warp_idx[lane] : INT_MAX;
      warp_argmax(best, bi);
      if (lane == 0) {
        // 2. alive = best > -inf; write idx and valid for this step
        const int alive = best > -INFINITY;
        sel_alive = alive;
        sel_idx = alive ? bi : 0;
        oi[step] = alive ? bi : 0;
        ov[step] = static_cast<uint8_t>(alive);
      }
    }
    __syncthreads();
    if (!sel_alive) {
      // nothing left to select: every later step is index 0, invalid
      for (int j = step + 1 + threadIdx.x; j < max_out; j += kThreads) {
        oi[j] = 0;
        ov[j] = 0;
      }
      return;
    }

    // 3. IoU of the selected box against this thread's share; 4. the
    //    selected box and every box with IoU > thr drop out
    const int k = sel_idx;
    const float kx1 = b[k * 6 + 0], ky1 = b[k * 6 + 1], kx2 = b[k * 6 + 2];
    const float ky2 = b[k * 6 + 3], kz1 = b[k * 6 + 4], kz2 = b[k * 6 + 5];
    const float vol_k = ((kx2 - kx1) * (ky2 - ky1)) * (kz2 - kz1);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (s_scores[i] == -INFINITY) continue;  // already out: no change
      const float x1 = b[i * 6 + 0], y1 = b[i * 6 + 1], x2 = b[i * 6 + 2];
      const float y2 = b[i * 6 + 3], z1 = b[i * 6 + 4], z2 = b[i * 6 + 5];
      const float ix = fmaxf(fminf(kx2, x2) - fmaxf(kx1, x1), 0.0f);
      const float iy = fmaxf(fminf(ky2, y2) - fmaxf(ky1, y1), 0.0f);
      const float iz = fmaxf(fminf(kz2, z2) - fmaxf(kz1, z1), 0.0f);
      const float inter = (ix * iy) * iz;
      const float vol = ((x2 - x1) * (y2 - y1)) * (z2 - z1);
      const float uni = fmaxf((vol_k + vol) - inter, 1e-12f);
      if (inter / uni > thr || i == k) s_scores[i] = -INFINITY;
    }
    __syncthreads();
  }
}

}  // namespace

// boxes [I, N, 6] f32, scores [I, N] f32, out_idx [I, max_out] int32,
// out_valid [I, max_out] uint8; all contiguous on the device. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int nms_topk_launch(const void* boxes, const void* scores,
                               int num_images, int n, int max_out, float thr,
                               void* out_idx, void* out_valid, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_topk_kernel<<<num_images, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores), n,
      max_out, thr, static_cast<int32_t*>(out_idx),
      static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

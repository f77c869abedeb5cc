// Pairwise 3D IoU matrix for Hopper (sm_90a).
//
// Replaces: nndetection_tpu/ops/pallas_ops.py::_iou_kernel (called by
// iou_matrix_pallas). No path of either package launches it: the JAX
// package's device WBC takes jnp box_iou (core/boxes/wbc.py:59), the port's
// computes its IoUs on chip (wbc_cluster.cu). Same function: out[i, j] =
// inter / max(union,
// 1e-12) of row box i of boxes1 [N, 6] and column box j of boxes2 [M, 6],
// boxes as (x1, y1, x2, y2, z1, z2).
//
// What bounds it on the H100: its output. It reads 24 B per box and writes
// 4 B per pair: 4 MB at 1000 x 1000, ~1.2 us at 3.35 TB/s, against ~26
// float32 operations per pair (~0.4 us at 67 TFLOP/s). At the WBC's sizes
// the launch itself takes longer than either. The design follows from the
// output: one thread per element, a 32 x 8 block of threads covering 32 rows
// x 32 columns, the block's row and column boxes (with their volumes) staged
// once in shared memory, and each warp storing 32 neighbouring floats of one
// row, so that every store is one coalesced 128-byte line. The Pallas
// kernel's 256 x 256 tiles and component-major layout exist for the TPU's
// (8, 128) vector tiling and do not carry over.
//
// Rounding: the Pallas formula's order (box_iou and volume of
// box_geometry.cuh, shared with the NMS and WBC kernels), IEEE division; with
// -fmad=false nothing is contracted, so the result equals the plain PyTorch
// version's bit for bit.
#include <cuda_runtime.h>

#include <cstddef>

#include "box_geometry.cuh"

namespace {

constexpr int kCols = 32;       // columns per block: one per thread of a warp
constexpr int kRows = 32;       // rows per block
constexpr int kThreadRows = 8;  // warps per block; each covers kRows / 8 rows
constexpr int kStride = 7;      // 6 coordinates + volume; odd, so no bank conflicts

__global__ void __launch_bounds__(kCols * kThreadRows)
iou_matrix_kernel(const float* __restrict__ boxes1,  // [N, 6]
                  const float* __restrict__ boxes2,  // [M, 6]
                  int n, int m,
                  float* __restrict__ out) {         // [N, M]
  __shared__ float s_rows[kRows * kStride];
  __shared__ float s_cols[kCols * kStride];
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  constexpr int kThreads = kCols * kThreadRows;

  // stage the block's boxes: 32 x 6 contiguous floats each, coalesced
  for (int k = tid; k < kRows * 6; k += kThreads) {
    const int r = k / 6, c = k - r * 6;
    s_rows[r * kStride + c] = row0 + r < n ? boxes1[static_cast<size_t>(row0) * 6 + k] : 0.0f;
  }
  for (int k = tid; k < kCols * 6; k += kThreads) {
    const int r = k / 6, c = k - r * 6;
    s_cols[r * kStride + c] = col0 + r < m ? boxes2[static_cast<size_t>(col0) * 6 + k] : 0.0f;
  }
  __syncthreads();
  if (tid < kRows) {
    s_rows[tid * kStride + 6] = volume(&s_rows[tid * kStride]);
  } else if (tid < kRows + kCols) {
    const int r = tid - kRows;
    s_cols[r * kStride + 6] = volume(&s_cols[r * kStride]);
  }
  __syncthreads();

  const int j = col0 + threadIdx.x;
  if (j >= m) return;
  float col[kStride];  // this thread's column box, in registers
#pragma unroll
  for (int f = 0; f < kStride; ++f) col[f] = s_cols[threadIdx.x * kStride + f];
  for (int r = threadIdx.y; r < kRows; r += kThreadRows) {
    const int i = row0 + r;
    if (i >= n) break;
    // the row box: one address per warp, a broadcast
    out[static_cast<size_t>(i) * m + j] = box_iou(&s_rows[r * kStride], col);
  }
}

}  // namespace

// boxes1 [N, 6], boxes2 [M, 6], out [N, M], all float32, contiguous on the
// device, N, M > 0. Launches on `stream` and returns cudaGetLastError().
extern "C" int iou_matrix_launch(const void* boxes1, const void* boxes2, int n,
                                 int m, void* out, void* stream) {
  const dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  const dim3 block(kCols, kThreadRows);
  iou_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2), n,
      m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Pairwise 3D IoU matrix for Hopper (sm_90a).
//
// Replaces: nndetection_tpu/ops/pallas_ops.py::_iou_kernel (called by
// iou_matrix_pallas). No path of either package launches it: the JAX
// package's device WBC takes jnp box_iou (core/boxes/wbc.py:59), the port's
// computes its IoUs on chip (wbc_cluster.cu). Same function: out[i, j] =
// inter / max(union, 1e-12) of row box i of boxes1 [N, 6] and column box j
// of boxes2 [M, 6], boxes as (x1, y1, x2, y2, z1, z2).
//
// What bounds it on the H100: its output. It reads 24 B per box and writes
// 4 B per pair (1 GiB at 16384 x 16384: 0.32 ms at 3.35 TB/s), against ~26
// float32 operations and an IEEE division per pair, about as much issue
// time at that size. The design follows from both:
// * a block of 8 warps covers 128 columns and 8 x R rows (R, the rows a
//   warp walks, from the caller's plan: 1 to 16, so that small matrices
//   still give every SM several blocks and large ones pay the staging once
//   per 64 KB of output). Lane l owns 4 columns and holds their boxes and
//   volumes in registers, and the warp walks its rows: each row is 512
//   contiguous bytes of one warp, one 16-byte store a lane;
// * the block's 128 column boxes and 8R row boxes are staged once, one box
//   a thread (6 loads, its volume, two float4 in shared memory), behind one
//   barrier; a row box is read by the whole warp at one address, a
//   broadcast;
// * row i starts on a 16-byte boundary only when M % 4 == 0 (the caller
//   allocates the output, aligned). For other M the lane owns columns l,
//   l + 32, l + 64 and l + 96 instead and stores them one float at a time:
//   each store instruction of the warp is still 128 contiguous bytes;
// * where the boxes do not meet (inter is +-0) and the union is not NaN,
//   the union is >= 1e-12 or +inf and the quotient is inter itself, sign
//   included: those pairs skip the division, exactly;
// * the stores are marked evict-first (st.global.cs): no slower at 1000
//   and 4096 boxes, 3.5 % faster at 16384 on the H100, where the 1 GiB
//   output passes through the 50 MB L2 once.
// The Pallas kernel's 256 x 256 tiles and component-major layout exist for
// the TPU's (8, 128) vector tiling and do not carry over. TMA stores are not
// used: the 16-byte stores already write whole 512-byte rows per warp, and a
// TMA store would first stage the tile in shared memory.
//
// Rounding: the Pallas formula's order (box_inter, box_union and volume of
// box_geometry.cuh, shared with the NMS, suppression and WBC kernels; every
// max and min carries NaN), IEEE division; with -fmad=false nothing is
// contracted, so the result equals the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "box_geometry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;
constexpr int kCols = 32 * kColsPerLane;  // columns per block
constexpr int kMaxRowsPerWarp = 16;       // R: rows per block up to 8 x 16 = 128
constexpr int kMaxRows = kWarps * kMaxRowsPerWarp;
static_assert(kCols + kMaxRows <= kThreads, "one staging thread per box");

// box idx of boxes [count, 6] with its volume, as two float4 (x1 y1 x2 y2 |
// z1 z2 volume -); zeros past the end
__device__ __forceinline__ void stage_box(const float* __restrict__ boxes, int idx, int count,
                                          float4& lo, float4& hi) {
  float b[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (idx < count) {
    const float* p = boxes + static_cast<size_t>(idx) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) b[c] = p[c];
    b[6] = volume(b);
  }
  lo = make_float4(b[0], b[1], b[2], b[3]);
  hi = make_float4(b[4], b[5], b[6], 0.0f);
}

__device__ __forceinline__ void unpack(const float4& lo, const float4& hi, float* b) {
  b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
  b[4] = hi.x; b[5] = hi.y; b[6] = hi.z;
}

// inter / union of row box a and column box b, the division skipped where
// the quotient is inter itself: inter +-0 and the union not NaN
__device__ __forceinline__ float pair_iou(const float* a, const float* b) {
  const float inter = box_inter(a, b);
  const float uni = box_union(a, b, inter);
  float q = inter;
  if (inter != 0.0f || uni != uni) q = inter / uni;
  return q;
}

// kVec: lane l owns columns 4l .. 4l + 3 of the block and stores them as one
// float4 (M % 4 == 0); else columns l, l + 32, l + 64, l + 96, one float each
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
iou_matrix_kernel(const float* __restrict__ boxes1,  // [N, 6]
                  const float* __restrict__ boxes2,  // [M, 6]
                  int n, int m, int rows_per_warp,
                  float* __restrict__ out) {         // [N, M]
  // column box of (lane l, slot k) at s_col[k][half][l]: a warp's read of
  // one slot is 32 consecutive float4, free of bank conflicts
  __shared__ float4 s_col[kColsPerLane][2][32];
  __shared__ float4 s_row[kMaxRows][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = kWarps * rows_per_warp;
  const int col0 = blockIdx.x * kCols, row0 = blockIdx.y * rows;
  if (tid < kCols) {
    const int k = kVec ? tid % kColsPerLane : tid / 32;
    const int l = kVec ? tid / kColsPerLane : tid % 32;
    stage_box(boxes2, col0 + tid, m, s_col[k][0][l], s_col[k][1][l]);
  } else if (tid - kCols < rows) {
    const int r = tid - kCols;
    stage_box(boxes1, row0 + r, n, s_row[r][0], s_row[r][1]);
  }
  __syncthreads();

  float col[kColsPerLane][7];
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) unpack(s_col[k][0][lane], s_col[k][1][lane], col[k]);
  const int j0 = col0 + (kVec ? kColsPerLane * lane : lane);
  for (int r = warp; r < rows; r += kWarps) {
    const int i = row0 + r;
    if (i >= n) break;
    float row[7];
    unpack(s_row[r][0], s_row[r][1], row);  // one address per warp: a broadcast
    float q[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) q[k] = pair_iou(row, col[k]);
    float* o = out + static_cast<size_t>(i) * m + j0;
    if (kVec) {
      // M % 4 == 0 and j0 % 4 == 0: the four columns are all in or all out
      if (j0 < m) __stcs(reinterpret_cast<float4*>(o), make_float4(q[0], q[1], q[2], q[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        if (j0 + 32 * k < m) __stcs(o + 32 * k, q[k]);
      }
    }
  }
}

}  // namespace

// boxes1 [N, 6], boxes2 [M, 6], out [N, M], all float32, contiguous on the
// device, N, M > 0; rows_per_warp in 1 .. kMaxRowsPerWarp; vector (16-byte
// stores) only for M % 4 == 0 and a 16-byte aligned out. Launches on
// `stream` and returns cudaGetLastError(), or the error that refuses the
// arguments.
extern "C" int iou_matrix_launch(const void* boxes1, const void* boxes2, int n, int m,
                                 int rows_per_warp, int vector, void* out, void* stream) {
  if (rows_per_warp < 1 || rows_per_warp > kMaxRowsPerWarp || n <= 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vector && (m % kColsPerLane != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int rows = kWarps * rows_per_warp;
  const dim3 grid((m + kCols - 1) / kCols, (n + rows - 1) / rows);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* b1 = static_cast<const float*>(boxes1);
  const auto* b2 = static_cast<const float*>(boxes2);
  auto* o = static_cast<float*>(out);
  if (vector) {
    iou_matrix_kernel<true><<<grid, kThreads, 0, s>>>(b1, b2, n, m, rows_per_warp, o);
  } else {
    iou_matrix_kernel<false><<<grid, kThreads, 0, s>>>(b1, b2, n, m, rows_per_warp, o);
  }
  return static_cast<int>(cudaGetLastError());
}

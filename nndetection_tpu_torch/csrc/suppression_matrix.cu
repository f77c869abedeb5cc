// Bitmask suppression matrix and the greedy keep-scan over it, for Hopper
// (sm_90a): untruncated greedy 3D NMS in two launches.
//
// suppression_matrix_kernel replaces
// nndetection_tpu/ops/pallas_ops.py::_suppression_kernel (called by
// suppression_matrix_pallas). Same relation over score-sorted boxes: box j
// is suppressed by box i iff j > i and IoU(i, j) > thr. The Pallas kernel
// writes it as an int8 N x N matrix in 256 x 256 tiles; here it takes the
// bitmask form of nnDetection's CUDA NMS (nndet/csrc/cuda/nms.cu): row i is
// ceil(N/64) 64-bit words, bit b of word w standing for column 64*w + b.
// One block of 64 threads owns a 64 x 64 tile: it stages the tile's 64
// column boxes in shared memory, and each thread builds its row's word with
// 64 IoU comparisons. Tiles below the diagonal only write zero words, and
// the diagonal tile starts each row after its own column.
// Bound: bytes out are N*ceil(N/64)*8 (128 KB at N = 1000) and the work is
// N^2/2 IoUs of ~26 float32 operations: ~0.2 us of arithmetic at N = 1000;
// the launch decides its time at the sizes NMS sees.
//
// nms_keep_scan_kernel replaces the lax.fori_loop of
// nndetection_tpu/core/boxes/nms.py:142-147, which is not a TPU kernel: the
// scan over rows in score order. Row i is kept iff it is valid and no kept
// row before it suppresses it; a kept row ORs its words into the removed
// vector. The rows form a chain (row i's fate depends on every kept row
// before it), so the scan is one warp: the removed vector lives in shared
// memory, a live row's words are ORed in one word per lane, and __syncwarp
// orders the rows. Its time is the chain's latency, ~N dependent steps of a
// shared-memory read and, for a kept row, an L2 read of its words.
//
// Rounding: the IoU is the Pallas formula in IEEE float32 (see
// iou_matrix.cu), compared with the float32 threshold; with -fmad=false the
// bits equal the plain PyTorch version's.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBits = 64;    // columns per word, rows and columns per tile
constexpr int kStride = 7;   // 6 coordinates + volume

__device__ __forceinline__ float volume(const float* b) {
  return ((b[2] - b[0]) * (b[3] - b[1])) * (b[5] - b[4]);
}

__global__ void __launch_bounds__(kBits)
suppression_matrix_kernel(const float* __restrict__ boxes,  // [N, 6], score-sorted
                          int n, int words, float thr,
                          unsigned long long* __restrict__ out) {  // [N, words]
  __shared__ float s_cols[kBits * kStride];
  const int row_tile = blockIdx.y;
  const int col_tile = blockIdx.x;
  const int i = row_tile * kBits + threadIdx.x;
  if (col_tile < row_tile) {  // below the diagonal: j < i everywhere
    if (i < n) out[static_cast<size_t>(i) * words + col_tile] = 0ull;
    return;
  }
  const int j0 = col_tile * kBits;
  for (int k = threadIdx.x; k < kBits * 6; k += kBits) {
    const int r = k / 6, c = k - r * 6;
    s_cols[r * kStride + c] = j0 + r < n ? boxes[static_cast<size_t>(j0) * 6 + k] : 0.0f;
  }
  __syncthreads();
  s_cols[threadIdx.x * kStride + 6] = volume(&s_cols[threadIdx.x * kStride]);
  __syncthreads();
  if (i >= n) return;

  const float* rb = boxes + static_cast<size_t>(i) * 6;
  const float x1 = rb[0], y1 = rb[1], x2 = rb[2], y2 = rb[3], z1 = rb[4], z2 = rb[5];
  const float vol_i = ((x2 - x1) * (y2 - y1)) * (z2 - z1);
  const int start = col_tile == row_tile ? threadIdx.x + 1 : 0;
  const int end = min(kBits, n - j0);
  unsigned long long bits = 0ull;
  for (int b = start; b < end; ++b) {
    const float* cb = &s_cols[b * kStride];  // one address per warp: a broadcast
    const float ix = fmaxf(fminf(x2, cb[2]) - fmaxf(x1, cb[0]), 0.0f);
    const float iy = fmaxf(fminf(y2, cb[3]) - fmaxf(y1, cb[1]), 0.0f);
    const float iz = fmaxf(fminf(z2, cb[5]) - fmaxf(z1, cb[4]), 0.0f);
    const float inter = (ix * iy) * iz;
    const float uni = fmaxf((vol_i + cb[6]) - inter, 1e-12f);
    if (inter / uni > thr) bits |= 1ull << b;
  }
  out[static_cast<size_t>(i) * words + col_tile] = bits;
}

__global__ void __launch_bounds__(32)
nms_keep_scan_kernel(const unsigned long long* __restrict__ sup,  // [N, words]
                     const uint8_t* __restrict__ valid,           // [N]
                     int n, int words,
                     uint8_t* __restrict__ keep) {                // [N]
  extern __shared__ unsigned long long s_removed[];
  const int lane = threadIdx.x;
  for (int w = lane; w < words; w += 32) s_removed[w] = 0ull;
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    const int wi = i >> 6;
    const bool live = valid[i] && !((s_removed[wi] >> (i & 63)) & 1ull);
    __syncwarp();  // every lane has read word wi before any lane ORs into it
    if (live) {
      // words below wi are zero in row i (upper triangle): start at wi
      const unsigned long long* row = sup + static_cast<size_t>(i) * words;
      for (int w = wi + lane; w < words; w += 32) s_removed[w] |= row[w];
    }
    if (lane == 0) keep[i] = static_cast<uint8_t>(live);
    __syncwarp();
  }
}

}  // namespace

// boxes [N, 6] float32 (score-sorted), out [N, ceil(N/64)] 64-bit words;
// contiguous on the device, N > 0. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int suppression_matrix_launch(const void* boxes, int n, float thr,
                                         void* out, void* stream) {
  const int words = (n + kBits - 1) / kBits;
  const dim3 grid(words, words);
  suppression_matrix_kernel<<<grid, kBits, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), n, words, thr,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// sup [N, words] 64-bit words, valid [N] uint8, keep [N] uint8; contiguous on
// the device, N > 0. Launches one warp on `stream` and returns
// cudaGetLastError().
extern "C" int nms_keep_scan_launch(const void* sup, const void* valid, int n,
                                    int words, void* keep, void* stream) {
  const size_t smem = static_cast<size_t>(words) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      nms_keep_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_keep_scan_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(sup),
      static_cast<const uint8_t*>(valid), n, words,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

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
// The grid covers only the 64 x 64 tiles on and above the diagonal (tile t
// is column tile c, row tile r with t = c(c+1)/2 + r), and a block also
// writes the zero words of its mirror tile below the diagonal. Inside a
// tile, 8 warps walk 8 rows each; lane l holds column boxes 64c + l and
// 64c + 32 + l in registers with their volumes, and two __ballot_sync of
// the IoU test give the row's word, 32 bits each: 16 IoUs a thread, with
// enough warps on an SM to hide the division's latency. At a threshold >= 0
// a pair of boxes that do not meet is decided without the division.
// Bound: bytes out are N*ceil(N/64)*8 (128 KB at N = 1000) and the work is
// N^2/2 IoUs of ~26 float32 operations: ~0.2 us of arithmetic at N = 1000,
// so the launch decides the time there; at 16384 boxes the arithmetic does.
//
// nms_keep_scan_kernel replaces the lax.fori_loop of
// nndetection_tpu/core/boxes/nms.py:142-147, which is not a TPU kernel: the
// scan over rows in score order. Row i is kept iff it is valid and no kept
// row before it suppresses it. The chain from row to row is real only
// inside the diagonal word: row r of 64-row block k depends on the removed
// word k, set by the blocks before k, and on the diagonal words of the
// block's own kept rows. One block of 16 warps walks the 64-row blocks:
//   - warp 0 resolves block k's chain in registers. Lane l holds rows
//     64k + l and 64k + 32 + l: their valid flags, diagonal words (word k)
//     and next words (word k + 1). The chain jumps from kept row to kept
//     row: the lowest live row r is kept, and its diagonal word, fetched
//     by a shuffle, removes the rows after it. Then warp 0 writes the
//     block's 64 flags, ORs the kept rows' next words into a register that
//     completes word k + 1 for the next chain (word k + 1 first), and loads
//     block k + 1's flags and words while the other warps run the tail;
//   - warps 1-15 OR the kept rows of block k - 1 into words k + 1 ... W - 1
//     of the removed vector in shared memory, one word a thread, up to
//     16 independent loads in flight per thread.
// The tail of block k - 1 overlaps the chain of block k, and one barrier a
// block orders them: the chain of block k reads word k, which the tails of
// blocks k - 2 and before completed, and the near word of block k - 1
// (warp 0's register). Word k of the removed vector is dead once block k's
// chain has read it; warp 0 stores block k's kept rows there for the tail,
// so shared memory holds the removed vector alone. Its time is ~W block
// steps of a chain of shuffles and one round trip to L2, not N.
//
// Rounding: the IoU is the Pallas formula in IEEE float32
// (box_geometry.cuh), its max and min carrying NaN as jnp.maximum and
// torch.maximum do, compared with the float32 threshold; with -fmad=false
// the bits equal the plain PyTorch version's.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "box_geometry.cuh"

namespace {

constexpr int kBits = 64;            // columns per word, rows and columns per tile
constexpr int kTileThreads = 256;    // #8: 8 warps, 8 rows of the tile each
constexpr int kScanThreads = 512;    // keep-scan: the chain warp and 15 tail warps
constexpr int kTailLoads = 16;       // loads a tail thread keeps in flight
constexpr int kMaxDevices = 64;

// whether row box a suppresses column box b: box_iou of box_geometry.cuh
// (a box with a NaN coordinate suppresses nothing and is suppressed by
// nothing, as in the plain version) above thr. Where
// the boxes do not meet, inter is 0 (or NaN) and the IoU 0 (or NaN), above
// no thr >= 0: with skip_disjoint (thr >= 0) those pairs, most of a tile's,
// skip the division
__device__ __forceinline__ bool suppresses(const float* a, const float* b, float thr,
                                           bool skip_disjoint) {
  const float inter = box_inter(a, b);
  if (skip_disjoint && !(inter > 0.0f)) return false;
  return inter / box_union(a, b, inter) > thr;
}

// upper tile t as (row tile r, column tile c), t = c(c+1)/2 + r, r <= c
__device__ __forceinline__ void upper_tile(long long t, int& r, int& c) {
  long long cc = static_cast<long long>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  while (cc * (cc + 1) / 2 > t) --cc;
  while ((cc + 1) * (cc + 2) / 2 <= t) ++cc;
  c = static_cast<int>(cc);
  r = static_cast<int>(t - cc * (cc + 1) / 2);
}

__global__ void __launch_bounds__(kTileThreads)
suppression_matrix_kernel(const float* __restrict__ boxes,  // [N, 6], score-sorted
                          int n, int words, float thr,
                          unsigned long long* __restrict__ out) {  // [N, words]
  // the tile's row boxes (side 0) and column boxes (side 1): x1 y1 x2 y2 |
  // z1 z2 volume -
  __shared__ float4 s_box[2][kBits][2];
  int rt, ct;
  upper_tile(blockIdx.x, rt, ct);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = rt * kBits, j0 = ct * kBits;
  if (tid < 2 * kBits) {
    const int side = tid / kBits, q = tid % kBits, idx = (side ? j0 : i0) + q;
    float b[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (idx < n) {
      const float* p = boxes + static_cast<size_t>(idx) * 6;
      for (int c = 0; c < 6; ++c) b[c] = p[c];
      b[6] = volume(b);
    }
    s_box[side][q][0] = make_float4(b[0], b[1], b[2], b[3]);
    s_box[side][q][1] = make_float4(b[4], b[5], b[6], 0.0f);
  } else if (tid < 3 * kBits && ct != rt) {
    // the mirror tile (rows of column tile c, word r): below the diagonal
    const int i = j0 + tid - 2 * kBits;
    if (i < n) out[static_cast<size_t>(i) * words + rt] = 0ull;
  }
  __syncthreads();

  float lo[7], hi[7];
  {
    const float4 a = s_box[1][lane][0], b = s_box[1][lane][1];
    const float4 c = s_box[1][lane + 32][0], d = s_box[1][lane + 32][1];
    lo[0] = a.x; lo[1] = a.y; lo[2] = a.z; lo[3] = a.w; lo[4] = b.x; lo[5] = b.y; lo[6] = b.z;
    hi[0] = c.x; hi[1] = c.y; hi[2] = c.z; hi[3] = c.w; hi[4] = d.x; hi[5] = d.y; hi[6] = d.z;
  }
  const int j_lo = j0 + lane, j_hi = j0 + 32 + lane;
  const bool skip_disjoint = thr >= 0.0f;
  constexpr int kRowsPerWarp = kBits / (kTileThreads / 32);
  unsigned long long mine = 0ull;  // lane s keeps the word of the warp's row s
  for (int s = 0; s < kRowsPerWarp; ++s) {
    const int q = warp * kRowsPerWarp + s, i = i0 + q;  // warp-uniform
    if (i >= n) break;
    const float4 a = s_box[0][q][0], b = s_box[0][q][1];  // one address: a broadcast
    const float row[7] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
    const unsigned bits_lo =
        __ballot_sync(kAllLanes,
                      j_lo > i && j_lo < n && suppresses(row, lo, thr, skip_disjoint));
    const unsigned bits_hi =
        __ballot_sync(kAllLanes,
                      j_hi > i && j_hi < n && suppresses(row, hi, thr, skip_disjoint));
    if (lane == s) mine = (static_cast<unsigned long long>(bits_hi) << 32) | bits_lo;
  }
  const int i = i0 + warp * kRowsPerWarp + lane;
  if (lane < kRowsPerWarp && i < n) out[static_cast<size_t>(i) * words + ct] = mine;
}

// what warp 0 holds of a 64-row block: lane l's rows 64k + l and 64k + 32 + l
struct BlockRows {
  unsigned char valid_lo, valid_hi;
  unsigned long long diag_lo, diag_hi;  // word k
  unsigned long long next_lo, next_hi;  // word k + 1 (zero past the last word)
};

__device__ __forceinline__ BlockRows load_block(const unsigned long long* __restrict__ sup,
                                                const uint8_t* __restrict__ valid, int n,
                                                int words, int k, int lane) {
  BlockRows b = {0, 0, 0ull, 0ull, 0ull, 0ull};
  const int i = k * kBits + lane;
  const bool has_next = k + 1 < words;
  if (i < n) {
    const unsigned long long* row = sup + static_cast<size_t>(i) * words + k;
    b.valid_lo = valid[i];
    b.diag_lo = row[0];
    if (has_next) b.next_lo = row[1];
  }
  if (i + 32 < n) {
    const unsigned long long* row = sup + static_cast<size_t>(i + 32) * words + k;
    b.valid_hi = valid[i + 32];
    b.diag_hi = row[0];
    if (has_next) b.next_hi = row[1];
  }
  return b;
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned lo = __reduce_or_sync(kAllLanes, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(kAllLanes, static_cast<unsigned>(v >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__global__ void __launch_bounds__(kScanThreads)
nms_keep_scan_kernel(const unsigned long long* __restrict__ sup,  // [N, words]
                     const uint8_t* __restrict__ valid,           // [N] bool
                     int n, int words,
                     uint8_t* __restrict__ keep) {                // [N] bool
  extern __shared__ unsigned long long s_removed[];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int w = tid; w < words; w += kScanThreads) s_removed[w] = 0ull;
  BlockRows cur = {0, 0, 0ull, 0ull, 0ull, 0ull};
  if (tid < 32) cur = load_block(sup, valid, n, words, 0, lane);
  unsigned long long carry = 0ull;  // warp 0: word k of block k - 1's kept rows
  __syncthreads();
  for (int k = 0; k < words; ++k) {
    if (tid < 32) {
      const BlockRows nxt = k + 1 < words ? load_block(sup, valid, n, words, k + 1, lane) : cur;
      const unsigned long long valid_mask =
          __ballot_sync(kAllLanes, cur.valid_lo != 0) |
          (static_cast<unsigned long long>(__ballot_sync(kAllLanes, cur.valid_hi != 0)) << 32);
      // the chain: the lowest live row is kept and removes the rows its
      // diagonal word names (all after it)
      unsigned long long live = valid_mask & ~(s_removed[k] | carry);
      unsigned long long kept = 0ull;
      while (live) {
        const int r = __ffsll(static_cast<long long>(live)) - 1;
        const unsigned long long d = __shfl_sync(kAllLanes, r < 32 ? cur.diag_lo : cur.diag_hi,
                                                 r & 31);
        kept |= 1ull << r;
        live &= ~(d | (1ull << r));
      }
      carry = warp_or(((kept >> lane) & 1ull ? cur.next_lo : 0ull) |
                      ((kept >> (lane + 32)) & 1ull ? cur.next_hi : 0ull));
      const int i = k * kBits + lane;
      if (i < n) keep[i] = static_cast<uint8_t>((kept >> lane) & 1ull);
      if (i + 32 < n) keep[i + 32] = static_cast<uint8_t>((kept >> (lane + 32)) & 1ull);
      __syncwarp();  // every lane has read word k
      if (lane == 0) s_removed[k] = kept;
      cur = nxt;
    } else if (k >= 1) {
      // the tail of block k - 1: its kept rows into words k + 1 ... words - 1
      const unsigned long long kept = s_removed[k - 1];
      const unsigned long long* base = sup + static_cast<size_t>(k - 1) * kBits * words;
      for (int w = k + 1 + tid - 32; w < words; w += kScanThreads - 32) {
        unsigned long long acc = 0ull, m = kept;
        while (m) {
          unsigned long long v[kTailLoads];
#pragma unroll
          for (int q = 0; q < kTailLoads; ++q) {
            v[q] = 0ull;
            if (m) {
              const int r = __ffsll(static_cast<long long>(m)) - 1;
              m &= m - 1;
              v[q] = base[static_cast<size_t>(r) * words + w];
            }
          }
#pragma unroll
          for (int q = 0; q < kTailLoads; ++q) acc |= v[q];
        }
        s_removed[w] |= acc;
      }
    }
    __syncthreads();
  }
}

bool g_scan_smem_set[kMaxDevices];

}  // namespace

// boxes [N, 6] float32 (score-sorted), out [N, ceil(N/64)] 64-bit words;
// contiguous on the device, N > 0. Launches one block per tile on and above
// the diagonal on `stream` and returns cudaGetLastError().
extern "C" int suppression_matrix_launch(const void* boxes, int n, float thr,
                                         void* out, void* stream) {
  const long long words = (n + kBits - 1) / kBits;
  const long long tiles = words * (words + 1) / 2;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  suppression_matrix_kernel<<<static_cast<unsigned>(tiles), kTileThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), n, static_cast<int>(words), thr,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// sup [N, words] 64-bit words, valid [N] bool, keep [N] bool; contiguous on
// the device, N > 0. Launches one block on `stream` and returns
// cudaGetLastError(). The removed vector takes words * 8 bytes of dynamic
// shared memory; the kernel's limit is raised to the device's opt-in
// maximum at the first launch on each device.
extern "C" int nms_keep_scan_launch(const void* sup, const void* valid, int n,
                                    int words, void* keep, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_scan_smem_set[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(nms_keep_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_scan_smem_set[dev] = true;
  }
  const size_t smem = static_cast<size_t>(words) * sizeof(unsigned long long);
  nms_keep_scan_kernel<<<1, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(sup),
      static_cast<const uint8_t*>(valid), n, words,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

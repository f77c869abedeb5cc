// Weighted box clustering, the cluster loop, for Hopper (sm_90a): one
// thread block per class, one launch per call.
//
// Replaces: the lax.while_loop of nndetection_tpu/core/boxes/wbc.py:61-104
// (wbc, called per class by batched_wbc), which JAX compiles into one device
// program. It is not a TPU kernel, but its straightforward PyTorch form is a
// Python loop with a host synchronisation per cluster.
//
// The function, per class c, over the boxes that are valid, of label c and
// of finite score ("remaining"), until none remain:
//   seed    = arg-max of the remaining scores (lowest index on ties)
//   cluster = remaining boxes j with IoU(seed, j) > iou_thr, the seed the
//             row box
//   msw_j   = IoU(seed, j) * w_j,  ms_j = msw_j * s_j
//   n_found = |cluster|, n_expected = sum(n_exp_j) / max(n_found, 1)
//   score   = sum(ms) / max(sum(msw) + max(0, n_expected - n_found) *
//             (sum(msw) / max(n_found, 1)) * missing_weight, 1e-12)
//   box     = sum(box_j * ms_j) / max(sum(ms), 1e-12)
//   emitted at the running count if score > score_thr; the cluster leaves,
//   and so does the seed, also when it is outside its own cluster (a
//   zero-volume seed has IoU 0 with itself; the JAX loop never ends there).
//
// The same function as a greedy NMS and a parallel pass: when a seed is
// picked every remaining box ranks below it, so a box becomes a seed exactly
// when no earlier seed overlaps it above the threshold (the untruncated
// greedy NMS keep set, in score order), and a box that is not a seed belongs
// to the first seed, in seed order, that overlaps it. Per class block:
// 1. keys: each remaining box's 64-bit key (score descending, index
//    ascending, -0 tied with +0), sorted once by the bitonic network of
//    box_geometry.cuh (shared with nms_topk.cu);
// 2. walk: the sorted candidates 32 at a time. Every warp tests the chunk
//    against its share of the seeds so far (warp w: seeds w, w + 16, ...,
//    stopping at its first hit per candidate), and the block takes the
//    lowest seed over the warps by an integer atomicMin, which is the same
//    whatever the order; the chunk's own 32 x 32 bit matrix is built beside
//    it. One warp resolves the chunk in order with __ffs, as nms_topk.cu
//    does: a candidate that no earlier seed holds is a seed unless an
//    earlier seed of the chunk overlaps it, and it then belongs to the first
//    such one. A seed belongs to itself iff its IoU with itself is above the
//    threshold. The walk records each candidate's owner (a seed's rank) and
//    each seed's box;
// 3. group: a second sort, of the keys (owner, index), puts each seed's
//    members side by side in index order; each seed's run is found from its
//    neighbours;
// 4. sums: one thread per seed adds its members' ten values in increasing
//    index, one float32 add at a time, and computes the score and the box;
// 5. emission: a block-wide exclusive count of the emitted flags, in seed
//    order, gives each output row; the rows after the count are zeros.
//
// What bounds it: latency, the chain of chunks (two barriers and a serial
// resolve of ~40 cycles per seed each) and the two sorts; bytes and
// arithmetic are microseconds below that at the WBC's sizes. The chunk's
// tests against the seeds so far are the one part that grows as N x seeds.
//
// The IoU is computed on chip, from the class's boxes, with the arithmetic
// of iou_matrix.cu (box_iou of box_geometry.cuh, -fmad=false), every max of
// the IoU and of the sums carrying NaN as the plain version's torch.maximum
// and torch.clamp do (a box with a NaN coordinate joins no cluster), not read
// from an N x N matrix: the walk needs the IoU of each candidate with the
// seeds before it and the sums that of each member with its seed, a
// fraction of the matrix at ~25 flops each, while the matrix costs 4 B per
// pair to write and to read back (4 MB at N = 1000, 13.3 GB at 57,600).
//
// Scratch: the sort keys (8 B per padded box), the seeds' boxes (32 B per
// box), the owners, reused as the runs' starts, and the runs' ends (4 B each
// per box), in shared memory behind a fixed header where they fit (N up to
// 4160 in the H100's 227 KB), else in a global workspace the caller provides, one slice
// per class, through the same generic pointers (each barrier also orders the
// block's global writes). The caller's plan (ops/wbc_cluster.py::plan_wbc)
// reads kHeaderWords and kBoxBytes from this file and kSeg from
// box_geometry.cuh.
//
// Bits: the walk takes no float decision but IoU > threshold; the sums add
// in index order, one value at a time, and the score and box follow the
// formula's order in IEEE float32, so the result equals the plain PyTorch
// version's (ops/wbc_cluster.py) bit for bit, run after run.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "box_geometry.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;         // candidates per chunk: one per lane
constexpr int kUnroll = 4;         // seeds a warp loads and tests at once
constexpr int kFields = 7;         // a box in registers: x1, y1, x2, y2, z1, z2, volume
constexpr int kSums = 10;          // n_found, sum n_exp, sum msw, sum ms, six coordinate sums
constexpr int kHeaderWords = 128;  // shared memory ahead of the scratch: counts, masks
constexpr int kBoxBytes = 40;      // scratch per box besides the keys: a seed's box, two ints
static_assert(2 * kChunk + kWarps + 2 <= kHeaderWords,
              "the header holds the block's masks and counts");
static_assert(kBoxBytes == 32 + 2 * 4, "a seed's box (two float4), an owner, a run end");

__global__ void __launch_bounds__(kThreads)
wbc_cluster_kernel(const float* __restrict__ boxes,     // [N, 6]
                   const float* __restrict__ scores,    // [N]
                   const float* __restrict__ weights,   // [N]
                   const float* __restrict__ n_exp,     // [N]
                   const int32_t* __restrict__ labels,  // [N]
                   const uint8_t* __restrict__ valid,   // [N]
                   int n, int n_pad, float iou_thr, float score_thr, float missing_weight,
                   unsigned long long* ws, long long ws_words,
                   float* __restrict__ out_boxes,       // [C, N, 6]
                   float* __restrict__ out_scores,      // [C, N]
                   uint8_t* __restrict__ out_valid) {   // [C, N]
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_mat = reinterpret_cast<uint32_t*>(smem);  // the chunk's own rows, 16-byte aligned
  // per candidate: the first seed of an earlier chunk over the threshold
  int* s_prev = reinterpret_cast<int*>(s_mat + kChunk);
  int* s_warp = s_prev + kChunk;                         // emitted per warp
  int& s_rem = s_warp[kWarps];
  int& s_count = s_warp[kWarps + 1];
  const int c = blockIdx.x;
  unsigned long long* keys =
      ws ? ws + c * ws_words : reinterpret_cast<unsigned long long*>(smem) + kHeaderWords / 2;
  float4* s_box = reinterpret_cast<float4*>(keys + n_pad);  // [2 n] seed k's box and volume
  // [n] owner by sorted position; after the walk, seed k's run start
  int* s_owner = reinterpret_cast<int*>(s_box + 2 * n);
  int* s_end = s_owner + n;  // [n] seed k's run end
  float* ob = out_boxes + static_cast<size_t>(c) * n * 6;
  float* os = out_scores + static_cast<size_t>(c) * n;
  uint8_t* ov = out_valid + static_cast<size_t>(c) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  auto load_box = [&](int i, float* o) {
    const float* b = boxes + static_cast<size_t>(i) * 6;
#pragma unroll
    for (int f = 0; f < 6; ++f) o[f] = b[f];
    o[6] = volume(o);
  };
  auto seed_box = [&](int k, float* o) {
    const float4 a = s_box[2 * k], b = s_box[2 * k + 1];
    o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z;
  };

  // 1. keys of the remaining boxes (the others sort last), their count
  if (tid == 0) s_rem = 0;
  if (tid < kChunk) s_prev[tid] = INT_MAX;
  __syncthreads();
  int rem = 0;
  for (int i = tid; i < n_pad; i += kThreads) {
    unsigned long long key = ~0ull;
    if (i < n) {
      const float s = scores[i];
      if (valid[i] && labels[i] == c && isfinite(s)) {
        key = sort_key(s, i);
        ++rem;
      }
    }
    keys[i] = key;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rem += __shfl_xor_sync(kAllLanes, rem, off);
  if (lane == 0 && rem) atomicAdd(&s_rem, rem);
  __syncthreads();
  sort_keys<kThreads>(keys, n_pad, tid);
  const int n_rem = s_rem;

  // 2. the walk: owners and seeds, a chunk of 32 sorted candidates at a time;
  // each lane loads its candidate of the next chunk while this one is tested
  auto load_candidate = [&](int p, float* o) {
    const size_t ref = p < n_rem ? static_cast<uint32_t>(keys[p]) : 0;
#pragma unroll
    for (int f = 0; f < 6; ++f) o[f] = p < n_rem ? boxes[ref * 6 + f] : 0.0f;
  };
  int n_seeds = 0;
  float next[6];
  const bool skip_apart = iou_thr >= 0.0f;  // see boxes_overlap
  load_candidate(lane, next);
  for (int cursor = 0; cursor < n_rem; cursor += kChunk) {
    const int p = cursor + lane;
    const bool vc = p < n_rem;
    float own[kFields];
#pragma unroll
    for (int f = 0; f < 6; ++f) own[f] = next[f];
    own[6] = volume(own);
    load_candidate(p + kChunk, next);
    // the first seed of an earlier chunk over the threshold: warp w tests
    // seeds w, w + 16, ..., kUnroll of them at once, and stops once each of
    // its candidates has a hit. Most seeds overlap no candidate of the chunk
    // along some axis (IoU 0): for a threshold >= 0 the warp takes the IoU
    // only of the seeds that overlap one of its candidates.
    int first = INT_MAX;
    bool done = !vc;
    for (int k0 = warp; k0 < n_seeds; k0 += kWarps * kUnroll) {
      // all loads first (past the last seed, the last one again), so that
      // they are in flight together
      float sb[kUnroll][kFields];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) seed_box(min(k0 + u * kWarps, n_seeds - 1), sb[u]);
      uint32_t near = 0;  // bit u: seed k0 + 16 u may be over the threshold here
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool maybe = !skip_apart || boxes_overlap(sb[u], own);
        if (k0 + u * kWarps < n_seeds && maybe) near |= 1u << u;
      }
      if (done) near = 0;
      const uint32_t any_near = __reduce_or_sync(kAllLanes, near);
      if (any_near) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (((any_near >> u) & 1u) && ((near >> u) & 1u) && !done &&
              iou_above(sb[u], own, iou_thr)) {
            first = k0 + u * kWarps;
            done = true;
          }
        }
        if (__all_sync(kAllLanes, done)) break;
      }
    }
    if (first != INT_MAX) atomicMin(&s_prev[lane], first);
    // row i: the later candidates of the chunk over the threshold with i
    for (int i = warp; i < kChunk; i += kWarps) {
      float bi[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) bi[f] = __shfl_sync(kAllLanes, own[f], i);
      const bool test = vc && lane > i && (!skip_apart || boxes_overlap(bi, own));
      uint32_t row = 0;
      if (__any_sync(kAllLanes, test)) {
        row = __ballot_sync(kAllLanes, test && iou_above(bi, own, iou_thr));
      }
      if (lane == 0) s_mat[i] = row;
    }
    __syncthreads();
    if (warp == 0) {
      const int prev = s_prev[lane];
      s_prev[lane] = INT_MAX;
      // every lane holds the chunk's 32 rows in registers and runs the same
      // scan: in order, a candidate still left is a seed, and takes its row
      uint32_t rows[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; i += 4) {
        const uint4 r = reinterpret_cast<const uint4*>(s_mat)[i / 4];
        rows[i] = r.x, rows[i + 1] = r.y, rows[i + 2] = r.z, rows[i + 3] = r.w;
      }
      uint32_t left = __ballot_sync(kAllLanes, vc && prev == INT_MAX), sel = 0;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if ((left >> i) & 1u) {
          sel |= 1u << i;
          left &= ~rows[i];
        }
      }
      const bool is_seed = (sel >> lane) & 1u;
      const int rank = n_seeds + __popc(sel & ((1u << lane) - 1u));
      int owner = prev;
      if (is_seed) {
        owner = iou_above(own, own, iou_thr) ? rank : -1;
      } else if (owner == INT_MAX) {
        // the chunk's first seed whose row holds this candidate
        int f_first = kChunk;
#pragma unroll
        for (int f = kChunk - 1; f >= 0; --f) {
          if ((sel >> f) & (rows[f] >> lane) & 1u) f_first = f;
        }
        if (f_first < kChunk) owner = n_seeds + __popc(sel & ((1u << f_first) - 1u));
      }
      if (vc) s_owner[p] = owner;
      if (is_seed) {
        s_box[2 * rank] = make_float4(own[0], own[1], own[2], own[3]);
        s_box[2 * rank + 1] = make_float4(own[4], own[5], own[6], 0.0f);
      }
      if (lane == 0) s_count = n_seeds + __popc(sel);
    }
    __syncthreads();
    n_seeds = s_count;
  }

  // 3. group: keys (owner, index), a member-less candidate (-1) last
  for (int p = tid; p < n_rem; p += kThreads) {
    const uint32_t owner = static_cast<uint32_t>(s_owner[p]);
    keys[p] = (static_cast<unsigned long long>(owner) << 32) | static_cast<uint32_t>(keys[p]);
  }
  __syncthreads();
  for (int k = tid; k < n_seeds; k += kThreads) {
    s_owner[k] = 0;
    s_end[k] = 0;
  }
  sort_keys<kThreads>(keys, n_pad, tid);
  for (int p = tid; p < n_rem; p += kThreads) {
    const uint32_t owner = static_cast<uint32_t>(keys[p] >> 32);
    if (owner == 0xffffffffu) continue;
    if (p == 0 || static_cast<uint32_t>(keys[p - 1] >> 32) != owner) s_owner[owner] = p;
    if (p + 1 == n_rem || static_cast<uint32_t>(keys[p + 1] >> 32) != owner) s_end[owner] = p + 1;
  }
  __syncthreads();

  // 4. and 5. each seed's sums in index order, its score, and its row
  int count = 0;
  for (int t0 = 0; t0 < n_seeds; t0 += kThreads) {
    const int k = t0 + tid;
    bool emit = false;
    float sum[kSums], score = 0.0f;
    if (k < n_seeds) {
      float sb[kFields];
      seed_box(k, sb);
#pragma unroll
      for (int q = 0; q < kSums; ++q) sum[q] = 0.0f;
      for (int p = s_owner[k]; p < s_end[k]; ++p) {
        const int j = static_cast<int>(static_cast<uint32_t>(keys[p]));
        float bj[kFields];
        load_box(j, bj);
        const float msw = box_iou(sb, bj) * weights[j];
        const float ms = msw * scores[j];
        sum[0] += 1.0f;
        sum[1] += n_exp[j];
        sum[2] += msw;
        sum[3] += ms;
#pragma unroll
        for (int d = 0; d < 6; ++d) sum[4 + d] += bj[d] * ms;
      }
      const float n_found = sum[0];
      const float n_expected = sum[1] / max_nan(n_found, 1.0f);
      const float n_missing = max_nan(n_expected - n_found, 0.0f);
      const float msw_mean = sum[2] / max_nan(n_found, 1.0f);
      const float denom = sum[2] + (n_missing * msw_mean) * missing_weight;
      score = sum[3] / max_nan(denom, 1e-12f);
      emit = score > score_thr;
    }
    const uint32_t votes = __ballot_sync(kAllLanes, emit);
    if (lane == 0) s_warp[warp] = __popc(votes);
    __syncthreads();
    int row = count + __popc(votes & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      const int cw = s_warp[w];
      count += cw;
      if (w < warp) row += cw;
    }
    if (emit) {
      const float ms_sum = max_nan(sum[3], 1e-12f);
#pragma unroll
      for (int d = 0; d < 6; ++d) ob[static_cast<size_t>(row) * 6 + d] = sum[4 + d] / ms_sum;
      os[row] = score;
      ov[row] = 1;
    }
    __syncthreads();  // s_warp is written again by the next tile
  }
  for (long long i = 6LL * count + tid; i < 6LL * n; i += kThreads) ob[i] = 0.0f;
  for (int i = count + tid; i < n; i += kThreads) {
    os[i] = 0.0f;
    ov[i] = 0;
  }
}

}  // namespace

// boxes [N, 6], scores, weights, n_exp [N] float32, labels [N] int32, valid
// [N] uint8; out_boxes [C, N, 6], out_scores [C, N] float32, out_valid
// [C, N] uint8; all contiguous on device `device`. n_pad the power of two
// >= max(N, kSeg) the sorts run over. The scratch of a class is 8 * n_pad +
// kBoxBytes * N bytes: in shared memory behind the header when ws is null
// (smem >= 4 * kHeaderWords + that), else in ws, C slices of ws_words >= its
// size in 8-byte words, an even number (smem >= 4 * kHeaderWords). Launches
// one block per class on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments out of range); the caller's current
// device is restored.
extern "C" int wbc_cluster_launch(const void* boxes, const void* scores, const void* weights,
                                  const void* n_exp, const void* labels, const void* valid,
                                  int n, int n_pad, int num_classes, float iou_thr,
                                  float score_thr, float missing_weight, void* ws,
                                  long long ws_words, int smem, void* out_boxes,
                                  void* out_scores, void* out_valid, void* stream, int device) {
  const long long scratch = 8LL * n_pad + static_cast<long long>(kBoxBytes) * n;
  const long long need = 4LL * kHeaderWords + (ws ? 0 : scratch);
  if (n < 1 || n_pad < n || n_pad < kSeg || (n_pad & (n_pad - 1)) || num_classes < 1 ||
      smem < need || (ws && (8 * ws_words < scratch || ws_words % 2))) {
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
    err = cudaFuncSetAttribute(wbc_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) set_bytes[device] = smem;
  }
  if (err == cudaSuccess) {
    wbc_cluster_kernel<<<num_classes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const float*>(weights), static_cast<const float*>(n_exp),
        static_cast<const int32_t*>(labels), static_cast<const uint8_t*>(valid), n, n_pad,
        iou_thr, score_thr, missing_weight, static_cast<unsigned long long*>(ws), ws_words,
        static_cast<float*>(out_boxes), static_cast<float*>(out_scores),
        static_cast<uint8_t*>(out_valid));
    err = cudaGetLastError();
  }
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}

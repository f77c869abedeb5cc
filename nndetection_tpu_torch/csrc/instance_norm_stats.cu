// Instance-norm statistics in one launch, for Hopper (sm_90a).
//
// Replaces: nndetection_tpu/ops/pallas_norm.py::_stats_kernel (called by
// _stats), the per-(b, c) mean and biased variance of a channel-last map
// x [B, D, Q, C] over the depth planes start, start + step, ... and all Q
// in-plane positions; step = 1 gives the exact statistics of
// fused_instance_norm, a stride the JAX package's plane_sub estimator.
//
// What bounds it on the H100: memory bandwidth at the large stages (the
// selected planes are read once, a few flops per element) and the launch at
// the small ones (stages 3-5 read well under a megabyte). The design:
// * one launch per call. Blocks of the grid (splits, channel blocks, B) take
//   a range of selected rows of one (b, channel block); the caller's plan
//   (ops/instance_norm.py::plan_in_stats) sizes the splits to fill the card
//   once. A selected plane is one contiguous run of Q * C elements, so a
//   block divides once per plane it enters, never per element;
// * 16-byte loads (8 bf16/f16 or 4 float32 channels per thread) where C and
//   the pointer allow, one element per thread otherwise; kUnroll rows per
//   thread in flight (8 measured no faster on the H100);
// * per-thread (count, mean, M2) in registers, Chan-combined tile by tile
//   (the count is the same for every channel of a thread, so one division
//   per tile), then over the block's rows in a fixed order: xor shuffles
//   inside a warp, then the eight warps' results in order by one warp; the
//   block writes its partial;
// * the block that arrives last for its (b, channel block) (an atomicAdd on
//   an arrival counter after __threadfence) combines every split's partial
//   with Chan's formula, writes mean and var and resets the counter to zero
//   for the next call. The combine loads every partial at once (each thread
//   holds up to kHold splits in registers: one round trip to L2; a Chan
//   merge per split, with its division, measured slower) and sums them in a
//   fixed order (thread groups over strided splits, then the groups in
//   order), whichever block arrives last: two runs give the same bits. No
//   float atomics.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;    // rows per thread per tile, loads in flight
constexpr int kMaxCB = 64;    // channels per block at most
constexpr int kHold = 24;     // partials per thread the combine holds in registers
constexpr int kBlocksPerSm = 2;  // resident blocks per SM: the plan's grid is one wave

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float from_bits16(uint32_t h, int dt) {
  return dt == kBF16 ? __uint_as_float(h << 16)
                     : __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
}

// V consecutive elements at p, as float32
template <int kDT, int V>
__device__ __forceinline__ void load(const char* p, float* f) {
  if constexpr (V == 1) {
    if constexpr (kDT == kF32) {
      f[0] = __ldg(reinterpret_cast<const float*>(p));
    } else {
      f[0] = from_bits16(__ldg(reinterpret_cast<const unsigned short*>(p)), kDT);
    }
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kDT == kF32) {
        f[i] = __uint_as_float(w[i]);
      } else {
        f[2 * i] = from_bits16(w[i] & 0xffffu, kDT);
        f[2 * i + 1] = from_bits16(w[i] >> 16, kDT);
      }
    }
  }
}

// Chan's update of the running (n, mean[V], M2[V]) by a part (nb, mb, m2b)
template <int V>
__device__ __forceinline__ void chan_merge(float& n, float* mean, float* m2, float nb,
                                           const float* mb, const float* m2b) {
  if (nb > 0.0f) {
    const float tot = n + nb;
    const float f = nb / tot;
    const float g = n * f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float delta = mb[e] - mean[e];
      mean[e] += delta * f;
      m2[e] += m2b[e] + delta * delta * g;
    }
    n = tot;
  }
}

template <int kDT, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
in_stats_kernel(const char* __restrict__ x, int D, int Q, int C, int start, int step,
                int cb, int n_rows, int rows_per_split,
                float* __restrict__ part_mean,   // [B * n_cb, splits, cb]
                float* __restrict__ part_m2,     // [B * n_cb, splits, cb]
                unsigned int* __restrict__ counters,  // [B * n_cb]
                float* __restrict__ out_mean,    // [B, C]
                float* __restrict__ out_var) {   // [B, C]
  constexpr int kBytes = kDT == kF32 ? 4 : 2;
  __shared__ float s_n[kThreads];
  __shared__ float s_mean[V][kThreads];
  __shared__ float s_m2[V][kThreads];
  __shared__ unsigned int s_last;

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int cbi = blockIdx.y, n_cb = gridDim.y;
  const int b = blockIdx.z;
  const int bc = b * n_cb + cbi;
  const int c0 = cbi * cb;
  const int t = threadIdx.x;

  // nv threads (a power of two) cover the block's channels, V each; R rows
  // of the plane are read side by side
  const int nvec = (cb + V - 1) / V;
  int nv = 1;
  while (nv < nvec) nv <<= 1;
  const int R = kThreads / nv;
  const int v = t & (nv - 1);
  const int rl = t / nv;
  const int ch = c0 + v * V;
  const bool active = v < nvec && ch < C;

  float n = 0.0f, mean[V], m2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) mean[e] = m2[e] = 0.0f;

  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, n_rows);
  const char* xb = x + static_cast<size_t>(b) * D * Q * C * kBytes;
  const size_t row_bytes = static_cast<size_t>(C) * kBytes;
  for (int r = r_begin; r < r_end;) {
    // one selected plane at a time: rows q0..q1 of plane start + p * step
    const int p = r / Q;
    const int q0 = r - p * Q;
    const int q1 = min(Q, q0 + (r_end - r));
    const char* plane = xb + static_cast<size_t>(start + p * step) * Q * row_bytes +
                        static_cast<size_t>(ch) * kBytes;
    for (int qb = q0; qb < q1; qb += R * kUnroll) {
      float xv[kUnroll][V];
      bool ok[kUnroll];
      float nb = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = qb + u * R + rl;
        ok[u] = active && q < q1;
        if (ok[u]) {
          load<kDT, V>(plane + static_cast<size_t>(q) * row_bytes, xv[u]);
          nb += 1.0f;
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) xv[u][e] = 0.0f;
        }
      }
      if (nb > 0.0f) {
        // the tile's own mean and M2, then Chan's update of the running ones
        const float inv_nb = 1.0f / nb;
        float mb[V], m2b[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float sum = 0.0f;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) sum += xv[u][e];
          mb[e] = sum * inv_nb;
          m2b[e] = 0.0f;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float dv = ok[u] ? xv[u][e] - mb[e] : 0.0f;
            m2b[e] += dv * dv;
          }
        }
        chan_merge<V>(n, mean, m2, nb, mb, m2b);
      }
    }
    r += q1 - q0;
  }

  // the block's rows, combined in a fixed order: the row lanes of a warp by
  // xor shuffles, then the warps' results (rows, where a warp holds one) in
  // order by the threads of row lane 0
  for (int off = 16; off >= nv; off >>= 1) {
    float mb[V], m2b[V];
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      mb[e] = __shfl_xor_sync(0xffffffffu, mean[e], off);
      m2b[e] = __shfl_xor_sync(0xffffffffu, m2[e], off);
    }
    chan_merge<V>(n, mean, m2, nb, mb, m2b);
  }
  const int rpw = nv < 32 ? 32 / nv : 1;  // row lanes per warp
  if (rl % rpw == 0) {
    const int i = (rl / rpw) * nv + v;
    s_n[i] = n;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s_mean[e][i] = mean[e];
      s_m2[e][i] = m2[e];
    }
  }
  __syncthreads();
  if (rl == 0) {
    for (int g = 1; g < R / rpw; ++g) {
      const int i = g * nv + v;
      float mb[V], m2b[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        mb[e] = s_mean[e][i];
        m2b[e] = s_m2[e][i];
      }
      chan_merge<V>(n, mean, m2, s_n[i], mb, m2b);
    }
  }
  if (rl == 0 && active) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const size_t i = (static_cast<size_t>(bc) * n_splits + split) * cb + v * V + e;
      part_mean[i] = mean[e];
      part_m2[i] = m2[e];
    }
  }

  // arrival: the last block of this (b, channel block) goes on to combine
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&counters[bc], 1u) == static_cast<unsigned int>(n_splits - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // combine: G groups of cbp threads; group g takes splits g, g + G, ...
  // (at most kHold: the plan keeps n_splits <= kHold * G), all loaded at
  // once and held; mean = sum(n_s m_s) / N, then M2 = sum(M2_s + n_s (m_s -
  // mean)^2), each summed in split order within a group, then over the
  // groups in order
  int cbp = 1;
  while (cbp < cb) cbp <<= 1;
  const int G = kThreads / cbp;
  const int cc = t & (cbp - 1);
  const int grp = t / cbp;
  const bool on = cc < cb && c0 + cc < C;
  const float* pm = part_mean + static_cast<size_t>(bc) * n_splits * cb + cc;
  const float* pv = part_m2 + static_cast<size_t>(bc) * n_splits * cb + cc;
  auto rows_of = [&](int u) {
    const int sp = grp + u * G;
    return sp < n_splits ? static_cast<float>(min(rows_per_split, n_rows - sp * rows_per_split))
                         : 0.0f;
  };
  float m[kHold], q[kHold];
#pragma unroll
  for (int u = 0; u < kHold; ++u) {
    const int sp = grp + u * G;
    const bool ok = on && sp < n_splits;
    m[u] = ok ? __ldcg(pm + static_cast<size_t>(sp) * cb) : 0.0f;
    q[u] = ok ? __ldcg(pv + static_cast<size_t>(sp) * cb) : 0.0f;
  }
  const float inv_rows = 1.0f / static_cast<float>(n_rows);
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < kHold; ++u) acc += m[u] * (rows_of(u) * inv_rows);
  float* s_acc = s_n;  // the tree is done with it
  s_acc[t] = acc;
  __syncthreads();
  float gmean = 0.0f;
  for (int k = 0; k < G; ++k) gmean += s_acc[k * cbp + cc];
  __syncthreads();
  acc = 0.0f;
#pragma unroll
  for (int u = 0; u < kHold; ++u) {
    const float d = m[u] - gmean;
    acc += q[u] + rows_of(u) * d * d;
  }
  s_acc[t] = acc;
  __syncthreads();
  if (grp == 0 && on) {
    float m2sum = 0.0f;
    for (int k = 0; k < G; ++k) m2sum += s_acc[k * cbp + cc];
    out_mean[static_cast<size_t>(b) * C + c0 + cc] = gmean;
    out_var[static_cast<size_t>(b) * C + c0 + cc] = m2sum * inv_rows;
  }
  if (t == 0) counters[bc] = 0u;
}

template <int kDT, int V>
cudaError_t launch(const void* x, int B, int D, int Q, int C, int start, int step, int n_rows,
                   int cb, int n_cb, int splits, int rows_per_split, float* part,
                   unsigned int* counters, float* mean, float* var, cudaStream_t stream) {
  const dim3 grid(splits, n_cb, B);
  float* part_m2 = part + static_cast<size_t>(B) * n_cb * splits * cb;
  in_stats_kernel<kDT, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(x), D, Q, C, start, step, cb, n_rows, rows_per_split, part,
      part_m2, counters, mean, var);
  return cudaGetLastError();
}

}  // namespace

// x [B, D, Q, C] contiguous, dtype 0 float32, 1 bfloat16, 2 float16;
// plan = {B, D, Q, C, start, step, n_rows, cb, n_cb, splits, rows_per_split}:
// channel blocks of cb (<= 64) channels, n_cb = ceil(C / cb) of them,
// `splits` row ranges of rows_per_split of the n_rows selected rows; part
// holds 2 * B * n_cb * splits * cb floats (splits <= kHold * kThreads / cb,
// cb rounded up to a power of two), counters B * n_cb zeros (left at
// zero); out [2, B, C] float32 (mean, then var). All on device `device`.
// Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments out of range); the caller's current
// device is restored.
extern "C" int in_stats_launch(const void* x, int dtype, const int* plan, void* part,
                               void* counters, void* out, void* stream, int device) {
  const int B = plan[0], D = plan[1], Q = plan[2], C = plan[3], start = plan[4], step = plan[5];
  const int n_rows = plan[6], cb = plan[7], n_cb = plan[8], splits = plan[9];
  const int rows_per_split = plan[10];
  if (dtype < kF32 || dtype > kF16 || cb < 1 || cb > kMaxCB || n_cb < 1 || n_cb > 65535 ||
      B < 1 || B > 65535 || splits < 1 || n_rows < 1 || rows_per_split < 1 || Q < 1 ||
      static_cast<long long>(splits) * rows_per_split < n_rows ||
      static_cast<long long>(n_cb) * cb < C ||
      start + static_cast<long long>((n_rows - 1) / Q) * step >= D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cbp = 1;  // the combine's thread groups hold kHold splits each
  while (cbp < cb) cbp <<= 1;
  if (splits > kHold * (kThreads / cbp)) return static_cast<int>(cudaErrorInvalidValue);
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* s = static_cast<cudaStream_t>(stream);
  auto* pt = static_cast<float*>(part);
  auto* ct = static_cast<unsigned int*>(counters);
  auto* mn = static_cast<float*>(out);
  float* vr = mn + static_cast<size_t>(B) * C;
  const int v = dtype == kF32 ? 4 : 8;
  const bool vec = C % v == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define IN_STATS_ARGS x, B, D, Q, C, start, step, n_rows, cb, n_cb, splits, rows_per_split, pt, ct, mn, vr, s
  if (dtype == kF32) {
    err = vec ? launch<kF32, 4>(IN_STATS_ARGS) : launch<kF32, 1>(IN_STATS_ARGS);
  } else if (dtype == kBF16) {
    err = vec ? launch<kBF16, 8>(IN_STATS_ARGS) : launch<kBF16, 1>(IN_STATS_ARGS);
  } else {
    err = vec ? launch<kF16, 8>(IN_STATS_ARGS) : launch<kF16, 1>(IN_STATS_ARGS);
  }
#undef IN_STATS_ARGS
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(err);
}

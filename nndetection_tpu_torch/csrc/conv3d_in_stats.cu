// 3x3x3 convolution (stride 1, SAME, NDHWC, bf16 in and out, f32
// accumulation) with the per-(b, c) instance-norm statistics of its rounded
// output, for Hopper (sm_90a).
//
// Replaces: nndetection_tpu/ops/pallas_conv.py::_kernel (called by
// _conv3d_in_stats_fwd_impl), the JAX package's fused conv of the
// NNDET_CONV_FUSED=1 configuration. Same function: y = conv3d(x, w) rounded
// once to bf16, and the mean and biased variance (clamped at 0) of the
// rounded y over all D*H*W voxels of each (b, c). The TPU kernel walks the
// depth blocks of one batch item in grid order and carries shifted running
// sums from step to step; blocks on the card run in parallel, so each block
// writes the Chan partials (mean, M2) of its own voxel tile and a second
// launch combines them in a fixed order: no float atomics, two runs give the
// same bits.
//
// What bounds it on the H100: arithmetic above Ci ~ 32, memory at the stem.
// The convolution is one implicit GEMM, M = B*D*H*W voxels, N = Co,
// K = 27*Ci, 2*27*Ci*Co flops per voxel. At Ci = Co = 32 a voxel does 55,296
// flops against 128 bytes of x read and y written once: 432 flops/byte,
// above the card's ~295, so the tensor cores bound it, provided the 27-fold
// reuse of every input byte stays on chip (the tiles below). The stem
// (Ci = 1, Co = 32) does 1,728 flops per 66 bytes, 26 flops/byte: memory
// bounds it, and y's write is most of that.
//
// Design (simple first; TMA, wgmma and a persistent schedule are later
// work): a block owns a tile of BM voxels of one batch item x BN output
// channels, 128 x 64 when Co is a multiple of 64 and 256 x 32 otherwise, so
// that each of the eight warps computes a 32 x 32 sub-tile either way, and
// walks K in steps of BK = 32. K is packed across taps and channels
// (k = tap * Ci + ci, zero-padded to a multiple of 32), so the stem's
// K = 27 fills one step instead of wasting 15/16 of each MMA. The
// A tile is gathered on the fly (im2col) from x with the halo zero-filled at
// the volume's borders: 16-byte cp.async copies when Ci % 8 == 0 (8 channels
// of one tap), scalar loads otherwise (the stem); A and B tiles are double
// buffered in shared memory, so the next step's copies overlap this step's
// MMAs. Eight warps run bf16 wmma 16x16x16 with f32 accumulators. The
// epilogue stages the f32 tile in shared memory, rounds it to bf16, stores y
// (NDHWC: the port's channels_last_3d memory, no copy) and computes the
// tile's per-channel mean and M2 of the rounded values, two-pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BK = 32;        // K per step
constexpr int CO_ALIGN = 64;  // packed weights: Co padded to a multiple of this
constexpr int kThreads = 256;
constexpr int LDA = BK + 8;   // bf16 row pitch of the A tile (80 B)

// voxels per tile for Co: 128 with 64-channel tiles, 256 with 32-channel ones
inline int tile_m(int co) { return co % 64 == 0 ? 128 : 256; }

template <int BM, int BN>
struct Smem {
  static constexpr int LDB = BN + 8;  // bf16 row pitch of the B tile
  static constexpr int LDC = BN + 4;  // f32 row pitch of the staged output
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int PIPE_BYTES = 2 * (A_ELEMS + B_ELEMS) * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// the voxel of row r of this block's tile: its (d, h, w) and whether it exists
struct Voxel {
  int d, h, w;
  bool ok;
};

__device__ __forceinline__ Voxel voxel_of(int m, int M, int H, int W) {
  Voxel v;
  v.ok = m < M;
  const int mm = v.ok ? m : 0;
  v.w = mm % W;
  v.h = (mm / W) % H;
  v.d = mm / (W * H);
  return v;
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv3d_in_stats_kernel(const __nv_bfloat16* __restrict__ x,   // [B, D, H, W, Ci]
                       const __nv_bfloat16* __restrict__ wpk, // [K_pad, Co_pad]
                       __nv_bfloat16* __restrict__ y,         // [B, D, H, W, Co]
                       float* __restrict__ part_mean,         // [B, m_tiles, Co]
                       float* __restrict__ part_m2,           // [B, m_tiles, Co]
                       int D, int H, int W, int Ci, int Co, int K, int K_pad, int Co_pad) {
  using S = Smem<BM, BN>;
  constexpr int WARPS_N = BN / 32, WARPS_M = BM / 32;  // 8 warps of 32 x 32
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "eight warps");
  constexpr int FM = 2, FN = 2;
  constexpr int A_PASSES = BM / 64;  // 16-byte A chunks per thread and step
  __shared__ __align__(128) unsigned char smem_raw[S::BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BM][LDA]
  __nv_bfloat16* Bs = As + 2 * S::A_ELEMS;                         // [2][BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem_raw);                  // [BM][LDC], after the K loop

  const int n0 = blockIdx.x * BN;
  const int mt = blockIdx.y;
  const int b = blockIdx.z;
  const int m_tiles = gridDim.y;
  const int M = D * H * W;
  const int m0 = mt * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const __nv_bfloat16* xb = x + static_cast<int64_t>(b) * M * Ci;

  // A-tile copy assignment (vector path): BM * 4 chunks of 8 channels,
  // A_PASSES per thread, rows r, r + 64, ..., the same 8-wide K slot in
  // every step
  const int a_kc = tid & 3;
  const int a_r0 = tid >> 2;
  Voxel av[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) av[i] = voxel_of(m0 + a_r0 + 64 * i, M, H, W);
  // the scalar path's row (BM <= kThreads)
  const Voxel sv = voxel_of(m0 + tid, tid < BM ? M : 0, H, W);

  auto load_tile = [&](int kt, int buf) {
    __nv_bfloat16* as = As + buf * S::A_ELEMS;
    __nv_bfloat16* bs = Bs + buf * S::B_ELEMS;
    if constexpr (VEC) {
      const int k0 = kt * BK + a_kc * 8;
      const bool k_ok = k0 < K;
      const int tap = k_ok ? k0 / Ci : 0;
      const int ci = k0 - tap * Ci;
      const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) {
        const int dd = av[i].d + dz, hh = av[i].h + dy, ww = av[i].w + dx;
        const bool ok = k_ok && av[i].ok && dd >= 0 && dd < D && hh >= 0 && hh < H &&
                        ww >= 0 && ww < W;
        const __nv_bfloat16* src =
            ok ? xb + ((static_cast<int64_t>(dd) * H + hh) * W + ww) * Ci + ci : xb;
        cp_async16(as + (a_r0 + 64 * i) * LDA + a_kc * 8, src, ok);
      }
    } else {
      // scalar gather (Ci % 8 != 0, the stem): one row per thread, its
      // voxel decoded once per tile, its BK slots in order; neighbouring
      // threads read neighbouring voxels
      if (tid < BM) {
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          const int k = kt * BK + kk;
          __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
          if (k < K && sv.ok) {
            const int tap = k / Ci, ci = k - tap * Ci;
            const int dd = sv.d + tap / 9 - 1, hh = sv.h + (tap / 3) % 3 - 1;
            const int ww = sv.w + tap % 3 - 1;
            if (dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W)
              v = xb[((static_cast<int64_t>(dd) * H + hh) * W + ww) * Ci + ci];
          }
          as[tid * LDA + kk] = v;
        }
      }
    }
    // B tile: BK rows x BN channels of the packed weights, always in bounds
    constexpr int B_CHUNKS = BK * BN / 8;
    for (int c = tid; c < B_CHUNKS; c += kThreads) {
      const int kr = c / (BN / 8), nc = c % (BN / 8);
      cp_async16(bs + kr * S::LDB + nc * 8,
                 wpk + static_cast<int64_t>(kt * BK + kr) * Co_pad + n0 + nc * 8, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_k = K_pad / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait1();   // this step's group has landed
    __syncthreads();
    const __nv_bfloat16* as = As + (kt & 1) * S::A_ELEMS;
    const __nv_bfloat16* bs = Bs + (kt & 1) * S::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * FM * 16 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * S::LDB + wn * FN * 16 + j * 16, S::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled in the next step
  }

  // ---- epilogue: stage, round to bf16, store y, tile statistics ----------
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * S::LDC + wn * FN * 16 + j * 16,
                              acc[i][j], S::LDC, wmma::mem_row_major);
  __syncthreads();

  const int rows = min(BM, M - m0);
  __nv_bfloat16* yb = y + (static_cast<int64_t>(b) * M + m0) * Co;
  // pairs of channels: BN / 2 per row
  for (int e = tid; e < BM * (BN / 2); e += kThreads) {
    const int r = e / (BN / 2), c = 2 * (e % (BN / 2));
    float* cp = Cs + r * S::LDC + c;
    const __nv_bfloat162 v = __floats2bfloat162_rn(cp[0], cp[1]);
    cp[0] = __low2float(v);
    cp[1] = __high2float(v);
    if (r < rows && n0 + c < Co)  // Co is even
      *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<int64_t>(r) * Co + n0 + c) = v;
  }
  __syncthreads();

  // per-channel mean and M2 of the tile's rounded values, over its valid
  // rows: GROUPS threads per channel, each over BM / GROUPS rows, then the
  // groups in a fixed order
  constexpr int GROUPS = kThreads / BN;
  constexpr int ROWS_PER = BM / GROUPS;
  __shared__ float red[kThreads];
  __shared__ float tile_mean[BN];
  const int col = tid % BN, grp = tid / BN;
  float s = 0.0f;
  for (int r = grp * ROWS_PER; r < (grp + 1) * ROWS_PER && r < rows; ++r)
    s += Cs[r * S::LDC + col];
  red[tid] = s;
  __syncthreads();
  if (grp == 0) {
    float t = 0.0f;
    for (int g = 0; g < GROUPS; ++g) t += red[g * BN + col];
    tile_mean[col] = t / static_cast<float>(rows);
  }
  __syncthreads();
  const float mu = tile_mean[col];
  float q = 0.0f;
  for (int r = grp * ROWS_PER; r < (grp + 1) * ROWS_PER && r < rows; ++r) {
    const float dv = Cs[r * S::LDC + col] - mu;
    q += dv * dv;
  }
  __syncthreads();  // every thread has read red[] of the first pass
  red[tid] = q;
  __syncthreads();
  if (grp == 0 && n0 + col < Co) {
    float t = 0.0f;
    for (int g = 0; g < GROUPS; ++g) t += red[g * BN + col];
    const int64_t o = (static_cast<int64_t>(b) * m_tiles + mt) * Co + n0 + col;
    part_mean[o] = mu;
    part_m2[o] = t;
  }
}

// Chan's parallel combine of the [m_tiles] partials of 32 channels of one
// batch item, in a fixed order: lane = channel (coalesced), warp w takes
// tiles w, w + 32, ...; then the 32 warps' sums in order.
// mean = sum(n_s m_s) / M; M2 = sum(M2_s + n_s (m_s - mean)^2).
constexpr int kCombineThreads = 1024;

__global__ void __launch_bounds__(kCombineThreads)
conv3d_in_stats_combine_kernel(const float* __restrict__ part_mean,
                               const float* __restrict__ part_m2, float* __restrict__ mean,
                               float* __restrict__ var, int m_tiles, int M, int Co, int BM) {
  __shared__ float red[32][33];
  __shared__ float s_mean[32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  const bool c_ok = c < Co;
  const float* pm = part_mean + static_cast<int64_t>(b) * m_tiles * Co;
  const float* p2 = part_m2 + static_cast<int64_t>(b) * m_tiles * Co;

  float s = 0.0f;
  if (c_ok)
    for (int t = warp; t < m_tiles; t += 32)
      s += static_cast<float>(min(BM, M - t * BM)) * pm[static_cast<int64_t>(t) * Co + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float tot = 0.0f;
    for (int w = 0; w < 32; ++w) tot += red[w][lane];
    s_mean[lane] = tot / static_cast<float>(M);
  }
  __syncthreads();
  const float mu = s_mean[lane];
  float q = 0.0f;
  if (c_ok)
    for (int t = warp; t < m_tiles; t += 32) {
      const int64_t o = static_cast<int64_t>(t) * Co + c;
      const float dv = pm[o] - mu;
      q += p2[o] + static_cast<float>(min(BM, M - t * BM)) * dv * dv;
    }
  __syncthreads();
  red[warp][lane] = q;
  __syncthreads();
  if (warp == 0 && c_ok) {
    float tot = 0.0f;
    for (int w = 0; w < 32; ++w) tot += red[w][lane];
    mean[b * Co + c] = mu;
    var[b * Co + c] = fmaxf(tot / static_cast<float>(M), 0.0f);
  }
}

template <int BM, int BN, bool VEC>
void launch_conv(dim3 grid, cudaStream_t st, const void* x, const void* wpk, void* y, float* pm,
                 float* p2, int D, int H, int W, int Ci, int Co, int K, int K_pad, int Co_pad) {
  conv3d_in_stats_kernel<BM, BN, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wpk),
      static_cast<__nv_bfloat16*>(y), pm, p2, D, H, W, Ci, Co, K, K_pad, Co_pad);
}

}  // namespace

// Tile sizes the caller needs to allocate the partials and pack the
// weights: which 0 -> voxels per tile for `co` output channels, 1 -> BK (K
// padding), 2 -> Co padding of the packed weights.
extern "C" int conv3d_in_stats_tile(int which, int co) {
  return which == 0 ? tile_m(co) : which == 1 ? BK : CO_ALIGN;
}

// x [B, D, H, W, Ci] bf16; wpk [K_pad, Co_pad] bf16 with row k = tap * Ci + ci
// (tap = (dz * 3 + dy) * 3 + dx), zero beyond K = 27 * Ci and beyond Co;
// y [B, D, H, W, Co] bf16; part_mean, part_m2 [B, ceil(D*H*W / BM), Co] f32
// scratch, BM = conv3d_in_stats_tile(0, Co); mean, var [B, Co] f32. All
// contiguous on the device. Launches the conv and the combine on `stream`
// and returns cudaGetLastError().
extern "C" int conv3d_in_stats_launch(const void* x, const void* wpk, int B, int D, int H, int W,
                                      int Ci, int Co, int K_pad, int Co_pad, void* y,
                                      void* part_mean, void* part_m2, void* mean, void* var,
                                      void* stream) {
  const int K = 27 * Ci;
  const int M = D * H * W;
  if (B < 1 || M < 1 || Ci < 1 || Co < 2 || Co % 2 || K_pad != (K + BK - 1) / BK * BK ||
      Co_pad != (Co + CO_ALIGN - 1) / CO_ALIGN * CO_ALIGN || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int BM = tile_m(Co);
  const int m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_mean);
  float* p2 = static_cast<float*>(part_m2);
  const bool vec = Ci % 8 == 0;
  if (BM == 128) {
    const dim3 grid(Co / 64, m_tiles, B);
    if (vec)
      launch_conv<128, 64, true>(grid, st, x, wpk, y, pm, p2, D, H, W, Ci, Co, K, K_pad, Co_pad);
    else
      launch_conv<128, 64, false>(grid, st, x, wpk, y, pm, p2, D, H, W, Ci, Co, K, K_pad, Co_pad);
  } else {
    const dim3 grid((Co + 31) / 32, m_tiles, B);
    if (vec)
      launch_conv<256, 32, true>(grid, st, x, wpk, y, pm, p2, D, H, W, Ci, Co, K, K_pad, Co_pad);
    else
      launch_conv<256, 32, false>(grid, st, x, wpk, y, pm, p2, D, H, W, Ci, Co, K, K_pad, Co_pad);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3d_in_stats_combine_kernel<<<dim3(B, (Co + 31) / 32), kCombineThreads, 0, st>>>(
      pm, p2, static_cast<float*>(mean), static_cast<float*>(var), m_tiles, M, Co, BM);
  return static_cast<int>(cudaGetLastError());
}

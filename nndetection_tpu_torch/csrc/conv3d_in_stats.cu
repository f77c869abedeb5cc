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
// reuse of every input byte stays on chip. The stem (Ci = 1, Co = 32) does
// 1,728 flops per 66 bytes, 26 flops/byte: memory bounds it, and y's write
// is most of that.
//
// Every route: a block owns a tile of BM voxels of one batch item x BN
// output channels, 128 x 64 when Co is a multiple of 64 and 256 x 32
// otherwise, so that each of the eight warps computes a 32 x 32 sub-tile with
// bf16 wmma 16x16x16 and f32 accumulators, and walks K in steps of BK = 32
// (k = tap * Ci + ci, zero-padded to a multiple of 32). Fragments are loaded
// with wmma.load.*.shared (load_frag_a/b), which compiles to ldmatrix; the
// API's generic-pointer load_matrix_sync gave four generic 32-bit loads per
// fragment. The weights' B tile (BK x BN) is streamed per step with 16-byte
// cp.async. The epilogue (tile_epilogue) stages the f32 tile in shared
// memory, rounds it to bf16, stores y (NDHWC: the port's channels_last_3d
// memory) and writes the tile's per-channel mean and M2 of the rounded
// values, two-pass. The caller's plan (ops/conv_in_stats.py::plan_conv)
// picks one of three routes; this file trusts it and checks it for range.
//
// * brick (Ci % 32 == 0, W % 16 == 0, a grid of at least one block per SM):
//   the tile is a brick of Td x Th x 16 voxels whose rows are runs of 16
//   consecutive w, the bricks dividing the volume (so each tile holds BM
//   voxels, as the combine counts). Per 32-channel chunk of Ci the block
//   copies the halo brick, (Td+2) x (Th+2) x 18 voxels, into shared memory
//   once and runs all 27 taps from it: the A fragment of a tap is the brick
//   shifted by the tap, read in place with a row pitch of one voxel (no
//   im2col). Every input byte crosses to the SM (Td+2)(Th+2)*18 / (Td*Th*16)
//   times (2.5 for 4 x 4 x 16) instead of 27. The voxel pitch is 40 bf16
//   (80 B): the rows of an ldmatrix phase fall in distinct banks, and every
//   shift keeps them 16-byte aligned. The weights stream through a ring:
//   one tap per step four buffers deep for 32-channel tiles, three taps per
//   step two deep for 64-channel ones (the faster of the two at each stage
//   of the LUNA plan on the H100). The next chunk's brick arrives in pieces
//   during this chunk's steps, in the same cp.async groups as the weights,
//   so the waits stay in step; one brick buffer when Ci = 32 (three blocks
//   then share an SM), two otherwise. Bounded by the MMA issue and the
//   fragment loads of the 32 x 32 warp tiles, not by bytes.
// * split_k (an im2col grid under one block per SM, Ci % 8 == 0: the deep
//   stages): the im2col kernel takes a range of K steps per split, one grid
//   dimension wider, and stores its f32 tile into a workspace
//   [S, B, M_pad, N_pad]; a finish kernel sums the S partials in split
//   order, then runs the shared epilogue. Bounded by the latency of the K
//   loop, which split-K divides, and at these sizes by the launches.
// * im2col (everything else: the stem, small Ci): the A tile is gathered
//   from x per K step with the halo zero-filled, 16-byte cp.async when
//   Ci % 8 == 0, scalar loads otherwise; the stem's K = 27 fills one step.
//   A and B tiles are double buffered.
//
// wmma stays (no mma.sync with larger warp tiles and a swizzled layout, no
// wgmma + TMA, no persistent schedule): those are the next levers, each a
// rewrite of the fragment path on its own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BK = 32;        // K per step
constexpr int CO_ALIGN = 64;  // packed weights: Co padded to a multiple of this
constexpr int kThreads = 256;
constexpr int LDA = BK + 8;   // bf16 row pitch of the im2col A tile (80 B)
constexpr int BRICK_W = 16;   // a brick's run of consecutive w
constexpr int HALO_W = BRICK_W + 2;
// bf16 per voxel of the halo brick, 32 channels + 8: 80-byte rows put the
// eight rows of an ldmatrix phase in distinct banks, and every tap shift
// keeps the 16-byte row alignment ldmatrix needs
constexpr int PITCH = 40;
constexpr int kMaxSmem = 232448;  // dynamic + static shared memory of one block
constexpr int kStaticSmem = 2048;  // kept for the epilogue's static arrays

enum Route { kIm2col = 0, kSplitK = 1, kBrick = 2 };

// voxels per tile for Co: 128 with 64-channel tiles, 256 with 32-channel ones
inline int tile_m(int co) { return co % 64 == 0 ? 128 : 256; }

// static shared memory of the im2col kernel: A and B tiles double buffered,
// the f32 output tile [BM][BN + 4] overlaying them after the K loop
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

// dynamic shared memory of the brick route: nbuf halo bricks, a ring of
// `stages` weight buffers of `taps` taps each; at least the f32 output tile
inline int brick_smem(int bm, int bn, int td, int th, int nbuf, int taps, int stages) {
  const int pipe =
      nbuf * (td + 2) * (th + 2) * HALO_W * PITCH * 2 + stages * taps * BK * (bn + 8) * 2;
  const int c_tile = bm * (bn + 4) * 4;
  return pipe > c_tile ? pipe : c_tile;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>  // at most N of the latest groups still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// wmma fragments, loaded from shared memory with the .shared state space
// stated: the API's wmma::load_matrix_sync takes a generic pointer, and nvcc
// then loads a bf16 fragment with four generic 32-bit loads (and transposes
// B with four movmatrix); wmma.load.*.shared compiles to one ldmatrix. The
// same instruction and fragment layout, so the same bits.
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

__device__ __forceinline__ void load_frag_a(FragA& f, const __nv_bfloat16* smem, unsigned ldm) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned* r = reinterpret_cast<unsigned*>(&f.x[0]);
  asm volatile("wmma.load.a.sync.aligned.row.m16n16k16.shared.bf16 {%0,%1,%2,%3}, [%4], %5;\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr), "r"(ldm)
               : "memory");
}
__device__ __forceinline__ void load_frag_b(FragB& f, const __nv_bfloat16* smem, unsigned ldm) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned* r = reinterpret_cast<unsigned*>(&f.x[0]);
  asm volatile("wmma.load.b.sync.aligned.row.m16n16k16.shared.bf16 {%0,%1,%2,%3}, [%4], %5;\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr), "r"(ldm)
               : "memory");
}

// B tile of K step kt: BK rows x BN channels of the packed weights from row
// k0, always in bounds
template <int BN>
__device__ __forceinline__ void load_b_tile(__nv_bfloat16* bs, const __nv_bfloat16* wpk, int k0,
                                            int n0, int Co_pad, int tid) {
  constexpr int LDB = BN + 8;
  constexpr int B_CHUNKS = BK * BN / 8;
  for (int c = tid; c < B_CHUNKS; c += kThreads) {
    const int kr = c / (BN / 8), nc = c % (BN / 8);
    cp_async16(bs + kr * LDB + nc * 8, wpk + static_cast<int64_t>(k0 + kr) * Co_pad + n0 + nc * 8,
               true);
  }
}

// The shared epilogue. Cs [BM][BN + 4] holds the tile's f32 sums, every
// thread synchronised. Rounds them to bf16 in place, stores rows r < rows to
// yb + row_voxel(r) * Co + n0 + c, and writes the per-channel mean and M2 of
// the rounded values over those rows to part_mean/part_m2 at part + n0 + c.
template <int BM, int BN, class RowVoxel>
__device__ __forceinline__ void tile_epilogue(float* Cs, int rows, RowVoxel row_voxel,
                                              __nv_bfloat16* yb, int Co, int n0,
                                              float* part_mean, float* part_m2, int64_t part) {
  constexpr int LDC = BN + 4;
  const int tid = threadIdx.x;
  // pairs of channels: BN / 2 per row
  for (int e = tid; e < BM * (BN / 2); e += kThreads) {
    const int r = e / (BN / 2), c = 2 * (e % (BN / 2));
    float* cp = Cs + r * LDC + c;
    const __nv_bfloat162 v = __floats2bfloat162_rn(cp[0], cp[1]);
    cp[0] = __low2float(v);
    cp[1] = __high2float(v);
    if (r < rows && n0 + c < Co)  // Co is even
      *reinterpret_cast<__nv_bfloat162*>(yb + row_voxel(r) * Co + n0 + c) = v;
  }
  __syncthreads();

  // GROUPS threads per channel, each over BM / GROUPS rows, then the groups
  // in a fixed order
  constexpr int GROUPS = kThreads / BN;
  constexpr int ROWS_PER = BM / GROUPS;
  __shared__ float red[kThreads];
  __shared__ float tile_mean[BN];
  const int col = tid % BN, grp = tid / BN;
  float s = 0.0f;
  for (int r = grp * ROWS_PER; r < (grp + 1) * ROWS_PER && r < rows; ++r) s += Cs[r * LDC + col];
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
    const float dv = Cs[r * LDC + col] - mu;
    q += dv * dv;
  }
  __syncthreads();  // every thread has read red[] of the first pass
  red[tid] = q;
  __syncthreads();
  if (grp == 0 && n0 + col < Co) {
    float t = 0.0f;
    for (int g = 0; g < GROUPS; ++g) t += red[g * BN + col];
    part_mean[part + n0 + col] = mu;
    part_m2[part + n0 + col] = t;
  }
}

// ---------------------------------------------------------- im2col, split-K
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

// SPLIT: blockIdx.z = b * splits + split, K steps [split * k_steps, +k_steps)
// of n_k, the f32 tile into ws [splits, B, m_tiles * BM, gridDim.x * BN];
// otherwise all K steps and the epilogue.
template <int BM, int BN, bool VEC, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
conv3d_in_stats_kernel(const __nv_bfloat16* __restrict__ x,   // [B, D, H, W, Ci]
                       const __nv_bfloat16* __restrict__ wpk, // [K_pad, Co_pad]
                       __nv_bfloat16* __restrict__ y,         // [B, D, H, W, Co]
                       float* __restrict__ part_mean,         // [B, m_tiles, Co]
                       float* __restrict__ part_m2,           // [B, m_tiles, Co]
                       float* __restrict__ ws,                // split-K workspace
                       int D, int H, int W, int Ci, int Co, int K, int K_pad, int Co_pad,
                       int splits, int k_steps) {
  constexpr int WARPS_N = BN / 32, WARPS_M = BM / 32;  // 8 warps of 32 x 32
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "eight warps");
  static_assert(!SPLIT || VEC, "split-K takes the vector gather");
  constexpr int FM = 2, FN = 2;
  constexpr int A_PASSES = BM / 64;  // 16-byte A chunks per thread and step
  using S = Smem<BM, BN>;
  constexpr int LDB = S::LDB, LDC = S::LDC, A_ELEMS = S::A_ELEMS, B_ELEMS = S::B_ELEMS;
  __shared__ __align__(128) unsigned char smem_raw[S::BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BM][LDA]
  __nv_bfloat16* Bs = As + 2 * A_ELEMS;                            // [2][BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem_raw);                  // [BM][LDC], after the K loop

  const int n0 = blockIdx.x * BN;
  const int mt = blockIdx.y;
  const int b = SPLIT ? blockIdx.z / splits : blockIdx.z;
  const int split = SPLIT ? blockIdx.z % splits : 0;
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
    __nv_bfloat16* as = As + buf * A_ELEMS;
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
    load_b_tile<BN>(Bs + buf * B_ELEMS, wpk, kt * BK, n0, Co_pad, tid);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_k = K_pad / BK;
  const int kt0 = split * k_steps;
  const int kt1 = SPLIT ? min(n_k, kt0 + k_steps) : n_k;
  load_tile(kt0, 0);
  cp_async_commit();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) load_tile(kt + 1, buf ^ 1);
    cp_async_commit();    // possibly empty: keeps the group count regular
    cp_async_wait<1>();   // this step's group has landed
    __syncthreads();
    const __nv_bfloat16* as = As + buf * A_ELEMS;
    const __nv_bfloat16* bs = Bs + buf * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[FM];
      FragB fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        load_frag_a(fa[i], as + (wm * FM * 16 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        load_frag_b(fb[j], bs + kk * LDB + wn * FN * 16 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled in the next step
  }

  if constexpr (SPLIT) {
    const int n_ws = gridDim.x * BN;
    const int64_t row0 = (static_cast<int64_t>(split) * (gridDim.z / splits) + b) * m_tiles * BM + m0;
    float* wt = ws + row0 * n_ws + n0;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(
            wt + static_cast<int64_t>(wm * FM * 16 + i * 16) * n_ws + wn * FN * 16 + j * 16,
            acc[i][j], n_ws, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * LDC + wn * FN * 16 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    tile_epilogue<BM, BN>(
        Cs, min(BM, M - m0), [m0](int r) { return static_cast<int64_t>(m0 + r); },
        y + static_cast<int64_t>(b) * M * Co, Co, n0, part_mean, part_m2,
        (static_cast<int64_t>(b) * m_tiles + mt) * Co);
  }
}

// Split-K finish: the S partial tiles of one (n tile, m tile, b) summed in
// split order, then the shared epilogue.
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
conv3d_split_finish_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
                           float* __restrict__ part_mean, float* __restrict__ part_m2, int B,
                           int M, int Co, int splits) {
  constexpr int LDC = BN + 4;
  __shared__ __align__(128) float Cs[BM * LDC];
  const int n0 = blockIdx.x * BN, mt = blockIdx.y, b = blockIdx.z;
  const int m_tiles = gridDim.y, m0 = mt * BM;
  const int n_ws = gridDim.x * BN;
  const int64_t split_stride = static_cast<int64_t>(B) * m_tiles * BM * n_ws;
  const float* wt = ws + (static_cast<int64_t>(b) * m_tiles * BM + m0) * n_ws + n0;
  for (int e = threadIdx.x; e < BM * BN / 4; e += kThreads) {
    const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
    const float* src = wt + static_cast<int64_t>(r) * n_ws + c;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(src + s * split_stride);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(Cs + r * LDC + c) = acc;
  }
  __syncthreads();
  tile_epilogue<BM, BN>(
      Cs, min(BM, M - m0), [m0](int r) { return static_cast<int64_t>(m0 + r); },
      y + static_cast<int64_t>(b) * M * Co, Co, n0, part_mean, part_m2,
      (static_cast<int64_t>(b) * m_tiles + mt) * Co);
}

// ------------------------------------------------------------------- brick
// Halo brick of Td x Th x 16 output voxels (blockIdx.y, bricks in w fastest,
// then h, then d; they divide the volume). A step runs TPS taps of one
// 32-channel chunk. Dynamic shared memory: [nbuf][(Td+2)(Th+2)18][PITCH]
// bf16 bricks, then a ring of NSTB weight buffers [TPS][BK][BN + 8] bf16;
// the f32 output tile overlays them after the K loop. With NSTB > 2 the
// ring loads NSTB - 2 steps ahead and a step has one barrier: a buffer is
// refilled two steps after it was read, so the barrier of the step between
// separates the two. With NSTB = 2 it loads one step ahead and a second
// barrier ends each step.
template <int BM, int BN, int TPS, int NSTB>
__global__ void __launch_bounds__(kThreads)
conv3d_brick_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wpk,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ part_mean,
                    float* __restrict__ part_m2, int D, int H, int W, int Ci, int Co, int Co_pad,
                    int Td, int Th, int nbuf) {
  constexpr int WARPS_N = BN / 32, WARPS_M = BM / 32;
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "eight warps");
  constexpr int FM = 2, FN = 2;
  constexpr int LDB = BN + 8, B_ELEMS = BK * LDB, B_STEP = TPS * B_ELEMS;
  constexpr int SPC = 27 / TPS;  // steps per chunk
  constexpr bool TAIL = NSTB == 2;  // a second barrier per step
  constexpr int LA = TAIL ? 1 : NSTB - 2;  // steps loading ahead
  // the next chunk's brick arrives over NEXT steps of this one from step
  // FIRST (after the barrier that ends the last reads of its buffer), so
  // that its last piece has landed when the next chunk starts
  constexpr int FIRST = TAIL ? 0 : 1;
  constexpr int NEXT = SPC + 1 - LA - FIRST;
  static_assert(SPC * TPS == 27 && NEXT >= 1 && LA >= 1, "taps per step, stages");
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  const int halo_h = Th + 2;
  const int nv = (Td + 2) * halo_h * HALO_W;  // voxels of one halo brick
  const int brick_elems = nv * PITCH;
  __nv_bfloat16* bricks = reinterpret_cast<__nv_bfloat16*>(smem_dyn);
  __nv_bfloat16* Bs = bricks + nbuf * brick_elems;
  float* Cs = reinterpret_cast<float*>(smem_dyn);

  const int n0 = blockIdx.x * BN;
  const int mt = blockIdx.y, b = blockIdx.z;
  const int m_tiles = gridDim.y;
  const int M = D * H * W;
  const int bw = W / BRICK_W, bh = H / Th;
  const int w0 = (mt % bw) * BRICK_W, h0 = ((mt / bw) % bh) * Th, d0 = mt / (bw * bh) * Td;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const __nv_bfloat16* xb = x + static_cast<int64_t>(b) * M * Ci;

  // this warp's two runs of 16 voxels: their (z, y) in the brick, as the
  // offset of the tap (0, 0, 0) voxel in the halo brick
  int run_voxel[FM];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
    const int run = wm * FM + i;
    run_voxel[i] = ((run / Th) * halo_h + run % Th) * HALO_W;
  }

  const int n_chunks = Ci / 32;
  const int n_steps = n_chunks * SPC;
  const int pieces = nv * 4;  // 16-byte pieces of one brick
  const int per_step = (pieces + NEXT - 1) / NEXT;

  auto load_brick = [&](int chunk, int buf, int begin, int end) {
    __nv_bfloat16* dst = bricks + buf * brick_elems;
    for (int i = begin + tid; i < end; i += kThreads) {
      const int v = i >> 2, q = i & 3;
      const int hx = v % HALO_W, t = v / HALO_W;
      const int dd = d0 - 1 + t / halo_h, hh = h0 - 1 + t % halo_h, ww = w0 - 1 + hx;
      const bool ok = dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const __nv_bfloat16* src =
          ok ? xb + ((static_cast<int64_t>(dd) * H + hh) * W + ww) * Ci + chunk * 32 + q * 8 : xb;
      cp_async16(dst + v * PITCH + q * 8, src, ok);
    }
  };
  // the weights of step s: taps (s % SPC) * TPS, ... of chunk s / SPC
  auto load_b = [&](int s, int buf) {
    const int chunk = s / SPC, tap0 = (s - chunk * SPC) * TPS;
#pragma unroll
    for (int t = 0; t < TPS; ++t)
      load_b_tile<BN>(Bs + buf * B_STEP + t * B_ELEMS, wpk, (tap0 + t) * Ci + chunk * 32, n0,
                      Co_pad, tid);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // one cp.async group per step (n_steps >= SPC > LA); the first holds the
  // first chunk's brick
  load_brick(0, 0, 0, pieces);
#pragma unroll
  for (int i = 0; i < LA; ++i) {
    load_b(i, i);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    const int chunk = s / SPC, ls = s - chunk * SPC;
    if (s + LA < n_steps) load_b(s + LA, (s + LA) % NSTB);
    if (chunk + 1 < n_chunks && ls >= FIRST && ls < FIRST + NEXT)
      load_brick(chunk + 1, (chunk + 1) & 1, (ls - FIRST) * per_step,
                 min(pieces, (ls - FIRST + 1) * per_step));
    cp_async_commit();
    cp_async_wait<LA>();  // this step's weights, and at its first step the chunk's brick
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < TPS * BK / 16; ++kt) {
      const int tap = ls * TPS + kt / 2, kk = (kt & 1) * 16;
      const __nv_bfloat16* br =
          bricks + (chunk & 1) * brick_elems +
          (((tap / 9) * halo_h + (tap / 3) % 3) * HALO_W + tap % 3) * PITCH;
      const __nv_bfloat16* bs = Bs + (s % NSTB) * B_STEP + (kt / 2) * B_ELEMS;
      FragA fa[FM];
      FragB fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) load_frag_a(fa[i], br + run_voxel[i] * PITCH + kk, PITCH);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        load_frag_b(fb[j], bs + kk * LDB + wn * FN * 16 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if constexpr (TAIL) __syncthreads();  // the buffers are refilled in the next step
  }
  cp_async_wait_all();  // only empty groups remain; the tile overlays the bricks
  if constexpr (!TAIL) __syncthreads();

  constexpr int LDC = BN + 4;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * LDC + wn * FN * 16 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  tile_epilogue<BM, BN>(
      Cs, BM,
      [=](int r) {
        const int run = r / BRICK_W;
        return (static_cast<int64_t>(d0 + run / Th) * H + h0 + run % Th) * W + w0 + r % BRICK_W;
      },
      y + static_cast<int64_t>(b) * M * Co, Co, n0, part_mean, part_m2,
      (static_cast<int64_t>(b) * m_tiles + mt) * Co);
}

// Chan's parallel combine of the [m_tiles] partials of 32 channels of one
// batch item, in a fixed order: lane = channel (coalesced), warp w takes
// tiles w, w + 32, ...; then the 32 warps' sums in order.
// mean = sum(n_s m_s) / M; M2 = sum(M2_s + n_s (m_s - mean)^2). Tile t holds
// min(BM, M - t * BM) voxels: bricks divide the volume, so each holds BM.
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

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wpk;
  __nv_bfloat16* y;
  float *pm, *p2, *ws;
  int B, D, H, W, Ci, Co, K, K_pad, Co_pad;
};

template <int BM, int BN, bool VEC, bool SPLIT>
cudaError_t launch_im2col(const Args& a, dim3 grid, int splits, int k_steps, cudaStream_t st) {
  conv3d_in_stats_kernel<BM, BN, VEC, SPLIT><<<grid, kThreads, 0, st>>>(
      a.x, a.wpk, a.y, a.pm, a.p2, a.ws, a.D, a.H, a.W, a.Ci, a.Co, a.K, a.K_pad, a.Co_pad,
      splits, k_steps);
  return cudaGetLastError();
}

template <int BM, int BN, int TPS, int NSTB>
cudaError_t launch_brick(const Args& a, dim3 grid, int td, int th, int smem_bytes,
                         cudaStream_t st) {
  const auto kernel = conv3d_brick_kernel<BM, BN, TPS, NSTB>;
  // dynamic shared memory above 48 KB: raise this instance's limit, once per
  // larger size
  static int allowed = 48 * 1024;
  if (smem_bytes > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    allowed = smem_bytes;
  }
  kernel<<<grid, kThreads, smem_bytes, st>>>(a.x, a.wpk, a.y, a.pm, a.p2, a.D, a.H, a.W, a.Ci,
                                             a.Co, a.Co_pad, td, th, a.Ci / 32 > 1 ? 2 : 1);
  return cudaGetLastError();
}

// the brick's (taps per step, weight stages) instances
inline bool brick_pipeline_ok(int taps, int stages) {
  return (taps == 1 && stages == 4) || (taps == 3 && stages == 2);
}

template <int BM, int BN>
cudaError_t launch_tiles(const Args& a, int route, int m_tiles, int td, int th, int taps,
                         int stages, int splits, int k_steps, int smem_bytes, cudaStream_t st) {
  const dim3 grid((a.Co + BN - 1) / BN, m_tiles, a.B);
  if (route == kBrick) {
    if (taps == 1) return launch_brick<BM, BN, 1, 4>(a, grid, td, th, smem_bytes, st);
    return launch_brick<BM, BN, 3, 2>(a, grid, td, th, smem_bytes, st);
  }
  if (route == kSplitK) {
    const dim3 split_grid(grid.x, grid.y, a.B * splits);
    const cudaError_t e = launch_im2col<BM, BN, true, true>(a, split_grid, splits, k_steps, st);
    if (e != cudaSuccess) return e;
    conv3d_split_finish_kernel<BM, BN><<<grid, kThreads, 0, st>>>(
        a.ws, a.y, a.pm, a.p2, a.B, a.D * a.H * a.W, a.Co, splits);
    return cudaGetLastError();
  }
  if (a.Ci % 8 == 0)
    return launch_im2col<BM, BN, true, false>(a, grid, 1, 0, st);
  return launch_im2col<BM, BN, false, false>(a, grid, 1, 0, st);
}

}  // namespace

// x [B, D, H, W, Ci] bf16; wpk [K_pad, Co_pad] bf16 with row k = tap * Ci + ci
// (tap = (dz * 3 + dy) * 3 + dx), zero beyond K = 27 * Ci and beyond Co,
// K_pad a multiple of 32 and Co_pad of 64; y [B, D, H, W, Co] bf16;
// part_mean, part_m2 [B, m_tiles, Co] f32 scratch; ws the split-K workspace
// [splits, B, m_tiles * bm, ceil(Co / bn) * bn] f32 (null on the other
// routes); mean, var [B, Co] f32. All contiguous on the device. The plan
// (route 0 im2col, 1 split_k, 2 brick; bm voxels per tile, 256 for Co % 64
// != 0 and 128 otherwise; the brick's td x th x 16 and its pipeline, `taps`
// taps per step in a ring of `stages` weight buffers; splits of k_steps K
// steps; the dynamic shared memory) comes from
// ops/conv_in_stats.py::plan_conv and is checked for range only. Launches
// the conv (and the split-K finish) and the combine on `stream`; returns
// cudaGetLastError() or the first error.
extern "C" int conv3d_in_stats_launch(const void* x, const void* wpk, int B, int D, int H, int W,
                                      int Ci, int Co, int K_pad, int Co_pad, int route, int bm,
                                      int td, int th, int taps, int stages, int splits,
                                      int k_steps, int smem_bytes,
                                      void* y, void* part_mean, void* part_m2, void* ws,
                                      void* mean, void* var, void* stream) {
  const int K = 27 * Ci;
  const int M = D * H * W;
  const int n_k = K_pad / BK;
  if (B < 1 || M < 1 || Ci < 1 || Co < 2 || Co % 2 || K_pad != (K + BK - 1) / BK * BK ||
      Co_pad != (Co + CO_ALIGN - 1) / CO_ALIGN * CO_ALIGN || B > 65535 || bm != tile_m(Co))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = 8192 / bm;
  int m_tiles = (M + bm - 1) / bm;
  int need = 0;  // the im2col kernel's shared memory is static
  if (route == kBrick) {
    if (Ci % 32 || W % BRICK_W || td < 1 || th < 1 || td * th * BRICK_W != bm || D % td ||
        H % th || !brick_pipeline_ok(taps, stages))
      return static_cast<int>(cudaErrorInvalidValue);
    need = brick_smem(bm, bn, td, th, Ci / 32 > 1 ? 2 : 1, taps, stages);
    m_tiles = (D / td) * (H / th) * (W / BRICK_W);
  } else if (route == kSplitK) {
    if (Ci % 8 || splits < 1 || k_steps < 1 || (splits - 1) * k_steps >= n_k ||
        splits * k_steps < n_k || ws == nullptr || static_cast<int64_t>(B) * splits > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (route != kIm2col) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes < need || smem_bytes > (route == kBrick ? kMaxSmem - kStaticSmem : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wpk),
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(part_mean),
               static_cast<float*>(part_m2), static_cast<float*>(ws), B, D, H, W, Ci, Co, K,
               K_pad, Co_pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bm == 128
      ? launch_tiles<128, 64>(a, route, m_tiles, td, th, taps, stages, splits, k_steps,
                              smem_bytes, st)
      : launch_tiles<256, 32>(a, route, m_tiles, td, th, taps, stages, splits, k_steps,
                              smem_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3d_in_stats_combine_kernel<<<dim3(B, (Co + 31) / 32), kCombineThreads, 0, st>>>(
      a.pm, a.p2, static_cast<float*>(mean), static_cast<float*>(var), m_tiles, M, Co, bm);
  return static_cast<int>(cudaGetLastError());
}

// Grouped (per-expert) GEMM forward for sm_90a: y[e] = x[e] @ w[e],
// x (E, C, d), w (E, d, h) -> y (E, C, h), fp32 accumulation, one rounding
// to x's dtype.
//
// Replaces the TPU kernel of src/repro/kernels/moe_gemm/kernel.py,
// moe_gemm_fwd (_mm_kernel): the three expert contractions of the MoE block
// (wg and wu: (E, C, d) x (E, d, h); wd: (E, C, h) x (E, h, d)).
//
// Bound, deepseek-v3-16b (E 64, d 2048, h 1408, bf16), H100 SXM:
//   prefill (C 240): 475 MB (x 63, w 369, y 43) over 3.35 TB/s = 0.142 ms,
//     88.6 GFLOP over 989 TFLOP/s = 0.090 ms: bytes, but close to even;
//   decode (C 8): 373 MB, almost all weights = 0.111 ms: bytes.
// Both are weight reads first, so each block reads its weight tile from
// device memory once for all of C.
//
// Three kernels, chosen by dtype and shape before launch (by the Python
// wrapper, moe_gemm_path, which passes its choice to the entry point):
//
// moe_gemm_wgmma<MT> (bf16, C > 64, d and h multiples of 8, 16-byte aligned
// pointers; prefill): one block per (C-tile of 128 MT rows, 128 h-columns,
// expert), two consumer warpgroups of 64 MT rows each and one producer warp.
// The producer keeps a ring of BK = 64 stages (6 at MT 1, 4 at MT 2) filled
// by TMA from 3-D tensor maps over x (d, C, E) and w (h, d, E), so that a
// box zero-fills past C and d inside its own expert (the TPU wrapper's
// padding, done by the copy engine).  Consumers run wgmma from shared
// memory: A = x, K-major; B = w, MN-major (h contiguous: the transpose bit).
// C 240 takes MT 2, one C-tile, so every weight byte is read once.  y is
// staged in the drained ring and written by a 3-D TMA store that clips at C
// and h.
//
// moe_gemm_wgmma_t<NC> (the same inputs, C <= 64; decode): A and B swapped,
// y[e]^T = w[e]^T x[e]^T, so that the 64-row M side is h (A = w from shared
// memory, MN-major) and C, padded to NC = 8, 16, 32 or 64, is wgmma's N.  One
// consumer warpgroup per 64 h-columns streams its weight panel through an
// 8-stage TMA ring: the bytes-bound case.
//
// moe_gemm_tc<BM> (bf16 where TMA cannot go: d or h not a multiple of 8, or
// an unaligned pointer): wmma 16x16x16 tiles fed element by element.
// moe_gemm_simt (fp32): CUDA-core FMA tiles (64x64 per block, 4x4 per
// thread), so that fp32 stays fp32 (TF32 would round the inputs).
#include "common.cuh"
#include "hopper.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// ------------------------------------------- bf16 where TMA cannot go, wmma
constexpr int TC_THREADS = 256;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int A_LD = BK + 8;   // padded shared-memory rows, in elements
constexpr int B_LD = BN + 8;

template <int BM> struct TcTile {
  static constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int FM = BM / (16 * WARPS_M);   // 16x16 fragments per warp
  static constexpr int FN = BN / (16 * WARPS_N);
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr size_t TILE_BYTES = (A_ELEMS + BK * B_LD) * sizeof(bf16);
  // the epilogue's per-warp 16x16 fp32 scratch reuses the tiles
  static constexpr size_t SCRATCH_BYTES = 8 * 256 * sizeof(float);
  static constexpr size_t SMEM = TILE_BYTES > SCRATCH_BYTES ? TILE_BYTES : SCRATCH_BYTES;
};

// The x and w tiles element by element, zero past C, d and h.
template <int BM>
__device__ __forceinline__ void scalar_load(bf16* sA, bf16* sB, const bf16* xe,
                                            const bf16* we, int c0, int n0,
                                            int k0, int C, int d, int h) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < BM * BK; i += TC_THREADS) {
    const int r = i / BK, c = i % BK;
    sA[r * A_LD + c] = (c0 + r < C && k0 + c < d)
                           ? xe[(int64_t)(c0 + r) * d + k0 + c] : zero;
  }
  for (int i = threadIdx.x; i < BK * BN; i += TC_THREADS) {
    const int r = i / BN, c = i % BN;
    sB[r * B_LD + c] = (k0 + r < d && n0 + c < h)
                           ? we[(int64_t)(k0 + r) * h + n0 + c] : zero;
  }
}

template <int BM>
__global__ void __launch_bounds__(TC_THREADS, 2)
moe_gemm_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
            bf16* __restrict__ y, int C, int d, int h) {
  using Tile = TcTile<BM>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + Tile::A_ELEMS;

  const int e = blockIdx.z;
  const int c0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bf16* xe = x + (int64_t)e * C * d;
  const bf16* we = w + (int64_t)e * d * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / Tile::WARPS_N, wn = warp % Tile::WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[Tile::FM][Tile::FN];
#pragma unroll
  for (int i = 0; i < Tile::FM; ++i)
#pragma unroll
    for (int j = 0; j < Tile::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < d; k0 += BK) {
    __syncthreads();               // the last tile's reads are done
    scalar_load<BM>(sA, sB, xe, we, c0, n0, k0, C, d, h);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[Tile::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[Tile::FN];
#pragma unroll
      for (int i = 0; i < Tile::FM; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * Tile::FM + i) * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < Tile::FN; ++j)
        wmma::load_matrix_sync(b[j], sB + kk * B_LD + (wn * Tile::FN + j) * 16, B_LD);
#pragma unroll
      for (int i = 0; i < Tile::FM; ++i)
#pragma unroll
        for (int j = 0; j < Tile::FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // epilogue: each fragment through a per-warp 16x16 fp32 scratch over the
  // tiles; a lane stores 8 neighbouring outputs of one row
  __syncthreads();
  float* sc = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < Tile::FM; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = c0 + (wm * Tile::FM + i) * 16 + r;
      const int gn = n0 + (wn * Tile::FN + j) * 16 + c;
      if (gr < C) {
        bf16* dst = y + ((int64_t)e * C + gr) * h + gn;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (gn + t < h) dst[t] = __float2bfloat16_rn(sc[r * 16 + c + t]);
      }
      __syncwarp();
    }
  }
}

template <int BM>
cudaError_t launch_tc(const void* x, const void* w, void* y, int E, int C,
                      int d, int h, cudaStream_t s) {
  const size_t smem = TcTile<BM>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(    // once per instance
      moe_gemm_tc<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((C + BM - 1) / BM, (h + BN - 1) / BN, E);
  moe_gemm_tc<BM><<<grid, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), C, d, h);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* x, const void* w, void* y, int E, int C,
                        int d, int h, cudaStream_t s) {
  if (C <= 16) return launch_tc<16>(x, w, y, E, C, d, h, s);
  if (C <= 32) return launch_tc<32>(x, w, y, E, C, d, h, s);
  if (C <= 64) return launch_tc<64>(x, w, y, E, C, d, h, s);
  return launch_tc<128>(x, w, y, E, C, d, h, s);
}

// --------------------------------------------------------- fp32, CUDA cores
constexpr int S_BM = 64, S_BN = 64, S_BK = 16, S_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(S_THREADS)
moe_gemm_simt(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ y, int C, int d, int h) {
  __shared__ float sA[S_BK][S_BM + 4];   // x tile, k-major
  __shared__ float sB[S_BK][S_BN];
  const int e = blockIdx.z, c0 = blockIdx.x * S_BM, n0 = blockIdx.y * S_BN;
  const T* xe = x + (int64_t)e * C * d;
  const T* we = w + (int64_t)e * d * h;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += S_BK) {
    for (int i = threadIdx.x; i < S_BM * S_BK; i += S_THREADS) {
      const int r = i / S_BK, k = i % S_BK;
      sA[k][r] = (c0 + r < C && k0 + k < d)
                     ? to_f(xe[(int64_t)(c0 + r) * d + k0 + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < S_BK * S_BN; i += S_THREADS) {
      const int k = i / S_BN, n = i % S_BN;
      sB[k][n] = (k0 + k < d && n0 + n < h)
                     ? to_f(we[(int64_t)(k0 + k) * h + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = c0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < C && n < h) y[((int64_t)e * C + r) * h + n] = from_f<T>(acc[i][j]);
    }
}

// ------------------------------------------------------ bf16, wgmma + TMA
constexpr int WG_BK = 64;                 // d per ring stage
constexpr int WG_BN = 128;                // h per block: two 64-wide boxes
constexpr int RING_BYTES = 192 * 1024;

template <int MT> struct WgTile {
  static constexpr int BM = 128 * MT;                // rows of C per block
  static constexpr int A_BYTES = BM * 128;           // BM rows x 64 d
  static constexpr int STAGE = A_BYTES + 2 * BOX;    // + 64 d x 128 h
  static constexpr int STAGES = RING_BYTES / STAGE;  // 6 at MT 1, 4 at MT 2
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

template <int MT>
__global__ void __launch_bounds__(288, 1)
moe_gemm_wgmma(const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mw,
               const __grid_constant__ CUtensorMap my, int d) {
  using Tile = WgTile<MT>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Tile::STAGE);
  uint64_t* empty = full + STAGES;
  const int c0 = blockIdx.x * Tile::BM, n0 = blockIdx.y * WG_BN, e = blockIdx.z;
  const int nk = (d + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);       // every consumer warp releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {                     // producer warp: one thread issues TMA
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        unsigned char* a = ring + s * Tile::STAGE;
        unsigned char* b = a + Tile::A_BYTES;
        mbar_expect_tx(&full[s], Tile::STAGE);
        tma_load_3d(a, &mx, &full[s], kt * WG_BK, c0, e);
        tma_load_3d(b, &mw, &full[s], n0, kt * WG_BK, e);
        tma_load_3d(b + BOX, &mw, &full[s], n0 + 64, kt * WG_BK, e);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows c0 + 64 (MT wg + mt) + [0, 64).  The first
  // product overwrites acc (scale_d 0): an ordinary instruction that wrote
  // it would make ptxas serialize the products in flight
  float acc[MT][64];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* a = ring + s * Tile::STAGE + wg * MT * BOX;
    const unsigned char* b = ring + s * Tile::STAGE + Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // B = w: d rows of 128 bytes of h, the second 64 h a box further
      const uint64_t bd = wgmma_desc(b + kk * 2048, BOX, 1024);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_ss<0, 1>(acc[mt], wgmma_desc(a + mt * BOX + kk * 32, 16, 1024),
                       bd, kt > 0 || kk > 0);
    }
    wgmma_commit();
    // keep this stage's products in flight; release the previous stage
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive_warp(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);

  // epilogue: both warpgroups are done with the ring (the producer issued no
  // load that was not consumed), so it holds y's tile in bf16, boxes of 64
  // rows x 64 h, each written by a TMA store that clips at C and h
  named_barrier(1, 256);
  unsigned char* out = ring + wg * MT * 2 * BOX;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane >> 2);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      unsigned char* box = out + (2 * mt + j / 8) * BOX;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(box + swz128(row + 8 * i, j % 8) +
                                     4 * (lane & 3)) =
            pack_bf16(acc[mt][4 * j + 2 * i], acc[mt][4 * j + 2 * i + 1]);
    }
  }
  fence_proxy_async();
  named_barrier(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        tma_store_3d(&my, out + (2 * mt + half) * BOX, n0 + 64 * half,
                     c0 + 64 * (MT * wg + mt), e);
    tma_store_wait();
  }
}

// C <= 64: y[e]^T (h x C) = w[e]^T (h x d) x[e]^T (d x C), C padded to NC
constexpr int T_STAGES = 8;

template <int NC> struct WgTileT {
  static constexpr int B_BYTES = NC * 128;           // NC rows of C x 64 d
  static constexpr int STAGE = BOX + B_BYTES;        // + 64 d x 64 h
  static constexpr size_t SMEM = 1024 + T_STAGES * STAGE + 2 * T_STAGES * 8;
};

template <int NC>
__global__ void __launch_bounds__(160)
moe_gemm_wgmma_t(const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mw, bf16* __restrict__ y,
                 int C, int d, int h) {
  using Tile = WgTileT<NC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T_STAGES * Tile::STAGE);
  uint64_t* empty = full + T_STAGES;
  const int h0 = blockIdx.x * 64, e = blockIdx.y;
  const int nk = (d + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup_index() == 1) {      // producer warp
    if (threadIdx.x == 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % T_STAGES;
        if (kt >= T_STAGES) mbar_wait(&empty[s], (kt / T_STAGES - 1) & 1);
        unsigned char* a = ring + s * Tile::STAGE;
        mbar_expect_tx(&full[s], Tile::STAGE);
        tma_load_3d(a, &mw, &full[s], h0, kt * WG_BK, e);
        tma_load_3d(a + BOX, &mx, &full[s], kt * WG_BK, 0, e);
      }
    }
    return;
  }

  float acc[NC / 2];                 // overwritten by the first product
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T_STAGES;
    mbar_wait(&full[s], (kt / T_STAGES) & 1);
    const unsigned char* a = ring + s * Tile::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)   // A = w^T: MN-major
      wgmma_ss<1, 0>(acc, wgmma_desc(a + kk * 2048, BOX, 1024),
                     wgmma_desc(a + BOX + kk * 32, 16, 1024), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive_warp(&empty[(kt - 1) % T_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator element 4 j + 2 i + c: h row h0 + 16 warp + lane / 4 + 8 i,
  // C column 8 j + 2 (lane % 4) + c
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int hr = h0 + 16 * warp + (lane >> 2) + 8 * i;
    if (hr >= h) continue;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cc = 8 * j + 2 * (lane & 3) + c;
        if (cc < C)
          y[((int64_t)e * C + cc) * h + hr] = __float2bfloat16_rn(acc[4 * j + 2 * i + c]);
      }
  }
}

// x (d, C, E) and w (h, d, E) as 3-D tensor maps, innermost first
cudaError_t make_maps(CUtensorMap* mx, CUtensorMap* mw, const void* x,
                      const void* w, int E, int C, int d, int h,
                      uint32_t x_rows) {
  const uint64_t xd[3] = {(uint64_t)d, (uint64_t)C, (uint64_t)E};
  const uint64_t xs[2] = {2ull * d, 2ull * C * d};
  const uint32_t xb[3] = {64, x_rows, 1};
  const uint64_t wd[3] = {(uint64_t)h, (uint64_t)d, (uint64_t)E};
  const uint64_t ws[2] = {2ull * h, 2ull * d * h};
  const uint32_t wb[3] = {64, 64, 1};
  cudaError_t err = make_map_bf16(mx, 3, x, xd, xs, xb);
  return err != cudaSuccess ? err : make_map_bf16(mw, 3, w, wd, ws, wb);
}

template <int MT>
cudaError_t launch_wgmma(const void* x, const void* w, void* y, int E, int C,
                         int d, int h, cudaStream_t s) {
  const size_t smem = WgTile<MT>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(    // once per instance
      moe_gemm_wgmma<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mx, mw, my;
  cudaError_t err = make_maps(&mx, &mw, x, w, E, C, d, h, WgTile<MT>::BM);
  if (err != cudaSuccess) return err;
  const uint64_t yd[3] = {(uint64_t)h, (uint64_t)C, (uint64_t)E};
  const uint64_t ys[2] = {2ull * h, 2ull * C * h};
  const uint32_t yb[3] = {64, 64, 1};
  if ((err = make_map_bf16(&my, 3, y, yd, ys, yb)) != cudaSuccess) return err;
  // the C-tiles of one (h-tile, expert) are neighbours: one weight tile in L2
  const dim3 grid((C + WgTile<MT>::BM - 1) / WgTile<MT>::BM,
                  (h + WG_BN - 1) / WG_BN, E);
  moe_gemm_wgmma<MT><<<grid, 288, smem, s>>>(mx, mw, my, d);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_wgmma_t(const void* x, const void* w, void* y, int E, int C,
                           int d, int h, cudaStream_t s) {
  const size_t smem = WgTileT<NC>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(    // once per instance
      moe_gemm_wgmma_t<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mx, mw;
  cudaError_t err = make_maps(&mx, &mw, x, w, E, C, d, h, NC);
  if (err != cudaSuccess) return err;
  const dim3 grid((h + 63) / 64, E);
  moe_gemm_wgmma_t<NC><<<grid, 160, smem, s>>>(mx, mw, static_cast<bf16*>(y),
                                               C, d, h);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(const void* x, const void* w, void* y, int E, int C,
                           int d, int h, cudaStream_t s) {
  if (C <= 8) return launch_wgmma_t<8>(x, w, y, E, C, d, h, s);
  if (C <= 16) return launch_wgmma_t<16>(x, w, y, E, C, d, h, s);
  if (C <= 32) return launch_wgmma_t<32>(x, w, y, E, C, d, h, s);
  if (C <= 64) return launch_wgmma_t<64>(x, w, y, E, C, d, h, s);
  if (C <= 128) return launch_wgmma<1>(x, w, y, E, C, d, h, s);
  return launch_wgmma<2>(x, w, y, E, C, d, h, s);
}

}  // namespace

EXPORT_ERROR_STRING

// x (E, C, d), w (E, d, h), y (E, C, h): contiguous, all of one dtype.
// path: the kernel to launch, as the Python wrapper chose it: kPathSimt for
// fp32; for bf16 kPathWgmma where TMA can read x and w (d > 0, d and h
// multiples of 8, 16-byte aligned pointers), else kPathWmma.  Inputs that
// kernel cannot take return cudaErrorInvalidValue (for wgmma, the tensor
// maps' encoding refuses them).
extern "C" int moe_gemm_fwd(const void* x, const void* w, void* y, int dtype,
                            int E, int C, int d, int h, void* stream,
                            int path) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || h <= 0 || d < 0) return cudaErrorInvalidValue;
  if (path == kPathSimt && dtype == kFloat32) {
    const dim3 grid((C + S_BM - 1) / S_BM, (h + S_BN - 1) / S_BN, E);
    moe_gemm_simt<float><<<grid, S_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), C, d, h);
    return cudaGetLastError();
  }
  if (path == kPathWgmma && dtype == kBFloat16 && d > 0)
    return dispatch_wgmma(x, w, y, E, C, d, h, s);
  if (path == kPathWmma && dtype == kBFloat16)
    return dispatch_tc(x, w, y, E, C, d, h, s);
  return cudaErrorInvalidValue;
}

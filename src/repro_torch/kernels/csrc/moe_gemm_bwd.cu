// Grouped (per-expert) GEMM backward for sm_90a: the two transposed forms of
// moe_gemm.cu's y[e] = x[e] w[e], x (E, C, d), w (E, d, h), y (E, C, h):
//
//   dgrad: dx[e] (C, d) = dy[e] (C, h) w[e]^T      contraction over h
//   wgrad: dw[e] (d, h) = x[e]^T (d, C) dy[e] (C, h)  contraction over C
//
// fp32 accumulation, one rounding to the inputs' dtype (the weight's: XLA's
// autodiff of the bf16 einsum rounds its products so).  No atomics and no
// split of the contraction: each output element is one block's sum in a fixed
// order, so a run gives the same bits every time.
//
// Replaces no TPU kernel: on the TPU these are XLA's autodiff of the expert
// einsums of src/repro/models/moe.py:91-93 (the Pallas moe_gemm_fwd has no
// backward).  They are the grouped GEMM's counterpart in training.
//
// Bound, deepseek-v3-16b training (E 64, C 960, d 2048, h 1408, bf16), H100
// SXM: each form does 2 E C d h = 354.3 GFLOP, 0.358 ms at 989 TFLOP/s, and
// moves 794 MB (x or dx 252, dy 173, w or dw 369), 0.237 ms at 3.35 TB/s:
// operations.  Unlike serving's forward (a weight read first), both are
// tensor-core bound, so the design is the forward's wgmma pipeline.
//
// moe_gemm_bwd_wgmma<FORM, MT> (bf16, d and h multiples of 8, 16-byte aligned
// bases): moe_gemm_wgmma<MT> of moe_gemm.cu with other operand layouts.  One
// block per (128 MT output rows, 128 output columns, expert), two consumer
// warpgroups of 64 MT rows each and one producer warp that keeps a ring of
// 64-deep contraction stages filled by TMA from 3-D tensor maps (zero-filled
// past each dim inside the expert); the tile is staged in the drained ring
// and written by 3-D TMA stores that clip.
//   dgrad: A = dy, K-major (h contiguous), one box of 64 h x 128 MT rows of
//     C, as the forward's x; B = w read K-major (h contiguous, d the output
//     column): one box of 64 h x 128 rows of d, transpose bit clear.
//   wgrad: A = x^T, MN-major (d contiguous along the output rows): 2 MT boxes
//     of 64 d x 64 C, transpose bit set, as moe_gemm_wgmma_t's A; B = dy,
//     MN-major (h contiguous), two boxes of 64 h x 64 C, as the forward's w.
// MT 2 (256 rows) where the output has more than 128 rows (training: C 960
// for dgrad, d or h for wgrad), else MT 1.
//
// moe_gemm_bwd_simt (fp32, and bf16 that TMA cannot read): CUDA-core FMA
// tiles of 64 x 64 over operands given by element strides, fp32 accumulate.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Form : int { kDgrad = 0, kWgrad = 1 };

// ---------------------------------------------------------------- CUDA cores
constexpr int S_BM = 64, S_BN = 64, S_BK = 16, S_THREADS = 256;

// out[e] (M x N, contiguous) = A[e] (M x K) B[e] (K x N), each operand by its
// element strides (per expert, per row, per column).  The loads walk the
// operand's contiguous dim across neighbouring threads.
template <typename T>
__global__ void __launch_bounds__(S_THREADS)
moe_gemm_bwd_simt(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int M, int N, int K, int64_t a_e,
                  int64_t a_m, int64_t a_k, int64_t b_e, int64_t b_k,
                  int64_t b_n) {
  __shared__ float sA[S_BK][S_BM + 4];
  __shared__ float sB[S_BK][S_BN + 4];
  const int e = blockIdx.z, m0 = blockIdx.x * S_BM, n0 = blockIdx.y * S_BN;
  const T* ae = a + e * a_e;
  const T* be = b + e * b_e;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += S_BK) {
    for (int i = threadIdx.x; i < S_BM * S_BK; i += S_THREADS) {
      const int r = a_k == 1 ? i / S_BK : i % S_BM;
      const int k = a_k == 1 ? i % S_BK : i / S_BM;
      sA[k][r] = (m0 + r < M && k0 + k < K)
                     ? to_f(ae[(m0 + r) * a_m + (k0 + k) * a_k]) : 0.f;
    }
    for (int i = threadIdx.x; i < S_BK * S_BN; i += S_THREADS) {
      const int n = b_n == 1 ? i % S_BN : i / S_BK;
      const int k = b_n == 1 ? i / S_BN : i % S_BK;
      sB[k][n] = (k0 + k < K && n0 + n < N)
                     ? to_f(be[(k0 + k) * b_k + (n0 + n) * b_n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S_BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < M && n < N) out[((int64_t)e * M + r) * N + n] = from_f<T>(acc[i][j]);
    }
}

template <typename T>
cudaError_t launch_simt(int form, const void* p0, const void* p1, void* out,
                        int E, int C, int d, int h, cudaStream_t s) {
  // dgrad: A = dy (C x h), B(n, j) = w[j][n]; wgrad: A(i, c) = x[c][i],
  // B = dy (C x h)
  const int M = form == kDgrad ? C : d, N = form == kDgrad ? d : h;
  const int K = form == kDgrad ? h : C;
  const int64_t Ch = (int64_t)C * h, dh = (int64_t)d * h, Cd = (int64_t)C * d;
  const dim3 grid((M + S_BM - 1) / S_BM, (N + S_BN - 1) / S_BN, E);
  if (form == kDgrad)
    moe_gemm_bwd_simt<T><<<grid, S_THREADS, 0, s>>>(
        static_cast<const T*>(p0), static_cast<const T*>(p1),
        static_cast<T*>(out), M, N, K, Ch, h, 1, dh, 1, h);
  else
    moe_gemm_bwd_simt<T><<<grid, S_THREADS, 0, s>>>(
        static_cast<const T*>(p0), static_cast<const T*>(p1),
        static_cast<T*>(out), M, N, K, Cd, 1, d, Ch, h, 1);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16, wgmma + TMA
constexpr int WG_BK = 64;                 // contraction per ring stage
constexpr int WG_BN = 128;                // output columns per block
constexpr int RING_BYTES = 192 * 1024;

template <int MT> struct WgTile {
  static constexpr int BM = 128 * MT;                // output rows per block
  static constexpr int A_BYTES = BM * 128;           // BM rows x 64 deep
  static constexpr int STAGE = A_BYTES + 2 * BOX;    // + 128 columns x 64
  static constexpr int STAGES = RING_BYTES / STAGE;  // 6 at MT 1, 4 at MT 2
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// ma, mb: the operands' maps (dgrad: dy (h, C, E), w (h, d, E); wgrad: x
// (d, C, E), dy (h, C, E)); mo: the output's (dgrad: dx (d, C, E); wgrad: dw
// (h, d, E)); K: the contraction's length (dgrad h, wgrad C)
template <int FORM, int MT>
__global__ void __launch_bounds__(288, 1)
moe_gemm_bwd_wgmma(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb,
                   const __grid_constant__ CUtensorMap mo, int K) {
  using Tile = WgTile<MT>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Tile::STAGE);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * Tile::BM, n0 = blockIdx.y * WG_BN, e = blockIdx.z;
  const int nk = (K + WG_BK - 1) / WG_BK;

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
        const int k0 = kt * WG_BK;
        mbar_expect_tx(&full[s], Tile::STAGE);
        if (FORM == kDgrad) {
          tma_load_3d(a, &ma, &full[s], k0, m0, e);     // dy: 64 h x BM C
          tma_load_3d(b, &mb, &full[s], k0, n0, e);     // w: 64 h x 128 d
        } else {
#pragma unroll
          for (int j = 0; j < 2 * MT; ++j)              // x: 64 d x 64 C
            tma_load_3d(a + j * BOX, &ma, &full[s], m0 + 64 * j, k0, e);
          tma_load_3d(b, &mb, &full[s], n0, k0, e);     // dy: 64 h x 64 C
          tma_load_3d(b + BOX, &mb, &full[s], n0 + 64, k0, e);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: output rows m0 + 64 (MT wg + mt) + [0, 64).  The
  // first product overwrites acc (scale_d 0)
  float acc[MT][64];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* a = ring + s * Tile::STAGE + wg * MT * BOX;
    const unsigned char* b = ring + s * Tile::STAGE + Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      if (FORM == kDgrad) {
        // A: BM rows of 128 bytes of h; B: 128 rows of d, 128 bytes of h
        // each (K-major: a k16 step is 32 bytes along the row)
        const uint64_t bd = wgmma_desc(b + kk * 32, 16, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_ss<0, 0>(acc[mt], wgmma_desc(a + mt * BOX + kk * 32, 16, 1024),
                         bd, kt > 0 || kk > 0);
      } else {
        // A and B: C rows of 128 bytes of d (of h), 64-wide boxes a BOX
        // apart (MN-major: a k16 step is 16 rows, 2048 bytes)
        const uint64_t bd = wgmma_desc(b + kk * 2048, BOX, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_ss<1, 1>(acc[mt], wgmma_desc(a + mt * BOX + kk * 2048, BOX, 1024),
                         bd, kt > 0 || kk > 0);
      }
    }
    wgmma_commit();
    // keep this stage's products in flight; release the previous stage
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive_warp(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);

  // epilogue, as moe_gemm_wgmma's: the drained ring holds the tile in bf16,
  // boxes of 64 rows x 64 columns, each written by a TMA store that clips
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
        tma_store_3d(&mo, out + (2 * mt + half) * BOX, n0 + 64 * half,
                     m0 + 64 * (MT * wg + mt), e);
    tma_store_wait();
  }
}

// a bf16 (inner, rows, E) map of a contiguous (E, rows, inner) tensor
cudaError_t map3(CUtensorMap* map, const void* base, int inner, int rows,
                 int E, uint32_t box_inner, uint32_t box_rows) {
  const uint64_t dims[3] = {(uint64_t)inner, (uint64_t)rows, (uint64_t)E};
  const uint64_t strides[2] = {2ull * inner, 2ull * inner * rows};
  const uint32_t box[3] = {box_inner, box_rows, 1};
  return make_map_bf16(map, 3, base, dims, strides, box);
}

template <int FORM, int MT>
cudaError_t launch_wgmma(const void* p0, const void* p1, void* out, int E,
                         int C, int d, int h, cudaStream_t s) {
  using Tile = WgTile<MT>;
  static const cudaError_t attr = cudaFuncSetAttribute(    // once per instance
      moe_gemm_bwd_wgmma<FORM, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap ma, mb, mo;
  cudaError_t err;
  int M, N, K;
  if (FORM == kDgrad) {            // p0 = dy (E, C, h), p1 = w (E, d, h)
    M = C, N = d, K = h;
    if ((err = map3(&ma, p0, h, C, E, 64, Tile::BM)) != cudaSuccess) return err;
    if ((err = map3(&mb, p1, h, d, E, 64, WG_BN)) != cudaSuccess) return err;
    if ((err = map3(&mo, out, d, C, E, 64, 64)) != cudaSuccess) return err;
  } else {                         // p0 = x (E, C, d), p1 = dy (E, C, h)
    M = d, N = h, K = C;
    if ((err = map3(&ma, p0, d, C, E, 64, 64)) != cudaSuccess) return err;
    if ((err = map3(&mb, p1, h, C, E, 64, 64)) != cudaSuccess) return err;
    if ((err = map3(&mo, out, h, d, E, 64, 64)) != cudaSuccess) return err;
  }
  // the row tiles of one (column tile, expert) are neighbours in the grid
  const dim3 grid((M + Tile::BM - 1) / Tile::BM, (N + WG_BN - 1) / WG_BN, E);
  moe_gemm_bwd_wgmma<FORM, MT><<<grid, 288, Tile::SMEM, s>>>(ma, mb, mo, K);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t dispatch_wgmma(const void* p0, const void* p1, void* out, int E,
                           int C, int d, int h, cudaStream_t s) {
  const int rows = FORM == kDgrad ? C : d;
  return rows <= 128 ? launch_wgmma<FORM, 1>(p0, p1, out, E, C, d, h, s)
                     : launch_wgmma<FORM, 2>(p0, p1, out, E, C, d, h, s);
}

int entry(int form, const void* p0, const void* p1, void* out, int dtype,
          int E, int C, int d, int h, void* stream, int path) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || d <= 0 || h <= 0) return cudaErrorInvalidValue;
  if (path == kPathSimt && dtype == kFloat32)
    return launch_simt<float>(form, p0, p1, out, E, C, d, h, s);
  if (path == kPathSimt && dtype == kBFloat16)
    return launch_simt<bf16>(form, p0, p1, out, E, C, d, h, s);
  if (path == kPathWgmma && dtype == kBFloat16)
    return form == kDgrad ? dispatch_wgmma<kDgrad>(p0, p1, out, E, C, d, h, s)
                          : dispatch_wgmma<kWgrad>(p0, p1, out, E, C, d, h, s);
  return cudaErrorInvalidValue;
}

}  // namespace

EXPORT_ERROR_STRING

// dy (E, C, h), w (E, d, h) -> dx (E, C, d).  All contiguous, one dtype.
// path: kPathWgmma (bf16 that TMA can read: d and h multiples of 8, 16-byte
// aligned bases) or kPathSimt (fp32 or bf16); else cudaErrorInvalidValue.
extern "C" int moe_gemm_dgrad(const void* dy, const void* w, void* dx,
                              int dtype, int E, int C, int d, int h,
                              void* stream, int path) {
  return entry(kDgrad, dy, w, dx, dtype, E, C, d, h, stream, path);
}

// x (E, C, d), dy (E, C, h) -> dw (E, d, h), as moe_gemm_dgrad.
extern "C" int moe_gemm_wgrad(const void* x, const void* dy, void* dw,
                              int dtype, int E, int C, int d, int h,
                              void* stream, int path) {
  return entry(kWgrad, x, dy, dw, dtype, E, C, d, h, stream, path);
}

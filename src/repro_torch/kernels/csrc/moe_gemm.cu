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
// Both are weight reads first, so every weight element is read from device
// memory once per C-tile, and the C-tile is as tall as C allows: one tile at
// decode, two at prefill.
//
// Design (bf16): one block of 8 warps per (C-tile, 128 h-columns, expert),
// looping over d in steps of 64; tensor cores through wmma (16x16x16 bf16,
// fp32 accumulators in registers); a 3-stage cp.async ring of 16-byte loads
// into padded shared memory, so that two tiles are in flight while one is
// multiplied. Each thread works out its load addresses and row/column masks
// once and only advances them along d, so that issuing the copies costs few
// instructions beside the tensor-core work; 128 registers a thread keep two
// blocks on an SM. The C-tile is 16, 32, 64 or 128 rows, the least that
// covers C (16 at decode, where C is 8), and the blocks of one (h-tile,
// expert) are neighbours in the grid, so that a weight tile read by one
// C-tile is still in L2 for the next. The TPU wrapper pads C, d and h to its
// block sizes; here the loads zero-fill past C and d, and the stores mask
// past C and h. Where d or h is not a multiple of 8 (or a pointer is not
// 16-byte aligned), the same kernel loads and stores element by element.
//
// Design (fp32): plain CUDA-core FMA tiles (64x64 per block, 4x4 per thread),
// no tensor cores, so that fp32 stays fp32 (TF32 would round the inputs).
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- bf16, wmma
constexpr int TC_THREADS = 256;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int A_LD = BK + 8;   // padded shared-memory rows, in elements
constexpr int B_LD = BN + 8;

template <int BM> struct TcTile {
  static constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int FM = BM / (16 * WARPS_M);   // 16x16 fragments per warp
  static constexpr int FN = BN / (16 * WARPS_N);
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * B_LD;
  static constexpr size_t PIPE_BYTES = STAGES * STAGE_ELEMS * sizeof(bf16);
  // the epilogue's per-warp 16x16 fp32 scratch reuses the ring
  static constexpr size_t SCRATCH_BYTES = 8 * 256 * sizeof(float);
  static constexpr size_t SMEM = PIPE_BYTES > SCRATCH_BYTES ? PIPE_BYTES : SCRATCH_BYTES;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;              // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The 16-byte copies of one thread (d % 8 == 0, h % 8 == 0, so that a vector
// is all in or all out).  A thread copies the same column of every
// A_ROWS-th row of the x tile and every B_ROWS-th row of the w tile, so that
// one pointer, one shared-memory offset and a row mask describe all its
// copies; the pointers advance one BK step along d per stage.  Zero past C,
// d and h.
template <int BM>
struct VecLoader {
  static constexpr int A_ROWS = TC_THREADS / (BK / 8);
  static constexpr int B_ROWS = TC_THREADS / (BN / 8);
  static constexpr int A_PASSES = (BM + A_ROWS - 1) / A_ROWS;
  static constexpr int B_PASSES = BK / B_ROWS;
  const bf16* a_src;
  const bf16* b_src;
  int64_t a_step, b_step;       // A_ROWS rows of x, B_ROWS rows of w
  int64_t b_kstep;              // BK rows of w
  int a_row, a_col, a_dst, b_row, b_dst, k0;
  unsigned a_rows;              // bit t: row a_row + t * A_ROWS is < C
  bool b_ok;

  __device__ __forceinline__ VecLoader(const bf16* xe, const bf16* we, int c0,
                                       int n0, int C, int d, int h) : k0(0) {
    a_row = threadIdx.x / (BK / 8);
    a_col = (threadIdx.x % (BK / 8)) * 8;
    a_rows = 0;
#pragma unroll
    for (int t = 0; t < A_PASSES; ++t)
      if (a_row + t * A_ROWS < BM && c0 + a_row + t * A_ROWS < C) a_rows |= 1u << t;
    a_src = xe + (int64_t)(c0 + a_row) * d + a_col;
    a_step = (int64_t)A_ROWS * d;
    a_dst = a_row * A_LD + a_col;
    b_row = threadIdx.x / (BN / 8);
    const int b_col = (threadIdx.x % (BN / 8)) * 8;
    b_ok = n0 + b_col < h;
    b_src = we + (int64_t)b_row * h + n0 + b_col;
    b_step = (int64_t)B_ROWS * h;
    b_kstep = (int64_t)BK * h;
    b_dst = b_row * B_LD + b_col;
  }

  // the next BK-slice of d into stage buffers sA, sB
  __device__ __forceinline__ void load(bf16* sA, bf16* sB, const bf16* xe,
                                       const bf16* we, int d) {
    const bool a_kok = k0 + a_col < d;
#pragma unroll
    for (int t = 0; t < A_PASSES; ++t) {
      if (A_PASSES * A_ROWS > BM && a_row + t * A_ROWS >= BM) continue;
      const bool ok = a_kok && ((a_rows >> t) & 1u);
      cp_async16(sA + a_dst + t * A_ROWS * A_LD, ok ? a_src + t * a_step : xe, ok);
    }
#pragma unroll
    for (int t = 0; t < B_PASSES; ++t) {
      const bool ok = b_ok && k0 + b_row + t * B_ROWS < d;
      cp_async16(sB + b_dst + t * B_ROWS * B_LD, ok ? b_src + t * b_step : we, ok);
    }
    a_src += BK;
    b_src += b_kstep;
    k0 += BK;
  }
};

// The same tiles element by element, for any d and h.
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

template <int BM, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
moe_gemm_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
            bf16* __restrict__ y, int C, int d, int h) {
  using Tile = TcTile<BM>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

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

  VecLoader<BM> vl(xe, we, c0, n0, C, d, h);
  auto load = [&](int kt) {   // tiles are loaded in order kt = 0, 1, ...
    bf16* st = smem + (kt % STAGES) * Tile::STAGE_ELEMS;
    if (VEC) vl.load(st, st + Tile::A_ELEMS, xe, we, d);
    else scalar_load<BM>(st, st + Tile::A_ELEMS, xe, we, c0, n0, kt * BK, C, d, h);
  };
  const int nk = (d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed (this thread's part)
    __syncthreads();               // ... and everyone's; slot kt-1 is free
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    const bf16* sA = smem + (kt % STAGES) * Tile::STAGE_ELEMS;
    const bf16* sB = sA + Tile::A_ELEMS;
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

  // epilogue: each fragment through a per-warp 16x16 fp32 scratch in the
  // drained ring; a lane stores 8 neighbouring outputs of one row
  cp_async_wait<0>();
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
        if (VEC) {
          if (gn < h) {
            uint4 pack;
            bf16* pv = reinterpret_cast<bf16*>(&pack);
#pragma unroll
            for (int t = 0; t < 8; ++t) pv[t] = __float2bfloat16_rn(sc[r * 16 + c + t]);
            *reinterpret_cast<uint4*>(dst) = pack;
          }
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (gn + t < h) dst[t] = __float2bfloat16_rn(sc[r * 16 + c + t]);
        }
      }
      __syncwarp();
    }
  }
}

template <int BM, bool VEC>
cudaError_t launch_tc(const void* x, const void* w, void* y, int E, int C,
                      int d, int h, cudaStream_t s) {
  const size_t smem = TcTile<BM>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_tc<BM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + BM - 1) / BM, (h + BN - 1) / BN, E);
  moe_gemm_tc<BM, VEC><<<grid, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), C, d, h);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch_tc(const void* x, const void* w, void* y, int E, int C,
                        int d, int h, cudaStream_t s) {
  if (C <= 16) return launch_tc<16, VEC>(x, w, y, E, C, d, h, s);
  if (C <= 32) return launch_tc<32, VEC>(x, w, y, E, C, d, h, s);
  if (C <= 64) return launch_tc<64, VEC>(x, w, y, E, C, d, h, s);
  return launch_tc<128, VEC>(x, w, y, E, C, d, h, s);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

EXPORT_ERROR_STRING

// x (E, C, d), w (E, d, h), y (E, C, h): contiguous, all of one dtype.
extern "C" int moe_gemm_fwd(const void* x, const void* w, void* y, int dtype,
                            int E, int C, int d, int h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || h <= 0 || d < 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    const dim3 grid((C + S_BM - 1) / S_BM, (h + S_BN - 1) / S_BN, E);
    moe_gemm_simt<float><<<grid, S_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), C, d, h);
    return cudaGetLastError();
  }
  if (dtype == kBFloat16) {
    const bool vec = d % 8 == 0 && h % 8 == 0 && aligned16(x) && aligned16(w) &&
                     aligned16(y);
    return vec ? dispatch_tc<true>(x, w, y, E, C, d, h, s)
               : dispatch_tc<false>(x, w, y, E, C, d, h, s);
  }
  return cudaErrorInvalidValue;
}

// RMSNorm forward for sm_90a, plain and with a fused residual add.
//
// Replaces the TPU kernels of src/repro/kernels/rmsnorm/kernel.py,
// rmsnorm_fwd: _rms_kernel (plain) and _rms_res_kernel (residual).
//
// Bound: bytes.  Per row it reads d inputs (2d with the residual) and the
// weight, and writes d outputs (2d), with about 4 flops per element, far
// below the 295 flops a byte the card needs to be compute-bound.  At decode
// (4 rows) the launch itself dominates.
//
// Design: one warp per row for d <= 1024 (8 rows per 256-thread block, warp
// shuffles only), one block per row above (warp shuffles, then one pass
// through shared memory).  The sum of squares is fp32; the row is read
// twice, the second read served from L1/L2.  The residual form stores
// x + r rounded to x's dtype and normalises the unrounded fp32 sum, as the
// TPU kernel does.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T, typename W, bool RES, bool WARP_ROW>
__global__ void __launch_bounds__(THREADS)
rms_kernel(const T* __restrict__ x, const T* __restrict__ r,
           const W* __restrict__ w, T* __restrict__ y, T* __restrict__ res,
           int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = WARP_ROW ? (int64_t)blockIdx.x * WARPS + warp : blockIdx.x;
  const int tid = WARP_ROW ? lane : threadIdx.x;
  const int nthr = WARP_ROW ? 32 : THREADS;
  if (WARP_ROW && row >= rows) return;      // whole warps leave together
  const int64_t base = row * d;

  float ss = 0.f;
  for (int i = tid; i < d; i += nthr) {
    float v = to_f(x[base + i]);
    if (RES) {
      v += to_f(r[base + i]);
      res[base + i] = from_f<T>(v);
    }
    ss += v * v;
  }
  ss = sum32(ss);
  if (!WARP_ROW) {
    __shared__ float part[WARPS];
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    ss = sum32(lane < WARPS ? part[lane] : 0.f);
  }
  const float inv = rsqrtf(ss / d + eps);
  for (int i = tid; i < d; i += nthr) {
    float v = to_f(x[base + i]);
    if (RES) v += to_f(r[base + i]);
    y[base + i] = from_f<T>(v * inv * to_f(w[i]));
  }
}

template <typename T, typename W, bool RES>
cudaError_t launch(const void* x, const void* r, const void* w, void* y,
                   void* res, int64_t rows, int d, float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  T* resp = static_cast<T*>(res);
  if (d <= 1024) {
    const int64_t blocks = (rows + WARPS - 1) / WARPS;
    rms_kernel<T, W, RES, true><<<blocks, THREADS, 0, s>>>(xp, rp, wp, yp, resp, rows, d, eps);
  } else {
    rms_kernel<T, W, RES, false><<<rows, THREADS, 0, s>>>(xp, rp, wp, yp, resp, rows, d, eps);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_res(const void* x, const void* r, const void* w, void* y,
                       void* res, int64_t rows, int d, float eps, cudaStream_t s) {
  return r ? launch<T, W, true>(x, r, w, y, res, rows, d, eps, s)
           : launch<T, W, false>(x, r, w, y, res, rows, d, eps, s);
}

}  // namespace

EXPORT_ERROR_STRING

// x, r, y, res: (rows, d) contiguous in x_dtype; w: (d,) in w_dtype.
// r == nullptr selects the plain form (res is then unused).
extern "C" int rmsnorm_fwd(const void* x, const void* r, const void* w, void* y,
                           void* res, int x_dtype, int w_dtype, long long rows,
                           int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && w_dtype == kFloat32)
    return launch_res<float, float>(x, r, w, y, res, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    return launch_res<float, __nv_bfloat16>(x, r, w, y, res, rows, d, eps, s);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_res<__nv_bfloat16, float>(x, r, w, y, res, rows, d, eps, s);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_res<__nv_bfloat16, __nv_bfloat16>(x, r, w, y, res, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

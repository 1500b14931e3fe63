// RMSNorm forward for sm_90a, plain and with a fused residual add.
//
// Replaces the TPU kernels of src/repro/kernels/rmsnorm/kernel.py,
// rmsnorm_fwd: _rms_kernel (plain) and _rms_res_kernel (residual).
//
// Bound: bytes.  Per row it reads d inputs (2d with the residual) and the
// weight, and writes d outputs (2d), with about 4 flops per element, far
// below the 295 flops a byte the card needs to be compute-bound.  At decode
// (4 rows) the launch and one DRAM round trip set the time.
//
// Two kernels, chosen by the Python wrapper (rmsnorm_path) and passed to the
// entry point as its `path`:
//
// rms_vec_kernel (kPathVector; rows wider than 1024 of whole 16-byte words
// on 16-byte aligned bases, up to 32 KB: every served call).  A block of TPR
// threads (128 for rows up to 8 KB, 512 above) walks rows gridDim apart,
// each thread up to NV 16-byte words of a row.  Its next rows arrive by
// cp.async.bulk in a ring of up to 4 stages of shared memory (up to 4 rows a
// block in flight, 4 blocks of 128 threads an SM), so that a row costs no
// round trip of its own at prefill.  Where there are no more rows than
// blocks (decode: 4 rows) a block takes one, straight into registers with
// no ring, in one round trip with its w fragment.  The fragment of w
// stays in registers for all of a block's rows, and so does the row
// between the sum of squares and the scale: x is read from DRAM once.
//
// rms_kernel (kPathSimt; any d and alignment): one warp per row for d <=
// 1024 (8 rows per 256-thread block; every narrow row, such as a qk-norm's,
// takes it), one block per row above, scalar loads, the row read twice (the
// second read from L1/L2).
//
// Both sum the squares in fp32 (warp shuffles, then shared memory across
// warps).  The residual form stores x + r rounded to x's dtype and
// normalises the unrounded fp32 sum, as the TPU kernel does.
//
// The backward (rmsnorm_bwd; the TPU kernel has none: the JAX package
// differentiates its plain rmsnorm with XLA) takes x, w and dy and gives
// dx = rstd (w dy - x^ mean(x^ w dy)) in x's dtype, with x^ = x rstd and rstd
// recomputed in fp32, and dw = sum over rows of dy x^.  Bound: bytes, three
// row streams (x and dy in, dx out; 201 MB at the training shape, 8192 rows
// of 4096 bf16: 60 us at 3.35 TB/s).  rms_bwd_kernel gives each block a
// contiguous run of rows (a warp a row for rows up to 1024 wide, the block a
// row above), holds a row's columns in registers between its two sums and
// dx, and sums its rows' dy x^ per column in registers; it writes one fp32
// partial row per block, which rms_dw_kernel adds up per column in block
// order: dw is the same in every run, with no float atomics.
#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>

namespace {

constexpr int WARP_ROW_MAX = 1024;   // rows up to this width: a warp each

// ---------------------------------------------------------- vector kernel
constexpr int NV = 4;           // 16-byte words of a row a thread holds

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[4]) {
  f[0] = __uint_as_float(q.x); f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z); f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[8]) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// N weights from p (aligned to their size) as floats
template <int N>
__device__ __forceinline__ void load_w(const float* p, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = q.x; f[i + 1] = q.y; f[i + 2] = q.z; f[i + 3] = q.w;
  }
}
template <int N>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float (&f)[N]) {
  if constexpr (N == 8) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  } else {
    static_assert(N == 4, "4 or 8 bf16 weights");
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
}

constexpr int STG_MAX = 4;              // rows a block has in flight
constexpr int RING_BYTES = 192 * 1024;  // shared memory a block's ring takes

// A block of TPR threads walks rows gridDim apart.  With stg > 0, thread 0
// copies the block's next rows (x, and r) with cp.async.bulk into a ring of
// stg stages completing on mbarriers; each thread reads its words of a row
// into registers, and the block barrier after the sum of squares also frees
// the stage for the row stg ahead.  With stg 0 (a block a row, no shared
// memory to set aside) each thread loads its words straight into registers.
template <typename T, typename W, bool RES, int TPR>
__global__ void __launch_bounds__(TPR, 512 / TPR)
rms_vec_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const W* __restrict__ w, T* __restrict__ y, T* __restrict__ res,
               int64_t rows, int d, float eps, int stg) {
  constexpr int VEC = 16 / sizeof(T);           // elements of a word
  constexpr int WARPS = TPR / 32;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[STG_MAX];
  __shared__ float part[2][WARPS];
  const uint32_t row_bytes = d * sizeof(T);
  const uint32_t stage_bytes = row_bytes * (RES ? 2 : 1);
  const int nv = d / VEC;
  const int tid = threadIdx.x, lane = threadIdx.x & 31;
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int n = rows > first ? (int)((rows - first + step - 1) / step) : 0;
  bool has[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) has[j] = tid + j * TPR < nv;

  if (stg) {
    if (tid == 0) {
      for (int i = 0; i < stg; ++i) mbar_init(&full[i], 1);
      mbar_fence_init();
    }
    __syncthreads();
  }
  auto issue = [&](int i) {           // thread 0: the block's row i
    const int64_t row = first + i * step;
    unsigned char* st = ring + (i % stg) * stage_bytes;
    mbar_expect_tx(&full[i % stg], stage_bytes);
    bulk_load(st, x + row * d, row_bytes, &full[i % stg]);
    if (RES) bulk_load(st + row_bytes, r + row * d, row_bytes, &full[i % stg]);
  };
  if (tid == 0)
    for (int i = 0; i < min(stg, n); ++i) issue(i);
  float wf[NV][VEC];                  // loaded while the first row arrives
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (has[j]) load_w<VEC>(w + (tid + j * TPR) * VEC, wf[j]);

  float f[NV][VEC];                   // x (+ r) in fp32: the row stays here
  auto load = [&](const uint4* xs, const uint4* rs) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (has[j]) {
        unpack(xs[tid + j * TPR], f[j]);
        if (RES) {
          float g[VEC];
          unpack(rs[tid + j * TPR], g);
#pragma unroll
          for (int q = 0; q < VEC; ++q) f[j][q] += g[q];
        }
      }
    }
  };
  for (int i = 0; i < n; ++i) {
    const int64_t row = first + i * step;
    if (stg) {
      mbar_wait(&full[i % stg], (i / stg) & 1);
      const unsigned char* st = ring + (i % stg) * stage_bytes;
      load(reinterpret_cast<const uint4*>(st),
           reinterpret_cast<const uint4*>(st + row_bytes));
    } else {
      load(reinterpret_cast<const uint4*>(x + row * d),
           reinterpret_cast<const uint4*>(r + row * d));
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (has[j]) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) ss = fmaf(f[j][q], f[j][q], ss);
      }
    }
    ss = sum32(ss);
    float* p = part[i & 1];           // alternating: one barrier a row
    if (lane == 0) p[tid >> 5] = ss;
    __syncthreads();                  // the stage is read, the sums are in
    if (stg && tid == 0 && i + stg < n) issue(i + stg);
    ss = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) ss += p[q];
    const float inv = rsqrtf(ss / d + eps);
    T* yp = y + row * d;
    T* sp = res + row * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (has[j]) {
        const int64_t o = (int64_t)(tid + j * TPR) * VEC;
        if (RES) *reinterpret_cast<uint4*>(sp + o) = pack(f[j]);
#pragma unroll
        for (int q = 0; q < VEC; ++q) f[j][q] = f[j][q] * inv * wf[j][q];
        *reinterpret_cast<uint4*>(yp + o) = pack(f[j]);
      }
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// More rows than the blocks that fit: stg stages of a row (and its
// residual) each, as many as fit RING_BYTES up to STG_MAX, and up to 512
// threads of blocks per SM, as many as their rings fit.  Else (decode) a
// block a row and no ring.
template <typename T, typename W, bool RES, int TPR>
cudaError_t launch_vec_tpr(const T* x, const T* r, const W* w, T* y, T* res,
                           int64_t rows, int d, float eps, cudaStream_t s) {
  const int stage = d * (int)sizeof(T) * (RES ? 2 : 1);
  int stg = std::min(STG_MAX, RING_BYTES / stage);
  const int64_t most =
      (int64_t)sm_count() * std::min(512 / TPR, RING_BYTES / (stg * stage));
  if (rows <= most) stg = 0;
  static int allowed = 48 * 1024;     // dynamic shared memory, raised once
  if (stg * stage > allowed) {        // to the largest ring seen
    const cudaError_t err = cudaFuncSetAttribute(
        rms_vec_kernel<T, W, RES, TPR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, stg * stage);
    if (err != cudaSuccess) return err;
    allowed = stg * stage;
  }
  rms_vec_kernel<T, W, RES, TPR><<<std::min(rows, most), TPR, stg * stage, s>>>(
      x, r, w, y, res, rows, d, eps, stg);
  return cudaGetLastError();
}

template <typename T, typename W, bool RES>
cudaError_t launch_vec(const void* x, const void* r, const void* w, void* y,
                       void* res, int64_t rows, int d, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (d <= WARP_ROW_MAX || d % VEC || !aligned(x) || !aligned(w) ||
      !aligned(y) || (RES && (!aligned(r) || !aligned(res))))
    return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  T* resp = static_cast<T*>(res);
  const int nv = d / VEC;
  if (nv <= 128 * NV) return launch_vec_tpr<T, W, RES, 128>(xp, rp, wp, yp, resp, rows, d, eps, s);
  if (nv <= 512 * NV) return launch_vec_tpr<T, W, RES, 512>(xp, rp, wp, yp, resp, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------- scalar kernel
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
  if (d <= WARP_ROW_MAX) {
    const int64_t blocks = (rows + WARPS - 1) / WARPS;
    rms_kernel<T, W, RES, true><<<blocks, THREADS, 0, s>>>(xp, rp, wp, yp, resp, rows, d, eps);
  } else {
    rms_kernel<T, W, RES, false><<<rows, THREADS, 0, s>>>(xp, rp, wp, yp, resp, rows, d, eps);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_path(int path, const void* x, const void* r, const void* w,
                        void* y, void* res, int64_t rows, int d, float eps,
                        cudaStream_t s) {
  if (path == kPathVector)
    return r ? launch_vec<T, W, true>(x, r, w, y, res, rows, d, eps, s)
             : launch_vec<T, W, false>(x, r, w, y, res, rows, d, eps, s);
  if (path == kPathSimt)
    return r ? launch<T, W, true>(x, r, w, y, res, rows, d, eps, s)
             : launch<T, W, false>(x, r, w, y, res, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------- backward
constexpr int BWD_NC_MAX = 32;      // columns of a row a thread holds

// Rows [blockIdx.x rpb, + rpb) of x, dy; a row group (a warp if WARP_ROW,
// else the block) takes a row at a time, each thread columns lane/tid +
// GROUP c.  part[blockIdx.x] gets the block's per-column sum of dy x^.
template <typename T, typename W, int NC, bool WARP_ROW>
__global__ void __launch_bounds__(THREADS)
rms_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
               const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ part, int64_t rows, int d, float eps,
               int64_t rpb) {
  constexpr int GROUP = WARP_ROW ? 32 : THREADS;
  constexpr int NGROUPS = THREADS / GROUP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tid = WARP_ROW ? lane : threadIdx.x;
  const int grp = WARP_ROW ? warp : 0;
  const int64_t r0 = (int64_t)blockIdx.x * rpb;
  const int64_t r1 = min(rows, r0 + rpb);
  __shared__ float red[2][2][WARPS];        // alternating: one barrier a row

  float wf[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = tid + GROUP * c;
    wf[c] = col < d ? to_f(w[col]) : 0.f;
    acc[c] = 0.f;
  }
  int n = 0;
  for (int64_t row = r0 + grp; row < r1; row += NGROUPS, ++n) {
    const int64_t base = row * d;
    float xf[NC], g[NC];
    float ss = 0.f, sxg = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tid + GROUP * c;
      xf[c] = col < d ? to_f(x[base + col]) : 0.f;
      g[c] = col < d ? to_f(dy[base + col]) : 0.f;
      ss = fmaf(xf[c], xf[c], ss);
      sxg = fmaf(xf[c], g[c] * wf[c], sxg);
    }
    ss = sum32(ss);
    sxg = sum32(sxg);
    if constexpr (!WARP_ROW) {
      float* p = red[n & 1][0];
      float* q = red[n & 1][1];
      if (lane == 0) { p[warp] = ss; q[warp] = sxg; }
      __syncthreads();
      ss = 0.f;
      sxg = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) { ss += p[k]; sxg += q[k]; }
    }
    const float rstd = rsqrtf(ss / d + eps);
    const float mean = rstd * sxg / d;      // mean of x^ w dy
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tid + GROUP * c;
      if (col < d) {
        const float xh = xf[c] * rstd;
        dx[base + col] = from_f<T>(rstd * (g[c] * wf[c] - xh * mean));
        acc[c] = fmaf(g[c], xh, acc[c]);
      }
    }
  }

  float* out = part + (int64_t)blockIdx.x * d;
  if constexpr (!WARP_ROW) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tid + GROUP * c < d) out[tid + GROUP * c] = acc[c];
  } else {
    // the block's warps hold partial sums of the same columns: add them in
    // warp order through shared memory
    __shared__ float wsum[WARPS][32 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) wsum[warp][lane + 32 * c] = acc[c];
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += THREADS) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) t += wsum[k][col];
      out[col] = t;
    }
  }
}

// dw[col] = sum of part[0..nblocks)[col], in block order
template <typename W>
__global__ void __launch_bounds__(THREADS)
rms_dw_kernel(const float* __restrict__ part, W* __restrict__ dw, int nblocks,
              int d) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= d) return;
  float t = 0.f;
  for (int k = 0; k < nblocks; ++k) t += part[(int64_t)k * d + col];
  dw[col] = from_f<W>(t);
}

template <typename T, typename W, int NC, bool WARP_ROW>
cudaError_t launch_bwd_nc(const T* x, const W* w, const T* dy, T* dx, W* dw,
                          float* part, int64_t rows, int d, float eps,
                          int nblocks, cudaStream_t s) {
  const int64_t rpb = (rows + nblocks - 1) / nblocks;
  rms_bwd_kernel<T, W, NC, WARP_ROW><<<nblocks, THREADS, 0, s>>>(
      x, w, dy, dx, part, rows, d, eps, rpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_dw_kernel<W><<<(d + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      part, dw, nblocks, d);
  return cudaGetLastError();
}

// the fewest columns a thread must hold: a warp a row up to 1024 (32 a
// lane), the block a row up to 8192 (32 a thread)
template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       void* dw, float* part, int64_t rows, int d, float eps,
                       int nblocks, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  W* dwp = static_cast<W*>(dw);
#define RMS_BWD(NC, WR) \
  return launch_bwd_nc<T, W, NC, WR>(xp, wp, dyp, dxp, dwp, part, rows, d, eps, nblocks, s)
  if (d <= WARP_ROW_MAX) {
    const int nc = (d + 31) / 32;
    if (nc <= 1) RMS_BWD(1, true);
    if (nc <= 2) RMS_BWD(2, true);
    if (nc <= 4) RMS_BWD(4, true);
    if (nc <= 8) RMS_BWD(8, true);
    if (nc <= 16) RMS_BWD(16, true);
    RMS_BWD(32, true);
  }
  const int nc = (d + THREADS - 1) / THREADS;
  if (nc <= 8) RMS_BWD(8, false);
  if (nc <= 16) RMS_BWD(16, false);
  if (nc <= 32) RMS_BWD(32, false);
#undef RMS_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

EXPORT_ERROR_STRING

// x, r, y, res: (rows, d) contiguous in x_dtype; w: (d,) in w_dtype.
// r == nullptr selects the plain form (res is then unused).  path: the
// kernel to launch, as the Python wrapper chose it: kPathVector (d a whole
// number of 16-byte words, at most 16384 bf16 / 8192 fp32, 16-byte aligned
// bases; anything else returns cudaErrorInvalidValue) or kPathSimt (any).
extern "C" int rmsnorm_fwd(const void* x, const void* r, const void* w, void* y,
                           void* res, int x_dtype, int w_dtype, long long rows,
                           int d, float eps, void* stream, int path) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && w_dtype == kFloat32)
    return launch_path<float, float>(path, x, r, w, y, res, rows, d, eps, s);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    return launch_path<float, __nv_bfloat16>(path, x, r, w, y, res, rows, d, eps, s);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_path<__nv_bfloat16, float>(path, x, r, w, y, res, rows, d, eps, s);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_path<__nv_bfloat16, __nv_bfloat16>(path, x, r, w, y, res, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

// The backward.  x, dy, dx: (rows, d) contiguous in x_dtype; w, dw: (d,) in
// w_dtype; part: (nblocks, d) fp32 scratch, nblocks >= 1 (rows split into
// nblocks contiguous runs).  d at most 8192.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, float* part, int x_dtype,
                           int w_dtype, long long rows, int d, float eps,
                           int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks < 1 || d < 1 || d > THREADS * BWD_NC_MAX) return cudaErrorInvalidValue;
  if (x_dtype == kFloat32 && w_dtype == kFloat32)
    return launch_bwd<float, float>(x, w, dy, dx, dw, part, rows, d, eps, nblocks, s);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    return launch_bwd<float, __nv_bfloat16>(x, w, dy, dx, dw, part, rows, d, eps, nblocks, s);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_bwd<__nv_bfloat16, float>(x, w, dy, dx, dw, part, rows, d, eps, nblocks, s);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, dy, dx, dw, part, rows, d, eps, nblocks, s);
  return cudaErrorInvalidValue;
}

// WKV6 recurrence forward for sm_90a.  Per (batch, head), from an optional
// fp32 state S (D x D, zeros when none is given), for t = 0 .. S-1:
//   y_t[e] = sum_d r_t[d] (S[d][e] + u[d] k_t[d] v_t[e])
//   S[d][e] <- S[d][e] exp(w_t[d]) + k_t[d] v_t[e]
// r, k, v (B, S, H, D) in one dtype (fp32 or bf16), w (the log-decay, < 0)
// (B, S, H, D) fp32, u (H, D) fp32 -> y (B, S, H, D) in r's dtype and the
// final state (B, H, D, D) fp32.  All arithmetic in fp32; w is never rounded.
//
// Replaces the TPU kernel of src/repro/kernels/rwkv6_wkv/kernel.py, wkv6_fwd
// (_wkv_kernel): there the (D, D) state sits in VMEM scratch and a
// sequential grid axis walks chunks of 64 tokens in the chunked-parallel
// form (pairwise decay matrices on the MXU).  Here the chain is walked token
// by token: the same function, summed in another order.
//
// Bound, rwkv6-3b serving (B 4, H 40, D 64), H100 SXM:
//   prefill (S 512, bf16 r/k/v): r, k, v 31.5 MB, w 21.0 MB, y 10.5 MB, the
//     state out 2.6 MB = 66 MB over 3.35 TB/s = 20 us; the recurrence does 5
//     fp32 operations per (t, d, e) (2 for y's multiply-add, 3 for the
//     decay, k v product and add) = 1.68 GFLOP over 67 TFLOP/s = 25 us:
//     operations, on CUDA cores, since the chain is fp32 throughout;
//   decode (S 1): the state read and written, 5.2 MB = 1.6 us: bytes.
//
// Two kernels, chosen by the Python wrapper (wkv6_path) and passed to the
// entry point as its `path`:
//
// kPathSplit (every input base 16-byte aligned, which TMA and the 16-byte
// loads need: every served call).  Column e of the state is updated from
// column e alone, so the columns split across blocks and the rows of a
// column across threads.  wkv6_split_kernel (S > 1): one block of 128
// threads per (b, h, 32 columns), 320 blocks at the serving shape.  A thread
// holds a 4 x 4 tile of the state (4 x D / 16 for smaller heads) in
// registers; the 16 threads of a column group are neighbouring lanes.  Per
// token and element it does what the reference does, fmaf(s, exp(w), k v)
// for the state and one multiply-add for y's partial sum over its rows; the
// u term is y += v[e] sum_d r[d] u[d] k[d], the sum taken once per token.
// Each token's partial sums go to shared memory (rows of a warp 4 banks
// apart), and once per chunk each lane adds up two (token, column) outputs
// over the 16 row groups and stores them.  Inputs arrive by TMA (4-D maps
// over the (B, S, H, D) strides: read in place, tokens past S zero-filled
// inside their own (b, h)) in chunks of 8 tokens into a ring of 3 stages
// completing on mbarriers; thread 0 refills a stage 3 chunks ahead once the
// block has read it.  Each chunk is transformed once per block into fp32 (r,
// k, exp(w), the block's v columns and the u term: one expf per (t, d), not
// per column), double-buffered, so one barrier per chunk suffices.
// wkv6_step_kernel (S 1, a decode step): the same tiles over 16 columns a
// block, every input read straight from device memory in one round trip.
// Moving the state sets its time: a plain copy of the state alone takes
// most of it (chip_smoke.py's decode_copy_device_ms).
//
// wkv6_kernel (kPathSimt; a base off the 16-byte grid): one block of D
// threads per (b, h); thread e keeps column e in registers and walks its
// d-sum alone, CHUNK tokens staged in shared memory per barrier.  About one
// block per SM, each a chain of S dependent steps: latency-bound.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

// ------------------------------------------------------------ split kernel
constexpr int STAGES = 3;       // chunks in flight

// A block takes CB state columns of one (b, h) and chunks of CH tokens; a
// thread a tile of R rows x C columns.  The G = D / R threads of a column
// group are neighbouring lanes; a warp holds WC columns.  P: floats of one
// lane's row of a warp's partial sums of y over a chunk, padded so that
// neighbouring rows start 4 banks apart.
template <int D> struct Split {
  static constexpr int CH = 8;
  static constexpr int CB = D < 32 ? D : 32;
  static constexpr int R = 4;
  static constexpr int C = D / 16;
  static constexpr int G = D / R;
  static constexpr int THREADS = G * CB / C;
  static constexpr int WC = 32 * C / G;
  static constexpr int P = CH * WC + 4;
};

template <typename T, int D>
struct Raw {                    // one chunk as TMA writes it, token-major
  static constexpr int CH = Split<D>::CH, CB = Split<D>::CB;
  T r[CH][D];
  T k[CH][D];
  float w[CH][D];
  T v[CH][CB];                  // the block's columns only
};

template <int D>
struct Xf {                     // one chunk in fp32, after the transform
  static constexpr int CH = Split<D>::CH, CB = Split<D>::CB;
  float r[CH][D];
  float k[CH][D];
  float ew[CH][D];              // exp(w)
  float v[CH][CB];
  float ruk[CH];                // sum_d r u k
};

template <typename T, int D>
constexpr int split_smem() {
  return STAGES * (int)sizeof(Raw<T, D>) + 2 * (int)sizeof(Xf<D>) +
         4 * Split<D>::THREADS / 32 * Split<D>::G * Split<D>::P + 8 * STAGES;
}

// N neighbouring elements (N = 1, 2 or 4; p aligned to their size) as
// floats, and back
template <int N>
__device__ __forceinline__ void ldn(const float* p, float (&f)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    f[0] = q.x; f[1] = q.y;
  } else {
    f[0] = *p;
  }
}
__device__ __forceinline__ float2 bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <int N>
__device__ __forceinline__ void ldn(const __nv_bfloat16* p, float (&f)[N]) {
  if constexpr (N == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = bf2(q.x), b = bf2(q.y);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a = bf2(*reinterpret_cast<const uint32_t*>(p));
    f[0] = a.x; f[1] = a.y;
  } else {
    f[0] = __bfloat162float(*p);
  }
}
template <int N>
__device__ __forceinline__ void stn(float* p, const float (&f)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *p = f[0];
  }
}

// two neighbouring outputs (p aligned to their size)
__device__ __forceinline__ void store2(float* p, const float (&f)[2]) {
  stn<2>(p, f);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float (&f)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::THREADS, 512 / Split<D>::THREADS)
wkv6_split_kernel(const __grid_constant__ CUtensorMap mr,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mw,
                  const float* __restrict__ u, const float* __restrict__ s_in,
                  T* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  constexpr int R = Split<D>::R, C = Split<D>::C, G = Split<D>::G;
  constexpr int CH = Split<D>::CH, CB = Split<D>::CB;
  constexpr int THREADS = Split<D>::THREADS;
  constexpr int CG = CB / C;          // column groups of a block
  constexpr int NCB = D / CB;         // blocks of a (b, h)
  constexpr int WC = Split<D>::WC, P = Split<D>::P;
  constexpr int K = CH * WC / 32;     // outputs of a lane a chunk
  static_assert(G <= 32 && 32 % G == 0 && K == 2 && P % 32 == 4, "layout");
  static_assert(CH % CG == 0 || (CH * G) % 32 == 0,
                "the transform's tokens must fall on whole warps");
  extern __shared__ __align__(128) unsigned char smem[];
  Raw<T, D>* raw = reinterpret_cast<Raw<T, D>*>(smem);
  Xf<D>* xf = reinterpret_cast<Xf<D>*>(raw + STAGES);
  float* part = reinterpret_cast<float*>(xf + 2);   // [warp][G][P]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + THREADS / 32 * G * P);

  const int cb0 = (blockIdx.x % NCB) * CB;
  const int bh = blockIdx.x / NCB, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, rg = tid % G, cg = tid / G;
  const int d0 = R * rg, e0 = cb0 + C * cg;   // this thread's first row, column
  const int lane = tid % 32, warp = tid / 32;
  float* wpart = part + warp * G * P;
  const int n_chunks = (S + CH - 1) / CH;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  const CUtensorMap *pr = &mr, *pk = &mk, *pv = &mv, *pw = &mw;
  auto issue = [&](int c) {           // thread 0: chunk c into its stage
    Raw<T, D>& st = raw[c % STAGES];
    uint64_t* bar = &full[c % STAGES];
    mbar_expect_tx(bar, sizeof(Raw<T, D>));
    tma_load_4d(st.r, pr, bar, 0, h, c * CH, b);
    tma_load_4d(st.k, pk, bar, 0, h, c * CH, b);
    tma_load_4d(st.w, pw, bar, 0, h, c * CH, b);
    tma_load_4d(st.v, pv, bar, cb0, h, c * CH, b);
  };
  if (tid == 0)
    for (int c = 0; c < min(STAGES, n_chunks); ++c) issue(c);

  float s[R][C];                      // s[i][c] = S[d0 + i][e0 + c]
  const int64_t sbase = (int64_t)bh * D * D + (int64_t)d0 * D + e0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (s_in) {
      ldn<C>(s_in + sbase + i * D, s[i]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = 0.f;
    }
  }
  float uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) uu[i] = u[h * D + d0 + i];

  // raw chunk -> fp32: thread (cg, rg) takes rows d0 .. d0 + R - 1 of tokens
  // cg, cg + CG, ..; the G threads of a token sum its u term by shuffles
  auto transform = [&](const Raw<T, D>& st, Xf<D>& x) {
#pragma unroll
    for (int i = 0; i < (CH + CG - 1) / CG; ++i) {
      const int t = cg + i * CG;
      if (CH % CG == 0 || t < CH) {   // whole warps (static_assert above)
        float rr[R], kk[R], ww[R], ew[R];
        ldn<R>(&st.r[t][d0], rr);
        ldn<R>(&st.k[t][d0], kk);
        ldn<R>(&st.w[t][d0], ww);
        float ruk = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          ew[j] = expf(ww[j]);
          ruk = fmaf(rr[j], uu[j] * kk[j], ruk);
        }
        stn<R>(&x.r[t][d0], rr);
        stn<R>(&x.k[t][d0], kk);
        stn<R>(&x.ew[t][d0], ew);
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          ruk += __shfl_xor_sync(0xffffffffu, ruk, o);
        if (rg == 0) x.ruk[t] = ruk;
      }
    }
    for (int q = tid; q < CH * CB / 4; q += THREADS) {
      float vv[4];
      ldn<4>(&st.v[q / (CB / 4)][4 * (q % (CB / 4))], vv);
      stn<4>(&x.v[q / (CB / 4)][4 * (q % (CB / 4))], vv);
    }
  };

  // token j of chunk x: y's C partial sums over this thread's rows, from
  // the state before the token, into row rg of the warp's partials; then
  // the update
  auto step = [&](const Xf<D>& x, int j) {
    float rr[R], kk[R], ew[R], vv[C], acc[C];
    ldn<R>(&x.r[j][d0], rr);
    ldn<R>(&x.k[j][d0], kk);
    ldn<R>(&x.ew[j][d0], ew);
    ldn<C>(&x.v[j][C * cg], vv);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float a = rr[0] * s[0][c];
#pragma unroll
      for (int i = 1; i < R; ++i) a = fmaf(rr[i], s[i][c], a);
      acc[c] = a;
    }
    stn<C>(wpart + rg * P + j * WC + C * (cg % (32 / G)), acc);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = fmaf(s[i][c], ew[i], kk[i] * vv[c]);
  };

  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(&full[c % STAGES], (c / STAGES) & 1);
    Xf<D>& x = xf[c & 1];
    transform(raw[c % STAGES], x);
    __syncthreads();    // x is whole; the stage, and the other x, are free
    if (tid == 0 && c + STAGES < n_chunks) issue(c + STAGES);
    const int t0 = c * CH;
    if (t0 + CH <= S) {
#pragma unroll
      for (int j = 0; j < CH; ++j) step(x, j);
    } else {                          // the last chunk, ragged
      for (int j = 0; j < S - t0; ++j) step(x, j);
    }
    // lane l sums K neighbouring (token, column) partials of the warp over
    // its G row groups: token j, columns col .. col + K - 1 of the warp's
    __syncwarp();
    const int idx = lane * K, j = idx / WC, col = idx % WC;
    float yv[K], part4[4][K] = {};   // four running sums, then their sum
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float pp[K];
      ldn<K>(wpart + g * P + idx, pp);
#pragma unroll
      for (int q = 0; q < K; ++q) part4[g % 4][q] += pp[q];
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
      yv[q] = (part4[0][q] + part4[1][q]) + (part4[2][q] + part4[3][q]);
    if (t0 + j < S) {
      const int e = warp * WC + col;  // in the block
#pragma unroll
      for (int q = 0; q < K; ++q) yv[q] = fmaf(x.v[j][e + q], x.ruk[j], yv[q]);
      store2(y + (((int64_t)b * S + t0 + j) * H + h) * D + cb0 + e, yv);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) stn<C>(s_out + sbase + i * D, s[i]);
}

// One token from a state (decode): a thread holds a 4 x D / 16 tile of the
// state, a block 16 columns (640 blocks at the serving shape); every input
// is read straight from device memory (the state in 16-byte words, spread
// over all threads) in one round trip, with no staging and no barrier.  y in
// the reference's form, sum_d r (S + u k v).
constexpr int STEP_CB = 16;
constexpr int STEP_THREADS = 4 * STEP_CB;

template <typename T, int D>
__global__ void __launch_bounds__(STEP_THREADS, 512 / STEP_THREADS)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s_in,
                 T* __restrict__ y, float* __restrict__ s_out, int H) {
  constexpr int R = 4, C = D / 16, G = D / R;
  constexpr int CB = STEP_CB, NCB = D / CB;
  static_assert(G * CB / C == STEP_THREADS, "layout");
  const int cb0 = (blockIdx.x % NCB) * CB;
  const int bh = blockIdx.x / NCB, b = bh / H, h = bh % H;
  const int rg = threadIdx.x % G, cg = threadIdx.x / G;
  const int d0 = R * rg, e0 = cb0 + C * cg;
  float s[R][C], uu[R];
  const int64_t sbase = (int64_t)bh * D * D + (int64_t)d0 * D + e0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    uu[i] = u[h * D + d0 + i];
    if (s_in) {
      ldn<C>(s_in + sbase + i * D, s[i]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = 0.f;
    }
  }
  const int64_t o = ((int64_t)b * H + h) * D;      // (b, 0, h, 0)
  float rr[R], kk[R], ww[R], vv[C], acc[C];
  ldn<R>(r + o + d0, rr);
  ldn<R>(k + o + d0, kk);
  ldn<R>(w + o + d0, ww);
  ldn<C>(v + o + e0, vv);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i)
      acc[c] = fmaf(rr[i], fmaf(uu[i] * kk[i], vv[c], s[i][c]), acc[c]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float ew = expf(ww[i]);
#pragma unroll
    for (int c = 0; c < C; ++c) s[i][c] = fmaf(s[i][c], ew, kk[i] * vv[c]);
  }
  // the C sums over the column group's lanes; lane c < C stores column c
  float yv = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], m);
    if (rg == c) yv = acc[c];
  }
  if (rg < C) y[o + e0 + rg] = from_f<T>(yv);
#pragma unroll
  for (int i = 0; i < R; ++i) stn<C>(s_out + sbase + i * D, s[i]);
}

template <typename T, int D>
cudaError_t launch_split(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s_in,
                         void* y, void* s_out, int B, int S, int H,
                         cudaStream_t stream) {
  constexpr int CH = Split<D>::CH, CB = Split<D>::CB;
  if (S == 1) {                       // a decode step
    wkv6_step_kernel<T, D><<<B * H * (D / STEP_CB), STEP_THREADS, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s_in),
        static_cast<T*>(y), static_cast<float*>(s_out), H);
    return cudaGetLastError();
  }
  constexpr int smem = split_smem<T, D>();
  static const cudaError_t attr = cudaFuncSetAttribute(    // once per instance
      wkv6_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  constexpr CUtensorMapDataType TT = std::is_same<T, float>::value
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  auto map = [&](CUtensorMap* m, const void* p, CUtensorMapDataType type,
                 uint64_t elem, uint32_t width) {
    const uint64_t strides[3] = {elem * D, elem * H * D, elem * S * H * D};
    const uint32_t box[4] = {width, 1, CH, 1};
    return make_map(m, type, CU_TENSOR_MAP_SWIZZLE_NONE, 4, p, dims, strides,
                    box);
  };
  CUtensorMap mr, mk, mv, mw;
  cudaError_t err;
  if ((err = map(&mr, r, TT, sizeof(T), D)) != cudaSuccess) return err;
  if ((err = map(&mk, k, TT, sizeof(T), D)) != cudaSuccess) return err;
  if ((err = map(&mv, v, TT, sizeof(T), CB)) != cudaSuccess) return err;
  if ((err = map(&mw, w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D)) != cudaSuccess)
    return err;
  wkv6_split_kernel<T, D><<<B * H * (D / CB), Split<D>::THREADS, smem, stream>>>(
      mr, mk, mv, mw, static_cast<const float*>(u),
      static_cast<const float*>(s_in), static_cast<T*>(y),
      static_cast<float*>(s_out), S, H);
  return cudaGetLastError();
}

// ------------------------------------------------------ one column a thread
constexpr int CHUNK = 16;       // tokens staged per barrier

template <int D>
struct Stage {                  // one chunk, token-major, fp32
  float r[CHUNK][D];
  float k[CHUNK][D];
  float uk[CHUNK][D];           // u * k
  float ew[CHUNK][D];           // exp(w)
  float v[CHUNK][D];
};

template <typename T, int D>
__global__ void __launch_bounds__(D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s_in,
            T* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  __shared__ __align__(16) Stage<D> st[2];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int e = threadIdx.x;    // state column, output lane and staging lane
  const int64_t base = ((int64_t)b * S * H + h) * D + e;   // (b, 0, h, e)
  const int64_t tstep = (int64_t)H * D;                    // one token
  const float ue = u[h * D + e];

  float s[D];                   // s[d] = S[d][e]
  const int64_t sbase = (int64_t)bh * D * D + e;
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = s_in ? s_in[sbase + (int64_t)d * D] : 0.f;

  // lane e of the next chunk's tokens, raw, in flight during a chunk
  T pr[CHUNK], pk[CHUNK], pv[CHUNK];
  float pw[CHUNK];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (t0 + j < S) {
        const int64_t i = base + (int64_t)(t0 + j) * tstep;
        pr[j] = r[i];
        pk[j] = k[i];
        pv[j] = v[i];
        pw[j] = w[i];
      } else {                  // past the end: staged, never read
        pr[j] = pk[j] = pv[j] = from_f<T>(0.f);
        pw[j] = 0.f;
      }
    }
  };
  auto stage = [&](Stage<D>& sb) {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float kk = to_f(pk[j]);
      sb.r[j][e] = to_f(pr[j]);
      sb.k[j][e] = kk;
      sb.uk[j][e] = ue * kk;
      sb.ew[j][e] = expf(pw[j]);
      sb.v[j][e] = to_f(pv[j]);
    }
  };

  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  fetch(0);
  stage(st[0]);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    if (more) fetch((c + 1) * CHUNK);
    const Stage<D>& sb = st[c & 1];
    const int t0 = c * CHUNK;
    const int n = min(CHUNK, S - t0);
    for (int j = 0; j < n; ++j) {
      const float ve = sb.v[j][e];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&sb.r[j][d]);
        const float4 kk = *reinterpret_cast<const float4*>(&sb.k[j][d]);
        const float4 uk = *reinterpret_cast<const float4*>(&sb.uk[j][d]);
        const float4 ew = *reinterpret_cast<const float4*>(&sb.ew[j][d]);
        acc[0] = fmaf(rr.x, fmaf(uk.x, ve, s[d + 0]), acc[0]);
        acc[1] = fmaf(rr.y, fmaf(uk.y, ve, s[d + 1]), acc[1]);
        acc[2] = fmaf(rr.z, fmaf(uk.z, ve, s[d + 2]), acc[2]);
        acc[3] = fmaf(rr.w, fmaf(uk.w, ve, s[d + 3]), acc[3]);
        s[d + 0] = fmaf(s[d + 0], ew.x, kk.x * ve);
        s[d + 1] = fmaf(s[d + 1], ew.y, kk.y * ve);
        s[d + 2] = fmaf(s[d + 2], ew.z, kk.z * ve);
        s[d + 3] = fmaf(s[d + 3], ew.w, kk.w * ve);
      }
      y[base + (int64_t)(t0 + j) * tstep] =
          from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    if (more) stage(st[(c + 1) & 1]);
    __syncthreads();            // the next chunk is staged; this one is free
  }
#pragma unroll
  for (int d = 0; d < D; ++d) s_out[sbase + (int64_t)d * D] = s[d];
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s_in, void* y, void* s_out,
                   int B, int S, int H, cudaStream_t stream) {
  wkv6_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s_in),
      static_cast<T*>(y), static_cast<float*>(s_out), S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int path, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s_in, void* y,
                     void* s_out, int B, int S, int H, int D,
                     cudaStream_t stream) {
  if (path == kPathSplit) {
    switch (D) {
      case 16: return launch_split<T, 16>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
      case 32: return launch_split<T, 32>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
      case 64: return launch_split<T, 64>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path == kPathSimt) {
    switch (D) {
      case 16: return launch<T, 16>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
      case 32: return launch<T, 32>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
      case 64: return launch<T, 64>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

EXPORT_ERROR_STRING

// r, k, v, w, y (B, S, H, D); u (H, D); s_in (optional, may be null) and
// s_out (B, H, D, D): contiguous.  dtype is r's, k's, v's and y's.  path:
// the kernel to launch, as the Python wrapper chose it: kPathSplit (every
// base 16-byte aligned; TMA refuses the rest with cudaErrorInvalidValue) or
// kPathSimt (any base).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s_in,
                        void* y, void* s_out, int dtype, int B, int S, int H,
                        int D, void* stream, int path) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return dispatch<float>(path, r, k, v, w, u, s_in, y, s_out, B, S, H, D, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(path, r, k, v, w, u, s_in, y, s_out, B, S, H, D, s);
  return cudaErrorInvalidValue;
}

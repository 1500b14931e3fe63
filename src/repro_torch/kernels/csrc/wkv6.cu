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
// by token and has no chunk: the same function, summed in another order.
//
// Bound, rwkv6-3b serving (B 4, H 40, D 64), H100 SXM:
//   prefill (S 512, bf16 r/k/v): r, k, v 31.5 MB, w 21.0 MB, y 10.5 MB, the
//     state in and out 5.2 MB = 68 MB over 3.35 TB/s = 20 us; the recurrence
//     does 5 fp32 operations per (t, d, e) (2 for y's multiply-add, 3 for
//     the decay, k v product and add) = 1.68 GFLOP over 67 TFLOP/s = 25 us:
//     operations, on CUDA cores, since the chain is fp32 throughout;
//   decode (S 1): the state read and written, 5.2 MB = 1.6 us: bytes.
// Neither is what limits this kernel: B H = 160 blocks of D = 64 threads is
// about one block per SM, each a chain of S dependent steps, so the time is
// S times the latency of one step (about D fused multiply-adds per thread
// and one shared-memory pass).  It is latency-bound, far from both bounds.
//
// Design: one block per (b, h) with D threads; thread e keeps column e of
// the state in registers (D floats) and computes y_t[e].  The D threads
// stage the inputs of CHUNK tokens at a time into shared memory (lane d of
// each token: r, k, u k, exp(w) and v in fp32), double-buffered: the global
// loads of chunk c+1 are issued into registers before chunk c is computed
// and written to the other buffer after it, so one barrier per chunk
// suffices and a load's latency hides behind CHUNK steps.  A per-token
// barrier would expose one global-load latency per token.  Every thread
// reads the same shared word at once (a broadcast), as float4.  Inputs are
// read in place through the (B, S, H, D) strides: element (b, t, h, d) is at
// ((b S + t) H + h) D + d, with no transpose, padding or copy; a ragged S
// just ends the last chunk early.
//
// Next (a later PR): split the d-sum of each column over several threads
// (shuffle-reduced), so that a step is shorter and more warps hide latency;
// or a chunked tensor-core form.
#include "common.cuh"

namespace {

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
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s_in, void* y,
                     void* s_out, int B, int S, int H, int D,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s_in, y, s_out, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

EXPORT_ERROR_STRING

// r, k, v, w, y (B, S, H, D); u (H, D); s_in (optional, may be null) and
// s_out (B, H, D, D): contiguous.  dtype is r's, k's, v's and y's.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s_in,
                        void* y, void* s_out, int dtype, int B, int S, int H,
                        int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return dispatch<float>(r, k, v, w, u, s_in, y, s_out, B, S, H, D, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s_in, y, s_out, B, S, H, D, s);
  return cudaErrorInvalidValue;
}

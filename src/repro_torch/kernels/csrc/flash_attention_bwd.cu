// Flash attention backward for sm_90a: dQ, dK and dV of
// O = softmax(Q K^T * D^-1/2 + causal/window mask) V from Q, K, V, O, the
// forward's fp32 log-sum-exp per row (lse = m + log l) and dO, grouped-query
// heads read in place.
//
// The TPU kernel (src/repro/kernels/flash_attention/kernel.py,
// flash_attention_fwd) has no backward: the JAX package differentiates its
// plain online-softmax form (models/attention.py, sdpa_flash) with XLA.
// This is the port's own backward of the same function, held against
// autograd of the plain version (kernels/flash_attention/ref.py).
//
// Bound: operations.  At the training shape (B 2, S 4096, H 32/8, D 128,
// bf16, causal) the backward is five matrix products over the causal half of
// each (S, S) score matrix, 5 B H S^2 D = 687 GFLOP, 0.69 ms at 989 TFLOP/s
// on the tensor cores, against 151 MB moved (0.05 ms).  These kernels run on
// the fp32 CUDA cores (67 TFLOP/s, so at least 10 ms there) and recompute S
// and dP a second time for dQ (seven products): a simple, correct first
// version; tensor cores (wgmma, TMA) are the later redesign's work.
//
// Three kernels, launched in order by the entry point:
//
// fa_bwd_dot_kernel: delta_i = rowsum(dO_i * O_i) in fp32, a warp a row,
// into (B, H, Sq) beside lse.
//
// fa_bwd_dkdv_kernel: one block of 256 threads per (K tile of 64 keys, kv
// head, batch).  K and V stay in shared memory (fp32) while the block walks
// every query tile that can see its keys, for each of the G query heads of
// the kv head's group in turn, so the group's sum of dK and dV stays in
// registers on the chip: no atomics, and the result does not depend on the
// order blocks run in.  Per query tile: S^T = K Q^T and dP^T = V dO^T (a 4 x 4
// tile of each per thread), P = exp(S D^-1/2 - lse), dS = P (dP - delta) where
// the key is visible (0 where it is masked, since the mask blocks the
// gradient); P (rounded to V's dtype, as the forward rounds it before P V)
// and dS go to shared memory, then dV += P^T dO and dK += dS^T Q (4 keys x
// D/16 columns per thread).
//
// fa_bwd_dq_kernel: one block per (Q tile of 64 queries, head, batch),
// walking the key tiles its queries see: S and dP again, dS to shared memory,
// dQ += dS K.
//
// Conventions follow the forward: masked scores are -1e30 (keys past Sk do
// not exist), and P = exp(score - lse).  For a row that sees no key at all
// the forward's lse is -1e30 and P is 1 for every key its tiles visited, as
// the plain backward computes it; the autograd function refuses inputs that
// make such rows, whose gradient the plain forward's would not match.
#include "common.cuh"

namespace {

constexpr int BQ = 64;            // queries per tile
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 256;
constexpr float NEG_BIG = -1e30f;

// ------------------------------------------------------------ delta pass
template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ delta, int64_t rows, int Sq, int H,
                  int D) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                  // whole warps leave together
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(op[d]), to_f(dp[d]), s);
  s = sum32(s);
  if (lane == 0) {                          // row = (b Sq + i) H + h
    const int64_t h = row % H, bi = row / H, i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = s;
  }
}

// Shared memory of both tile kernels, in floats: four (64, D + 1) tiles
// (padded rows: a column read across lanes hits distinct banks), two
// (64, 65) score tiles, lse and delta of the query tile.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * (BQ + 1) + 2 * BQ);
}

// rows [r0, r0 + 64) of a (B, S, heads, D) contiguous tensor at (b, h) into
// a (64, D + 1) fp32 tile; rows past S read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int h, int r0, int S,
                                          int heads) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int row = e / D, d = e % D, r = r0 + row;
    dst[row * (D + 1) + d] =
        r < S ? to_f(src[(((int64_t)b * S + r) * heads + h) * D + d]) : 0.f;
  }
}

// key kj visible to the query at position qpos
__device__ __forceinline__ bool visible(int kj, int qpos, int causal,
                                        int window) {
  return (!causal || kj <= qpos) && (window <= 0 || kj > qpos - window);
}

// ------------------------------------------------------------ dK and dV
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int Sq, int Sk, int H, int kvH,
                   int causal, int window, int q_offset, float scale) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * DP;
  float* Qs = Vs + 64 * DP;
  float* dOs = Qs + 64 * DP;
  float* Ps = dOs + 64 * DP;                // (key, query), P rounded to T
  float* dSs = Ps + 64 * (BQ + 1);          // (key, query)
  float* lse_s = dSs + 64 * (BQ + 1);
  float* dl_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / kvH, tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;   // score tile: keys tr + 16 i,
  //                                           queries tc + 16 j
  load_tile<T, D>(Ks, k, b, kh, k0, Sk, kvH);
  load_tile<T, D>(Vs, v, b, kh, k0, Sk, kvH);

  // queries that see some key of this tile: causal from the tile's first
  // key on, a window up to its last key + window - 1
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k0 + BK - 1 + window - q_offset);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();                      // the last tile's reads are done
      load_tile<T, D>(Qs, q, b, h, q0, Sq, H);
      load_tile<T, D>(dOs, dout, b, h, q0, Sq, H);
      if (tid < BQ) {
        const int qi = q0 + tid;
        const int64_t at = ((int64_t)b * H + h) * Sq + qi;
        lse_s[tid] = qi < Sq ? lse[at] : 0.f;
        dl_s[tid] = qi < Sq ? delta[at] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(tr + 16 * i) * DP + d];
          vv[i] = Vs[(tr + 16 * i) * DP + d];
          qv[i] = Qs[(tc + 16 * i) * DP + d];
          ov[i] = dOs[(tc + 16 * i) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = tr + 16 * i, kj = k0 + kr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tc + 16 * j, qi = q0 + qr;
          const bool live = kj < Sk && qi < Sq;
          const bool vis = live && visible(kj, qi + q_offset, causal, window);
          const float p =
              live ? expf((vis ? s[i][j] * scale : NEG_BIG) - lse_s[qr]) : 0.f;
          Ps[kr * (BQ + 1) + qr] = to_f(from_f<T>(p));
          dSs[kr * (BQ + 1) + qr] = vis ? p * (dp[i][j] - dl_s[qr]) : 0.f;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: keys tr + 16 i, columns tc + 16 jj
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], sv[4], ov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(tr + 16 * i) * (BQ + 1) + qq];
          sv[i] = dSs[(tr + 16 * i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          ov[jj] = dOs[qq * DP + tc + 16 * jj];
          qv[jj] = Qs[qq * DP + tc + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DC; ++jj) {
            acc_v[i][jj] = fmaf(pv[i], ov[jj], acc_v[i][jj]);
            acc_k[i][jj] = fmaf(sv[i], qv[jj], acc_k[i][jj]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + tr + 16 * i;
    if (kj >= Sk) continue;
    const int64_t base = (((int64_t)b * Sk + kj) * kvH + kh) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dk[base + tc + 16 * jj] = from_f<T>(acc_k[i][jj] * scale);
      dv[base + tc + 16 * jj] = from_f<T>(acc_v[i][jj]);
    }
  }
}

// ------------------------------------------------------------------ dQ
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                 int Sk, int H, int kvH, int causal, int window, int q_offset,
                 float scale) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * DP;
  float* Ks = dOs + 64 * DP;
  float* Vs = Ks + 64 * DP;
  float* dSs = Vs + 64 * DP;                // (query, key)
  float* lse_s = dSs + 2 * 64 * (BK + 1);   // past the space of two tiles
  float* dl_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / kvH), tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;   // score tile: queries tr + 16 i,
  //                                           keys tc + 16 j
  load_tile<T, D>(Qs, q, b, h, q0, Sq, H);
  load_tile<T, D>(dOs, dout, b, h, q0, Sq, H);
  if (tid < BQ) {
    const int qi = q0 + tid;
    const int64_t at = ((int64_t)b * H + h) * Sq + qi;
    lse_s[tid] = qi < Sq ? lse[at] : 0.f;
    dl_s[tid] = qi < Sq ? delta[at] : 0.f;
  }

  // keys the tile's queries see: causal up to the last query's position,
  // a window from the first query's position - window + 1
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BQ + q_offset);
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                        // the last tile's reads are done
    load_tile<T, D>(Ks, k, b, kh, k0, Sk, kvH);
    load_tile<T, D>(Vs, v, b, kh, k0, Sk, kvH);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(tr + 16 * i) * DP + d];
        ov[i] = dOs[(tr + 16 * i) * DP + d];
        kv[i] = Ks[(tc + 16 * i) * DP + d];
        vv[i] = Vs[(tc + 16 * i) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = tr + 16 * i, qi = q0 + qr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tc + 16 * j, kj = k0 + kc;
        const bool vis = kj < Sk && qi < Sq &&
                         visible(kj, qi + q_offset, causal, window);
        const float p = vis ? expf(s[i][j] * scale - lse_s[qr]) : 0.f;
        dSs[qr * (BK + 1) + kc] = p * (dp[i][j] - dl_s[qr]);
      }
    }
    __syncthreads();

    // dQ += dS K: queries tr + 16 i, columns tc + 16 jj
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(tr + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) kv[jj] = Ks[kk * DP + tc + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(sv[i], kv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    const int64_t base = (((int64_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      dq[base + tc + 16 * jj] = from_f<T>(acc[i][jj] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int B, int Sq, int Sk, int H, int kvH,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = [] {     // once per instance
    cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(fa_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }();
  if (attr != cudaSuccess) return attr;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int64_t rows = (int64_t)B * Sq * H;
  const int64_t dot_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  fa_bwd_dot_kernel<T><<<dot_blocks, THREADS, 0, s>>>(
      static_cast<const T*>(o), dop, delta, rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<T, D><<<dim3((Sk + BK - 1) / BK, kvH, B), THREADS, smem, s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, kvH, causal, window, q_offset, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_kernel<T, D><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, smem, s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Sq, Sk, H, kvH, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                     int Sk, int H, int kvH, int causal, int window,
                     int q_offset, float scale, cudaStream_t s) {
  if (D == 16) return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  if (D == 32) return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  if (D == 64) return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  if (D == 128) return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

EXPORT_ERROR_STRING

// q, o, dout, dq: (B, Sq, H, D) contiguous; k, v, dk, dv: (B, Sk, kvH, D)
// contiguous; lse (the forward's) and delta (scratch, written here): (B, H,
// Sq) fp32.  One dtype for q, k, v, o, dout and the gradients; D 16, 32, 64
// or 128; H a multiple of kvH.  Launches the three kernels on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Sq,
                                   int Sk, int H, int kvH, int D, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvH <= 0 || H % kvH) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_d<float>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

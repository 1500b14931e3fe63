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
// on the tensor cores, against 151 MB moved (0.05 ms).  Both paths below
// recompute S and dP a second time for dQ (seven products, 962 GFLOP, 0.97
// ms at that rate): each gradient is summed in registers by the one block
// that owns it, in a fixed order, so there are no atomics and every run
// gives the same bits.
//
// Two paths, chosen by dtype and head size before launch (by the Python
// wrapper, flash_bwd_path, which passes its choice to the entry point),
// each three kernels launched in order:
//
// "wgmma" (bf16, D 64 or 128; every trained model), on the tensor cores:
//
// fa_bwd_dot_kernel: delta_i = rowsum(dO_i * O_i) and lse_i log2 e, into
// (B, H, Sp) fp32 planes whose rows are padded with zeros to Sp, a multiple
// of 128, so that the kernels below copy 64 of them at a time by TMA.
//
// fa_bwd_dkdv_wgmma: one block per (kv head, batch, 128 keys) of two
// consumer warpgroups (64 keys each) and a producer warpgroup.  The producer
// loads the block's K and V once, then streams tiles of 64 queries of Q and
// dO (4-D TMA maps over (B, S, H, D): rows past Sq are zero-filled) with
// their lse and delta through a three-stage ring, over every query tile
// that sees a key of the block and over all G query heads of the group, so
// that the group's dK and dV stay summed in registers.  A consumer computes
// S^T = K Q^T and dP^T = V dO^T with wgmma from shared memory (both
// operands K-major: d is contiguous), then in registers P^T = exp2(S^T D^-1/2
// log2 e - lse log2 e) and dS^T = P^T (dP^T - delta), where lse and delta
// belong to the accumulator's columns (the queries), and packs P^T and dS^T
// to bf16 in the accumulator layout, which is the A-operand layout of the
// next wgmma: dV += P^T dO and dK += dS^T Q, B = the dO or Q tile,
// MN-major.  At D 128 the accumulators dK, dV (64 fp32 registers a thread
// each), S^T and dP^T (32 each) need more registers than a third of the
// file: the producer gives its own up (setmaxnreg), the consumers take 240.
// dK is scaled by D^-1/2 at the end; dK and dV are rounded, staged in the
// block's K and V tiles and written by TMA stores that clip at Sk.
//
// fa_bwd_dq_wgmma: one block per (head, batch, 128 queries) of two consumer
// warpgroups and a producer warpgroup (setmaxnreg as above); the longest query tiles (causal) first.
// Q and dO are loaded once; K and V tiles of 64 keys stream through
// three-stage rings with a barrier each.  S = Q K^T and dP = dO V^T (wgmma,
// K-major), dS = P (dP - delta) in registers with this thread's two rows'
// lse and delta, then dQ += dS K (B = the K tile, MN-major).  The two
// warpgroups take turns to issue their products, as the forward's do: a
// turn issues dQ += dS_{t-1} K_{t-1} and S_t, dP_t, so one warpgroup's
// exponentials run while the other's products keep the tensor cores busy.
// A V stage is free once dP is done, a K stage once dQ's product is.
//
// Both wgmma kernels mask only the tiles where some (query, key) pair is
// hidden by the causal or window condition (and, in dQ, where keys pass
// Sk); elsewhere a query past Sq has zero Q and dO rows and zero lse and
// delta, so it adds exactly 0, and a key past Sk owns only rows of dK and
// dV that the stores drop.  dS is rounded to bf16 as the A operand of its
// product (the plain backward keeps it fp32: about 2^-9 relative per
// term); P is rounded to bf16 for dV, as the forward rounds it before P V.
//
// "simt" (fp32, which must not round to TF32 or bf16, and D 16 or 32), on
// the fp32 CUDA cores:
//
// fa_bwd_dot_kernel as above, into (B, H, Sq) beside lse, unpadded.
//
// fa_bwd_dkdv_kernel: one block of 256 threads per (K tile of 64 keys, kv
// head, batch).  K and V stay in shared memory (fp32) while the block walks
// every query tile that can see its keys, for each of the G query heads of
// the kv head's group in turn.  Per query tile: S^T = K Q^T and dP^T = V dO^T
// (a 4 x 4 tile of each per thread), P = exp(S D^-1/2 - lse), dS = P (dP -
// delta) where the key is visible (0 where it is masked, since the mask
// blocks the gradient); P (rounded to V's dtype) and dS go to shared memory,
// then dV += P^T dO and dK += dS^T Q (4 keys x D/16 columns per thread).
//
// fa_bwd_dq_kernel: one block per (Q tile of 64 queries, head, batch),
// walking the key tiles its queries see: S and dP again, dS to shared memory,
// dQ += dS K.
//
// Conventions follow the forward: masked scores are -1e30 (keys past Sk do
// not exist), and P = exp(score - lse).  For a row that sees no key at all
// the forward's lse is -1e30 and P is 1 for every key, as the plain backward
// computes it: where some row sees no key the wgmma dK/dV kernel visits
// every query tile, so that such a row adds its dO to dV of every key (the
// simt kernel only for the keys of the tiles it visits).  The autograd
// function refuses inputs that make such rows, whose gradient the plain
// forward's would not match.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // queries per tile
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 256;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------ delta pass
// rows (b, i, h) for i < Sp, a warp a row: delta and (where lse2 is given)
// lse log2 e into (B, H, Sp) planes, 0 for the rows from Sq to Sp
template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  float* __restrict__ lse2, int64_t rows, int Sq, int Sp,
                  int H, int D) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                  // whole warps leave together
  const int64_t h = row % H, bi = row / H, i = bi % Sp, b = bi / Sp;
  float s = 0.f;
  if (i < Sq) {                             // the same for the whole warp
    const int64_t at = ((b * Sq + i) * H + h) * D;
    for (int d = lane; d < D; d += 32)
      s = fmaf(to_f(o[at + d]), to_f(dout[at + d]), s);
    s = sum32(s);
  }
  if (lane == 0) {
    const int64_t at = (b * H + h) * Sp + i;
    delta[at] = s;
    if (lse2) lse2[at] = i < Sq ? lse[(b * H + h) * Sq + i] * LOG2E : 0.f;
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
                   const void* dout, float* delta, const float* lse, void* dq,
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
      static_cast<const T*>(o), dop, nullptr, delta, nullptr, rows, Sq, Sq, H,
      D);
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
                     const void* o, const void* dout, float* delta,
                     const float* lse, void* dq, void* dk, void* dv, int B,
                     int Sq, int Sk, int H, int kvH, int causal, int window,
                     int q_offset, float scale, cudaStream_t s) {
  if (D == 16) return launch<T, 16>(q, k, v, o, dout, delta, lse, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  if (D == 32) return launch<T, 32>(q, k, v, o, dout, delta, lse, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  if (D == 64) return launch<T, 64>(q, k, v, o, dout, delta, lse, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  if (D == 128) return launch<T, 128>(q, k, v, o, dout, delta, lse, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------- bf16, wgmma + TMA
constexpr int W_ROWS = 128;       // keys (dK/dV) or queries (dQ) of a block:
//                                   two consumer warpgroups of 64
constexpr int W_TILE = 64;        // queries (dK/dV) or keys (dQ) a ring stage
constexpr int W_STAGES = 3;
// two consumer warpgroups and a producer warpgroup, whose registers
// setmaxnreg moves to the consumers (ptxas sizes a wgmma kernel's entry for
// whole warpgroups: 168 registers a thread at 384 threads, also at 288)
constexpr int W_THREADS = 384;
constexpr float NEG_BIG2 = NEG_BIG * LOG2E;   // a masked score, in base 2

template <int D>
struct BwdTile {
  static constexpr int HALVES = D / 64;                   // 64-wide boxes
  static constexpr int FIXED = W_ROWS * 128 * HALVES;     // K or V; Q or dO
  static constexpr int STREAM = W_TILE * 128 * HALVES;    // one per stage
  static constexpr int STAGE = 2 * STREAM;
  static constexpr int STATS = 2 * W_TILE * 4;            // lse2, delta
  // 1024 bytes of slack to align the tiles, then the stats, the barriers
  static constexpr size_t SMEM =
      1024 + 2 * FIXED + W_STAGES * (STAGE + STATS) + 128;
};

// P^T and dS^T of one (64 keys, 64 queries) tile in registers, packed to
// bf16 pairs as wgmma's A operand (k16 step kk: queries 16 kk + [0, 16),
// accumulator columns j = 2 kk and 2 kk + 1).  Accumulator element 4j + 2i
// + c of a thread is key kj0 + 8 i, query qc0 + 8 j + c; st holds the
// tile's lse log2 e and (after W_TILE) delta by query, from this thread's
// first column on.  sc and dp are only read.  EDGE: the tile holds a pair
// that the causal or window condition hides (with the simt kernel's
// conventions for pairs past Sq or Sk); without it, no masking code.
template <bool EDGE>
__device__ __forceinline__ void dkdv_tile(
    const float (&sc)[W_TILE / 2], const float (&dp)[W_TILE / 2],
    uint32_t (&pa)[W_TILE / 16][4], uint32_t (&da)[W_TILE / 16][4],
    const float* st, int kj0, int qc0, int Sq, int Sk, int causal, int window,
    int q_offset, float scale_log2) {
#pragma unroll
  for (int j = 0; j < W_TILE / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j);
    const float2 dl = *reinterpret_cast<const float2*>(st + W_TILE + 8 * j);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lc = c ? l2.y : l2.x, dc = c ? dl.y : dl.x;
        const int e = 4 * j + 2 * i + c;
        p[c] = exp2f(fmaf(sc[e], scale_log2, -lc));
        ds[c] = p[c] * (dp[e] - dc);
        if (EDGE) {
          const int kj = kj0 + 8 * i, qi = qc0 + 8 * j + c;
          const bool live = kj < Sk && qi < Sq;
          if (!(live && visible(kj, qi + q_offset, causal, window))) {
            // exp(-1e30 - lse): 1 for a row that sees no key (lse -1e30),
            // else 0
            p[c] = live && lc < 0.5f * NEG_BIG2 ? 1.f : 0.f;
            ds[c] = 0.f;
          }
        }
      }
      pa[j / 2][2 * (j % 2) + i] = pack_bf16(p[0], p[1]);
      da[j / 2][2 * (j % 2) + i] = pack_bf16(ds[0], ds[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mdo,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mdk,
                  const __grid_constant__ CUtensorMap mdv,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta, int Sq, int Sk, int Sp,
                  int H, int group, int causal, int window, int q_offset,
                  int blind, float scale) {
  using Tile = BwdTile<D>;
  constexpr int HALVES = Tile::HALVES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Ks = smem;                      // HALVES boxes of W_ROWS rows
  unsigned char* Vs = Ks + Tile::FIXED;
  unsigned char* ring = Vs + Tile::FIXED;        // per stage: Q boxes, dO boxes
  float* stats = reinterpret_cast<float*>(ring + W_STAGES * Tile::STAGE);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(stats) + W_STAGES * Tile::STATS);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + W_STAGES;

  // blocks start in index order: the first keys (causal: the most query
  // tiles) first, every kv head and batch side by side
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * W_ROWS;
  // query tiles that see some key of the block (every tile where some row
  // sees no key at all: its P is 1 for every key), on the 64-row grid
  int q_lo = 0, q_hi = Sq;
  if (!blind) {
    if (causal) q_lo = max(0, k0 - q_offset);
    if (window > 0)
      q_hi = min(Sq, min(k0 + W_ROWS, Sk) - 1 + window - q_offset);
  }
  q_lo = q_lo / W_TILE * W_TILE;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + W_TILE - 1) / W_TILE : 0;
  const int n_tiles = group * n_q;           // all G heads of the group

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);       // every consumer warp releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {                     // producer: one thread issues TMA
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_bar, 2 * Tile::FIXED);
#pragma unroll
      for (int j = 0; j < HALVES; ++j) {
        tma_load_4d(Ks + j * W_ROWS * 128, &mk, kv_bar, 64 * j, kh, k0, b);
        tma_load_4d(Vs + j * W_ROWS * 128, &mv, kv_bar, 64 * j, kh, k0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % W_STAGES, h = kh * group + t / n_q;
        const int q0 = q_lo + (t % n_q) * W_TILE;
        unsigned char* qs = ring + s * Tile::STAGE;
        unsigned char* dos = qs + Tile::STREAM;
        float* st = stats + s * 2 * W_TILE;
        const int64_t at = ((int64_t)b * H + h) * Sp + q0;
        if (t >= W_STAGES) mbar_wait(&empty[s], (t / W_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], Tile::STAGE + Tile::STATS);
#pragma unroll
        for (int j = 0; j < HALVES; ++j) {
          tma_load_4d(qs + j * W_TILE * 128, &mq, &full[s], 64 * j, h, q0, b);
          tma_load_4d(dos + j * W_TILE * 128, &mdo, &full[s], 64 * j, h, q0, b);
        }
        bulk_load(st, lse2 + at, W_TILE * 4, &full[s]);
        bulk_load(st + W_TILE, delta + at, W_TILE * 4, &full[s]);
      }
    }
  } else {
    // consumer warpgroup wg: keys k0 + 64 wg + [0, 64).  Accumulator
    // element 4j + 2i + c of a thread is row 16 warp + lane / 4 + 8 i,
    // column 8 j + 2 (lane % 4) + c.
    reg_alloc<240>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int row_l = 16 * warp + (lane >> 2);        // + 8 i
    const int col_l = 2 * (lane & 3);                 // + 8 j + c
    const int kw0 = k0 + 64 * wg;                     // first key
    const float scale_log2 = scale * LOG2E;
    unsigned char* k_own = Ks + wg * BOX;             // this warpgroup's rows
    unsigned char* v_own = Vs + wg * BOX;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float sc[W_TILE / 2], dp[W_TILE / 2];
    uint32_t pa[W_TILE / 16][4], da[W_TILE / 16][4];
    // pins the registers the products read and write in place around the
    // issue, so that ptxas keeps products in flight instead of serializing
    auto fence_operands = [&] {
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < W_TILE / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
    };

    mbar_wait(kv_bar, 0);   // also before the epilogue overwrites K and V
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % W_STAGES, q0 = q_lo + (t % n_q) * W_TILE;
      const unsigned char* qs = ring + s * Tile::STAGE;
      const unsigned char* dos = qs + Tile::STREAM;
      mbar_wait(&full[s], (t / W_STAGES) & 1);
      fence_operands();
      wgmma_fence();        // after the wait: no branch between fence and wgmma
      // S^T = K Q^T, dP^T = V dO^T: k16 steps along d, both K-major
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int aoff = (kk / 4) * W_ROWS * 128 + (kk % 4) * 32;
        const int boff = (kk / 4) * W_TILE * 128 + (kk % 4) * 32;
        wgmma_ss<0, 0>(sc, wgmma_desc(k_own + aoff, 16, 1024),
                       wgmma_desc(qs + boff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int aoff = (kk / 4) * W_ROWS * 128 + (kk % 4) * 32;
        const int boff = (kk / 4) * W_TILE * 128 + (kk % 4) * 32;
        wgmma_ss<0, 0>(dp, wgmma_desc(v_own + aoff, 16, 1024),
                       wgmma_desc(dos + boff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands();
      // masking where some pair of the tile is hidden: keys past some
      // query's position (causal), or at or before some position - window
      const float* st = stats + s * 2 * W_TILE + col_l;
      const int pos0 = q0 + q_offset;
      if ((causal && kw0 + 63 > pos0) ||
          (window > 0 && kw0 <= pos0 + 63 - window))
        dkdv_tile<true>(sc, dp, pa, da, st, kw0 + row_l, q0 + col_l, Sq, Sk,
                        causal, window, q_offset, scale_log2);
      else
        dkdv_tile<false>(sc, dp, pa, da, st, kw0 + row_l, q0 + col_l, Sq, Sk,
                         causal, window, q_offset, scale_log2);
      fence_operands();
      wgmma_fence();
      // dV += P^T dO, dK += dS^T Q: k16 steps along the queries, B MN-major
#pragma unroll
      for (int kk = 0; kk < W_TILE / 16; ++kk)
        wgmma_rs<1>(dv, pa[kk], wgmma_desc(dos + kk * 2048, W_TILE * 128, 1024),
                    1);
#pragma unroll
      for (int kk = 0; kk < W_TILE / 16; ++kk)
        wgmma_rs<1>(dk, da[kk], wgmma_desc(qs + kk * 2048, W_TILE * 128, 1024),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands();
      mbar_arrive_warp(&empty[s]);
    }

    // epilogue: dK D^-1/2 and dV in bf16 into this warpgroup's rows of the
    // K and V tiles (read by no one now), then one TMA store per 64-wide
    // box, clipped at Sk
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* kb = k_own + (j / 8) * W_ROWS * 128;
      unsigned char* vb = v_own + (j / 8) * W_ROWS * 128;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t off = swz128(row_l + 8 * i, j % 8) + 2 * col_l;
        *reinterpret_cast<uint32_t*>(kb + off) =
            pack_bf16(dk[4 * j + 2 * i] * scale, dk[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(vb + off) =
            pack_bf16(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
      for (int j = 0; j < HALVES; ++j) {
        tma_store_4d(&mdk, k_own + j * W_ROWS * 128, 64 * j, kh, kw0, b);
        tma_store_4d(&mdv, v_own + j * W_ROWS * 128, 64 * j, kh, kw0, b);
      }
      tma_store_wait();
    }
  }
}

// dS of one (64 queries, 64 keys) tile in registers, packed to bf16 pairs
// as wgmma's A operand (k16 step kk: keys 16 kk + [0, 16)).  Accumulator
// element 4j + 2i + c of a thread is query qi0 + 8 i (lse log2 e lse2[i],
// delta dl[i]), key kc0 + 8 j + c.  sc and dp are only read.  EDGE: the
// tile holds a pair that the causal or window condition hides, or keys
// past Sk (zero rows of K: their P must not count).
template <bool EDGE>
__device__ __forceinline__ void dq_tile(
    const float (&sc)[W_TILE / 2], const float (&dp)[W_TILE / 2],
    uint32_t (&da)[W_TILE / 16][4], const float (&lse2)[2],
    const float (&dl)[2], int qi0, int kc0, int Sk, int causal, int window,
    int q_offset, float scale_log2) {
#pragma unroll
  for (int j = 0; j < W_TILE / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        ds[c] = exp2f(fmaf(sc[e], scale_log2, -lse2[i])) * (dp[e] - dl[i]);
        if (EDGE) {
          const int kj = kc0 + 8 * j + c;
          if (!(kj < Sk && visible(kj, qi0 + 8 * i + q_offset, causal, window)))
            ds[c] = 0.f;
        }
      }
      da[j / 2][2 * (j % 2) + i] = pack_bf16(ds[0], ds[1]);
    }
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mdq,
                const float* __restrict__ lse2,
                const float* __restrict__ delta, int Sk, int Sp, int group,
                int causal, int window, int q_offset, float scale) {
  using Tile = BwdTile<D>;
  constexpr int HALVES = Tile::HALVES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;                      // HALVES boxes of W_ROWS rows
  unsigned char* dOs = Qs + Tile::FIXED;
  unsigned char* ring = dOs + Tile::FIXED;       // per stage: K boxes, V boxes
  // K and V have barriers of their own: a V stage is free once dP = dO V^T
  // is done, a K stage once dQ += dS K is
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(ring + W_STAGES * Tile::STAGE);
  uint64_t* full_k = q_bar + 1;
  uint64_t* empty_k = full_k + W_STAGES;
  uint64_t* full_v = empty_k + W_STAGES;
  uint64_t* empty_v = full_v + W_STAGES;

  // blocks start in index order: every head's last (longest) query tile
  // first, the heads of one kv head side by side
  const int q0 = (gridDim.z - 1 - blockIdx.z) * W_ROWS;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / group;
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + W_ROWS + q_offset);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1) / W_TILE * W_TILE;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + W_TILE - 1) / W_TILE : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);     // every consumer warp releases a stage
      mbar_init(&empty_v[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {                     // producer: one thread issues TMA
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, 2 * Tile::FIXED);
#pragma unroll
      for (int j = 0; j < HALVES; ++j) {
        tma_load_4d(Qs + j * W_ROWS * 128, &mq, q_bar, 64 * j, h, q0, b);
        tma_load_4d(dOs + j * W_ROWS * 128, &mdo, q_bar, 64 * j, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % W_STAGES, k0 = k_begin + t * W_TILE;
        unsigned char* ks = ring + s * Tile::STAGE;
        unsigned char* vs = ks + Tile::STREAM;
        if (t >= W_STAGES) mbar_wait(&empty_k[s], (t / W_STAGES - 1) & 1);
        mbar_expect_tx(&full_k[s], Tile::STREAM);
#pragma unroll
        for (int j = 0; j < HALVES; ++j)
          tma_load_4d(ks + j * W_TILE * 128, &mk, &full_k[s], 64 * j, kh, k0, b);
        if (t >= W_STAGES) mbar_wait(&empty_v[s], (t / W_STAGES - 1) & 1);
        mbar_expect_tx(&full_v[s], Tile::STREAM);
#pragma unroll
        for (int j = 0; j < HALVES; ++j)
          tma_load_4d(vs + j * W_TILE * 128, &mv, &full_v[s], 64 * j, kh, k0, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64), accumulator
    // layout as in fa_bwd_dkdv_wgmma
    reg_alloc<240>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int row_l = 16 * warp + (lane >> 2);        // + 8 i
    const int col_l = 2 * (lane & 3);                 // + 8 j + c
    const int qw0 = q0 + 64 * wg, qi0 = qw0 + row_l;
    const int pos0 = qw0 + q_offset;                  // first row's position
    const float scale_log2 = scale * LOG2E;
    unsigned char* q_own = Qs + wg * BOX;             // this warpgroup's rows
    const unsigned char* do_own = dOs + wg * BOX;
    // the padded planes hold every row of the block (Sp >= q0 + W_ROWS)
    const int64_t at = ((int64_t)b * gridDim.x + h) * Sp + qi0;
    const float l2r[2] = {lse2[at], lse2[at + 8]};
    const float dlr[2] = {delta[at], delta[at + 8]};

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float sc[W_TILE / 2], dp[W_TILE / 2];
    uint32_t da[W_TILE / 16][4];                      // dS of the last tile

    // S = Q K_t^T, dP = dO V_t^T, issued (not waited for); K_t, V_t landed
    auto issue_ss = [&](int t) {
      const unsigned char* ks = ring + (t % W_STAGES) * Tile::STAGE;
      const unsigned char* vs = ks + Tile::STREAM;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {   // k16 steps along d
        const int aoff = (kk / 4) * W_ROWS * 128 + (kk % 4) * 32;
        const int boff = (kk / 4) * W_TILE * 128 + (kk % 4) * 32;
        wgmma_ss<0, 0>(sc, wgmma_desc(q_own + aoff, 16, 1024),
                       wgmma_desc(ks + boff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int aoff = (kk / 4) * W_ROWS * 128 + (kk % 4) * 32;
        const int boff = (kk / 4) * W_TILE * 128 + (kk % 4) * 32;
        wgmma_ss<0, 0>(dp, wgmma_desc(do_own + aoff, 16, 1024),
                       wgmma_desc(vs + boff, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K_t, issued (not waited for).  K is MN-major (d contiguous)
    auto issue_rs = [&](int t) {
      const unsigned char* ks = ring + (t % W_STAGES) * Tile::STAGE;
#pragma unroll
      for (int kk = 0; kk < W_TILE / 16; ++kk)   // 16 keys = 16 rows of K
        wgmma_rs<1>(dq, da[kk], wgmma_desc(ks + kk * 2048, W_TILE * 128, 1024),
                    1);
      wgmma_commit();
    };
    auto fence_operands = [&] {
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < W_TILE / 16; ++kk) fence_regs(da[kk]);
    };
    auto wait_kv = [&](int t) {
      mbar_wait(&full_k[t % W_STAGES], (t / W_STAGES) & 1);
      mbar_wait(&full_v[t % W_STAGES], (t / W_STAGES) & 1);
    };
    // dS of the tile at key k0 into da; masking only where some key may be
    // hidden from some row of this warpgroup or lie past Sk
    auto grad_scores = [&](int k0) {
      if (k0 + W_TILE > Sk || (causal && k0 + 63 > pos0) ||
          (window > 0 && k0 <= pos0 + 63 - window))
        dq_tile<true>(sc, dp, da, l2r, dlr, qi0, k0 + col_l, Sk, causal,
                      window, q_offset, scale_log2);
      else
        dq_tile<false>(sc, dp, da, l2r, dlr, qi0, k0 + col_l, Sk, causal,
                       window, q_offset, scale_log2);
    };

    // The two warpgroups take turns to issue their products (barriers 3
    // and 4), as in the forward: warpgroup 0 starts and takes one turn more
    // at the end, so that no arrival is left over.
    auto my_turn = [&] { named_barrier(3 + wg, 256); };
    auto your_turn = [&] { named_barrier_arrive(4 - wg, 256); };
    if (wg == 1) your_turn();

    mbar_wait(q_bar, 0);   // also before the epilogue overwrites Q
    if (n_tiles > 0) {
      my_turn();
      wait_kv(0);
      fence_operands();
      wgmma_fence();
      issue_ss(0);
      your_turn();
      wgmma_wait<0>();
      fence_operands();
      mbar_arrive_warp(&empty_v[0]);
      grad_scores(k_begin);
    }
    // a turn issues dQ += dS_{t-1} K_{t-1} and S_t, dP_t
    for (int t = 1; t < n_tiles; ++t) {
      my_turn();
      wait_kv(t);
      fence_operands();
      wgmma_fence();    // after the waits: no branch between fence and wgmma
      issue_rs(t - 1);
      issue_ss(t);
      your_turn();
      wgmma_wait<0>();
      fence_operands();
      mbar_arrive_warp(&empty_k[(t - 1) % W_STAGES]);
      mbar_arrive_warp(&empty_v[t % W_STAGES]);
      grad_scores(k_begin + t * W_TILE);
    }
    if (n_tiles > 0) {
      my_turn();
      fence_operands();
      wgmma_fence();
      issue_rs(n_tiles - 1);
      your_turn();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    if (wg == 0) my_turn();

    // epilogue: dQ D^-1/2 in bf16 into this warpgroup's rows of the Q tile
    // (read by no one now), then one TMA store per 64-wide box, clipped at Sq
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* box = q_own + (j / 8) * W_ROWS * 128;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(box + swz128(row_l + 8 * i, j % 8) +
                                     2 * col_l) =
            pack_bf16(dq[4 * j + 2 * i] * scale,
                      dq[4 * j + 2 * i + 1] * scale);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
      for (int j = 0; j < HALVES; ++j)
        tma_store_4d(&mdq, q_own + j * W_ROWS * 128, 64 * j, h, qw0, b);
      tma_store_wait();
    }
  }
}

// q, o, dout, dq: (B, Sq, H, D) contiguous bf16; k, v, dk, dv: (B, Sk, kvH,
// D); scratch: 2 B H Sp floats, Sp = Sq rounded up to 128.  Fails with
// cudaErrorInvalidValue where TMA cannot take a layout (the Python wrapper
// raises before that).
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, float* scratch,
                         const float* lse, void* dq, void* dk, void* dv, int B,
                         int Sq, int Sk, int H, int kvH, int causal,
                         int window, int q_offset, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = BwdTile<D>::SMEM;
  static const cudaError_t attr = [] {     // once per instance
    cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv_wgmma<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(fa_bwd_dq_wgmma<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }();
  if (attr != cudaSuccess) return attr;
  // setmaxnreg moves registers inside the block's own allocation: the
  // consumers' 240 and the producer's 24 must fit in what the launch holds,
  // or the consumers would wait for registers forever
  static const cudaError_t regs = [] {
    cudaFuncAttributes kv, dq;
    cudaError_t e = cudaFuncGetAttributes(&kv, fa_bwd_dkdv_wgmma<D>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&dq, fa_bwd_dq_wgmma<D>);
    if (e != cudaSuccess) return e;
    const int need = 256 * 240 + 128 * 24;
    return kv.numRegs * W_THREADS >= need && dq.numRegs * W_THREADS >= need
               ? cudaSuccess : cudaErrorInvalidConfiguration;
  }();
  if (regs != cudaSuccess) return regs;
  const int Sp = (Sq + W_ROWS - 1) / W_ROWS * W_ROWS;
  float* lse2 = scratch;
  float* delta = scratch + (int64_t)B * H * Sp;
  // (B, S, heads, D) contiguous, boxes of `rows` rows of one 64-wide half
  auto map = [&](CUtensorMap* m, const void* p, int S, int heads, int rows) {
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)S,
                              (uint64_t)B};
    const uint64_t strides[3] = {2ull * D, 2ull * heads * D,
                                 2ull * S * heads * D};
    const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
    return make_map_bf16(m, 4, p, dims, strides, box);
  };
  CUtensorMap mq_t, mdo_t, mk_f, mv_f, mdk, mdv;   // dK/dV: Q, dO stream
  CUtensorMap mq_f, mdo_f, mk_t, mv_t, mdq;        // dQ: K, V stream
  cudaError_t err;
  if ((err = map(&mq_t, q, Sq, H, W_TILE)) != cudaSuccess) return err;
  if ((err = map(&mdo_t, dout, Sq, H, W_TILE)) != cudaSuccess) return err;
  if ((err = map(&mk_f, k, Sk, kvH, W_ROWS)) != cudaSuccess) return err;
  if ((err = map(&mv_f, v, Sk, kvH, W_ROWS)) != cudaSuccess) return err;
  if ((err = map(&mdk, dk, Sk, kvH, 64)) != cudaSuccess) return err;
  if ((err = map(&mdv, dv, Sk, kvH, 64)) != cudaSuccess) return err;
  if ((err = map(&mq_f, q, Sq, H, W_ROWS)) != cudaSuccess) return err;
  if ((err = map(&mdo_f, dout, Sq, H, W_ROWS)) != cudaSuccess) return err;
  if ((err = map(&mk_t, k, Sk, kvH, W_TILE)) != cudaSuccess) return err;
  if ((err = map(&mv_t, v, Sk, kvH, W_TILE)) != cudaSuccess) return err;
  if ((err = map(&mdq, dq, Sq, H, 64)) != cudaSuccess) return err;

  using T = __nv_bfloat16;
  const int64_t rows = (int64_t)B * Sp * H;
  const int64_t dot_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  fa_bwd_dot_kernel<T><<<dot_blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, lse2,
      rows, Sq, Sp, H, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // some row sees no key: causal rows before position 0, window rows whose
  // first key lies past Sk - 1
  const int blind = (causal && q_offset < 0) ||
                    (window > 0 && Sq - 1 + q_offset - window + 1 > Sk - 1);
  fa_bwd_dkdv_wgmma<D><<<dim3(kvH, B, (Sk + W_ROWS - 1) / W_ROWS), W_THREADS,
                         smem, stream>>>(
      mq_t, mdo_t, mk_f, mv_f, mdk, mdv, lse2, delta, Sq, Sk, Sp, H, H / kvH,
      causal, window, q_offset, blind, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_wgmma<D><<<dim3(H, B, (Sq + W_ROWS - 1) / W_ROWS), W_THREADS,
                       smem, stream>>>(
      mq_f, mdo_f, mk_t, mv_t, mdq, lse2, delta, Sk, Sp, H / kvH, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

EXPORT_ERROR_STRING

// q, o, dout, dq: (B, Sq, H, D) contiguous; k, v, dk, dv: (B, Sk, kvH, D)
// contiguous; lse (the forward's): (B, H, Sq) fp32; scratch: fp32 written
// here, B H Sq floats (simt) or 2 B H Sp with Sp = Sq rounded up to 128
// (wgmma).  One dtype for q, k, v, o, dout and the gradients; H a multiple
// of kvH.  path: the kernels to launch, as the Python wrapper chose them:
// kPathWgmma (bf16, D 64 or 128) or kPathSimt (fp32 or bf16, D 16, 32, 64
// or 128).  Inputs those cannot take return cudaErrorInvalidValue.
// Launches three kernels on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* scratch, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Sq,
                                   int Sk, int H, int kvH, int D, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream, int path) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvH <= 0 || H % kvH) return cudaErrorInvalidValue;
  if (path == kPathWgmma && dtype == kBFloat16) {
    if (D == 64)
      return launch_wgmma<64>(q, k, v, o, dout, scratch, lse, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
    if (D == 128)
      return launch_wgmma<128>(q, k, v, o, dout, scratch, lse, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  }
  if (path == kPathSimt && dtype == kFloat32)
    return launch_d<float>(D, q, k, v, o, dout, scratch, lse, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  if (path == kPathSimt && dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, dout, scratch, lse, dq, dk, dv, B, Sq, Sk, H, kvH, causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

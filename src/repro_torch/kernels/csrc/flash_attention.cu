// Flash attention forward for sm_90a: softmax(Q K^T * D^-1/2 + mask) V with
// an online softmax over key tiles, grouped-query heads read in place.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/kernel.py,
// flash_attention_fwd: _fa_kernel (causal/window mask from indices) and
// _fa_kernel_masked (explicit (Sq, Sk) bool mask streamed in tiles).  Here
// one kernel takes both: the mask pointer may be null, and the causal and
// window conditions apply on top of it.
//
// Bound: at the serving prefill shape (B 4, S 512, H 32/8, D 128, bf16) the
// function moves 41.9 MB and does 8.6 GFLOP of causal work: bytes bound it on
// an H100 (about 12.5 us at 3.35 TB/s).  This first kernel does its math on
// the fp32 CUDA cores, not the tensor cores, so its own limit is the
// arithmetic: shared-memory operand loads feeding fp32 FMAs.
//
// Design: one block of 128 threads per (batch, head, 64-query tile).  The
// query tile is staged once in shared memory, transposed; each 64-key tile of
// K (transposed) and V is staged in turn.  A thread owns 8 query rows x 4 key
// columns of the score tile and 8 rows x D/16 columns of the output, strided
// so that shared-memory reads are broadcasts or consecutive banks.  Running
// max, sum and accumulator stay in fp32 registers; row reductions are 16-lane
// shuffles.  The query's kv head is h / (H / kvH), so K/V are never repeated.
// Causal and window tiles that hold no valid key are skipped.
//
// Numerics follow the TPU kernel: masked scores are -1e30 (not -inf), so a
// row with no valid key averages V uniformly like the reference; keys past
// Sk (the ragged edge) get -inf and weigh exactly 0.  P is rounded to V's
// dtype before P V, l sums the unrounded P, and l is clamped at 1e-30.
#include "common.cuh"

namespace {

constexpr int BQ = 64;            // queries per block
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 128;
constexpr int PAD = 65;           // row stride of transposed tiles and of P
constexpr float NEG_BIG = -1e30f;

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * BQ * PAD            // P
         + sizeof(T) * D * PAD * 2           // Q^T, K^T
         + sizeof(T) * BK * D;               // V
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ mask,
              T* __restrict__ o, int Sq, int Sk, int H, int group,
              int64_t sqb, int64_t sqs, int64_t sqh,
              int64_t skb, int64_t sks, int64_t skh,
              int64_t svb, int64_t svs, int64_t svh,
              int causal, int window, int q_offset, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;               // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ps = reinterpret_cast<float*>(smem_raw);
  T* Qt = reinterpret_cast<T*>(Ps + BQ * PAD);
  T* Kt = Qt + D * PAD;
  T* Vs = Kt + D * PAD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + (h / group) * skh;
  const T* vb = v + b * svb + (h / group) * svh;
  const T zero = from_f<T>(0.f);

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int row = e / D, d = e % D, qi = q0 + row;
    Qt[d * PAD + row] = qi < Sq ? qb[qi * sqs + d] : zero;
  }

  // keys this query tile can see: causal stops at the last query's position,
  // a window starts at the first query's position - window + 1
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BQ + q_offset);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1) / BK * BK;

  float m[8], l[8], acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                       // last tile's K, V and P reads done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int row = e / D, d = e % D, kj = k0 + row;
      const bool ok = kj < Sk;
      Kt[d * PAD + row] = ok ? kb[kj * sks + d] : zero;
      Vs[row * D + d] = ok ? vb[kj * svs + d] : zero;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = to_f(Qt[d * PAD + r + 8 * i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f(Kt[d * PAD + c + 16 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r + 8 * i, qi = q0 + row, qpos = qi + q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c + 16 * j;
        bool valid = true;
        if (causal) valid = valid && kj <= qpos;
        if (window > 0) valid = valid && kj > qpos - window;
        if (mask) valid = valid && qi < Sq && kj < Sk && mask[(int64_t)qi * Sk + kj];
        float sv = valid ? s[i][j] * scale : NEG_BIG;
        if (kj >= Sk) sv = -INFINITY;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[row * PAD + c + 16 * j] = to_f(from_f<T>(p));
      }
      l[i] = alpha * l[i] + sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();                       // P complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[8], vv[DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ps[(r + 8 * i) * PAD + kk];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) vv[jj] = to_f(Vs[kk * D + c + 16 * jj]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + r + 8 * i;
    if (qi >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) orow[c + 16 * jj] = from_f<T>(acc[i][jj] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, int B, int Sq, int Sk, int H,
                   int kvH, const long long* st, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(o), Sq, Sk, H, H / kvH, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* o, int B, int Sq, int Sk, int H,
                     int kvH, const long long* st, int causal, int window,
                     int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, mask, o, B, Sq, Sk, H, kvH, st, causal, window, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, mask, o, B, Sq, Sk, H, kvH, st, causal, window, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, mask, o, B, Sq, Sk, H, kvH, st, causal, window, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, mask, o, B, Sq, Sk, H, kvH, st, causal, window, q_offset, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

EXPORT_ERROR_STRING

// q: (B, Sq, H, D), k/v: (B, Sk, kvH, D), each with unit stride on D and
// element strides (batch, seq, head) given in `strides` as q, k, v triples.
// o: (B, Sq, H, D) contiguous.  mask: null or (Sq, Sk) contiguous bytes.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* o, int dtype, int B,
                                   int Sq, int Sk, int H, int kvH, int D,
                                   const long long* strides, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == kFloat32)
    return launch_d<float>(D, q, k, v, m, o, B, Sq, Sk, H, kvH, strides, causal, window, q_offset, scale, s);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(D, q, k, v, m, o, B, Sq, Sk, H, kvH, strides, causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

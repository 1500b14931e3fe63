// Flash attention forward for sm_90a: softmax(Q K^T * D^-1/2 + mask) V with
// an online softmax over key tiles, grouped-query heads read in place.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/kernel.py,
// flash_attention_fwd: _fa_kernel (causal/window mask from indices) and
// _fa_kernel_masked (explicit (Sq, Sk) bool mask streamed in tiles).  Here
// each kernel takes both: the mask pointer may be null, and the causal and
// window conditions apply on top of it.
//
// Bound: at the serving prefill shape (B 4, S 512, H 32/8, D 128, bf16) the
// function moves 41.9 MB and does 8.6 GFLOP of causal work: bytes bound it on
// an H100 (about 12.5 us at 3.35 TB/s), the tensor cores close behind (8.7 us
// at 989 TFLOP/s).
//
// Two kernels, chosen by dtype and head size before launch (by the Python
// wrapper, flash_path, which passes its choice to the entry point):
//
// fa_fwd_wgmma (bf16, D 64 or 128; every served model): one block per
// (head, batch, 128-query tile) of two consumer warpgroups (64 query rows
// each) and one producer warp.  The producer loads the Q tile once and K
// and V tiles of 64 keys into three-stage rings by TMA (4-D maps over the
// (B, S, H, D) strides, so that q, k and v are read in place and the kv
// head is h / group; rows past Sq or Sk are zero-filled inside their own
// (b, h)), completing on mbarriers.  A consumer computes S = Q K^T with
// wgmma from shared memory (K is K-major: d is contiguous), masks and
// exponentiates S in registers into P in bf16, laid out as the A registers
// of the next wgmma (the accumulator layout of m64nNk16 is that layout),
// and adds P V with wgmma, B = the V tile, MN-major (the transpose bit).
// The output is divided by l, rounded, staged in the block's Q tile and
// written by a TMA store that clips at Sq.  The two warpgroups take turns
// to issue their products (P_{t-1} V_{t-1} and S_t = Q K_t^T), so that
// one's softmax runs while the other's products keep the tensor cores
// busy; K and V stages are released apart.  Scores are scaled by D^-1/2
// log2 e and exponentiated in base 2 (the same softmax, one ex2 a score).
// The longest query tiles (causal) start first.
//
// fa_fwd_kernel (fp32, which must not round to TF32, and D 16 or 32): one
// block of 128 threads per (batch, head, 64-query tile) on the fp32 CUDA
// cores.  The query tile is staged once in shared memory, transposed; each
// 64-key tile of K (transposed) and V is staged in turn.  A thread owns 8
// query rows x 4 key columns of the score tile and 8 rows x D/16 columns of
// the output; row reductions are 16-lane shuffles.
//
// Both skip causal and window tiles that hold no valid key.  Numerics follow
// the TPU kernel: masked scores are -1e30 (not -inf), so a row with no valid
// key averages V uniformly like the reference; keys past Sk (the ragged
// edge) get -inf and weigh exactly 0, also where TMA zero-filled them.  P is
// rounded to V's dtype before P V, l sums the unrounded P, l is clamped at
// 1e-30, and m, l and the row reductions are fp32.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

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
  static const cudaError_t attr = cudaFuncSetAttribute(    // once per instance
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(o), Sq, Sk, H, H / kvH, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], causal, window, q_offset, scale);
  return cudaGetLastError();
}

// D 16 and 32 in both dtypes, D 64 and 128 in fp32: bf16 at those sizes is
// fa_fwd_wgmma's, so no such instance is built
template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* o, int B, int Sq, int Sk, int H,
                     int kvH, const long long* st, int causal, int window,
                     int q_offset, float scale, cudaStream_t s) {
  if (D == 16) return launch<T, 16>(q, k, v, mask, o, B, Sq, Sk, H, kvH, st, causal, window, q_offset, scale, s);
  if (D == 32) return launch<T, 32>(q, k, v, mask, o, B, Sq, Sk, H, kvH, st, causal, window, q_offset, scale, s);
  if constexpr (std::is_same_v<T, float>) {
    if (D == 64) return launch<T, 64>(q, k, v, mask, o, B, Sq, Sk, H, kvH, st, causal, window, q_offset, scale, s);
    if (D == 128) return launch<T, 128>(q, k, v, mask, o, B, Sq, Sk, H, kvH, st, causal, window, q_offset, scale, s);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------- bf16, wgmma + TMA
constexpr int WQ = 128;           // queries per block: two warpgroups of 64
constexpr int WK = 64;            // keys per ring stage
constexpr int W_STAGES = 3;
constexpr int W_THREADS = 288;    // two consumer warpgroups + a producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct WgTile {
  static constexpr int HALVES = D / 64;              // 64-wide boxes along d
  static constexpr int Q_BYTES = WQ * 128 * HALVES;
  static constexpr int KV_BYTES = WK * 128 * HALVES;  // one of K, V
  static constexpr int STAGE = 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles, then the barriers
  static constexpr size_t SMEM = 1024 + Q_BYTES + W_STAGES * STAGE + 128;
};

// Online softmax of one score tile, in base 2: sc (WK / 2 scores of two
// rows a thread, scaled by D^-1/2 log2 e here) gives P in bf16 pairs laid
// out as wgmma's A operand (k16 step kk holds keys 16 kk + [0, 16), i.e.
// accumulator columns j = 2 kk and 2 kk + 1); m and l of both rows advance,
// alpha gets the factors that rescale O.  Masked scores are -1e30, keys past
// Sk -inf.  sc is only read: writing a wgmma's accumulator while another
// wgmma is in flight would make ptxas serialize them.  EDGE: the tile needs
// masking by index (causal, window, the ragged edge); MASK: by the explicit
// mask too.  The instance for the tiles inside the valid region has no
// masking code at all.
template <bool EDGE, bool MASK>
__device__ __forceinline__ void softmax_tile(
    const float (&sc)[WK / 2], uint32_t (&p_out)[WK / 16][4], float (&m)[2],
    float (&l)[2], float (&alpha)[2], int k0, int qi0, int col_l,
    const uint8_t* __restrict__ mask, int Sq, int Sk, int causal, int window,
    int q_offset, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // tile column col (key k0 + col) is valid for this row where lo <= col
    // <= hi and the mask's bit 2 j + c is set, and lies before Sk where
    // col < sk
    const int qi = qi0 + 8 * i, qpos = qi + q_offset;
    int lo = -1, hi = WK, sk = WK;
    uint32_t keep = ~0u;
    if (EDGE) {
      if (window > 0) lo = qpos - window + 1 - k0;
      if (causal) hi = qpos - k0;
      sk = Sk - k0;
    }
    if (MASK) {
      const int64_t row = (int64_t)min(qi, Sq - 1) * Sk;
      keep = 0;
#pragma unroll
      for (int j = 0; j < WK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = min(k0 + 8 * j + col_l + c, Sk - 1);
          keep |= uint32_t(qi < Sq && mask[row + kj]) << (2 * j + c);
        }
    }
    auto score = [&](int j, int c) {
      const int col = 8 * j + col_l + c;
      float sv = sc[4 * j + 2 * i + c] * scale_log2;
      if (EDGE && (col < lo || col > hi)) sv = NEG_BIG;
      if (MASK && !((keep >> (2 * j + c)) & 1u)) sv = NEG_BIG;
      if (EDGE && col >= sk) sv = -INFINITY;
      return sv;
    };
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j)
      mx = fmaxf(mx, fmaxf(score(j, 0), score(j, 1)));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = exp2f(m[i] - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
      const float p0 = exp2f(score(j, 0) - m_new);
      const float p1 = exp2f(score(j, 1) - m_new);
      ps += p0 + p1;
      p_out[j / 2][2 * (j % 2) + i] = pack_bf16(p0, p1);
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l[i] = alpha[i] * l[i] + ps;
    m[i] = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
fa_fwd_wgmma(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv,
             const __grid_constant__ CUtensorMap mo,
             const uint8_t* __restrict__ mask, int Sq, int Sk, int group,
             int causal, int window, int q_offset, float scale) {
  using Tile = WgTile<D>;
  constexpr int HALVES = Tile::HALVES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;                      // HALVES boxes of WQ rows
  unsigned char* ring = smem + Tile::Q_BYTES;    // per stage: K boxes, V boxes
  // K and V have barriers of their own: a K stage is free once S = Q K^T
  // is done, a V stage once P V is
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(ring + W_STAGES * Tile::STAGE);
  uint64_t* full_k = q_bar + 1;
  uint64_t* empty_k = full_k + W_STAGES;
  uint64_t* full_v = empty_k + W_STAGES;
  uint64_t* empty_v = full_v + W_STAGES;

  // blocks start in index order: every head's last (longest) query tile
  // first, the heads of one kv head side by side
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WQ;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / group;
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + WQ + q_offset);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1) / WK * WK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + WK - 1) / WK : 0;

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
  if (wg == 2) {                     // producer warp: one thread issues TMA
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, Tile::Q_BYTES);
#pragma unroll
      for (int j = 0; j < HALVES; ++j)
        tma_load_4d(Qs + j * WQ * 128, &mq, q_bar, 64 * j, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % W_STAGES, k0 = k_begin + t * WK;
        unsigned char* ks = ring + s * Tile::STAGE;
        unsigned char* vs = ks + Tile::KV_BYTES;
        if (t >= W_STAGES) mbar_wait(&empty_k[s], (t / W_STAGES - 1) & 1);
        mbar_expect_tx(&full_k[s], Tile::KV_BYTES);
#pragma unroll
        for (int j = 0; j < HALVES; ++j)
          tma_load_4d(ks + j * WK * 128, &mk, &full_k[s], 64 * j, kh, k0, b);
        if (t >= W_STAGES) mbar_wait(&empty_v[s], (t / W_STAGES - 1) & 1);
        mbar_expect_tx(&full_v[s], Tile::KV_BYTES);
#pragma unroll
        for (int j = 0; j < HALVES; ++j)
          tma_load_4d(vs + j * WK * 128, &mv, &full_v[s], 64 * j, kh, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64).  Accumulator
  // element 4j + 2i + c of a thread is row 16 warp + lane / 4 + 8 i, column
  // 8 j + 2 (lane % 4) + c.
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int row_l = 16 * warp + (lane >> 2);          // + 8 i
  const int col_l = 2 * (lane & 3);                   // + 8 j + c
  const int qi0 = q0 + 64 * wg + row_l;
  const int pos0 = q0 + 64 * wg + q_offset;           // first row's position
  const float scale_log2 = scale * LOG2E;             // e^x = 2^(x log2 e)
  unsigned char* q_own = Qs + wg * BOX;               // this warpgroup's rows

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[WK / 2];
  uint32_t pa[WK / 16][4];                            // P of the last tile

  // S = Q K_t^T into sc, issued (not waited for); K_t has landed
  auto issue_s = [&](int t) {
    const int s = t % W_STAGES;
    const unsigned char* ks = ring + s * Tile::STAGE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {   // k16 steps along d
      const int off = (kk / 4) * WQ * 128 + (kk % 4) * 32;
      const int koff = (kk / 4) * WK * 128 + (kk % 4) * 32;
      wgmma_ss<0, 0>(sc, wgmma_desc(q_own + off, 16, 1024),
                     wgmma_desc(ks + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_t, issued (not waited for); V_t has landed.  V is MN-major
  // (d contiguous)
  auto issue_pv = [&](int t) {
    const int s = t % W_STAGES;
    const unsigned char* vs = ring + s * Tile::STAGE + Tile::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)    // 16 keys = 16 rows of V
      wgmma_rs<1>(o, pa[kk], wgmma_desc(vs + kk * 2048, WK * 128, 1024), 1);
    wgmma_commit();
  };
  // pins the registers the products read and write in place around the
  // issue, so that ptxas keeps products in flight instead of serializing
  auto fence_operands = [&] {
    fence_regs(sc);
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) fence_regs(pa[kk]);
  };
  auto wait_k = [&](int t) {
    mbar_wait(&full_k[t % W_STAGES], (t / W_STAGES) & 1);
  };
  auto wait_v = [&](int t) {
    mbar_wait(&full_v[t % W_STAGES], (t / W_STAGES) & 1);
  };
  // softmax of the tile at key k0 into pa; masking only where some key
  // may be invalid for some row of this warpgroup (the mask, the ragged
  // edge, the diagonal, the window)
  auto softmax = [&](int k0) {
    if (mask)
      softmax_tile<true, true>(sc, pa, m, l, alpha, k0, qi0, col_l, mask, Sq,
                               Sk, causal, window, q_offset, scale_log2);
    else if (k0 + WK > Sk || (causal && k0 + WK - 1 > pos0) ||
             (window > 0 && k0 <= pos0 + 63 - window))
      softmax_tile<true, false>(sc, pa, m, l, alpha, k0, qi0, col_l, mask, Sq,
                                Sk, causal, window, q_offset, scale_log2);
    else
      softmax_tile<false, false>(sc, pa, m, l, alpha, k0, qi0, col_l, mask,
                                 Sq, Sk, causal, window, q_offset, scale_log2);
  };

  // The two warpgroups take turns to issue their products (barriers 3 and
  // 4: a warpgroup waits for its turn, issues, and hands the turn over), so
  // that one's softmax runs while the other's products keep the tensor cores
  // busy.  Warpgroup 0 starts; it takes one turn more at the end, so that no
  // arrival is left over.
  auto my_turn = [&] { named_barrier(3 + wg, 256); };
  auto your_turn = [&] { named_barrier_arrive(4 - wg, 256); };
  if (wg == 1) your_turn();

  mbar_wait(q_bar, 0);   // also before the epilogue overwrites Q
  if (n_tiles > 0) {
    my_turn();
    wait_k(0);
    fence_operands();
    wgmma_fence();
    issue_s(0);
    your_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive_warp(&empty_k[0]);
    softmax(k_begin);
  }
  // a turn issues P_{t-1} V_{t-1} and S_t = Q K_t^T; no product is in
  // flight while the warpgroup works out a softmax, so that ptxas keeps the
  // products of a turn back to back
  for (int t = 1; t < n_tiles; ++t) {
    const int k0 = k_begin + t * WK;
    my_turn();
    wait_v(t - 1);
    wait_k(t);
    fence_operands();
    wgmma_fence();    // after the waits: no branch between fence and wgmma
    issue_pv(t - 1);
    issue_s(t);
    your_turn();
    wgmma_wait<0>();
    fence_operands();
    mbar_arrive_warp(&empty_v[(t - 1) % W_STAGES]);
    mbar_arrive_warp(&empty_k[t % W_STAGES]);
    softmax(k0);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  }
  if (n_tiles > 0) {
    my_turn();
    wait_v(n_tiles - 1);
    fence_operands();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    your_turn();
    wgmma_wait<0>();
    fence_regs(o);
  }
  if (wg == 0) my_turn();

  // epilogue: o / l in bf16 into this warpgroup's rows of the Q tile (now
  // read by no one), then one TMA store per 64-wide box, clipped at Sq
  const float l_c[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* box = q_own + (j / 8) * WQ * 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t v = pack_bf16(o[4 * j + 2 * i] / l_c[i],
                                   o[4 * j + 2 * i + 1] / l_c[i]);
      *reinterpret_cast<uint32_t*>(box + swz128(row_l + 8 * i, j % 8) +
                                   2 * col_l) = v;
    }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int j = 0; j < HALVES; ++j)
      tma_store_4d(&mo, q_own + j * WQ * 128, 64 * j, h, q0 + 64 * wg, b);
    tma_store_wait();
  }
}

// q (B, Sq, H, D), k/v (B, Sk, kvH, D) through their element strides `st`,
// o (B, Sq, H, D) contiguous.  Fails with cudaErrorInvalidValue where TMA
// cannot take a layout (the Python wrapper raises before that).
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const uint8_t* mask, void* o, int B, int Sq, int Sk,
                         int H, int kvH, const long long* st, int causal,
                         int window, int q_offset, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = WgTile<D>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(    // once per instance
      fa_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mq, mk, mv, mo;
  const uint32_t qbox[4] = {64, 1, WQ, 1}, kbox[4] = {64, 1, WK, 1};
  const uint32_t obox[4] = {64, 1, 64, 1};
  auto map = [&](CUtensorMap* m, const void* p, int S, int heads,
                 const long long* s3, const uint32_t* bx) {
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
    const uint64_t strides[3] = {2ull * s3[2], 2ull * s3[1], 2ull * s3[0]};
    return make_map_bf16(m, 4, p, dims, strides, bx);
  };
  const long long ost[3] = {(long long)Sq * H * D, (long long)H * D, D};
  cudaError_t err;
  if ((err = map(&mq, q, Sq, H, st, qbox)) != cudaSuccess) return err;
  if ((err = map(&mk, k, Sk, kvH, st + 3, kbox)) != cudaSuccess) return err;
  if ((err = map(&mv, v, Sk, kvH, st + 6, kbox)) != cudaSuccess) return err;
  if ((err = map(&mo, o, Sq, H, ost, obox)) != cudaSuccess) return err;
  dim3 grid(H, B, (Sq + WQ - 1) / WQ);
  fa_fwd_wgmma<D><<<grid, W_THREADS, smem, stream>>>(
      mq, mk, mv, mo, mask, Sq, Sk, H / kvH, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

EXPORT_ERROR_STRING

// q: (B, Sq, H, D), k/v: (B, Sk, kvH, D), each with unit stride on D and
// element strides (batch, seq, head) given in `strides` as q, k, v triples.
// o: (B, Sq, H, D) contiguous.  mask: null or (Sq, Sk) contiguous bytes.
// path: the kernel to launch, as the Python wrapper chose it: kPathWgmma
// (bf16, D 64 or 128) or kPathSimt (fp32; bf16 with D 16 or 32).  Inputs
// that kernel cannot take return cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* o, int dtype, int B,
                                   int Sq, int Sk, int H, int kvH, int D,
                                   const long long* strides, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream, int path) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (path == kPathWgmma && dtype == kBFloat16) {
    if (D == 64)
      return launch_wgmma<64>(q, k, v, m, o, B, Sq, Sk, H, kvH, strides, causal, window, q_offset, scale, s);
    if (D == 128)
      return launch_wgmma<128>(q, k, v, m, o, B, Sq, Sk, H, kvH, strides, causal, window, q_offset, scale, s);
  }
  if (path == kPathSimt && dtype == kFloat32)
    return launch_d<float>(D, q, k, v, m, o, B, Sq, Sk, H, kvH, strides, causal, window, q_offset, scale, s);
  if (path == kPathSimt && dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(D, q, k, v, m, o, B, Sq, Sk, H, kvH, strides, causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

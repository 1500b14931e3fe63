// The C3 window scan for sm_90a: one simulated training iteration of every
// device lane of a fleet, in float64, in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this arithmetic as one
// XLA program, the jit of _iteration_scan (src/repro/core/jax_engine.py:198,
// a lax.scan over the workload's static step table, vmapped over barrier
// groups).  Run eagerly in PyTorch, each of the table's ~465 steps (the
// cluster studies' 8-layer llama) is ~30 elementwise launches, ~14,000 an
// iteration; here it is one.
//
// The scan is sequential in its steps and independent across lanes but for
// one max over a group's G lanes at each collective.  So one thread runs one
// lane through the whole table with its state in registers (clock, kernel
// cursor, remaining GFLOP and GB of the kernel in flight, busy time, the
// kernel's start, the group's barrier), and reads the table's step (kind,
// index, capped) at each step, the same address for every thread.  The work
// of kernel i is gflop[i] x noise and gbyte[i] x noise, formed when the lane
// starts kernel i: the noise is read once, row i of a (Kc, lanes) layout per
// sample, so a warp reads one contiguous row.
//
// The group max: width-G xor shuffles where G is a power of two that divides
// 32 (groups lie inside a warp, aligned, with blocks of 256); else through
// shared memory, blocks of a whole number of groups (a group never straddles
// two blocks).  Threads past the last lane run the table with no load or
// store, so that every thread of a block reaches each shuffle and barrier.
//
// Emit mode writes the trace directly: a (lane, kernel) start and end at most
// once (NaN where never reached: the wrapper fills them), the overlap of the
// kernel in flight summed in a register and stored at each window step,
// each comm's arrival per lane and its global end per group, busy per lane.
// Summary mode writes t_iter per group and util per lane only.
//
// Rounding: control flow follows rounded values (t + dt <= barrier decides
// whether a kernel finishes inside a window), so every add, subtract,
// multiply and divide is the _rn intrinsic, which nvcc never contracts into
// an FMA, in the order of the plain version (kernels/c3_window/ref.py).  The
// two give the same bits.
//
// Bound of the read form: bytes.  The noise, 8 B per lane and kernel, is
// what it reads (Kc x lanes x 8: 135 MB for 64 fleets of 256 nodes of 8
// lanes at Kc 129); per lane and kernel ~6 float64 operations, two of them
// divisions, against the card's 34 TFLOP/s of float64 outside the tensor
// cores.  Every step costs every thread a few instructions, and a lane's
// steps are a chain of dependent divisions, so at small populations
// latency, not either bound, sets the time.
//
// The draw form (c3_window_draw, summary mode only: run_fleet_scan's) reads
// no noise.  JAX's fleet scan draws its noise from jax.random's threefry2x32
// streams (src/repro/core/jax_engine.py:554-660), which are counter-based,
// so each thread draws what it needs where it needs it, in registers: from
// the sample's raw key and the iteration's fold_in datum it derives k1 (and
// k2, ks, ku where it draws durations) the way fold_in and split do.  When
// its lane starts kernel i it takes exp(sigma z), z the normal of k1 at
// counter (lane in sample) Kc + i, JAX's (N, G, Kc) layout; the next
// kernel's factor is drawn as kernel i starts, ahead of kernel i's division
// chain, so the integer hash (INT32 pipe) and uniform -> erfinv -> exp (FP64
// pipe) can issue while a division is in flight.  A group's Km comm
// durations, base x exp(sigma z) from k2 at counter node Km + j (times the
// spike where ks's uniform falls under p), are the same for its G lanes:
// they are drawn once, before the scan, lane g drawing comms g, g + G, ...
// into shared memory (every lane drawing all of them took 72 of a lane's
// 201 threefry calls, and 0.80 against 0.71 ms at 64 x 256 x 8 lanes on an
// H100 80GB HBM3 at 700 W, chip_smoke.py phase 2).  The
// step table is staged once per block into shared memory, packed to one
// word a step (kind | capped << 2 | index << 3): one shared-memory load a
// step where the read form makes three global ones, and 465 words stay
// resident beside the durations.  Drawing 2, 4 or 8 kernels' factors at
// once (independent chains for the scheduler to interleave) was no faster
// than one drawn ahead on that card; capping registers at 64 (four blocks
// an SM, one wave at the population) was 5% faster.  The arithmetic follows
// repro_torch/core/prng.py (the plain version: threefry2x32, then max(lo,
// u (hi - lo) + lo), sqrt(2) erfinv(u)) with every float64 operation an _rn
// intrinsic and erfinv and exp from the CUDA math library, the functions
// torch.special.erfinv and torch.exp call on the card, so kernel and plain
// version agree to the bit.
//
// Bound of the draw form: operations.  Its bytes are the rates in and t_iter
// and util out, ~3.6 MB at 64 fleets of 256 nodes of 8 lanes.  The function
// needs an iteration's keys once a sample (6 threefry2x32 calls: fold_in,
// k1, k2, k3, ks, ku), one draw per lane and kernel, and per group and comm
// a normal, a uniform and, where the spike fires, a second: each draw one
// threefry2x32 (~76 32-bit adds, funnel-shift rotates, xors and the bits'
// shifts, on the INT32 pipe: 64 lanes an SM, a quarter of the fp32 rate),
// each kernel's ~120 float64 FLOP (the uniform 3, erfinv ~70 with its log,
// exp ~26, the scan's two divisions ~18 and its products and sums, on the
// FP64 pipe, 34 TFLOP/s).  The INT32 pipe bounds it: ~1.35 G operations,
// ~81 us at that population with spikes at p 0.2, against ~63 us of
// float64 (chip_smoke.py phase 2 counts both from its run's data).  The
// kernel does more: each thread derives its sample's keys itself, and the
// static SASS of c3_window_shuffle<false, 8, DrawNoise> (cuobjdump -sass of
// the sm_90a build) is 2,872 instructions, 1,445 integer, 458 float64, 19
// MUFU (jax_normal_kernel: 640, 293, 115, 5).  It runs ~8x the bound (0.68
// ms on an H100 80GB HBM3 at 700 W): no pipe is saturated by that count,
// so the lane's chain of dependent steps (465 table steps, a division
// chain and a draw per kernel) and its branches set the time.
//
// jax_normal: S keys x M counters of JAX's float64 normal from
// fold_in(key, datum), the fleet scan's TP jitter (jax_engine.py:586),
// one thread an element.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int KIND_KERNEL = 0, KIND_COMM = 1;   // else: pull to the barrier
constexpr int SHUFFLE_THREADS = 256;
constexpr int SHARED_THREADS = 256;             // rounded down to whole groups
constexpr int MAX_GROUP = 1024;

struct Args {
  const int* table;          // (n_steps, 3): kind, index, capped
  int n_steps;
  const double* rate_f;      // (L,) full rate
  const double* rate_f_s;    // (L,) slowed by the comm's contention
  const double* rm;          // (B,)
  const double* rm_s;        // (B,)
  const double* noise;       // (S, Kc, P)
  const double* gflop;       // (Kc,)
  const double* gbyte;       // (Kc,)
  const double* dur;         // (B, Km)
  long long L, P;            // lanes, lanes per sample
  int G, Kc, Km;
  double* out[6];            // emit: comp_start, comp_end, comp_ovl (Kc, L),
                             // comm_lstart (Km, L), comm_gend (B, Km),
                             // busy (L,); summary: t_iter (B,), util (L,)
  // the draw form: in place of noise and dur
  const unsigned* keys;      // (S, 2) raw keys
  unsigned datum;            // the iteration's fold_in datum
  const double* sigma;       // (S,)
  const double* base;        // (S, Km) cbytes / (comm_gbps 1e9)
  const double* spike_p;     // (S,)
  const double* spike_mult;  // (S,)
  int spike;
};

// ---- jax.random's threefry2x32 (partitionable) and its float64 draws ----
constexpr unsigned PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint2 threefry2x32(uint2 k, unsigned x0,
                                              unsigned x1) {
  const unsigned ks[3] = {k.x, k.y, k.x ^ k.y ^ PARITY};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = i % 2 ? 17 : 13, r1 = i % 2 ? 29 : 15,
              r2 = i % 2 ? 16 : 26, r3 = i % 2 ? 24 : 6;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r0) ^ x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r1) ^ x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r2) ^ x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
  return make_uint2(x0, x1);
}

// fold_in(k, d) and split(k, n)[j] of JAX's raw uint32 keys
__device__ __forceinline__ uint2 fold_in(uint2 k, unsigned d) {
  return threefry2x32(k, 0u, d);
}
__device__ __forceinline__ uint2 split_at(uint2 k, unsigned j) {
  return threefry2x32(k, 0u, j);
}

// [0, 1) from the 64-bit draw of key k at flat counter c: x0 << 32 | x1,
// its 52 high bits as the mantissa of [1, 2), less 1
__device__ __forceinline__ double unit_at(uint2 k, unsigned long long c) {
  const uint2 w = threefry2x32(k, (unsigned)(c >> 32), (unsigned)c);
  const unsigned hi = (w.x >> 12) | 0x3FF00000u;
  const unsigned lo = __funnelshift_r(w.y, w.x, 12);
  return __dsub_rn(__hiloint2double((int)hi, (int)lo), 1.0);
}

// jax.random.normal (float64) at counter c: sqrt(2) erfinv(u), u uniform on
// [nextafter(-1, 0), 1), where hi - lo rounds to 2
__device__ __forceinline__ double normal_at(uint2 k, unsigned long long c) {
  const double lo = __longlong_as_double(0xBFEFFFFFFFFFFFFFLL);
  const double u = fmax(lo, __dadd_rn(__dmul_rn(unit_at(k, c), 2.0), lo));
  return __dmul_rn(1.4142135623730951, erfinv(u));
}

// The read form's noise: a (S, Kc, P) factor per lane and kernel, a (B, Km)
// duration per group and comm.
struct ReadNoise {
  const double* nz;
  const double* dur;
  long long P, b;
  int Km;
  __device__ ReadNoise(const Args& a, long long lane, bool valid, double*)
      : nz(a.noise + (lane / a.P) * a.Kc * a.P + lane % a.P), dur(a.dur),
        P(a.P), b(lane / a.G), Km(a.Km) {}
  __device__ __forceinline__ double kernel(int i) {
    return nz[(long long)i * P];
  }
  __device__ __forceinline__ double comm(int j) { return dur[b * Km + j]; }
};

// The draw form's noise, drawn in registers.  The group's Km comm durations
// are drawn once, before the scan, lane g of the group drawing comms g,
// g + G, ..., into the block's shared memory (`durs`: the block's groups x
// Km); kernel(i) returns the factor drawn ahead and draws kernel i + 1's
// (kernels start in order, 0 first).
struct DrawNoise {
  uint2 k1;
  double sigma, next;
  const double* durs;
  unsigned long long ck;       // the lane's first counter: (lane in sample) Kc
  int Kc;
  __device__ DrawNoise(const Args& a, long long lane, bool valid,
                       double* sm_durs) {
    const long long s = valid ? lane / a.P : 0, q = valid ? lane % a.P : 0;
    const uint2 k = fold_in(make_uint2(a.keys[2 * s], a.keys[2 * s + 1]),
                            a.datum);
    k1 = split_at(k, 0);
    sigma = a.sigma[s];
    Kc = a.Kc;
    ck = (unsigned long long)q * a.Kc;
    const int g = (int)(lane % a.G);
    double* mine = sm_durs + (threadIdx.x / a.G) * a.Km;
    if (valid && g < a.Km) {
      const uint2 k2 = split_at(k, 1), k3 = split_at(k, 2);
      const uint2 ks = split_at(k3, 0), ku = split_at(k3, 1);
      const unsigned long long cm = (unsigned long long)(q / a.G) * a.Km;
      for (int j = g; j < a.Km; j += a.G) {
        const double e = exp(__dmul_rn(sigma, normal_at(k2, cm + j)));
        double d = __dmul_rn(a.base[s * a.Km + j], e);
        if (a.spike && unit_at(ks, cm + j) < a.spike_p[s])
          d = __dmul_rn(d, __dmul_rn(a.spike_mult[s],
                                     __dadd_rn(1.0, unit_at(ku, cm + j))));
        mine[j] = d;
      }
    }
    durs = mine;
    next = valid ? factor(0) : 0.0;
  }
  __device__ __forceinline__ double factor(int i) {
    return exp(__dmul_rn(sigma, normal_at(k1, ck + i)));
  }
  __device__ __forceinline__ double kernel(int i) {
    const double n = next;
    if (i + 1 < Kc) next = factor(i + 1);
    return n;
  }
  __device__ __forceinline__ double comm(int j) { return durs[j]; }
};

// the max of v over the lane's group: width-W shuffles, or (W 0) shared memory
template <int W>
__device__ __forceinline__ double group_max(double v, double* sm, int G) {
  if constexpr (W > 0) {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1)
      v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  } else {
    sm[threadIdx.x] = v;
    __syncthreads();
    const int base = threadIdx.x - threadIdx.x % G;
    double m = sm[base];
    for (int k = 1; k < G; ++k) m = fmax(m, sm[base + k]);
    __syncthreads();
    return m;
  }
}

// The scan over the step table with the noise of Source (ReadNoise or
// DrawNoise).  The draw form's shared memory: the group max's doubles
// (blockDim.x of them on the shared path), the block's comm durations
// (blockDim.x / G groups x Km doubles), the step table packed a word a step.
template <bool EMIT, int W, typename Source>
__device__ __forceinline__ void window_scan(const Args& a) {
  extern __shared__ double sm[];
  constexpr bool DRAW = std::is_same<Source, DrawNoise>::value;
  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < a.L;
  const long long b = lane / a.G;
  const bool first = lane % a.G == 0;
  const double rate_f = valid ? a.rate_f[lane] : 1.0;
  const double rate_f_s = valid ? a.rate_f_s[lane] : 1.0;
  const double rm = valid ? a.rm[b] : 1.0;
  const double rm_s = valid ? a.rm_s[b] : 1.0;
  double* durs = sm + (W > 0 ? 0 : blockDim.x);
  int* steps = reinterpret_cast<int*>(durs + blockDim.x / a.G * a.Km);
  if constexpr (DRAW) {
    for (int s = threadIdx.x; s < a.n_steps; s += blockDim.x)
      steps[s] = a.table[3 * s] | (a.table[3 * s + 2] != 0) << 2 |
                 a.table[3 * s + 1] << 3;
  }
  Source src(a, lane, valid, durs);
  if constexpr (DRAW) __syncthreads();

  double t = 0.0, gfr = 0.0, gbr = 0.0, busy = 0.0, cur_start = 0.0;
  double prev_end = 0.0, ovl = 0.0;
  int ci = 0;
  bool started = false;
  for (int s = 0; s < a.n_steps; ++s) {
    int kind, i;
    bool cap;
    if constexpr (DRAW) {
      const int w = steps[s];
      kind = w & 3;
      cap = (w >> 2) & 1;
      i = w >> 3;
    } else {
      kind = __ldg(a.table + 3 * s);
      i = __ldg(a.table + 3 * s + 1);
      cap = __ldg(a.table + 3 * s + 2) != 0;
    }
    if (kind == KIND_KERNEL) {
      if (valid && ci == i) {
        const long long at = (long long)i * a.L + lane;
        const double ts = cap ? prev_end : INF;
        const double rf = cap ? rate_f_s : rate_f;
        const double rmm = cap ? rm_s : rm;
        if (!started) {
          started = true;
          cur_start = t;
          const double n = src.kernel(i);
          gfr = __dmul_rn(__ldg(a.gflop + i), n);
          gbr = __dmul_rn(__ldg(a.gbyte + i), n);
          ovl = 0.0;
          if (EMIT) a.out[0][at] = t;
        }
        const double dt = __dadd_rn(__ddiv_rn(gfr, rf), __ddiv_rn(gbr, rmm));
        const double tn = __dadd_rn(t, dt);
        if (tn <= ts) {                          // finishes in this step
          t = tn;
          busy = __dadd_rn(busy, __dsub_rn(t, cur_start));
          started = false;
          ci = i + 1;
          if (EMIT) {
            a.out[1][at] = t;
            if (cap) ovl = __dadd_rn(ovl, dt);
          }
        } else if (cap) {                        // partial, to the barrier
          const double avail = __dsub_rn(ts, t);
          if (avail > 0.0) {
            const double use = fmin(avail, __ddiv_rn(gfr, rate_f_s));
            gbr = fmax(0.0, __dsub_rn(gbr, __dmul_rn(__dsub_rn(avail, use),
                                                     rm_s)));
            gfr = __dsub_rn(gfr, __dmul_rn(use, rate_f_s));
            if (EMIT) ovl = __dadd_rn(ovl, avail);
          }
        }
        if (EMIT && cap) a.out[2][at] = ovl;
      }
    } else if (kind == KIND_COMM) {              // uniform: every thread
      if (EMIT && valid) a.out[3][(long long)i * a.L + lane] = t;
      const double d = valid ? src.comm(i) : 0.0;
      prev_end = __dadd_rn(group_max<W>(t, sm, a.G), d);
      if (EMIT && valid && first) a.out[4][b * a.Km + i] = prev_end;
    } else {
      t = prev_end;
    }
  }
  if constexpr (EMIT) {
    if (valid) a.out[5][lane] = busy;
  } else {
    const double t_iter = fmax(group_max<W>(t, sm, a.G), prev_end);
    if (valid) {
      a.out[1][lane] = __ddiv_rn(busy, fmax(t_iter, 1e-12));
      if (first) a.out[0][b] = t_iter;
    }
  }
}

// blocks of 256 an SM: the draw form's registers are capped at 64 so that
// four fit, and 64 fleets of 256 nodes of 8 lanes (512 blocks) run in one
// wave on 132 SMs (uncapped, ptxas takes 80 and three fit)
template <typename Source>
constexpr int min_blocks() {
  return std::is_same<Source, DrawNoise>::value ? 4 : 1;
}

template <bool EMIT, int W, typename Source>
__global__ void __launch_bounds__(SHUFFLE_THREADS, min_blocks<Source>())
    c3_window_shuffle(const Args a) {
  window_scan<EMIT, W, Source>(a);
}

template <bool EMIT, typename Source>
__global__ void __launch_bounds__(MAX_GROUP) c3_window_shared(const Args a) {
  window_scan<EMIT, 0, Source>(a);
}

// dynamic shared memory: the group max's doubles, and the draw form's table
template <typename K>
cudaError_t shared_bytes(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the draw form's shared memory past the group max's: the block's comm
// durations and the packed table
template <typename Source>
size_t draw_bytes(const Args& a, int threads) {
  if (!std::is_same<Source, DrawNoise>::value) return 0;
  return (size_t)(threads / a.G) * a.Km * sizeof(double) +
         a.n_steps * sizeof(int);
}

template <bool EMIT, int W, typename Source>
cudaError_t launch_shuffle(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.L + SHUFFLE_THREADS - 1) / SHUFFLE_THREADS;
  const size_t bytes = draw_bytes<Source>(a, SHUFFLE_THREADS);
  auto kernel = c3_window_shuffle<EMIT, W, Source>;
  const cudaError_t err = shared_bytes(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, SHUFFLE_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool EMIT, typename Source>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch (a.G) {       // the powers of two that divide 32: shuffles
    case 1: return launch_shuffle<EMIT, 1, Source>(a, stream);
    case 2: return launch_shuffle<EMIT, 2, Source>(a, stream);
    case 4: return launch_shuffle<EMIT, 4, Source>(a, stream);
    case 8: return launch_shuffle<EMIT, 8, Source>(a, stream);
    case 16: return launch_shuffle<EMIT, 16, Source>(a, stream);
    case 32: return launch_shuffle<EMIT, 32, Source>(a, stream);
    default: break;
  }
  const int threads = a.G >= SHARED_THREADS ? a.G
                                            : SHARED_THREADS / a.G * a.G;
  const long long blocks = (a.L + threads - 1) / threads;
  const size_t bytes = threads * sizeof(double) + draw_bytes<Source>(a, threads);
  auto kernel = c3_window_shared<EMIT, Source>;
  const cudaError_t err = shared_bytes(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

constexpr int NORMAL_THREADS = 256;

__global__ void __launch_bounds__(NORMAL_THREADS)
jax_normal_kernel(const unsigned* keys, unsigned datum, long long M,
                  long long n, double* out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long s = e / M;
  const uint2 k = fold_in(make_uint2(keys[2 * s], keys[2 * s + 1]), datum);
  out[e] = normal_at(k, (unsigned long long)(e % M));
}

}  // namespace

EXPORT_ERROR_STRING

// One iteration of L / G groups of G lanes; emit != 0: the trace into out0..5,
// else t_iter into out0 and util into out1.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a shape it cannot take).
extern "C" int c3_window(const int* table, int n_steps, const double* rate_f,
                         const double* rate_f_s, const double* rm,
                         const double* rm_s, const double* noise,
                         const double* gflop, const double* gbyte,
                         const double* dur, long long L, long long P, int G,
                         int Kc, int Km, int emit, double* out0, double* out1,
                         double* out2, double* out3, double* out4,
                         double* out5, cudaStream_t stream) {
  if (G < 1 || G > MAX_GROUP || L < 1 || L % G || P < 1 || L % P || Kc < 1 ||
      Km < 0 || n_steps < 0)
    return cudaErrorInvalidValue;
  Args a{table, n_steps, rate_f, rate_f_s, rm, rm_s, noise, gflop, gbyte, dur,
         L, P, G, Kc, Km,
         {out0, out1, out2, out3, out4, out5}};
  return emit ? launch<true, ReadNoise>(a, stream)
              : launch<false, ReadNoise>(a, stream);
}

// The draw form, summary mode: t_iter (B,) into t_iter, util (L,) into util,
// the noise drawn from keys (S, 2) at fold_in datum `datum` (S = L / P).
extern "C" int c3_window_draw(const int* table, int n_steps,
                              const double* rate_f, const double* rate_f_s,
                              const double* rm, const double* rm_s,
                              const unsigned* keys, unsigned datum,
                              const double* sigma, const double* base,
                              const double* spike_p, const double* spike_mult,
                              int spike, const double* gflop,
                              const double* gbyte, long long L, long long P,
                              int G, int Kc, int Km, double* t_iter,
                              double* util, cudaStream_t stream) {
  if (G < 1 || G > MAX_GROUP || L < 1 || L % G || P < 1 || L % P || P % G ||
      Kc < 1 || Km < 0 || n_steps < 0)
    return cudaErrorInvalidValue;
  Args a{table, n_steps, rate_f, rate_f_s, rm, rm_s, nullptr, gflop, gbyte,
         nullptr, L, P, G, Kc, Km, {t_iter, util}, keys, datum, sigma, base,
         spike_p, spike_mult, spike};
  return launch<false, DrawNoise>(a, stream);
}

// out (S, M): jax.random.normal(fold_in(keys[s], datum), (M,)) in float64.
extern "C" int jax_normal(const unsigned* keys, unsigned datum, long long S,
                          long long M, double* out, cudaStream_t stream) {
  if (S < 1 || M < 1) return cudaErrorInvalidValue;
  const long long n = S * M;
  jax_normal_kernel<<<(unsigned)((n + NORMAL_THREADS - 1) / NORMAL_THREADS),
                      NORMAL_THREADS, 0, stream>>>(keys, datum, M, n, out);
  return cudaGetLastError();
}

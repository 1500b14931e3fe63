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
// Bound: bytes.  The noise, 8 B per lane and kernel, is what it reads
// (Kc x lanes x 8: 135 MB for 256 nodes of 8 lanes at Kc 129); per lane and
// kernel ~6 float64 operations, two of them divisions, against the card's
// 34 TFLOP/s of float64 outside the tensor cores.  Every step costs every
// thread a few instructions, and a lane's steps are a chain of dependent
// divisions, so at small populations latency, not either bound, sets the
// time.
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

template <bool EMIT, int W>
__device__ __forceinline__ void window_scan(const Args& a) {
  extern __shared__ double sm[];
  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < a.L;
  const long long b = lane / a.G;
  const bool first = lane % a.G == 0;
  const double rate_f = valid ? a.rate_f[lane] : 1.0;
  const double rate_f_s = valid ? a.rate_f_s[lane] : 1.0;
  const double rm = valid ? a.rm[b] : 1.0;
  const double rm_s = valid ? a.rm_s[b] : 1.0;
  const double* nz = a.noise + (lane / a.P) * a.Kc * a.P + lane % a.P;

  double t = 0.0, gfr = 0.0, gbr = 0.0, busy = 0.0, cur_start = 0.0;
  double prev_end = 0.0, ovl = 0.0;
  int ci = 0;
  bool started = false;
  for (int s = 0; s < a.n_steps; ++s) {
    const int kind = __ldg(a.table + 3 * s);
    const int i = __ldg(a.table + 3 * s + 1);
    const bool cap = __ldg(a.table + 3 * s + 2) != 0;
    if (kind == KIND_KERNEL) {
      if (valid && ci == i) {
        const long long at = (long long)i * a.L + lane;
        const double ts = cap ? prev_end : INF;
        const double rf = cap ? rate_f_s : rate_f;
        const double rmm = cap ? rm_s : rm;
        if (!started) {
          started = true;
          cur_start = t;
          const double n = nz[(long long)i * a.P];
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
      const double d = valid ? a.dur[b * a.Km + i] : 0.0;
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

template <bool EMIT, int W>
__global__ void __launch_bounds__(SHUFFLE_THREADS) c3_window_shuffle(const Args a) {
  window_scan<EMIT, W>(a);
}

template <bool EMIT>
__global__ void __launch_bounds__(MAX_GROUP) c3_window_shared(const Args a) {
  window_scan<EMIT, 0>(a);
}

template <bool EMIT, int W>
cudaError_t launch_shuffle(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.L + SHUFFLE_THREADS - 1) / SHUFFLE_THREADS;
  c3_window_shuffle<EMIT, W><<<(unsigned)blocks, SHUFFLE_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool EMIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch (a.G) {       // the powers of two that divide 32: shuffles
    case 1: return launch_shuffle<EMIT, 1>(a, stream);
    case 2: return launch_shuffle<EMIT, 2>(a, stream);
    case 4: return launch_shuffle<EMIT, 4>(a, stream);
    case 8: return launch_shuffle<EMIT, 8>(a, stream);
    case 16: return launch_shuffle<EMIT, 16>(a, stream);
    case 32: return launch_shuffle<EMIT, 32>(a, stream);
    default: break;
  }
  const int threads = a.G >= SHARED_THREADS ? a.G
                                            : SHARED_THREADS / a.G * a.G;
  const long long blocks = (a.L + threads - 1) / threads;
  c3_window_shared<EMIT><<<(unsigned)blocks, threads,
                           threads * sizeof(double), stream>>>(a);
  return cudaGetLastError();
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
  return emit ? launch<true>(a, stream) : launch<false>(a, stream);
}

// Fused real FFT + no-delay optimal-filter reduction: float32 traces
// [B, N] -> per-slot sums q [B, S] and chi2_0 [B, S] in float64.
//
// Replaces the TPU kernel detprocess_tpu/ops/pallas_of.py::FusedNodelayOF,
// which ran a four-step DFT-by-matmul over tiles of 8 traces in VMEM in a
// scrambled 2-D layout and reduced with selector matmuls. Here one thread
// block owns one trace, transforms it with the register-resident FFT of
// fft_regs.cuh, untangles each half-spectrum bin X_k and reduces, for every
// filter slot s of the bank,
//
//   q_s    = Σ_k (w_k φ_{s,k}) · X_k     (real part)
//   chi2_0 = Σ_k (w_k d_{s,k}) · |X_k|²
//
// with w = (1, 2, …, 2, 1) the half-spectrum bin weights and d = 1/(N·fs·J)
// the inverse noise weights, folded into the rows by the host (w·φ and w·d,
// exact since w is 1 or 2). The spectrum never reaches HBM; the caller
// forms amp = q/norm and chi2 = chi2_0 − q²/norm.
//
// What bounds it on an H100: HBM bytes. At B = 8192, N = 32768 it must
// read 1.074 GB of traces, 0.320 ms at 3.35 TB/s; its FFT and sums are
// about 11 GFLOP of float32, 0.16 ms at 67 TFLOP/s. What held the first
// form (shared-memory radix-4 stages, as in the first rFFT kernel) far
// from that, and what this one does about it:
// - 7 stages, each a full read, barrier, write and barrier over shared
//   memory, with 4-way bank conflicts early, and a trace staged through
//   shared memory before the first: now 4 radix-16 passes in registers, the
//   first read straight from HBM, a padded layout free of conflicts;
// - 24 bytes of L2 reads per bin at S = 1 (bin weight, φ, d and an
//   M-entry twiddle table): now w·φ and w·d only (12 bytes), the untangle
//   twiddle W_N^k = W_N^{64·⌊k/64⌋} · W_N^{k mod 64} from two small tables
//   in shared memory, and 16 bins a thread fixed at compile time, 4 at a
//   time, so that their loads are in flight together;
// - at most 8 slots: now groups of 4, 2 and 1 slots over the spectrum
//   held in shared memory, so the trace is read once whatever S is.
// Per-thread partial sums and the block reduction are float64, so the
// chi2 cancellation chi2_0 − q²/norm starts from exact block sums. At
// every N the kernel fits 64 registers a thread without spilling.
//
// The kStamp instance writes, per block, SM clocks of four phases (load;
// FFT passes; untangle and sums; reduction) to `stamps` [B, 4]; in the
// main-path instance the stamps compile away.
//
// C interface (loaded with ctypes): each entry returns a cudaError_t
// code; 0 means the launch was accepted.

#include "fft_regs.cuh"

namespace {

// slots reduced together at most: 4 pairs of float64 accumulators leave
// the epilogue room under the 64 registers of 1024 threads (groups of 8
// spilled at N = 32768)
constexpr int kGroup = 4;
constexpr int kLoBits = 6;     // untangle twiddle W_N^k = hi[k >> 6]·lo[k & 63]

template <int LOG2M>
struct FusedShape {
  using S = dpr::Shape<LOG2M>;
  static constexpr int NH = S::M + 1;
  static constexpr int NLO = 1 << kLoBits;
  static constexpr int NHI = S::M >> kLoBits;
  static constexpr int LANES = S::THREADS < 32 ? S::THREADS : 32;
  static constexpr int WARPS = S::THREADS / LANES;
  static constexpr size_t SMEM_BYTES =
      sizeof(float2) * (S::PADDED + NLO + NHI) +
      sizeof(double) * 2 * kGroup * WARPS;
};

__device__ __forceinline__ long long stamp_now() { return clock64(); }

// One group of G slots starting at s0: untangle this thread's 16 bins
// (and the Nyquist bin on thread 0), accumulate, reduce over the block and
// write q and chi2_0. Ends with a block barrier.
template <int LOG2M, int G>
__device__ __forceinline__ void slot_group(
    const float2* s, const float2* lo, const float2* hi,
    const float2* __restrict__ phiw, const float* __restrict__ dinvw,
    int nslots, int s0, double* red,
    double* __restrict__ q_out, double* __restrict__ c0_out,
    long long& clk_sums, long long& clk_red, bool stamp) {
  using S = dpr::Shape<LOG2M>;
  using F = FusedShape<LOG2M>;
  const long long t0 = stamp ? stamp_now() : 0;
  const int tid = dpr::fresh_tid();
  double q[G];
  double c0[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    q[g] = 0.0;
    c0[g] = 0.0;
  }
  const float2* prow = phiw + static_cast<long long>(s0) * F::NH;
  const float* drow = dinvw + static_cast<long long>(s0) * F::NH;
  // a fixed set of 16 bins; 4 at a time keeps their loads in flight
  // without spilling
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int k = tid + i * S::THREADS;
    const float2 zk = s[dpr::pad(k)];
    float2 zr = s[dpr::pad((S::M - k) & (S::M - 1))];
    zr.y = -zr.y;
    const float2 w = dpr::cmul(hi[k >> kLoBits], lo[k & (F::NLO - 1)]);
    // X_k = ½(Z_k + conj Z_{M−k}) − ½·i·W_N^k·(Z_k − conj Z_{M−k})
    const float2 e = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y + zr.y));
    const float2 o = make_float2(0.5f * (zk.x - zr.x), 0.5f * (zk.y - zr.y));
    const float2 wo = dpr::cmul(w, o);
    const float2 xk = make_float2(e.x + wo.y, e.y - wo.x);
    const float p2 = xk.x * xk.x + xk.y * xk.y;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float2 ph = __ldg(prow + g * F::NH + k);
      const float d = __ldg(drow + g * F::NH + k);
      q[g] += static_cast<double>(ph.x * xk.x - ph.y * xk.y);
      c0[g] += static_cast<double>(d * p2);
    }
  }
  if (tid == 0) {                     // Nyquist bin X_M = Re Z_0 − Im Z_0
    const float2 z0 = s[0];
    const float xm = z0.x - z0.y;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      q[g] += static_cast<double>(__ldg(prow + g * F::NH + S::M).x * xm);
      c0[g] += static_cast<double>(__ldg(drow + g * F::NH + S::M) *
                                   (xm * xm));
    }
  }
  long long t1 = 0;
  if (stamp) {
    __syncthreads();
    t1 = stamp_now();
    clk_sums += t1 - t0;
  }

  constexpr unsigned kMask =
      F::LANES == 32 ? 0xffffffffu : ((1u << F::LANES) - 1u);
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = F::LANES / 2; off > 0; off >>= 1) {
      q[g] += __shfl_down_sync(kMask, q[g], off);
      c0[g] += __shfl_down_sync(kMask, c0[g], off);
    }
  }
  const int warp = tid / F::LANES;
  if (tid % F::LANES == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red[(warp * G + g) * 2] = q[g];
      red[(warp * G + g) * 2 + 1] = c0[g];
    }
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    const long long b = dpr::fresh_bid();
    double qs = 0.0;
    double cs = 0.0;
    for (int wp = 0; wp < F::WARPS; ++wp) {
      qs += red[(wp * G + g) * 2];
      cs += red[(wp * G + g) * 2 + 1];
    }
    q_out[b * nslots + s0 + g] = qs;
    c0_out[b * nslots + s0 + g] = cs;
  }
  __syncthreads();                    // red is reused by the next group
  if (stamp) clk_red += stamp_now() - t1;
}

template <int LOG2M, bool kStamp>
__global__ void __launch_bounds__(dpr::Shape<LOG2M>::THREADS,
                                  dpr::Shape<LOG2M>::MIN_BLOCKS)
    fused_nodelay_kernel(const float2* __restrict__ x,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ phiw,
                         const float* __restrict__ dinvw, int nslots,
                         double* __restrict__ q_out,
                         double* __restrict__ c0_out,
                         long long* __restrict__ stamps) {
  using S = dpr::Shape<LOG2M>;
  using F = FusedShape<LOG2M>;
  extern __shared__ float4 smem4[];
  float2* s = reinterpret_cast<float2*>(smem4);
  float2* lo = s + S::PADDED;
  float2* hi = lo + F::NLO;
  double* red = reinterpret_cast<double*>(hi + F::NHI);
  const long long b = blockIdx.x;
  long long clk[4] = {0, 0, 0, 0};
  long long t = kStamp ? stamp_now() : 0;

  float2 v[16];
  dpr::load_first<LOG2M>(x + b * S::M, v);
  // the untangle's factor tables, published to the epilogue by the
  // passes' barriers
  for (int i = dpr::fresh_tid(); i < F::NLO + F::NHI; i += S::THREADS) {
    lo[i] = __ldg(tw + (i < F::NLO ? i : (i - F::NLO) << kLoBits));
  }
  if constexpr (kStamp) {
    // wait for this thread's 16 loads, then for every thread's
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) acc += v[r].x + v[r].y;
    if (__float_as_uint(acc) == 0xffffffffu) stamps[b * 4] = 0;
    __syncthreads();
    const long long now = stamp_now();
    clk[0] = now - t;
    t = now;
  }

  dpr::first_pass<LOG2M>(v, s);
  dpr::other_passes<LOG2M>(v, s, tw);
  if constexpr (kStamp) clk[1] = stamp_now() - t;

  // full groups, then the rest in groups of 2 and 1 (kGroup = 4)
  static_assert(kGroup == 4, "the remainder below takes groups of 2 and 1");
  int s0 = 0;
  for (; s0 + kGroup <= nslots; s0 += kGroup) {
    slot_group<LOG2M, kGroup>(s, lo, hi, phiw, dinvw, nslots, s0, red,
                              q_out, c0_out, clk[2], clk[3], kStamp);
  }
  if (nslots & 2) {
    slot_group<LOG2M, 2>(s, lo, hi, phiw, dinvw, nslots, s0, red, q_out,
                         c0_out, clk[2], clk[3], kStamp);
    s0 += 2;
  }
  if (nslots & 1) {
    slot_group<LOG2M, 1>(s, lo, hi, phiw, dinvw, nslots, s0, red, q_out,
                         c0_out, clk[2], clk[3], kStamp);
  }
  if constexpr (kStamp) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < 4; ++p) stamps[b * 4 + p] = clk[p];
    }
  }
}

template <int LOG2M, bool kStamp>
int launch_fused(const float2* x, const float2* tw, const float2* phiw,
                 const float* dinvw, int nslots, long long batch,
                 double* q_out, double* c0_out, long long* stamps,
                 cudaStream_t stream) {
  using F = FusedShape<LOG2M>;
  cudaError_t err = cudaFuncSetAttribute(
      fused_nodelay_kernel<LOG2M, kStamp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_nodelay_kernel<LOG2M, kStamp>
      <<<static_cast<unsigned>(batch), dpr::Shape<LOG2M>::THREADS,
         F::SMEM_BYTES, stream>>>(x, tw, phiw, dinvw, nslots, q_out, c0_out,
                                  stamps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStamp>
int fused_entry(const void* x, const void* tw, const void* phiw,
                const void* dinvw, int nslots, long long batch, int n,
                void* q_out, void* c0_out, void* stamps, int device,
                void* stream) {
  dpr::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (batch <= 0 || batch > 0x7fffffffLL || nslots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float2* xp = static_cast<const float2*>(x);
  const float2* twp = static_cast<const float2*>(tw);
  const float2* php = static_cast<const float2*>(phiw);
  const float* dp_ = static_cast<const float*>(dinvw);
  double* qp = static_cast<double*>(q_out);
  double* cp = static_cast<double*>(c0_out);
  long long* sp = static_cast<long long*>(stamps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DP_LAUNCH_FUSED(L) \
  launch_fused<L, kStamp>(xp, twp, php, dp_, nslots, batch, qp, cp, sp, st)
  DPR_DISPATCH_N(n, DP_LAUNCH_FUSED)
#undef DP_LAUNCH_FUSED
}

}  // namespace

extern "C" int dp_fused_nodelay_of_f32(const void* x, const void* tw,
                                       const void* phiw, const void* dinvw,
                                       int nslots, long long batch, int n,
                                       void* q_out, void* c0_out, int device,
                                       void* stream) {
  return fused_entry<false>(x, tw, phiw, dinvw, nslots, batch, n, q_out,
                            c0_out, nullptr, device, stream);
}

// The same kernel with the phase stamps: stamps [B, 4] int64 SM clocks.
extern "C" int dp_fused_nodelay_of_stamped_f32(
    const void* x, const void* tw, const void* phiw, const void* dinvw,
    int nslots, long long batch, int n, void* q_out, void* c0_out,
    void* stamps, int device, void* stream) {
  return fused_entry<true>(x, tw, phiw, dinvw, nslots, batch, n, q_out,
                           c0_out, stamps, device, stream);
}

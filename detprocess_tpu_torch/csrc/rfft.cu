// Batched real FFT: float32 traces [B, N] -> natural-order half spectrum
// complex64 [B, N/2 + 1].
//
// Replaces the TPU kernel detprocess_tpu/ops/pallas_fft.py::fft_pallas,
// a four-step DFT-by-matmul over tiles of 8 traces held in VMEM that
// emitted the full spectrum. Here one thread block owns one trace and
// transforms it with the register-resident FFT of fft_regs.cuh: the
// packed trace z[m] = x[2m] + i·x[2m+1] (M = N/2) is read from HBM
// straight into registers, 16 values a thread, and radix-16 Stockham
// passes run in registers with one exchange through a padded shared
// buffer between passes (4 passes at N = 32768). The untangle then writes
// the N/2 + 1 natural-order bins once.
//
// What bounds it on an H100: HBM bytes at best. Per trace it reads 4·N
// bytes and writes 8·(N/2 + 1): at B = 8192, N = 32768 that is 2.15 GB,
// 0.641 ms at 3.35 TB/s, against about 11 GFLOP of float32 (0.16 ms at
// 67 TFLOP/s). What held the first form (seven barrier-separated radix-4
// stages over an unpadded shared buffer, the trace staged through shared
// memory, an M-entry twiddle table read from L2 for every bin) at 1.7×
// cuFFT, and what this one does about it:
// - the passes: 4 radix-16 passes in registers, two barriers each, on a
//   padded layout free of bank conflicts, the first read from HBM;
// - the untangle: one thread forms the pair of bins k and M − k from one
//   read of Z_k and Z_{M−k}, with one twiddle W_N^k = hi[k >> 6]·lo[k & 63]
//   from two small tables in shared memory, since
//
//     X_k     = e − i·W·o,    X_{M−k} = conj(e + i·W·o),
//     e = ½(Z_k + conj Z_{M−k}),  o = ½(Z_k − conj Z_{M−k}),  W = W_N^k
//
//   (W_N^{M−k} = −conj W_N^k). At k = 0 the pair is X_0 and the Nyquist
//   bin X_M; thread 0 writes the middle bin X_{M/2} = conj Z_{M/2}. The
//   rows have a stride of M + 1 complex values, so a row start is only
//   8-byte aligned: each warp writes both bins of its pairs as coalesced
//   float2 stores, one run ascending and one descending.
// At N = 32768 the padded buffer and the tables take 141,824 bytes, so one
// block of 1024 threads runs on an SM; __launch_bounds__ holds every
// instance to 64 registers a thread, without spills. On an H100 80GB HBM3
// at 700 W it takes 0.811 ms at B = 8192, N = 32768 (79 % of the bound;
// cuFFT 0.975 ms). Its phases (load 6.5k, passes 15.7k, untangle and
// store 6.3k SM clocks a trace) run one after another: with one block an
// SM, nothing overlaps one trace's load with another's passes.
//
// The kStamp instance writes, per block, the SM clocks of three phases
// (load; FFT passes; untangle and store) to `stamps` [B, 3]; in the
// main-path instance the stamps compile away.
//
// C interface (loaded with ctypes): each entry returns a cudaError_t code;
// 0 means the launch was accepted.

#include "fft_regs.cuh"

namespace {

constexpr int kLoBits = 6;  // untangle twiddle W_N^k = hi[k >> 6]·lo[k & 63]
constexpr int kPhases = 3;  // stamps a trace: load, passes, untangle + store

template <int LOG2M>
struct RfftShape {
  using S = dpr::Shape<LOG2M>;
  static constexpr int NLO = 1 << kLoBits;
  static constexpr int NHI = S::M >> kLoBits;
  static constexpr int PAIRS = S::M / 2 / S::THREADS;   // bin pairs a thread
  static constexpr size_t SMEM_BYTES =
      sizeof(float2) * (S::PADDED + NLO + NHI);
};

__device__ __forceinline__ long long stamp_now() { return clock64(); }

// Untangle the transform Z (padded shared buffer) into this block's row of
// the half spectrum: bins k and M − k for this thread's k < M/2, and the
// middle bin on thread 0.
template <int LOG2M>
__device__ __forceinline__ void untangle_store(const float2* s,
                                               const float2* lo,
                                               const float2* hi,
                                               float2* __restrict__ out) {
  using S = dpr::Shape<LOG2M>;
  using F = RfftShape<LOG2M>;
  const int tid = dpr::fresh_tid();
  float2* orow = out + static_cast<long long>(dpr::fresh_bid()) * (S::M + 1);
  // 4 pairs at a time keeps their shared reads in flight without spilling
#pragma unroll 4
  for (int i = 0; i < F::PAIRS; ++i) {
    const int k = tid + i * S::THREADS;
    const float2 zk = s[dpr::pad(k)];
    const float2 zr = s[dpr::pad((S::M - k) & (S::M - 1))];
    const float2 w = dpr::cmul(hi[k >> kLoBits], lo[k & (F::NLO - 1)]);
    // e and o with conj Z_{M−k} = (zr.x, −zr.y)
    const float2 e = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
    const float2 o = make_float2(0.5f * (zk.x - zr.x), 0.5f * (zk.y + zr.y));
    const float2 wo = dpr::cmul(w, o);
    orow[k] = make_float2(e.x + wo.y, e.y - wo.x);
    orow[S::M - k] = make_float2(e.x - wo.y, -(e.y + wo.x));
  }
  if (tid == 0) {
    const float2 z = s[dpr::pad(S::M / 2)];
    orow[S::M / 2] = make_float2(z.x, -z.y);
  }
}

template <int LOG2M, bool kStamp>
__global__ void __launch_bounds__(dpr::Shape<LOG2M>::THREADS,
                                  dpr::Shape<LOG2M>::MIN_BLOCKS)
    rfft_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                const float2* __restrict__ tw,
                long long* __restrict__ stamps) {
  using S = dpr::Shape<LOG2M>;
  using F = RfftShape<LOG2M>;
  extern __shared__ float4 smem4[];
  float2* s = reinterpret_cast<float2*>(smem4);
  float2* lo = s + S::PADDED;
  float2* hi = lo + F::NLO;
  const long long b = blockIdx.x;
  long long clk[kPhases] = {0, 0, 0};
  long long t = kStamp ? stamp_now() : 0;

  float2 v[16];
  dpr::load_first<LOG2M>(x + b * S::M, v);
  // the untangle's factor tables, written while the loads are in flight
  // and published to the epilogue by the passes' barriers
  for (int i = dpr::fresh_tid(); i < F::NLO + F::NHI; i += S::THREADS) {
    lo[i] = __ldg(tw + (i < F::NLO ? i : (i - F::NLO) << kLoBits));
  }
  if constexpr (kStamp) {
    // wait for this thread's 16 loads, then for every thread's
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) acc += v[r].x + v[r].y;
    if (__float_as_uint(acc) == 0xffffffffu) stamps[b * kPhases] = 0;
    __syncthreads();
    const long long now = stamp_now();
    clk[0] = now - t;
    t = now;
  }

  dpr::first_pass<LOG2M>(v, s);
  dpr::other_passes<LOG2M>(v, s, tw);
  if constexpr (kStamp) {
    const long long now = stamp_now();
    clk[1] = now - t;
    t = now;
  }

  untangle_store<LOG2M>(s, lo, hi, out);
  if constexpr (kStamp) {
    __syncthreads();
    clk[2] = stamp_now() - t;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < kPhases; ++p) stamps[b * kPhases + p] = clk[p];
    }
  }
}

template <int LOG2M, bool kStamp>
int launch_rfft(const float2* x, float2* out, const float2* tw,
                long long* stamps, long long batch, cudaStream_t stream) {
  using F = RfftShape<LOG2M>;
  cudaError_t err = cudaFuncSetAttribute(
      rfft_kernel<LOG2M, kStamp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  rfft_kernel<LOG2M, kStamp>
      <<<static_cast<unsigned>(batch), dpr::Shape<LOG2M>::THREADS,
         F::SMEM_BYTES, stream>>>(x, out, tw, stamps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStamp>
int rfft_entry(const void* x, void* out, const void* tw, void* stamps,
               long long batch, int n, int device, void* stream) {
  dpr::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (batch <= 0 || batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float2* xp = static_cast<const float2*>(x);
  float2* op = static_cast<float2*>(out);
  const float2* twp = static_cast<const float2*>(tw);
  long long* sp = static_cast<long long*>(stamps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DP_LAUNCH_RFFT(L) launch_rfft<L, kStamp>(xp, op, twp, sp, batch, st)
  DPR_DISPATCH_N(n, DP_LAUNCH_RFFT)
#undef DP_LAUNCH_RFFT
}

}  // namespace

extern "C" int dp_rfft_f32(const void* x, void* out, const void* tw,
                           long long batch, int n, int device,
                           void* stream) {
  return rfft_entry<false>(x, out, tw, nullptr, batch, n, device, stream);
}

// The same kernel with the phase stamps: stamps [B, 3] int64 SM clocks.
extern "C" int dp_rfft_stamped_f32(const void* x, void* out, const void* tw,
                                   void* stamps, long long batch, int n,
                                   int device, void* stream) {
  return rfft_entry<true>(x, out, tw, stamps, batch, n, device, stream);
}

extern "C" const char* dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

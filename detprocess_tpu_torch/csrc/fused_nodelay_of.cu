// Fused real FFT + no-delay optimal-filter reduction: float32 traces
// [B, N] -> per-slot sums q [B, S] and chi2_0 [B, S] in float64.
//
// Replaces the TPU kernel detprocess_tpu/ops/pallas_of.py::FusedNodelayOF,
// which ran a four-step DFT-by-matmul over tiles of 8 traces in VMEM in a
// scrambled 2-D layout and reduced with selector matmuls. Here one thread
// block owns one trace: the rFFT of rfft_smem.cuh runs in shared memory,
// and the epilogue untangles each half-spectrum bin X_k in registers and
// reduces, for every filter slot s of the bank,
//
//   q_s    = Σ_k w_k · Re(φ_{s,k} X_k)
//   chi2_0 = Σ_k w_k · d_{s,k} · |X_k|²
//
// with w = (1, 2, …, 2, 1) the half-spectrum bin weights and d = 1/(N·fs·J)
// the inverse noise weights. The spectrum never reaches HBM; the caller
// forms amp = q/norm and chi2 = chi2_0 − q²/norm.
//
// What bounds it on an H100: HBM bytes. Per trace it reads 4·N bytes of
// trace (plus the bank rows, shared by all blocks through L2) and writes
// 16·S bytes. Per-thread partial sums and the block reduction are float64,
// so the chi2 cancellation chi2_0 − q²/norm starts from exact block sums.
//
// C interface (loaded with ctypes): dp_fused_nodelay_of_f32 returns a
// cudaError_t code; 0 means the launch was accepted.

#include "rfft_smem.cuh"

namespace {

constexpr int kMaxSlots = 8;

template <int LOG2M>
__global__ void __launch_bounds__(dp::FftShape<LOG2M>::THREADS)
    fused_nodelay_kernel(const float* __restrict__ x,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ phi,
                         const float* __restrict__ dinv,
                         const float* __restrict__ binw, int nslots,
                         double* __restrict__ q_out,
                         double* __restrict__ c0_out) {
  using S = dp::FftShape<LOG2M>;
  constexpr int NH = S::M + 1;
  constexpr int NWARPS = S::THREADS / 32;
  extern __shared__ float4 smem4[];
  float2* s = reinterpret_cast<float2*>(smem4);
  const long long b = blockIdx.x;

  dp::load_packed<LOG2M>(x + b * S::N, s);
  dp::fft_smem<LOG2M>(s, tw);

  double q[kMaxSlots];
  double c0[kMaxSlots];
#pragma unroll
  for (int sl = 0; sl < kMaxSlots; ++sl) {
    q[sl] = 0.0;
    c0[sl] = 0.0;
  }
  for (int k = threadIdx.x; k < NH; k += S::THREADS) {
    const float2 xk = k < S::M ? dp::untangle<LOG2M>(s, tw, k) : dp::nyquist(s);
    const float p2 = xk.x * xk.x + xk.y * xk.y;
    const float w = __ldg(binw + k);
#pragma unroll
    for (int sl = 0; sl < kMaxSlots; ++sl) {
      if (sl < nslots) {
        const float2 ph = __ldg(phi + sl * NH + k);
        const float d = __ldg(dinv + sl * NH + k);
        q[sl] += static_cast<double>(w * (ph.x * xk.x - ph.y * xk.y));
        c0[sl] += static_cast<double>(w * d * p2);
      }
    }
  }

  // warp sums, then one partial per warp through shared memory (the
  // spectrum is dead once every thread has passed the barrier)
#pragma unroll
  for (int sl = 0; sl < kMaxSlots; ++sl) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      q[sl] += __shfl_down_sync(0xffffffffu, q[sl], off);
      c0[sl] += __shfl_down_sync(0xffffffffu, c0[sl], off);
    }
  }
  __syncthreads();
  double* red = reinterpret_cast<double*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
#pragma unroll
    for (int sl = 0; sl < kMaxSlots; ++sl) {
      red[(warp * kMaxSlots + sl) * 2] = q[sl];
      red[(warp * kMaxSlots + sl) * 2 + 1] = c0[sl];
    }
  }
  __syncthreads();
  if (threadIdx.x < nslots) {
    const int sl = threadIdx.x;
    double qs = 0.0;
    double cs = 0.0;
    for (int wp = 0; wp < NWARPS; ++wp) {
      qs += red[(wp * kMaxSlots + sl) * 2];
      cs += red[(wp * kMaxSlots + sl) * 2 + 1];
    }
    q_out[b * nslots + sl] = qs;
    c0_out[b * nslots + sl] = cs;
  }
}

template <int LOG2M>
int launch_fused(const float* x, const float2* tw, const float2* phi,
                 const float* dinv, const float* binw, int nslots,
                 long long batch, double* q_out, double* c0_out,
                 cudaStream_t stream) {
  using S = dp::FftShape<LOG2M>;
  constexpr size_t red_bytes =
      sizeof(double) * 2 * kMaxSlots * (S::THREADS / 32);
  constexpr size_t smem =
      S::SMEM_BYTES > red_bytes ? S::SMEM_BYTES : red_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_nodelay_kernel<LOG2M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_nodelay_kernel<LOG2M><<<static_cast<unsigned>(batch), S::THREADS,
                                smem, stream>>>(x, tw, phi, dinv, binw,
                                                nslots, q_out, c0_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dp_fused_nodelay_of_max_slots() { return kMaxSlots; }

extern "C" int dp_fused_nodelay_of_f32(const void* x, const void* tw,
                                       const void* phi, const void* dinv,
                                       const void* binw, int nslots,
                                       long long batch, int n, void* q_out,
                                       void* c0_out, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || batch > 0x7fffffffLL || nslots < 1 ||
      nslots > kMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xp = static_cast<const float*>(x);
  const float2* twp = static_cast<const float2*>(tw);
  const float2* php = static_cast<const float2*>(phi);
  const float* dp_ = static_cast<const float*>(dinv);
  const float* bwp = static_cast<const float*>(binw);
  double* qp = static_cast<double*>(q_out);
  double* cp = static_cast<double*>(c0_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DP_LAUNCH_FUSED(L) \
  launch_fused<L>(xp, twp, php, dp_, bwp, nslots, batch, qp, cp, st)
  DP_DISPATCH_N(n, DP_LAUNCH_FUSED)
#undef DP_LAUNCH_FUSED
}

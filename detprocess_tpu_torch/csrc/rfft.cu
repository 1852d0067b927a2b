// Batched real FFT: float32 traces [B, N] -> natural-order half spectrum
// complex64 [B, N/2 + 1].
//
// Replaces the TPU kernel detprocess_tpu/ops/pallas_fft.py::fft_pallas,
// a four-step DFT-by-matmul over tiles of 8 traces held in VMEM that
// emitted the full spectrum in digit-reversed order. Here one thread block
// owns one trace: the trace is read from HBM once, the whole transform
// (packed M = N/2-point Stockham FFT plus the real-to-half-spectrum
// untangle) runs in shared memory, and the N/2 + 1 natural-order bins are
// written once.
//
// What bounds it on an H100: HBM bytes. Per trace it moves 4·N bytes in
// and 8·(N/2 + 1) bytes out against ~2.5·N·log2(N) flops, far below the
// card's flop-to-byte balance; the design keeps every intermediate stage
// of the transform in shared memory (128 KB at N = 32768, above the 48 KB
// default, so the launcher raises the block's dynamic shared-memory
// limit).
//
// C interface (loaded with ctypes): dp_rfft_f32 returns a cudaError_t code;
// 0 means the launch was accepted.

#include "rfft_smem.cuh"

namespace {

template <int LOG2M>
__global__ void __launch_bounds__(dp::FftShape<LOG2M>::THREADS)
    rfft_kernel(const float* __restrict__ x, float2* __restrict__ out,
                const float2* __restrict__ tw) {
  using S = dp::FftShape<LOG2M>;
  extern __shared__ float4 smem4[];
  float2* s = reinterpret_cast<float2*>(smem4);
  const long long b = blockIdx.x;

  dp::load_packed<LOG2M>(x + b * S::N, s);
  dp::fft_smem<LOG2M>(s, tw);

  float2* orow = out + b * (S::M + 1);
  for (int k = threadIdx.x; k < S::M; k += S::THREADS) {
    orow[k] = dp::untangle<LOG2M>(s, tw, k);
  }
  if (threadIdx.x == 0) orow[S::M] = dp::nyquist(s);
}

template <int LOG2M>
int launch_rfft(const float* x, float2* out, const float2* tw,
                long long batch, cudaStream_t stream) {
  using S = dp::FftShape<LOG2M>;
  cudaError_t err = cudaFuncSetAttribute(
      rfft_kernel<LOG2M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  rfft_kernel<LOG2M><<<static_cast<unsigned>(batch), S::THREADS,
                       S::SMEM_BYTES, stream>>>(x, out, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dp_rfft_f32(const void* x, void* out, const void* tw,
                           long long batch, int n, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xp = static_cast<const float*>(x);
  float2* op = static_cast<float2*>(out);
  const float2* twp = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DP_LAUNCH_RFFT(L) launch_rfft<L>(xp, op, twp, batch, st)
  DP_DISPATCH_N(n, DP_LAUNCH_RFFT)
#undef DP_LAUNCH_RFFT
}

extern "C" const char* dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared-memory real FFT of one trace per thread block (Hopper, sm_90a).
//
// Device functions shared by rfft.cu (the batched rFFT) and
// fused_nodelay_of.cu (rFFT + no-delay optimal-filter epilogue).
//
// A real trace x[0..N) is packed as M = N/2 complex values
// z[m] = x[2m] + i·x[2m+1] (a plain float2 view of the trace), transformed
// by an in-place radix-4 Stockham FFT of size M in dynamic shared memory
// (one radix-2 stage first when log2(M) is odd), and untangled into the
// natural half spectrum X[0..M]:
//
//   X_k = ½(Z_k + conj Z_{M−k}) − ½·i·W_N^k·(Z_k − conj Z_{M−k}),  k < M
//   X_M = Re Z_0 − Im Z_0
//
// Stockham stage with radix R over sub-transforms of size Ns (natural
// order in, natural order out after the last stage):
//
//   for j in [0, M/R):  k = j mod Ns
//     v_r = z[j + r·M/R] · W_{Ns·R}^{r·k}      (r < R)
//     y   = DFT_R(v)
//     z'[(j − k)·R + k + r·Ns] = y_r
//
// Every thread first loads all of its butterflies' inputs into registers,
// the block synchronises, and then the outputs overwrite the same buffer:
// one M-point buffer (8·M bytes: 128 KB at N = 32768) instead of the two
// a ping-pong Stockham needs, which would not fit in a block's 227 KB.
//
// Twiddles come from a table tw[k] = W_N^k = exp(−2πik/N), k < M, computed
// in float64 on the host and cast to float32. W_M^t = W_N^{2t}; stage
// twiddles W^{2}, W^{3} are products of the one table read.
#pragma once

#include <cuda_runtime.h>

namespace dp {

template <int LOG2M>
struct FftShape {
  static constexpr int M = 1 << LOG2M;
  static constexpr int N = 2 * M;
  // 16 complex values in registers per thread during a stage
  static constexpr int T0 = M / 16;
  static constexpr int THREADS = T0 < 32 ? 32 : (T0 > 1024 ? 1024 : T0);
  static constexpr size_t SMEM_BYTES = sizeof(float2) * M;
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// (−i)·a
__device__ __forceinline__ float2 mul_neg_i(float2 a) {
  return make_float2(a.y, -a.x);
}

// Load one trace row (N floats, 16-byte aligned) into shared memory as
// M packed complex values. Ends with a block barrier.
template <int LOG2M>
__device__ __forceinline__ void load_packed(const float* __restrict__ xrow,
                                            float2* s) {
  using S = FftShape<LOG2M>;
  const float4* src = reinterpret_cast<const float4*>(xrow);
  float4* dst = reinterpret_cast<float4*>(s);
#pragma unroll 4
  for (int i = threadIdx.x; i < S::M / 2; i += S::THREADS) {
    dst[i] = __ldg(src + i);
  }
  __syncthreads();
}

// One in-place Stockham stage of radix R (2 or 4) after sub-transforms of
// size Ns = 2^lns. Ends with a block barrier.
template <int LOG2M, int R>
__device__ __forceinline__ void stockham_stage(float2* s,
                                               const float2* __restrict__ tw,
                                               int lns) {
  using S = FftShape<LOG2M>;
  constexpr int NB = S::M / R;        // butterflies per stage
  constexpr int PER = NB / S::THREADS;  // butterflies per thread
  constexpr int LR = R == 4 ? 2 : 1;
  static_assert(PER >= 1 && NB % S::THREADS == 0, "stage does not tile");
  const int ns = 1 << lns;

  float2 v[PER][R];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * S::THREADS;
#pragma unroll
    for (int r = 0; r < R; ++r) v[i][r] = s[j + r * NB];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * S::THREADS;
    const int k = j & (ns - 1);
    // W_{Ns·R}^k = W_M^t with t = k·M/(Ns·R) = W_N^{2t}
    const int t = k << (LOG2M - lns - LR);
    const float2 w = __ldg(tw + 2 * t);
    const int base = (j - k) * R + k;
    if constexpr (R == 4) {
      const float2 w2 = cmul(w, w);
      const float2 w3 = cmul(w2, w);
      const float2 a = v[i][0];
      const float2 b = cmul(v[i][1], w);
      const float2 c = cmul(v[i][2], w2);
      const float2 d = cmul(v[i][3], w3);
      const float2 a0 = cadd(a, c);
      const float2 a1 = csub(a, c);
      const float2 a2 = cadd(b, d);
      const float2 a3 = mul_neg_i(csub(b, d));
      s[base] = cadd(a0, a2);
      s[base + ns] = cadd(a1, a3);
      s[base + 2 * ns] = csub(a0, a2);
      s[base + 3 * ns] = csub(a1, a3);
    } else {
      const float2 a = v[i][0];
      const float2 b = cmul(v[i][1], w);
      s[base] = cadd(a, b);
      s[base + ns] = csub(a, b);
    }
  }
  __syncthreads();
}

// In-place forward FFT of the M values in shared memory (natural order
// in and out). Expects the data to be visible to the whole block.
template <int LOG2M>
__device__ __forceinline__ void fft_smem(float2* s,
                                         const float2* __restrict__ tw) {
  int lns = 0;
  if (LOG2M & 1) {
    stockham_stage<LOG2M, 2>(s, tw, 0);
    lns = 1;
  }
#pragma unroll 1
  for (; lns < LOG2M; lns += 2) stockham_stage<LOG2M, 4>(s, tw, lns);
}

// Half-spectrum bin X_k, k in [0, M), from the packed transform Z in
// shared memory.
template <int LOG2M>
__device__ __forceinline__ float2 untangle(const float2* s,
                                           const float2* __restrict__ tw,
                                           int k) {
  constexpr int M = FftShape<LOG2M>::M;
  const float2 zk = s[k];
  float2 zr = s[(M - k) & (M - 1)];
  zr.y = -zr.y;
  const float2 e = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y + zr.y));
  const float2 o = make_float2(0.5f * (zk.x - zr.x), 0.5f * (zk.y - zr.y));
  const float2 wo = cmul(__ldg(tw + k), o);
  // e − i·(W·o)
  return make_float2(e.x + wo.y, e.y - wo.x);
}

// Nyquist bin X_M (real).
__device__ __forceinline__ float2 nyquist(const float2* s) {
  return make_float2(s[0].x - s[0].y, 0.0f);
}

}  // namespace dp

// Dispatch a templated launcher over the supported trace lengths
// N = 256 … 32768 (LOG2M = 7 … 14). Expands to a switch that returns.
#define DP_DISPATCH_N(n, LAUNCH)                   \
  switch (n) {                                     \
    case 256: return LAUNCH(7);                    \
    case 512: return LAUNCH(8);                    \
    case 1024: return LAUNCH(9);                   \
    case 2048: return LAUNCH(10);                  \
    case 4096: return LAUNCH(11);                  \
    case 8192: return LAUNCH(12);                  \
    case 16384: return LAUNCH(13);                 \
    case 32768: return LAUNCH(14);                 \
    default: return (int)cudaErrorInvalidValue;    \
  }

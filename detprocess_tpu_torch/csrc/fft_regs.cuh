// Register-resident FFT of one packed trace per thread block (Hopper,
// sm_90a), used by rfft.cu and fused_nodelay_of.cu.
//
// A real trace x[0..N) is read as M = N/2 complex values
// z[m] = x[2m] + i·x[2m+1] and transformed by a Stockham FFT of size M
// whose passes run in registers: each of the M/16 threads holds 16 complex
// values, and a pass of radix R (16, or 2, 4, 8 for the last 1–3 bits of
// log2 M) over sub-transforms of size Ns is
//
//   for b in [0, M/R):  k = b mod Ns
//     v_r = z[b + r·M/R] · W_{Ns·R}^{r·k}      (r < R)
//     y   = DFT_R(v)
//     z'[(b − k)·R + k + q·Ns] = y_q
//
// with a thread owning the 16/R butterflies b = tid + i·M/16. The first
// pass (Ns = 1, no twiddles) reads its 16 inputs straight from HBM, all
// issued before any arithmetic; later passes exchange through shared
// memory, one read and one write per value and two barriers per pass. At
// N = 32768 that is 4 passes (16·16·16·4) against the 7 radix-4 stages
// of the shared-memory form that both kernels had first.
//
// DFT_R in registers: R = 4·Q with r = Q·a + b and q = c + 4·d,
// DFT_4 over a, the twiddle W_R^{b·c}, DFT_Q over b; the result q lands in
// slot Q·(q mod 4) + q/4 of the butterfly's registers (out_pos).
//
// Shared memory is padded: entry i lives at i + (i >> 4). Pass 1 writes
// at a stride of 16 and every other access is contiguous, so a half-warp's
// 16 float2 accesses hit 16 distinct bank pairs in every pass and in the
// untangle. The padded buffer holds M + M/16 values (136 KB at N = 32768).
//
// Stage twiddles take two reads of the table tw[i] = W_N^i (i < M, float64
// cast to float32): w = W_{Ns·R}^k = tw[2t] and, for R ≥ 8, W^{4k} =
// tw[8t], with t = k·M/(Ns·R). The rest are chained products,
// W^{(a+4c)·k} = (W^{4k})^c · (W^k)^a, at most five roundings: within
// 2.7e-7 of the exact value (tests/test_torch_fused_model.py).
#pragma once

#include <cuda_runtime.h>

namespace dpr {

template <int LOG2M>
struct Shape {
  static_assert(LOG2M >= 7 && LOG2M <= 14, "N = 256 … 32768");
  static constexpr int M = 1 << LOG2M;
  static constexpr int N = 2 * M;
  static constexpr int THREADS = M / 16;      // 16 values per thread
  static constexpr int PADDED = M + M / 16;   // shared entries after padding
  static constexpr int FULL = LOG2M / 4;      // radix-16 passes
  static constexpr int REM = LOG2M % 4;       // bits of the last pass
  // 64 registers a thread at 1024 resident threads per SM
  static constexpr int MIN_BLOCKS = THREADS >= 32 ? 1024 / THREADS : 32;
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// threadIdx.x and blockIdx.x read afresh. A volatile read is not merged
// with an earlier one, so each phase recomputes its indices from them
// instead of keeping values of an earlier phase live, and spilled, across
// the passes, which need every register.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ int fresh_bid() {
  int b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// cos(π·e/8), a switch so that a constant e folds to a literal
__host__ __device__ constexpr float cos16(int e) {
  constexpr float C1 = 0.92387953251128674f;   // cos(π/8)
  constexpr float H = 0.70710678118654752f;    // cos(π/4)
  constexpr float S1 = 0.38268343236508978f;   // sin(π/8)
  switch (e & 15) {
    case 0: return 1.0f;
    case 1: case 15: return C1;
    case 2: case 14: return H;
    case 3: case 13: return S1;
    case 5: case 11: return -S1;
    case 6: case 10: return -H;
    case 7: case 9: return -C1;
    case 8: return -1.0f;
    default: return 0.0f;                      // 4, 12
  }
}

// a·W_16^e with W_16 = exp(−2πi/16); e is a constant after unrolling, so
// the branches fold and the quarter turns cost no multiply
__device__ __forceinline__ float2 mul_w16(float2 a, int e) {
  e &= 15;
  if (e == 0) return a;
  if (e == 4) return make_float2(a.y, -a.x);
  if (e == 8) return make_float2(-a.x, -a.y);
  if (e == 12) return make_float2(-a.y, a.x);
  return cmul(a, make_float2(cos16(e), -cos16(e + 12)));
}

// in-place DFT_2 and DFT_4, natural order
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  const float2 a0 = cadd(a, c);
  const float2 a1 = csub(a, c);
  const float2 a2 = cadd(b, d);
  const float2 d3 = csub(b, d);
  const float2 a3 = make_float2(d3.y, -d3.x);   // −i·(b − d)
  a = cadd(a0, a2);
  b = cadd(a1, a3);
  c = csub(a0, a2);
  d = csub(a1, a3);
}

// Register slot of output q of an in-place DFT_R (see the header note).
__host__ __device__ constexpr int out_pos(int radix, int q) {
  return radix <= 4 ? q : (radix / 4) * (q & 3) + (q >> 2);
}

// In-place DFT_R of v[o .. o+R), R in {2, 4, 8, 16}.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[16], int o) {
  if constexpr (R == 2) {
    dft2(v[o], v[o + 1]);
  } else if constexpr (R == 4) {
    dft4(v[o], v[o + 1], v[o + 2], v[o + 3]);
  } else {
    constexpr int Q = R / 4;
#pragma unroll
    for (int b = 0; b < Q; ++b) {
      dft4(v[o + b], v[o + b + Q], v[o + b + 2 * Q], v[o + b + 3 * Q]);
    }
#pragma unroll
    for (int b = 1; b < Q; ++b) {
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        v[o + Q * c + b] = mul_w16(v[o + Q * c + b], (16 / R) * b * c);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (Q == 2) {
        dft2(v[o + 2 * c], v[o + 2 * c + 1]);
      } else {
        dft4(v[o + 4 * c], v[o + 4 * c + 1], v[o + 4 * c + 2],
             v[o + 4 * c + 3]);
      }
    }
  }
}

// Pass 1 inputs from HBM: v[r] = z[tid + r·M/16], 16 loads in flight.
template <int LOG2M>
__device__ __forceinline__ void load_first(const float2* __restrict__ z,
                                           float2 (&v)[16]) {
  constexpr int STRIDE = Shape<LOG2M>::M / 16;
  const float2* zt = z + fresh_tid();
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = __ldg(zt + r * STRIDE);
}

// The twiddles and DFTs of one pass of radix R after sub-transforms of
// size Ns = 2^LNS, on this thread's 16/R butterflies.
template <int LOG2M, int R, int LNS>
__device__ __forceinline__ void pass_compute(float2 (&v)[16],
                                             const float2* __restrict__ tw) {
  using S = Shape<LOG2M>;
  constexpr int LR = R == 16 ? 4 : (R == 8 ? 3 : (R == 4 ? 2 : 1));
  const int tid = LNS > 0 ? fresh_tid() : 0;
#pragma unroll
  for (int i = 0; i < 16 / R; ++i) {
    const int o = i * R;
    if constexpr (LNS > 0) {
      const int b = tid + i * S::THREADS;
      const int k = b & ((1 << LNS) - 1);
      const int t = k << (LOG2M - LNS - LR);    // W_{Ns·R}^k = W_N^{2t}
      const float2 w1 = __ldg(tw + 2 * t);
      float2 w4 = make_float2(1.0f, 0.0f);
      if constexpr (R >= 8) w4 = __ldg(tw + 8 * t);
      // r = a + 4c: W^{r·k} = (W^{4k})^c · W^{k} · … · W^{k}, a chain of
      // products, so that only W^k, W^{4k} and two running values live
      float2 wc = make_float2(1.0f, 0.0f);
#pragma unroll
      for (int c = 0; c < (R >= 4 ? R / 4 : 1); ++c) {
        if (c == 1) wc = w4;
        if (c >= 2) wc = cmul(wc, w4);
        if (c > 0) v[o + 4 * c] = cmul(v[o + 4 * c], wc);
        float2 w = wc;
#pragma unroll
        for (int a = 1; a < (R >= 4 ? 4 : R); ++a) {
          w = c == 0 && a == 1 ? w1 : cmul(w, w1);
          v[o + a + 4 * c] = cmul(v[o + a + 4 * c], w);
        }
      }
    }
    dft<R>(v, o);
  }
}

// Pass outputs to the padded shared buffer.
template <int LOG2M, int R, int LNS>
__device__ __forceinline__ void pass_store(const float2 (&v)[16], float2* s) {
  using S = Shape<LOG2M>;
  constexpr int NS = 1 << LNS;
  // pad(base + q·Ns) = pad(base) + q·PS: base is a multiple of 16 when
  // Ns = 1 (q < 16), and Ns is a multiple of 16 otherwise
  static_assert(NS == 1 || NS % 16 == 0, "passes take 4 bits at a time");
  constexpr int PS = NS == 1 ? 1 : NS + NS / 16;
  const int tid = fresh_tid();
#pragma unroll
  for (int i = 0; i < 16 / R; ++i) {
    const int b = tid + i * S::THREADS;
    const int k = b & (NS - 1);
    const int pb = pad((b - k) * R + k);
#pragma unroll
    for (int q = 0; q < R; ++q) s[pb + q * PS] = v[i * R + out_pos(R, q)];
  }
}

// Pass inputs from the padded shared buffer: v[i·R + r] = z[b + r·M/R].
template <int LOG2M, int R>
__device__ __forceinline__ void pass_load(float2 (&v)[16], const float2* s) {
  using S = Shape<LOG2M>;
  constexpr int STRIDE = S::M / R;
  const int tid = fresh_tid();
#pragma unroll
  for (int i = 0; i < 16 / R; ++i) {
    const int b = tid + i * S::THREADS;
    const int pb = pad(b);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // pad(b + r·STRIDE) = pad(b) + r·(STRIDE + STRIDE/16) when STRIDE is
      // a multiple of 16 (all but N = 256)
      v[i * R + r] = STRIDE % 16 == 0 ? s[pb + r * (STRIDE + STRIDE / 16)]
                                      : s[pad(b + r * STRIDE)];
    }
  }
}

template <int LOG2M, int R, int LNS>
__device__ __forceinline__ void middle_pass(float2 (&v)[16], float2* s,
                                            const float2* __restrict__ tw) {
  pass_load<LOG2M, R>(v, s);
  __syncthreads();
  pass_compute<LOG2M, R, LNS>(v, tw);
  pass_store<LOG2M, R, LNS>(v, s);
  __syncthreads();
}

// Pass 1 on the values of load_first, into shared memory; ends with a
// block barrier.
template <int LOG2M>
__device__ __forceinline__ void first_pass(float2 (&v)[16], float2* s) {
  pass_compute<LOG2M, 16, 0>(v, nullptr);
  pass_store<LOG2M, 16, 0>(v, s);
  __syncthreads();
}

// Passes 2 … last; the natural-order transform Z is then in the padded
// shared buffer, visible to the whole block.
template <int LOG2M>
__device__ __forceinline__ void other_passes(float2 (&v)[16], float2* s,
                                             const float2* __restrict__ tw) {
  using S = Shape<LOG2M>;
  if constexpr (S::FULL >= 2) middle_pass<LOG2M, 16, 4>(v, s, tw);
  if constexpr (S::FULL >= 3) middle_pass<LOG2M, 16, 8>(v, s, tw);
  if constexpr (S::REM > 0) {
    middle_pass<LOG2M, (1 << S::REM), 4 * S::FULL>(v, s, tw);
  }
}

// Makes `device` current for one C entry and gives the caller's current
// device back when the entry returns, on every path: a launch on cuda:1
// must not leave a thread that allocates on "cuda" pointing at cuda:1.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    restore_ = cudaGetDevice(&previous_) == cudaSuccess;
    error_ = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return error_; }

 private:
  int previous_ = 0;
  bool restore_ = false;
  cudaError_t error_ = cudaSuccess;
};

}  // namespace dpr

// Dispatch a templated launcher over N = 256 … 32768 (LOG2M = 7 … 14).
// Expands to a switch that returns.
#define DPR_DISPATCH_N(n, LAUNCH)                  \
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

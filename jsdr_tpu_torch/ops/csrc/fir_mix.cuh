// The tuner mix + 27-tap decimating FIR arithmetic shared by the
// mix + decimate kernel (mix_decimate.cu) and the merged spectrum + front
// end kernel (spec_front.cu). Both take every product and sum from here,
// so their decimated outputs and carried tails agree bit for bit on the
// same input.
//
// Conventions (jsdr_tpu/ops/pallas_kernels.py::_mix_decimate_kernel):
//   mixed[t] = (xr[s,t] * cos_pat[s, t % 128], xi[s,t] * sin_pat[s, t % 128])
// for input sample t of the block (t < 0: the carried 26-sample tail,
// already mixed), and output k of the block is
//   y[s,k] = gain * sum_{a<27} mixed[k*m + m - 1 - a] * taps[a].
#pragma once

#include <cuda_runtime.h>

// Everything has internal linkage: each kernel file gets its own copy.
namespace jsdr_fir {
namespace {

constexpr int kTaps = 27;
constexpr int kHalo = kTaps - 1;
constexpr int kPeriod = 128;

// One decimated output: sum_{a<27} fetch(a) * taps[a] per plane, in order
// a = 0..26, one fused multiply-add each. fetch(a) returns the mixed
// sample (re, im) that tap a meets.
template <class Fetch>
__device__ __forceinline__ float2 fir_output(Fetch fetch,
                                             const float* __restrict__ tp,
                                             float gain) {
  float ar = 0.f, ai = 0.f;
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
    const float2 v = fetch(a);
    ar = fmaf(v.x, tp[a], ar);
    ai = fmaf(v.y, tp[a], ai);
  }
  return make_float2(__fmul_rn(ar, gain), __fmul_rn(ai, gain));
}

// new_tail[s, j] = padded[t_len + j], padded = [tail ++ mixed]
__global__ void mix_tail_kernel(const float* __restrict__ xr,
                                const float* __restrict__ xi,
                                const float* __restrict__ cos_pat,
                                const float* __restrict__ sin_pat,
                                const float* __restrict__ tail_r,
                                const float* __restrict__ tail_i,
                                float* __restrict__ ntail_r,
                                float* __restrict__ ntail_i, int n_streams,
                                int t_len) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_streams * kHalo) return;
  const int s = idx / kHalo;
  const int j = idx - s * kHalo;
  const int t = t_len + j - kHalo;  // input index of padded[t_len + j]
  if (t < 0) {
    ntail_r[idx] = tail_r[s * kHalo + t_len + j];
    ntail_i[idx] = tail_i[s * kHalo + t_len + j];
  } else {
    const long long at = static_cast<long long>(s) * t_len + t;
    const int p = t & (kPeriod - 1);
    ntail_r[idx] = __fmul_rn(xr[at], cos_pat[s * kPeriod + p]);
    ntail_i[idx] = __fmul_rn(xi[at], sin_pat[s * kPeriod + p]);
  }
}

// Enqueue mix_tail_kernel for all streams; returns cudaGetLastError().
inline cudaError_t launch_mix_tail(const float* xr, const float* xi,
                                   const float* cos_pat, const float* sin_pat,
                                   const float* tail_r, const float* tail_i,
                                   float* ntail_r, float* ntail_i,
                                   int n_streams, int t_len,
                                   cudaStream_t st) {
  const int n_tail = n_streams * kHalo;
  mix_tail_kernel<<<(n_tail + 255) / 256, 256, 0, st>>>(
      xr, xi, cos_pat, sin_pat, tail_r, tail_i, ntail_r, ntail_i, n_streams,
      t_len);
  return cudaGetLastError();
}

}  // namespace
}  // namespace jsdr_fir

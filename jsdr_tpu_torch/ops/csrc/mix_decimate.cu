// Fused tuner mix + decimate-by-m FIR for Hopper (sm_90a).
//
// Replaces: jsdr_tpu/ops/pallas_kernels.py::_mix_decimate_kernel
// (wrapper mix_decimate). Same contract: per stream s and input sample t
// of the block,
//   mixed[t] = (xr[s,t] * cos_pat[s, t % 128], xi[s,t] * sin_pat[s, t % 128])
// (the reference's non-complex mix; the pattern phase is block-relative),
// the carried 26-sample tail (already MIXED) is prepended, and output k is
//   y[s,k] = gain * sum_{a<27} padded[(k+1)*m - 1 + 26 - a] * taps[a].
// The new tail is the last 26 mixed samples of [tail ++ mixed].
//
// What bounds it on this card: device memory. Each input sample is 8 bytes
// in (two float32 planes) for 27*2/m FMAs out, and each output 8 bytes out:
// at 128 streams x 96000 samples that is 98 MB read and 10 MB written per
// 1 s block, about 32 us at 3.35 TB/s, against ~0.3 GFLOP of FMAs.
//
// Design: one CTA per (stream, tile of 128 outputs). The CTA stages its
// input span (128*m samples plus the 27-m sample halo shared with the
// previous tile) in shared memory, mixing on the way in, with consecutive
// threads on consecutive addresses; so each input sample comes from DRAM
// once (the halo's re-read hits L2). The first tile's halo comes from the
// carried tail. Each thread then forms one output from 27 shared-memory
// FMAs per plane. The TPU kernel's banded MXU matmul over [8, 1280*m]
// blocks is not carried over: 27 MACs per output are cheaper as FMAs than
// as a padded tensor-core product. A second small launch writes the tail.
//
// The mix and the per-output FMA loop live in fir_mix.cuh, shared with the
// merged spectrum + front end kernel (spec_front.cu).
#include <cuda_runtime.h>

#include "fir_mix.cuh"

namespace {

using jsdr_fir::kHalo;
using jsdr_fir::kPeriod;
using jsdr_fir::kTaps;
constexpr int kOutPerCta = 128;

__global__ void __launch_bounds__(kOutPerCta)
mix_decimate_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ cos_pat,
                    const float* __restrict__ sin_pat,
                    const float* __restrict__ taps,
                    const float* __restrict__ tail_r,
                    const float* __restrict__ tail_i, float* __restrict__ yr,
                    float* __restrict__ yi, int t_len, int m, float gain) {
  extern __shared__ float smem[];
  __shared__ float tp[kTaps];
  const int s = blockIdx.y;
  const int n_out = t_len / m;
  const int k0 = blockIdx.x * kOutPerCta;
  const int n_here = min(kOutPerCta, n_out - k0);
  // wr[j] holds mixed sample t = base + j (t < 0: the carried tail)
  const int base = k0 * m + m - kTaps;
  const int span = (n_here - 1) * m + kTaps;
  float* wr = smem;
  float* wi = smem + (kOutPerCta * m + kHalo);
  const long long row = static_cast<long long>(s) * t_len;
  const float* cs = cos_pat + s * kPeriod;
  const float* sn = sin_pat + s * kPeriod;

  if (threadIdx.x < kTaps) tp[threadIdx.x] = taps[threadIdx.x];
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const int t = base + j;
    if (t < 0) {
      wr[j] = tail_r[s * kHalo + kHalo + t];
      wi[j] = tail_i[s * kHalo + kHalo + t];
    } else {
      const int p = t & (kPeriod - 1);
      wr[j] = __fmul_rn(xr[row + t], cs[p]);
      wi[j] = __fmul_rn(xi[row + t], sn[p]);
    }
  }
  __syncthreads();

  const int o = threadIdx.x;
  if (o < n_here) {
    const float* pr = wr + o * m + kHalo;
    const float* pi = wi + o * m + kHalo;
    const float2 y = jsdr_fir::fir_output(
        [&](int a) { return make_float2(pr[-a], pi[-a]); }, tp, gain);
    const long long out = static_cast<long long>(s) * n_out + k0 + o;
    yr[out] = y.x;
    yi[out] = y.y;
  }
}

}  // namespace

extern "C" int jsdr_mix_decimate(const float* xr, const float* xi,
                                 const float* cos_pat, const float* sin_pat,
                                 const float* taps, const float* tail_r,
                                 const float* tail_i, float* yr, float* yi,
                                 float* ntail_r, float* ntail_i, int n_streams,
                                 int t_len, int m, float gain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = t_len / m;
  if (n_out > 0) {
    const size_t smem = 2 * (kOutPerCta * m + kHalo) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          mix_decimate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid((n_out + kOutPerCta - 1) / kOutPerCta, n_streams);
    mix_decimate_kernel<<<grid, kOutPerCta, smem, st>>>(
        xr, xi, cos_pat, sin_pat, taps, tail_r, tail_i, yr, yi, t_len, m,
        gain);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(jsdr_fir::launch_mix_tail(
      xr, xi, cos_pat, sin_pat, tail_r, tail_i, ntail_r, ntail_i, n_streams,
      t_len, st));
}

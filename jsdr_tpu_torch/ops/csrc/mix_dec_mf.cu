// Fused tuner mix + decimate-by-m FIR + VCO mix + 65-tap matched filter for
// Hopper (sm_90a).
//
// Replaces: jsdr_tpu/ops/pallas_kernels.py::_mix_dec_mf_kernel (wrapper
// mix_decimate_mf). Same contract: the decimated stream ds of kernel 1
// (mix_decimate.cu, the same arithmetic from fir_mix.cuh), then per stream s
// and decimated sample k of the block
//   bb[k]  = (ds_re[k] * vco_cos[s, k % 128], ds_im[k] * vco_sin[s, k % 128])
// (the reference's non-complex VCO mix; the pattern phase is block-relative)
// and the matched filter over the carried 64-sample vco-mixed history,
//   mf[k]  = sum_{a<65} bbp[k + 64 - a] * mf_taps[a],  bbp = [mf_tail ++ bb].
// The new ds tail is the last 26 mixed input samples (kernel 1's tail
// kernel), the new mf tail the last 64 samples of bbp. The decimated stream
// never reaches device memory.
//
// What bounds it on this card: device memory, as for kernel 1. Each input
// sample is 8 bytes in for (27*2 + 2 + 65*2)/m flops; each output 8 bytes
// out. At 128 streams x 96000 samples that is ~108 MB per 1 s block, about
// 0.032 ms at 3.35 TB/s, against ~0.5 GFLOP.
//
// Design: one CTA per (stream, tile of 256 matched-filter outputs). Blocks
// run in no order, so a CTA cannot inherit the matched filter's halo from
// the previous tile as the TPU kernel's sequential grid did (its scratch
// carried it). Each CTA recomputes instead: it stages the input span of the
// 64 decimated samples before its tile plus its own 256 (mixing on the way
// in; the halo's re-read hits L2), forms those 320 decimated samples with
// kernel 1's 27-FMA routine, VCO-multiplies them into shared memory, and
// then each thread forms one output from 65 shared-memory FMAs in order
// a = 0..64. Only the first tile reads the carried mf tail; the last tile
// writes the new one from shared memory. The recomputation costs 64*m more
// input reads and 64 more decimated samples per 256 outputs (25%).
#include <cuda_runtime.h>

#include "fir_mix.cuh"

namespace {

using jsdr_fir::kHalo;
using jsdr_fir::kPeriod;
using jsdr_fir::kTaps;
constexpr int kMfTaps = 65;
constexpr int kMfHalo = kMfTaps - 1;
constexpr int kOutPerCta = 256;
constexpr int kDsPerCta = kOutPerCta + kMfHalo;

// input samples staged per plane for kDsPerCta decimated outputs
__host__ __device__ constexpr int staged(int m) {
  return (kDsPerCta - 1) * m + kTaps;
}

__global__ void __launch_bounds__(kOutPerCta)
mix_dec_mf_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ cos_pat,
                  const float* __restrict__ sin_pat,
                  const float* __restrict__ taps,
                  const float* __restrict__ tail_r,
                  const float* __restrict__ tail_i,
                  const float* __restrict__ vco_cos,
                  const float* __restrict__ vco_sin,
                  const float* __restrict__ mf_taps,
                  const float* __restrict__ mtail_r,
                  const float* __restrict__ mtail_i, float* __restrict__ yr,
                  float* __restrict__ yi, float* __restrict__ nmtail_r,
                  float* __restrict__ nmtail_i, int t_len, int m, float gain) {
  extern __shared__ float smem[];
  __shared__ float tp[kTaps];
  __shared__ float mt[kMfTaps];
  // bb of decimated samples k0 - 64 .. k0 + n_here - 1 (k < 0: mf tail)
  __shared__ float br[kDsPerCta];
  __shared__ float bi[kDsPerCta];
  const int s = blockIdx.y;
  const int n_out = t_len / m;
  const int k0 = blockIdx.x * kOutPerCta;
  const int n_here = min(kOutPerCta, n_out - k0);
  const int kf = max(k0 - kMfHalo, 0);  // first decimated sample computed
  // wr[j] holds mixed input sample t = base + j (t < 0: the carried tail)
  const int base = kf * m + m - kTaps;
  const int span = (k0 + n_here - 1 - kf) * m + kTaps;
  float* wr = smem;
  float* wi = smem + staged(m);
  const long long row = static_cast<long long>(s) * t_len;
  const float* cs = cos_pat + s * kPeriod;
  const float* sn = sin_pat + s * kPeriod;

  if (threadIdx.x < kTaps) tp[threadIdx.x] = taps[threadIdx.x];
  if (threadIdx.x < kMfTaps) mt[threadIdx.x] = mf_taps[threadIdx.x];
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

  // decimate (kernel 1's arithmetic) and VCO-mix into br/bi
  for (int j = threadIdx.x; j < n_here + kMfHalo; j += blockDim.x) {
    const int k = k0 - kMfHalo + j;
    if (k < 0) {
      br[j] = mtail_r[s * kMfHalo + kMfHalo + k];
      bi[j] = mtail_i[s * kMfHalo + kMfHalo + k];
    } else {
      const float* pr = wr + (k - kf) * m + kHalo;
      const float* pi = wi + (k - kf) * m + kHalo;
      const float2 y = jsdr_fir::fir_output(
          [&](int a) { return make_float2(pr[-a], pi[-a]); }, tp, gain);
      const int p = k & (kPeriod - 1);
      br[j] = __fmul_rn(y.x, vco_cos[s * kPeriod + p]);
      bi[j] = __fmul_rn(y.y, vco_sin[s * kPeriod + p]);
    }
  }
  __syncthreads();

  const int o = threadIdx.x;
  if (o < n_here) {
    float ar = 0.f, ai = 0.f;
#pragma unroll
    for (int a = 0; a < kMfTaps; ++a) {
      ar = fmaf(br[o + kMfHalo - a], mt[a], ar);
      ai = fmaf(bi[o + kMfHalo - a], mt[a], ai);
    }
    const long long out = static_cast<long long>(s) * n_out + k0 + o;
    yr[out] = ar;
    yi[out] = ai;
  }
  if (k0 + n_here == n_out) {  // the last tile: bbp's last 64 samples
    for (int j = threadIdx.x; j < kMfHalo; j += blockDim.x) {
      nmtail_r[s * kMfHalo + j] = br[n_here + j];
      nmtail_i[s * kMfHalo + j] = bi[n_here + j];
    }
  }
}

}  // namespace

extern "C" int jsdr_mix_dec_mf(
    const float* xr, const float* xi, const float* cos_pat,
    const float* sin_pat, const float* taps, const float* tail_r,
    const float* tail_i, const float* vco_cos, const float* vco_sin,
    const float* mf_taps, const float* mtail_r, const float* mtail_i,
    float* yr, float* yi, float* ntail_r, float* ntail_i, float* nmtail_r,
    float* nmtail_i, int n_streams, int t_len, int m, float gain,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = t_len / m;
  if (n_out > 0) {
    const size_t smem = 2 * staged(m) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          mix_dec_mf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid((n_out + kOutPerCta - 1) / kOutPerCta, n_streams);
    mix_dec_mf_kernel<<<grid, kOutPerCta, smem, st>>>(
        xr, xi, cos_pat, sin_pat, taps, tail_r, tail_i, vco_cos, vco_sin,
        mf_taps, mtail_r, mtail_i, yr, yi, nmtail_r, nmtail_i, t_len, m,
        gain);
  } else {  // no output: the mf history carries over unchanged
    const size_t bytes = static_cast<size_t>(n_streams) * kMfHalo * sizeof(float);
    cudaMemcpyAsync(nmtail_r, mtail_r, bytes, cudaMemcpyDeviceToDevice, st);
    cudaMemcpyAsync(nmtail_i, mtail_i, bytes, cudaMemcpyDeviceToDevice, st);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(jsdr_fir::launch_mix_tail(
      xr, xi, cos_pat, sin_pat, tail_r, tail_i, ntail_r, ntail_i, n_streams,
      t_len, st));
}

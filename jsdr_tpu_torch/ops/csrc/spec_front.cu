// Merged waterfall spectrum + tuner mix + decimating FIR for Hopper
// (sm_90a): one read of the full-rate input feeds both the display
// spectrum and the telemetry front end.
//
// Replaces: jsdr_tpu/ops/pallas_kernels.py::_spec_front_kernel (wrapper
// spectrum_front_fused). Outputs are those of spectrum_wf.cu (wf, mx, idx
// at decimation group q) plus those of mix_decimate.cu (ds [S, T/m] and
// the new 26-sample mixed-domain tail), and equal them bit for bit: the
// spectrum is spectrum_body.cuh, the mix and FIR are fir_mix.cuh.
//
// What bounds it on this card: device memory. At 128 x 460800 samples it
// reads 0.47 GB (8 bytes a sample) and writes 0.09 GB (lines, ds), ~0.17
// ms at 3.35 TB/s; the factored FFT of spectrum_body.cuh with the window
// and power (~0.7 MFLOP per 9600-sample block) and the front end's 54
// FMAs per output (960 outputs per block) are ~5.1 GFLOP, ~0.08 ms at 67
// TFLOP/s fp32. Within the CTA the shared-memory passes over the block
// come on top of the read. The merge saves the second read of the input
// that the staged pair makes (~0.14 ms at that shape).
//
// Design: one CTA per (FFT block, stream), n = 960 * m samples, for
// n1 <= 225; above, a cluster of 4 CTAs per (FFT block, stream), each
// holding 32 columns of every row (spectrum_body.cuh). A CTA copies its
// share of the block's raw samples into shared memory, plus the 26 mixed
// samples before the block (from the previous block's input, or the
// carried tail for block 0). It forms its share of the block's n/m
// decimated outputs, mixing each sample as the FIR meets it (pattern phase
// t % 128, block-relative as in mix_decimate.cu; n is a multiple of 128):
// one CTA reads the samples from shared memory, a cluster's rank reads
// them from device memory (the block is L2-hot by then; a rank's columns
// do not hold an output's 27 consecutive samples). Then it windows its
// columns in place and runs the spectrum body (a factored FFT in shared
// memory, planned by jsdr_tpu_torch/ops/fft_plan.py). A second small
// launch writes the new tail, as mix_decimate.cu does. The TPU kernel's
// grid geometry (sf_geometry: 4 or 2 FFT blocks and 3 FIR sub-chunks per
// grid step, sized for VMEM) is not needed.
#include <cuda_runtime.h>

#include "fir_mix.cuh"
#include "spectrum_body.cuh"

namespace {

using jsdr_fir::kHalo;
using jsdr_fir::kPeriod;
using jsdr_fir::kTaps;
using jsdr_spec::kThreads;

template <int kRanks>
__global__ void __launch_bounds__(kThreads)
spec_front_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ win, jsdr_spec::Plan pl,
                  const float* __restrict__ cos_pat,
                  const float* __restrict__ sin_pat,
                  const float* __restrict__ taps,
                  const float* __restrict__ tail_r,
                  const float* __restrict__ tail_i, float* __restrict__ wf,
                  float* __restrict__ mx, int* __restrict__ idx,
                  float* __restrict__ yr, float* __restrict__ yi,
                  int n_streams, int t_len, int n1, int q, float cf, int m,
                  float gain) {
  extern __shared__ float4 smem4[];
  __shared__ float tp[kTaps];
  __shared__ float cs[kPeriod], sn[kPeriod];
  __shared__ float hr[kHalo], hi[kHalo];
  float* ar = reinterpret_cast<float*>(smem4);
  const int n = n1 * jsdr_spec::kN2;
  const int words = n / kRanks;  // this CTA's share of the block
  float* ai = ar + words;
  const int rank = jsdr_spec::block_rank<kRanks>();
  const int b = blockIdx.x / kRanks;
  const int s = blockIdx.y;
  const long long row = static_cast<long long>(s) * t_len;
  const long long at = row + static_cast<long long>(b) * n;

  // ---- raw columns, taps, pattern, and the 26 mixed samples before it
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int t = jsdr_spec::block_sample<kRanks>(w, rank);
    ar[w] = xr[at + t];
    ai[w] = xi[at + t];
  }
  if (threadIdx.x < kTaps) tp[threadIdx.x] = taps[threadIdx.x];
  if (threadIdx.x < kPeriod) {
    cs[threadIdx.x] = cos_pat[s * kPeriod + threadIdx.x];
    sn[threadIdx.x] = sin_pat[s * kPeriod + threadIdx.x];
  }
  if (threadIdx.x < kHalo) {
    const int j = threadIdx.x;
    const long long t = static_cast<long long>(b) * n - kHalo + j;
    if (t < 0) {
      hr[j] = tail_r[s * kHalo + j];
      hi[j] = tail_i[s * kHalo + j];
    } else {
      const int p = static_cast<int>(t & (kPeriod - 1));
      hr[j] = __fmul_rn(xr[row + t], cos_pat[s * kPeriod + p]);
      hi[j] = __fmul_rn(xi[row + t], sin_pat[s * kPeriod + p]);
    }
  }
  __syncthreads();

  // ---- tuner mix + decimating FIR: this CTA's share of the n/m outputs
  const int n_out = n / m;
  const long long out0 = static_cast<long long>(s) * (t_len / m) +
                         static_cast<long long>(b) * n_out;
  for (int o = rank * kThreads + threadIdx.x; o < n_out;
       o += kRanks * kThreads) {
    const int last = o * m + m - 1;  // block-relative sample of tap 0
    const float2 y = jsdr_fir::fir_output(
        [&](int a) {
          const int u = last - a;
          if (u < 0) return make_float2(hr[kHalo + u], hi[kHalo + u]);
          const int p = u & (kPeriod - 1);
          float vr, vi;
          if constexpr (kRanks == 1) {
            vr = ar[u];
            vi = ai[u];
          } else {
            vr = __ldg(xr + at + u);
            vi = __ldg(xi + at + u);
          }
          return make_float2(__fmul_rn(vr, cs[p]), __fmul_rn(vi, sn[p]));
        },
        tp, gain);
    yr[out0 + o] = y.x;
    yi[out0 + o] = y.y;
  }
  __syncthreads();

  // ---- window in place, then the spectrum
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const float wv = win[jsdr_spec::block_sample<kRanks>(w, rank)];
    ar[w] = __fmul_rn(ar[w], wv);
    ai[w] = __fmul_rn(ai[w], wv);
  }
  __syncthreads();
  const long long line = static_cast<long long>(b) * n_streams + s;
  jsdr_spec::spectrum_body<kRanks>(ar, ai, n1, q, cf, pl,
                                   wf + line * (n1 / q) * jsdr_spec::kN2,
                                   mx + line, idx + line);
}

}  // namespace

// ranks: 1 (one CTA a block) or 4 (a cluster a block); the wrapper picks 4
// above n1 = 225 (jsdr_tpu_torch/ops/spectrum_fused.py::cuda_ranks).
extern "C" int jsdr_spec_front(
    const float* xr, const float* xi, const float* win, const int* passes,
    const float* ptwr, const float* ptwi, const int* perm, const float* gwr,
    const float* gwi, const float* s2r, const float* s2i, const int* k2map,
    const float* twr, const float* twi, const float* cos_pat,
    const float* sin_pat, const float* taps, const float* tail_r,
    const float* tail_i, float* wf, float* mx, int* idx, float* yr, float* yi,
    float* ntail_r, float* ntail_i, int n_streams, int t_len, int n1, int q,
    int n_pass, int rg, float cf, int m, float gain, int ranks,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = t_len / (n1 * jsdr_spec::kN2);
  if (nblk > 0 && n_streams > 0) {
    const jsdr_spec::Plan pl{passes, ptwr, ptwi, perm, gwr, gwi, s2r,
                             s2i,    k2map, twr,  twi,  n_pass, rg};
    cudaError_t e = cudaErrorInvalidValue;
    if (ranks == 1)
      e = jsdr_spec::launch_blocks<1>(
          spec_front_kernel<1>, nblk, n_streams, n1, st, xr, xi, win, pl,
          cos_pat, sin_pat, taps, tail_r, tail_i, wf, mx, idx, yr, yi,
          n_streams, t_len, n1, q, cf, m, gain);
    else if (ranks == jsdr_spec::kCluster)
      e = jsdr_spec::launch_blocks<jsdr_spec::kCluster>(
          spec_front_kernel<jsdr_spec::kCluster>, nblk, n_streams, n1, st, xr,
          xi, win, pl, cos_pat, sin_pat, taps, tail_r, tail_i, wf, mx, idx,
          yr, yi, n_streams, t_len, n1, q, cf, m, gain);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(jsdr_fir::launch_mix_tail(
      xr, xi, cos_pat, sin_pat, tail_r, tail_i, ntail_r, ntail_i, n_streams,
      t_len, st));
}

// The static shared memory of the merged kernel at ranks 1 or 4 (its taps,
// pattern and halo arrays and the body's peak reduction), which the
// dynamic planes share the CTA's 232,448 bytes with:
// jsdr_tpu_torch/ops/spectrum_fused.py derives the one-CTA n1 limit from
// it, and checks the cluster's fit at n1 = 512.
extern "C" int jsdr_spec_front_static_smem(int ranks, int* bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, ranks == 1 ? spec_front_kernel<1>
                     : spec_front_kernel<jsdr_spec::kCluster>);
  if (e == cudaSuccess) *bytes = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(e);
}

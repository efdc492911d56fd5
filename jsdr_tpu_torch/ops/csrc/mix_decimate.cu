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
// Design: the front half of kernel 6's walk (front_walk.cuh), without the
// matched filter. One CTA of 256 threads walks a span of one stream's
// outputs (spans sized on the host so that one wave of CTAs fills the
// card) in sub-chunks of 256 outputs: each sub-chunk's input (and the 26/m
// columns of FIR halo before it, re-read from L2) is loaded into registers
// one sub-chunk ahead of the one being computed, so the DRAM read overlaps
// the FIR; then mixed and stored polyphase (sample j at row j % m, column
// j / m) into the other of two buffers. Each thread forms one output, tap
// a of every lane reading one row at consecutive words, the taps in
// registers, through the same fir_output chain as kernels 3 and 6 (so all
// three agree bit for bit), and the store is coalesced. The CTA that walks
// a stream's last span holds the stream's last 26 mixed samples in its last
// sub-chunk's buffer ((h + 1) * m >= 27) and writes them as the new tail,
// so a block with outputs takes one launch. The TPU kernel's banded MXU
// matmul over [8, 1280*m] blocks is not carried over: 27 MACs per output
// are cheaper as FMAs than as a padded tensor-core product.
// m = 10 and 20 (96 and 192 kS/s) are compiled with m fixed, so every word
// offset is a constant; any other m takes the same code with m at run time,
// its offsets stepped (front_walk.cuh) and its sub-chunks shrinking as m
// grows.
#include <cuda_runtime.h>

#include "front_walk.cuh"

namespace {

using jsdr_fir::kHalo;
using jsdr_fir::kPeriod;
using jsdr_fir::kTaps;
using jsdr_walk::kMaxPer;
using jsdr_walk::kThreads;
using jsdr_walk::row_words;
constexpr int kMinSpan = 32;  // outputs

__host__ constexpr size_t smem_bytes(int sub, int m) {
  return sizeof(float) * 2 * 2 * static_cast<size_t>(m) * row_words(sub, m);
}

// kM: the decimation, fixed at compile time (10, 20), or 0 for m at run
// time (then sub_arg is the sub-chunk; with kM fixed it is 256).
template <int kM>
__global__ void __launch_bounds__(kThreads, 2)
mix_decimate_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ cos_pat,
                    const float* __restrict__ sin_pat,
                    const float* __restrict__ taps,
                    const float* __restrict__ tail_r,
                    const float* __restrict__ tail_i, float* __restrict__ yr,
                    float* __restrict__ yi, float* __restrict__ ntail_r,
                    float* __restrict__ ntail_i, int t_len, int m_arg,
                    int sub_arg, int span, float gain) {
  extern __shared__ float4 smem4[];
  __shared__ float cs[kPeriod], sn[kPeriod];
  const int m = kM > 0 ? kM : m_arg;
  const int sub = kM > 0 ? kThreads : sub_arg;
  const int h = kHalo / m;             // FIR halo columns before a sub-chunk
  const int wp = row_words(sub, m);
  const int plane = m * wp;
  float* in = reinterpret_cast<float*>(smem4);  // [2 buffers][re, im][m][wp]
  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int n_out = t_len / m;
  const int k_s = blockIdx.x * span;            // this CTA's outputs
  const int k_e = min(k_s + span, n_out);
  const int n_sub = (k_e - k_s + sub - 1) / sub;
  const long long row = static_cast<long long>(s) * t_len;
  const long long out = static_cast<long long>(s) * n_out;

  if (tid < kPeriod) {
    cs[tid] = cos_pat[s * kPeriod + tid];
    sn[tid] = sin_pat[s * kPeriod + tid];
  }
  float tp[kTaps];
#pragma unroll
  for (int a = 0; a < kTaps; ++a) tp[a] = __ldg(taps + a);

  // Sub-chunk c holds outputs k_c .. k_c + n - 1 (k_c = k_s + c * sub);
  // its input is samples t = (k_c - h) * m + j, j < (h + n) * m, staged in
  // registers, then stored polyphase into buffer c & 1 (front_walk.cuh).
  jsdr_walk::Stager<kM> st;
  auto load = [&](int c) {
    const int k_c = k_s + c * sub;
    st.load(xr, xi, row, (k_c - h) * m, (h + min(sub, k_e - k_c)) * m, tid);
  };
  auto store = [&](int c) {
    const int k_c = k_s + c * sub;
    float* br = in + (c & 1) * 2 * plane;
    st.store(br, br + plane, cs, sn, tail_r + s * kHalo, tail_i + s * kHalo,
             (k_c - h) * m, (h + min(sub, k_e - k_c)) * m, m, wp, tid);
  };

  load(0);
  __syncthreads();  // the patterns are in place
  store(0);
  __syncthreads();
  for (int c = 0; c < n_sub; ++c) {
    const int k_c = k_s + c * sub;
    const int n = min(sub, k_e - k_c);
    if (c + 1 < n_sub) load(c + 1);  // in flight while c computes
    const float* br = in + (c & 1) * 2 * plane;
    const float* bi = br + plane;
    if (tid < n) {
      const float2 y = jsdr_walk::fir_staged<kM>(br, bi, m, wp, tid, tp, gain);
      yr[out + k_c + tid] = y.x;
      yi[out + k_c + tid] = y.y;
    }
    // the stream's last sub-chunk: its buffer holds input samples
    // t_len - 26 .. t_len - 1 (mixed, or the carried tail where t < 0)
    if (k_c + n == n_out && tid < kHalo) {
      const int j = t_len - kHalo + tid - (k_c - h) * m;
      const int w = (j % m) * wp + j / m;
      ntail_r[s * kHalo + tid] = br[w];
      ntail_i[s * kHalo + tid] = bi[w];
    }
    if (c + 1 < n_sub) store(c + 1);  // buffer (c + 1) & 1: c - 1 is done
    __syncthreads();
  }
}

template <int kM>
cudaError_t launch(const float* xr, const float* xi, const float* cos_pat,
                   const float* sin_pat, const float* taps,
                   const float* tail_r, const float* tail_i, float* yr,
                   float* yi, float* ntail_r, float* ntail_i, int n_streams,
                   int t_len, int m, float gain, cudaStream_t st) {
  const int sub = jsdr_walk::sub_chunk<kM>(m);
  if (sub == 0) return cudaErrorInvalidValue;  // m > kMaxM
  const size_t smem = smem_bytes(sub, m);
  // m * row_words <= per_thread * kThreads + m, m <= kMaxM
  const size_t cap =
      kM > 0 ? smem
             : sizeof(float) * 4 * (kMaxPer * kThreads + jsdr_walk::kMaxM);
  int ctas = 0;
  cudaError_t e =
      jsdr_walk::wave_ctas(mix_decimate_kernel<kM>, smem, cap, &ctas);
  if (e != cudaSuccess) return e;
  const int n_out = t_len / m;
  const int span = jsdr_walk::wave_span(ctas, n_streams, n_out, kMinSpan);
  const dim3 grid((n_out + span - 1) / span, n_streams);
  mix_decimate_kernel<kM><<<grid, kThreads, smem, st>>>(
      xr, xi, cos_pat, sin_pat, taps, tail_r, tail_i, yr, yi, ntail_r,
      ntail_i, t_len, m, sub, span, gain);
  return cudaGetLastError();
}

}  // namespace

extern "C" int jsdr_mix_decimate(const float* xr, const float* xi,
                                 const float* cos_pat, const float* sin_pat,
                                 const float* taps, const float* tail_r,
                                 const float* tail_i, float* yr, float* yi,
                                 float* ntail_r, float* ntail_i, int n_streams,
                                 int t_len, int m, float gain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t_len / m == 0)  // no output: the tail is all there is (fir_mix.cuh)
    return static_cast<int>(jsdr_fir::launch_mix_tail(
        xr, xi, cos_pat, sin_pat, tail_r, tail_i, ntail_r, ntail_i,
        n_streams, t_len, st));
  decltype(&launch<0>) go =
      m == 10 ? &launch<10> : m == 20 ? &launch<20> : &launch<0>;
  return static_cast<int>(go(xr, xi, cos_pat, sin_pat, taps, tail_r, tail_i,
                             yr, yi, ntail_r, ntail_i, n_streams, t_len, m,
                             gain, st));
}

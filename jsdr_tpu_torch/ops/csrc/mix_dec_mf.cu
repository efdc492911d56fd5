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
//   mf[k]  = sum_{a<65} bbp[k + 64 - a] * mf_taps[a],  bbp = [mf_tail ++ bb],
// one fmaf per tap in order a = 0..64. The new ds tail is the last 26 mixed
// input samples (kernel 1's tail kernel), the new mf tail the last 64
// samples of bbp. The decimated stream never reaches device memory.
//
// What bounds it on this card: device memory, as for kernel 1. Each input
// sample is 8 bytes in for (27*2 + 2 + 65*2)/m flops; each output 8 bytes
// out. At 128 streams x 96000 samples that is ~108 MB per 1 s block, about
// 0.032 ms at 3.35 TB/s, against ~0.5 GFLOP.
//
// Design: one CTA of 256 threads walks a span of one stream's outputs
// (spans sized on the host so that one wave of CTAs fills the card) in
// sub-chunks of 256 decimated samples, and runs the matched filter every
// 1024 of them (one pass). Shared memory traffic, not arithmetic, is what
// the design spends carefully:
//   * input and FIR: the staged polyphase walk of front_walk.cuh, shared
//     with kernel 1: each sub-chunk's samples are loaded into registers
//     one sub-chunk ahead of the one being computed, so the DRAM read
//     overlaps the FIR and the matched filter, then mixed and stored
//     polyphase in the other of two buffers; one decimated sample a
//     thread, every tap's lanes on consecutive words of one row, the taps
//     in registers, the same fir_output chain as kernels 1 and 3.
//   * VCO mix into bb, stored by position p at row p % 4, column p / 4
//     (rows 296 words apart).
//   * matched filter: thread t forms the 4 consecutive outputs at
//     positions 64 + 4t .. 64 + 4t + 3 from a sliding window in registers:
//     per tap one new bb sample (lanes on consecutive columns of one row)
//     and one broadcast tap read for 4 outputs, 195/4 reads an output
//     instead of 195.
//   * the 64-sample matched-filter halo is carried in bb from pass to pass
//     (the stream's first span starts from the carried mf tail; a later
//     span recomputes the 64 decimated samples before it, once).
// A second small launch writes the new ds tail (fir_mix.cuh).
// m = 10 and 20 (96 and 192 kS/s) are compiled with m fixed, so every
// tap's shared-memory offset is a constant: 1.4x and 1.1x faster there
// than the same code with m at run time, its offsets stepped
// (tools/mf_probe.py on an H100). Any other m takes that code, and
// sub-chunks shrink (to 8) as m grows so a thread stages at most kMaxPer
// samples a plane.
#include <cuda_runtime.h>

#include "front_walk.cuh"

namespace {

using jsdr_fir::kHalo;
using jsdr_fir::kPeriod;
using jsdr_fir::kTaps;
using jsdr_walk::kMaxPer;
using jsdr_walk::kThreads;
using jsdr_walk::row_words;
constexpr int kMfTaps = 65;
constexpr int kMfHalo = kMfTaps - 1;
constexpr int kR = 4;                        // matched-filter outputs a thread
constexpr int kPass = kThreads * kR;         // outputs a matched-filter pass
// bb columns: (64 + 1024) / 4 = 272, padded to 8 mod 32 so the FIR's
// stores of 32 consecutive positions (4 rows x 8 columns) hit 32 banks
constexpr int kBbCols = 296;
constexpr int kMinSpan = 512;                // outputs; bounds the halo's share
static_assert(kPass % kThreads == 0, "sub-chunks divide a pass");
static_assert((kMfHalo + kPass) / kR <= kBbCols && kBbCols % 32 == 8,
              "bb layout");

__host__ constexpr size_t smem_bytes(int sub, int m) {
  return sizeof(float) * (2 * 2 * static_cast<size_t>(m) * row_words(sub, m) +
                          2 * kR * kBbCols);
}

// bb position p (p >= 0) of a plane
__device__ __forceinline__ int bb_word(int p) {
  return (p % kR) * kBbCols + p / kR;
}

// kM: the decimation, fixed at compile time (10, 20), or 0 for m at run
// time (then sub_arg is the sub-chunk; with kM fixed it is 256). Two CTAs
// an SM: at m = 20 ptxas would take 168 registers (one CTA an SM); capped
// at 128 it runs 0.070 -> 0.055 ms at 64 x 192,000, m = 10 unchanged
// (tools/mf_probe.py on an H100).
template <int kM>
__global__ void __launch_bounds__(kThreads, 2)
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
                  float* __restrict__ nmtail_i, int t_len, int m_arg,
                  int sub_arg, int span, float gain) {
  extern __shared__ float4 smem4[];
  __shared__ float cs[kPeriod], sn[kPeriod], vc[kPeriod], vs[kPeriod];
  __shared__ float mt[kMfTaps];
  const int m = kM > 0 ? kM : m_arg;
  const int sub = kM > 0 ? kThreads : sub_arg;
  const int h = kHalo / m;             // FIR halo columns before a sub-chunk
  const int wp = row_words(sub, m);
  const int plane = m * wp;
  float* in = reinterpret_cast<float*>(smem4);  // [2 buffers][re, im][m][wp]
  float* bbr = in + 4 * plane;                  // [kR][kBbCols]
  float* bbi = bbr + kR * kBbCols;
  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int n_out = t_len / m;
  const int k_s = blockIdx.x * span;            // this CTA's outputs
  const int k_e = min(k_s + span, n_out);
  // the first decimated sample it computes: a later span starts 64 early
  const int ds0 = k_s == 0 ? 0 : k_s - kMfHalo;
  const int n_sub = (k_e - ds0 + sub - 1) / sub;
  const long long row = static_cast<long long>(s) * t_len;

  if (tid < kPeriod) {
    cs[tid] = cos_pat[s * kPeriod + tid];
    sn[tid] = sin_pat[s * kPeriod + tid];
    vc[tid] = vco_cos[s * kPeriod + tid];
    vs[tid] = vco_sin[s * kPeriod + tid];
  }
  if (tid < kMfTaps) mt[tid] = mf_taps[tid];
  if (k_s == 0 && tid < kMfHalo) {  // bbp's carried history
    bbr[bb_word(tid)] = mtail_r[s * kMfHalo + tid];
    bbi[bb_word(tid)] = mtail_i[s * kMfHalo + tid];
  }
  float tp[kTaps];
#pragma unroll
  for (int a = 0; a < kTaps; ++a) tp[a] = __ldg(taps + a);

  // Sub-chunk c holds decimated samples k_c .. k_c + n - 1 (k_c = ds0 +
  // c * sub); its input is samples t = (k_c - h) * m + j, j < (h + n) * m,
  // staged in registers, then stored polyphase into buffer c & 1
  // (front_walk.cuh).
  jsdr_walk::Stager<kM> st;
  auto load = [&](int c) {
    const int k_c = ds0 + c * sub;
    st.load(xr, xi, row, (k_c - h) * m, (h + min(sub, k_e - k_c)) * m, tid);
  };
  auto store = [&](int c) {
    const int k_c = ds0 + c * sub;
    float* br = in + (c & 1) * 2 * plane;
    st.store(br, br + plane, cs, sn, tail_r + s * kHalo, tail_i + s * kHalo,
             (k_c - h) * m, (h + min(sub, k_e - k_c)) * m, m, wp, tid);
  };

  load(0);
  __syncthreads();  // the patterns are in place
  store(0);
  __syncthreads();
  for (int c = 0; c < n_sub; ++c) {
    const int k_c = ds0 + c * sub;
    const int n = min(sub, k_e - k_c);
    if (c + 1 < n_sub) load(c + 1);  // in flight while c computes
    const float* br = in + (c & 1) * 2 * plane;
    const float* bi = br + plane;

    // ---- decimate (kernel 1's arithmetic) and VCO-mix into bb
    const int k_m = ds0 + (c * sub / kPass) * kPass;  // this pass's first
    const int n_m = min(kPass, k_e - k_m);
    if (tid < n) {
      const int k = k_c + tid;
      const float2 y = jsdr_walk::fir_staged<kM>(br, bi, m, wp, tid, tp, gain);
      const int p = k & (kPeriod - 1);
      const int at = bb_word(kMfHalo + k - k_m);
      bbr[at] = __fmul_rn(y.x, vc[p]);
      bbi[at] = __fmul_rn(y.y, vs[p]);
    }

    // ---- the pass's last sub-chunk: the matched filter over its bb
    if (k_c + n == k_m + n_m) {
      __syncthreads();
      // outputs at positions p0 + u (u < kR), p0 = 64 + kR * tid: column
      // c0 = p0 / kR of row u; tap a's new sample p0 - a sits at row
      // (-a) mod kR, column c0 - ceil(a / kR)
      const int c0 = kMfHalo / kR + tid;
      float wr[kR], wi[kR], ar[kR], ai[kR];
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        wr[u] = bbr[u * kBbCols + c0];
        wi[u] = bbi[u * kBbCols + c0];
        ar[u] = 0.f;
        ai[u] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < kMfTaps; ++a) {
        if (a > 0) {
#pragma unroll
          for (int u = kR - 1; u > 0; --u) {
            wr[u] = wr[u - 1];
            wi[u] = wi[u - 1];
          }
          const int w = ((kR - a % kR) % kR) * kBbCols + c0 - (a + kR - 1) / kR;
          wr[0] = bbr[w];
          wi[0] = bbi[w];
        }
        const float t = mt[a];
#pragma unroll
        for (int u = 0; u < kR; ++u) {
          ar[u] = fmaf(wr[u], t, ar[u]);
          ai[u] = fmaf(wi[u], t, ai[u]);
        }
      }
      const long long out = static_cast<long long>(s) * n_out;
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const int k = k_m + kR * tid + u;
        if (k >= k_s && k < k_m + n_m) {
          yr[out + k] = ar[u];
          yi[out + k] = ai[u];
        }
      }
      if (k_m + n_m == n_out && tid < kMfHalo) {  // bbp's last 64 samples
        nmtail_r[s * kMfHalo + tid] = bbr[bb_word(n_m + tid)];
        nmtail_i[s * kMfHalo + tid] = bbi[bb_word(n_m + tid)];
      }
      __syncthreads();
      if (k_m + n_m < k_e && tid < kMfHalo) {  // carry the halo
        bbr[bb_word(tid)] = bbr[bb_word(n_m + tid)];
        bbi[bb_word(tid)] = bbi[bb_word(n_m + tid)];
      }
    }
    if (c + 1 < n_sub) store(c + 1);  // buffer (c + 1) & 1: c - 1 is done
    __syncthreads();
  }
}

template <int kM>
cudaError_t launch(const float* xr, const float* xi, const float* cos_pat,
                   const float* sin_pat, const float* taps,
                   const float* tail_r, const float* tail_i,
                   const float* vco_cos, const float* vco_sin,
                   const float* mf_taps, const float* mtail_r,
                   const float* mtail_i, float* yr, float* yi,
                   float* nmtail_r, float* nmtail_i, int n_streams, int t_len,
                   int m, float gain, cudaStream_t st) {
  const int sub = jsdr_walk::sub_chunk<kM>(m);
  if (sub == 0) return cudaErrorInvalidValue;  // m > kMaxM
  const size_t smem = smem_bytes(sub, m);
  // m * row_words <= per_thread * kThreads + m, m <= kMaxM
  const size_t cap =
      kM > 0 ? smem
             : sizeof(float) * (4 * (kMaxPer * kThreads + jsdr_walk::kMaxM) +
                                2 * kR * kBbCols);
  // spans: one wave of CTAs over the card, none shorter than kMinSpan
  int ctas = 0;
  cudaError_t e =
      jsdr_walk::wave_ctas(mix_dec_mf_kernel<kM>, smem, cap, &ctas);
  if (e != cudaSuccess) return e;
  const int n_out = t_len / m;
  const int span = jsdr_walk::wave_span(ctas, n_streams, n_out, kMinSpan);
  const dim3 grid((n_out + span - 1) / span, n_streams);
  mix_dec_mf_kernel<kM><<<grid, kThreads, smem, st>>>(
      xr, xi, cos_pat, sin_pat, taps, tail_r, tail_i, vco_cos, vco_sin,
      mf_taps, mtail_r, mtail_i, yr, yi, nmtail_r, nmtail_i, t_len, m, sub,
      span, gain);
  return cudaGetLastError();
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
  cudaError_t e = cudaSuccess;
  if (t_len / m > 0) {
    decltype(&launch<0>) go =
        m == 10 ? &launch<10> : m == 20 ? &launch<20> : &launch<0>;
    e = go(xr, xi, cos_pat, sin_pat, taps, tail_r, tail_i, vco_cos, vco_sin,
           mf_taps, mtail_r, mtail_i, yr, yi, nmtail_r, nmtail_i, n_streams,
           t_len, m, gain, st);
  } else {  // no output: the mf history carries over unchanged
    const size_t bytes =
        static_cast<size_t>(n_streams) * kMfHalo * sizeof(float);
    e = cudaMemcpyAsync(nmtail_r, mtail_r, bytes, cudaMemcpyDeviceToDevice,
                        st);
    if (e == cudaSuccess)
      e = cudaMemcpyAsync(nmtail_i, mtail_i, bytes, cudaMemcpyDeviceToDevice,
                          st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(jsdr_fir::launch_mix_tail(
      xr, xi, cos_pat, sin_pat, tail_r, tail_i, ntail_r, ntail_i, n_streams,
      t_len, st));
}

// The staged polyphase walk of the tuner mix + 27-tap decimating FIR,
// shared by the mix + decimate kernel (mix_decimate.cu, kernel 1) and the
// fused front end + matched filter kernel (mix_dec_mf.cu, kernel 6).
//
// A CTA of kThreads threads walks a span of one stream's decimated samples
// in sub-chunks of `sub` of them (kThreads at a fixed m; fewer as a
// run-time m grows). Sub-chunk c holds decimated samples k_c .. k_c + n - 1;
// its input is samples t = (k_c - h) * m + j, j < (h + n) * m, h = 26 / m
// columns of FIR halo before it (re-read from L2). Thread tid loads
// j = tid + kThreads * i into registers one sub-chunk ahead of the one
// being computed (Stager::load), then mixes them with one pattern entry (j
// steps by a multiple of 128) and stores sample j at row j % m, column
// j / m of a polyphase buffer, rows row_words(sub, m) (odd) words apart
// (Stager::store). FIR tap a of output tid then reads row (m - 1 - a) mod
// m at column tid + h + floor((m - 1 - a) / m): every lane of a tap reads
// one row at consecutive columns, with no bank conflict at any m
// (fir_staged). Products and sums are jsdr_fir's (fir_mix.cuh), so every
// kernel built on this walk agrees bit for bit with kernel 3's front end.
//
// With m fixed at compile time (kM > 0) every word offset is a constant.
// With m at run time (kM == 0) the offsets are stepped, not divided: a
// thread's store words advance by kThreads / m columns and kThreads % m
// rows an entry, and the FIR's tap words by one row back (a column back
// where the row wraps).
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#include "fir_mix.cuh"

// Everything has internal linkage: each kernel file gets its own copy.
namespace jsdr_walk {
namespace {

using jsdr_fir::kHalo;
using jsdr_fir::kPeriod;
using jsdr_fir::kTaps;
constexpr int kThreads = 256;
constexpr int kMaxPer = 21;  // input samples a thread stages a plane
// the largest m: (8 + 26 / m) * m <= kMaxPer * kThreads
constexpr int kMaxM = 672;

// Words of one input row: the sub-chunk's columns and 26/m halo columns,
// odd (fewer bank conflicts on the staged samples' scattered stores).
__host__ __device__ constexpr int row_words(int sub, int m) {
  return (sub + kHalo / m) | 1;
}

// Input samples a thread stages a plane and sub-chunk of kThreads outputs
// at a fixed m (kMaxPer at run-time m).
template <int kM>
__host__ __device__ constexpr int per_thread() {
  return kM > 0 ? ((kThreads + kHalo / kM) * kM + kThreads - 1) / kThreads
                : kMaxPer;
}
static_assert(per_thread<10>() <= kMaxPer && per_thread<20>() <= kMaxPer,
              "staging registers");

// The sub-chunk at decimation m: kThreads at a fixed m; at run-time m
// halved (to 8 at least) until a thread stages at most kMaxPer samples a
// plane. 0 if m is larger than any sub-chunk can take (m > kMaxM).
template <int kM>
__host__ int sub_chunk(int m) {
  int sub = kThreads;
  if (kM == 0)
    while (sub > 8 && (sub + kHalo / m) * m > kMaxPer * kThreads) sub /= 2;
  return (sub + kHalo / m) * m > per_thread<kM>() * kThreads ? 0 : sub;
}

// A thread's staged input samples of one sub-chunk, both planes.
template <int kM>
struct Stager {
  static constexpr int kPer = per_thread<kM>();
  float ur[kPer], ui[kPer];

  // samples t0 + j, j = tid + kThreads * i < cnt (t >= 0) into registers
  __device__ __forceinline__ void load(const float* __restrict__ xr,
                                       const float* __restrict__ xi,
                                       long long row, int t0, int cnt,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = tid + kThreads * i;
      if (j < cnt && t0 + j >= 0) {
        ur[i] = __ldg(xr + row + t0 + j);
        ui[i] = __ldg(xi + row + t0 + j);
      }
    }
  }

  // Mix the loaded samples and store sample j at word (j % m) * wp + j / m
  // of br / bi. t < 0: the carried tail tr / ti (26 samples, already mixed;
  // h * m <= 26, so t >= -26); else the pattern entry (t0 + tid) & 127.
  __device__ __forceinline__ void store(float* br, float* bi,
                                        const float* cs, const float* sn,
                                        const float* __restrict__ tr,
                                        const float* __restrict__ ti, int t0,
                                        int cnt, int m, int wp, int tid) {
    const int p = (t0 + tid) & (kPeriod - 1);
    const float cr = cs[p], ci = sn[p];
    // run-time m: thread tid's first word, and the step of each entry
    int r = 0, w = 0, dr = 0, dw = 0;
    if constexpr (kM == 0) {
      r = tid % m;
      w = r * wp + tid / m;
      dr = kThreads % m;
      dw = dr * wp + kThreads / m;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = tid + kThreads * i;
      if (j < cnt) {
        int at = w;
        if constexpr (kM > 0) at = (j % kM) * wp + j / kM;
        const int t = t0 + j;
        if (t >= 0) {
          br[at] = __fmul_rn(ur[i], cr);
          bi[at] = __fmul_rn(ui[i], ci);
        } else {
          br[at] = tr[kHalo + t];
          bi[at] = ti[kHalo + t];
        }
      }
      if constexpr (kM == 0) {
        r += dr;
        w += dw;
        if (r >= m) {
          r -= m;
          w += 1 - m * wp;
        }
      }
    }
  }
};

// The FIR output (jsdr_fir::fir_output) of the decimated sample in column
// col of a staged sub-chunk (col = tid: output k_c + tid): tap a meets
// j = (col + h + 1) * m - 1 - a, at row (m - 1 - a) mod m, column
// col + h + floor((m - 1 - a) / m) (>= col: h = 26 / m).
template <int kM>
__device__ __forceinline__ float2 fir_staged(const float* br, const float* bi,
                                             int m, int wp, int col,
                                             const float* tp, float gain) {
  const int h = kHalo / m;
  if constexpr (kM > 0) {
    return jsdr_fir::fir_output(
        [&](int a) {
          const int e = kM - 1 - a;
          const int q = (e % kM + kM) % kM;
          const int w = q * wp + col + h + (e - q) / kM;
          return make_float2(br[w], bi[w]);
        },
        tp, gain);
  } else {
    // m at run time: fir_output calls fetch once a tap, in order a = 0..26
    int q = m - 1, w = (m - 1) * wp + col + h;
    return jsdr_fir::fir_output(
        [&](int) {
          const float2 v = make_float2(br[w], bi[w]);
          if (q == 0) {
            q = m - 1;
            w += (m - 1) * wp - 1;
          } else {
            --q;
            w -= wp;
          }
          return v;
        },
        tp, gain);
  }
}

// The CTAs of one wave of `kernel` (kThreads threads, smem bytes of dynamic
// shared memory) on the current device. Worked out once per (kernel,
// device, smem) and kept, so a launch makes no query; the shared-memory
// attribute is set to smem_cap (the most any m takes) once with it.
template <class Kernel>
cudaError_t wave_ctas(Kernel kernel, size_t smem, size_t smem_cap,
                      int* ctas) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel),
                                   dev, smem);
  auto it = known.find(key);
  if (it == known.end()) {
    int n_sm = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_cap));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return e;
    it = known.emplace(key, n_sm * (per_sm > 1 ? per_sm : 1)).first;
  }
  *ctas = it->second;
  return cudaSuccess;
}

// The span of a stream's outputs a CTA walks: one wave of `ctas` CTAs over
// n_streams streams of n_out outputs, a multiple of 32, none shorter than
// min_span.
inline int wave_span(int ctas, int n_streams, int n_out, int min_span) {
  const int spans = ctas / n_streams > 1 ? ctas / n_streams : 1;
  const int span = ((n_out + spans - 1) / spans + 31) / 32 * 32;
  return span > min_span ? span : min_span;
}

}  // namespace
}  // namespace jsdr_walk

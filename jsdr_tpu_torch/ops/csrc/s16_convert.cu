// Interleaved S16LE I/Q -> planar float32 re and im rows, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference converts with jnp ops
// (jsdr_tpu/io/convert_device.py::s16_to_cf), which XLA fuses into one pass;
// eager torch ran the same chain as ~13 launches a block. Same contract as
// the plain chain io/convert_device.py::s16_to_cf_ref, for each sample k < n:
//   channels 2: i = wrap16(in[2k] + ic), q = wrap16(in[2k + 1] + qc)
//   channels 1: i = wrap16(in[k] + ic),  q = wrap16(qc)
//   re[k] = float(i) * scale, im[k] = float(q) * scale
// with wrap16(x) = ((x + 32768) & 0xFFFF) - 32768 in int32 (Java's short
// wrap-around, JavaAudio.java:275-293). wrap16 reads x mod 65536 alone, so
// the wrapper hands ic and qc in reduced mod 65536 and no sum overflows.
// The conversion is exact and the one product rounds once (__int2float_rn,
// __fmul_rn): kernel and plain chain agree bit for bit.
//
// What bounds it on this card: device memory. A complex sample reads 4 bytes
// and writes 8; a 4.8 s block at 192 kS/s (921,600 samples) moves 11 MB,
// 3.3 us at 3.35 TB/s, so at the Session's sizes the launch sets the time.
//
// Design: a thread takes 4 consecutive samples: one 16-byte load of 8 int16
// (stereo; mono: one 8-byte load of 4) and one float4 store to each row.
// The wrapper places the rows 16-byte aligned. A thread whose 4 samples run
// past n, or any thread where the input is not aligned for its vector load,
// takes its samples one at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;        // samples a thread

__device__ __forceinline__ float convert(int x, int corr, float scale) {
  const int w = ((x + corr + 32768) & 0xFFFF) - 32768;
  return __fmul_rn(__int2float_rn(w), scale);
}

__global__ void __launch_bounds__(kThreads)
s16_to_cf_kernel(const int16_t* __restrict__ in, float* __restrict__ re,
                 float* __restrict__ im, int n, int stereo, int ic, int qc,
                 float scale, int vec) {
  const int64_t k0 =
      kPerThread * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (k0 >= n) return;
  if (vec && k0 + kPerThread <= n) {
    int xi[kPerThread], xq[kPerThread];
    if (stereo) {
      // little-endian words: I in the low half, Q in the high half
      const int4 v = *reinterpret_cast<const int4*>(in + 2 * k0);
      const int w[kPerThread] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        xi[j] = static_cast<int16_t>(w[j] & 0xFFFF);
        xq[j] = w[j] >> 16;
      }
    } else {
      const short4 v = *reinterpret_cast<const short4*>(in + k0);
      xi[0] = v.x, xi[1] = v.y, xi[2] = v.z, xi[3] = v.w;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) xq[j] = 0;
    }
    *reinterpret_cast<float4*>(re + k0) =
        make_float4(convert(xi[0], ic, scale), convert(xi[1], ic, scale),
                    convert(xi[2], ic, scale), convert(xi[3], ic, scale));
    *reinterpret_cast<float4*>(im + k0) =
        make_float4(convert(xq[0], qc, scale), convert(xq[1], qc, scale),
                    convert(xq[2], qc, scale), convert(xq[3], qc, scale));
    return;
  }
  const int64_t end = k0 + kPerThread < n ? k0 + kPerThread : n;
  for (int64_t k = k0; k < end; ++k) {
    re[k] = convert(stereo ? in[2 * k] : in[k], ic, scale);
    im[k] = convert(stereo ? in[2 * k + 1] : 0, qc, scale);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// in: 2n (channels 2) or n (channels 1) int16; re, im: n float32 each.
// ic, qc in [0, 65536).
extern "C" int jsdr_s16_to_cf(const int16_t* in, float* re, float* im, int n,
                              int channels, int ic, int qc, float scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int stereo = channels == 2;
  const int vec = aligned(in, stereo ? 16 : 8) && aligned(re, 16) &&
                  aligned(im, 16);
  const int64_t threads = (static_cast<int64_t>(n) + kPerThread - 1) /
                          kPerThread;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) /
                                              kThreads);
  s16_to_cf_kernel<<<grid, kThreads, 0, st>>>(in, re, im, n, stereo, ic, qc,
                                              scale, vec);
  return static_cast<int>(cudaGetLastError());
}

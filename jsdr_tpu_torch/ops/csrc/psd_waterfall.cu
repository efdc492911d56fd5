// Fused power -> dBFS -> max-decimate -> 8-bit waterfall line for Hopper
// (sm_90a).
//
// Replaces: jsdr_tpu/ops/pallas_kernels.py::_psd_waterfall_kernel (wrapper
// psd_waterfall). Same contract, per spectrum row of n bins:
//   db[i]   = 10 * log10(max((re[i]^2 + im[i]^2) * cf, 1e-30)),  cf = (2/n)^2
//   dec[g]  = max_{j < n/width} db[g*(n/width) + j]
//   line[(g + width/2) % width] = u8(clip(255 - dec[g] * -2.55, 0, 255))
// The line order is the reference's jnp version (jnp.roll by width/2, so
// 0 Hz sits at width/2 for odd widths too); the Pallas kernel's half swap
// agrees with it only for even widths.
//
// What bounds it on this card: device memory. Per row it reads 8n bytes and
// writes 4n + width, for ~20 flops and one log10f per bin: at 1280 rows of
// 9600 bins that is 0.16 GB, about 0.05 ms at 3.35 TB/s.
//
// Design: one CTA per row. Pass 1 reads re/im with consecutive threads on
// consecutive bins and writes db the same way; pass 2 (after the CTA's
// barrier, which makes those writes visible to the whole CTA) gives each
// thread whole groups, takes the maximum over the row's db values (from
// L1/L2, not device memory) and writes the clipped intensity as u8: no
// float line and no cast pass. Every product and sum is an explicit
// __fmul_rn/__fadd_rn in the plain version's order and the log is log10f,
// so kernel and plain version agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
psd_waterfall_kernel(const float* __restrict__ re, const float* __restrict__ im,
                     float* db, unsigned char* __restrict__ line, int n,
                     int width, float cf) {
  const long long row = blockIdx.x;
  const float* r = re + row * n;
  const float* q = im + row * n;
  float* d = db + row * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float a = r[i];
    const float b = q[i];
    const float p = __fmul_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), cf);
    d[i] = __fmul_rn(10.0f, log10f(fmaxf(p, 1e-30f)));
  }
  __syncthreads();
  const int step = n / width;
  const int half = width / 2;
  unsigned char* out = line + row * width;
  for (int g = threadIdx.x; g < width; g += kThreads) {
    const float* grp = d + static_cast<long long>(g) * step;
    float mx = grp[0];
    for (int j = 1; j < step; ++j) mx = fmaxf(mx, grp[j]);
    const float v = __fsub_rn(255.0f, __fmul_rn(mx, -2.55f));
    out[(g + half) % width] =
        static_cast<unsigned char>(fminf(fmaxf(v, 0.0f), 255.0f));
  }
}

}  // namespace

extern "C" int jsdr_psd_waterfall(const float* re, const float* im, float* db,
                                  unsigned char* line, int n_rows, int n,
                                  int width, float cf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  psd_waterfall_kernel<<<n_rows, kThreads, 0, st>>>(re, im, db, line, n,
                                                    width, cf);
  return static_cast<int>(cudaGetLastError());
}

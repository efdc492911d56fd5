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
// 9600 bins that is 0.15 GB, about 0.044 ms at 3.35 TB/s. At the Session's
// 10 rows (0.96 MB) the bytes take 0.35 us, so there the launch and one
// round trip to device memory set the time.
//
// Design: the card is filled whatever the row count. A CTA takes a tile of
// G whole groups (G * step consecutive bins of one row, step = n / width);
// the grid covers rows x tiles. G is chosen here (tile_groups) so that a
// few rows still give several CTAs an SM, and many rows give tiles of at
// most kSlab bins. In one pass each thread computes power and dB for its
// bins, with 16-byte loads and stores where the tile starts 16-byte aligned
// (G rounded so that it does where n allows) and 4-byte ones otherwise,
// writes db coalesced and keeps the tile's dB values in shared memory;
// after one barrier each thread takes whole groups, takes their maximum
// from shared memory and writes the clipped intensity as u8. db is never
// read back. A group larger than kSlab bins (width < n / kSlab) takes a
// CTA of its own that walks it with a running maximum a thread, then over
// the CTA. Every product and sum is an explicit __fmul_rn/__fadd_rn in the
// plain version's order and the log is log10f, so kernel and plain version
// agree bit for bit (a maximum is exact in any order).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 2048;                  // bins of dB a CTA keeps (8 KB)
constexpr int kVec = kSlab / 4 / kThreads;   // float4s a thread and plane
constexpr int kCtasPerSm = 4;                // CTAs wanted at few rows

__device__ __forceinline__ float db_of(float a, float b, float cf) {
  const float p = __fmul_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), cf);
  return __fmul_rn(10.0f, log10f(fmaxf(p, 1e-30f)));
}

__device__ __forceinline__ unsigned char intensity(float mx) {
  const float v = __fsub_rn(255.0f, __fmul_rn(mx, -2.55f));
  return static_cast<unsigned char>(fminf(fmaxf(v, 0.0f), 255.0f));
}

__global__ void __launch_bounds__(kThreads)
psd_waterfall_kernel(const float* __restrict__ re,
                     const float* __restrict__ im, float* __restrict__ db,
                     unsigned char* __restrict__ line, int n, int width,
                     int groups, float cf) {
  __shared__ __align__(16) float tile[kSlab];
  __shared__ float warp_max[kThreads / 32];
  const int tid = threadIdx.x;
  const int step = n / width;
  const int tiles = (width + groups - 1) / groups;
  const long long row = blockIdx.x / tiles;    // the grid: rows x tiles
  const int g0 = (blockIdx.x % tiles) * groups;  // this CTA's first group
  const int gn = min(groups, width - g0);      // and its groups
  const long long b0 = row * n + static_cast<long long>(g0) * step;
  const float* r = re + b0;
  const float* q = im + b0;
  float* d = db + b0;
  const int cnt = gn * step;                   // the tile's bins
  const bool vec =
      ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(q) |
        reinterpret_cast<uintptr_t>(d)) & 15) == 0;
  unsigned char* out = line + row * width;
  const int half = width / 2;

  if (cnt <= kSlab) {
    // ---- dB of the tile's bins, kept in shared memory
    int done = 0;
    if (vec) {
      const int nv = cnt / 4;
      float4 a[kVec], b[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int v = tid + u * kThreads;
        if (v < nv) {
          a[u] = __ldg(reinterpret_cast<const float4*>(r) + v);
          b[u] = __ldg(reinterpret_cast<const float4*>(q) + v);
        }
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int v = tid + u * kThreads;
        if (v < nv) {
          const float4 o = make_float4(
              db_of(a[u].x, b[u].x, cf), db_of(a[u].y, b[u].y, cf),
              db_of(a[u].z, b[u].z, cf), db_of(a[u].w, b[u].w, cf));
          reinterpret_cast<float4*>(d)[v] = o;
          reinterpret_cast<float4*>(tile)[v] = o;
        }
      }
      done = 4 * nv;
    }
    for (int i = done + tid; i < cnt; i += kThreads) {
      const float o = db_of(r[i], q[i], cf);
      d[i] = o;
      tile[i] = o;
    }
    __syncthreads();
    // ---- each group's maximum from shared memory
    for (int g = tid; g < gn; g += kThreads) {
      const float* grp = tile + g * step;
      float mx = grp[0];
      for (int j = 1; j < step; ++j) mx = fmaxf(mx, grp[j]);
      out[(g0 + g + half) % width] = intensity(mx);
    }
    return;
  }

  // ---- one group of more than kSlab bins (groups == 1): a running maximum
  float mx = -__int_as_float(0x7f800000);  // -inf
  int done = 0;
  if (vec) {
    const int nv = cnt / 4;
    for (int v = tid; v < nv; v += kThreads) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(r) + v);
      const float4 b = __ldg(reinterpret_cast<const float4*>(q) + v);
      const float4 o = make_float4(db_of(a.x, b.x, cf), db_of(a.y, b.y, cf),
                                   db_of(a.z, b.z, cf), db_of(a.w, b.w, cf));
      reinterpret_cast<float4*>(d)[v] = o;
      mx = fmaxf(mx, fmaxf(fmaxf(o.x, o.y), fmaxf(o.z, o.w)));
    }
    done = 4 * nv;
  }
  for (int i = done + tid; i < cnt; i += kThreads) {
    const float o = db_of(r[i], q[i], cf);
    d[i] = o;
    mx = fmaxf(mx, o);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    out[(g0 + half) % width] = intensity(mx);
  }
}

// The SMs of the current device, asked once per device and kept.
cudaError_t sm_count(int* n_sm) {
  static std::mutex mu;
  static std::map<int, int> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(dev);
  if (it == known.end()) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    it = known.emplace(dev, n).first;
  }
  *n_sm = it->second;
  return cudaSuccess;
}

// Groups a CTA takes (ops/psd_waterfall.py::tile_groups mirrors it): as
// many tiles a row as give n_rows * tiles >= kCtasPerSm CTAs an SM, but no
// tile over kSlab bins (one group if a group is larger); G then rounded up
// so that a tile spans a multiple of 4 bins where n is one (16-byte
// aligned tiles), back by that much if the tile outgrew a slab, and at
// most width.
int tile_groups(int n, int width, int n_rows, int n_sm) {
  const int step = n / width;
  const int g_max = step >= kSlab ? 1 : kSlab / step;
  const int want = (kCtasPerSm * n_sm + n_rows - 1) / n_rows;
  const int tiles =
      std::max((width + g_max - 1) / g_max, std::min(width, want));
  int g = (width + tiles - 1) / tiles;
  const int align =
      n % 4 ? 1 : 4 / (step % 4 == 0 ? 4 : step % 2 == 0 ? 2 : 1);
  g = (g + align - 1) / align * align;
  if (g * step > kSlab && g > 1) g -= align;  // stay within a slab
  return std::max(1, std::min(g, width));
}

}  // namespace

extern "C" int jsdr_psd_waterfall(const float* re, const float* im, float* db,
                                  unsigned char* line, int n_rows, int n,
                                  int width, float cf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_sm = 0;
  cudaError_t e = sm_count(&n_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int g = tile_groups(n, width, n_rows, n_sm);
  const unsigned grid = static_cast<unsigned>(n_rows) * ((width + g - 1) / g);
  psd_waterfall_kernel<<<grid, kThreads, 0, st>>>(re, im, db, line, n, width,
                                                  g, cf);
  return static_cast<int>(cudaGetLastError());
}

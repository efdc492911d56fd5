// The spectrum of one FFT block, computed by one CTA from shared memory:
// the body shared by the waterfall spectrum kernel (spectrum_wf.cu) and the
// merged spectrum + front end kernel (spec_front.cu). It is the Hopper form
// of jsdr_tpu/ops/pallas_kernels.py::_spec_stage1_to_scratch +
// _spec_tail_batched; both kernels call this one routine, so their
// waterfall lines and peaks agree bit for bit on the same input.
//
// Contract, for the windowed block a[t] (t < n = n1 * 128), with
// A[j, c] = a[128*j + c]:
//   stage 1   B[k1, c]  = sum_j W1[k1, j] * A[j, c]          (n1-point DFT)
//   twiddle   C[k1, c]  = B[k1, c] * TW[k1, c]
//   stage 2   D[k1, k2] = sum_c C[k1, c] * W2[k2, c]           (128-point DFT)
//   power     P[k1, k2] = (Dr^2 + Di^2) * (2/n)^2, natural bin n1*k2 + k1
//   wf[g, k2] = max_{k1 in [g*q, (g+1)*q)} 10*log10(max(P[k1, k2], 1e-30))
//   peak: the FIRST maximum of P in the permuted flat order k1*128 + k2
//   (ties go to the smaller flat index), mx = 10*log10(max(P_max, 1e-30)).
// W1 = _dft_mats(n1, -1), TW = _twiddles(n1, 128, -1), W2 = _dft_mats(128,
// -1): the f32 host tables of jsdr_tpu_torch/ops/mxu_fft.py, in device
// memory. Both DFT matrices are symmetric, so W1[j * n1 + k1] and
// W2[c * 128 + k2] read them with consecutive lanes on consecutive
// addresses. The waterfall max is taken over dB values (log, then max), so
// the q-decimated lines equal the full PSD (q = 1) max-decimated, exactly.
//
// Every product and sum is an explicit fmaf / __fmul_rn / __fadd_rn: the
// compiler has no contraction left to choose, so the routine computes the
// same bits wherever it is inlined.
//
// Work split (kThreads = 256, 8 warps):
//   stage 1: a warp takes 4 columns at a time, copies them (n1 x 4 complex)
//     into its own buffer, then each lane accumulates 3 rows k1 x 4 columns
//     in registers over j (n1 complex MACs each) and writes C = B * TW back
//     over the columns, in place;
//   stage 2: a warp takes whole decimation groups (q >= 8: one group in
//     chunks of <= 8 rows; q < 8: 8/q groups), each lane 4 bins k2 for up to
//     8 rows in registers over the 128 columns c; the group max and the
//     running (max P, min index) stay in registers; the peak is reduced over
//     the warp by shuffles, then over the CTA in shared memory.
//
// What bounds it: arithmetic. The direct two-stage DFT is (n1^2 * 128 +
// n1 * 128^2) complex MACs per block (1,948,800 at n = 9600: 15.6 MFLOP)
// for 8 bytes of input per sample; a factored FFT would need far fewer.
#pragma once

#include <climits>

#include <cuda_runtime.h>

// Everything has internal linkage: each kernel file gets its own copy.
namespace jsdr_spec {
namespace {

constexpr int kN2 = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;        // stage 1: columns per warp task
constexpr int kK1PerLane = 3;   // stage 1: rows per lane per pass
constexpr int kRows = 8;        // stage 2: rows per chunk
constexpr int kBins = kN2 / 32;  // stage 2: bins k2 per lane
constexpr float kEps = 1e-30f;

struct Tables {
  const float* w1r;  // [n1, n1]
  const float* w1i;
  const float* twr;  // [n1, 128]
  const float* twi;
  const float* w2r;  // [128, 128]
  const float* w2i;
};

// Dynamic shared memory of one CTA: the block's two planes (n floats each)
// and each warp's stage-1 buffer (2 planes of n1 x kCols floats).
__host__ __device__ constexpr size_t smem_bytes(int n1) {
  return sizeof(float) * (2 * static_cast<size_t>(n1) * kN2 +
                          static_cast<size_t>(kWarps) * 2 * n1 * kCols);
}

// acc += w * x (complex), four fused multiply-adds in a fixed order
__device__ __forceinline__ void cmac(float& acc_r, float& acc_i, float wr,
                                     float wi, float xr, float xi) {
  acc_r = fmaf(wr, xr, acc_r);
  acc_r = fmaf(-wi, xi, acc_r);
  acc_i = fmaf(wr, xi, acc_i);
  acc_i = fmaf(wi, xr, acc_i);
}

__device__ __forceinline__ float to_db(float p) {
  return __fmul_rn(10.f, log10f(fmaxf(p, kEps)));
}

// (p, i) ranks above (bp, bi): larger power, or equal power at a smaller
// flat index (the first maximum)
__device__ __forceinline__ bool better(float p, int i, float bp, int bi) {
  return p > bp || (p == bp && i < bi);
}

// Stage 1 + twiddle, in place over ar/ai ([n1, 128] planes).
__device__ __forceinline__ void stage1(float* ar, float* ai, float* buf,
                                       int n1, const Tables& tb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* br = buf + static_cast<size_t>(warp) * 2 * n1 * kCols;
  float* bi = br + n1 * kCols;
  for (int c0 = warp * kCols; c0 < kN2; c0 += kWarps * kCols) {
    for (int j = lane; j < n1; j += 32) {
      *reinterpret_cast<float4*>(br + j * kCols) =
          *reinterpret_cast<const float4*>(ar + j * kN2 + c0);
      *reinterpret_cast<float4*>(bi + j * kCols) =
          *reinterpret_cast<const float4*>(ai + j * kN2 + c0);
    }
    __syncwarp();
    for (int kb = 0; kb < n1; kb += 32 * kK1PerLane) {
      float accr[kK1PerLane][kCols], acci[kK1PerLane][kCols];
#pragma unroll
      for (int u = 0; u < kK1PerLane; ++u)
#pragma unroll
        for (int c = 0; c < kCols; ++c) accr[u][c] = acci[u][c] = 0.f;
      for (int j = 0; j < n1; ++j) {
        const float4 xr = *reinterpret_cast<const float4*>(br + j * kCols);
        const float4 xi = *reinterpret_cast<const float4*>(bi + j * kCols);
#pragma unroll
        for (int u = 0; u < kK1PerLane; ++u) {
          const int k1 = kb + lane + 32 * u;
          float wr = 0.f, wi = 0.f;
          if (k1 < n1) {
            wr = __ldg(tb.w1r + j * n1 + k1);
            wi = __ldg(tb.w1i + j * n1 + k1);
          }
          cmac(accr[u][0], acci[u][0], wr, wi, xr.x, xi.x);
          cmac(accr[u][1], acci[u][1], wr, wi, xr.y, xi.y);
          cmac(accr[u][2], acci[u][2], wr, wi, xr.z, xi.z);
          cmac(accr[u][3], acci[u][3], wr, wi, xr.w, xi.w);
        }
      }
#pragma unroll
      for (int u = 0; u < kK1PerLane; ++u) {
        const int k1 = kb + lane + 32 * u;
        if (k1 >= n1) continue;
        const float4 tr =
            __ldg(reinterpret_cast<const float4*>(tb.twr + k1 * kN2 + c0));
        const float4 ti =
            __ldg(reinterpret_cast<const float4*>(tb.twi + k1 * kN2 + c0));
        const float twr[kCols] = {tr.x, tr.y, tr.z, tr.w};
        const float twi[kCols] = {ti.x, ti.y, ti.z, ti.w};
        float cr[kCols], ci[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          cr[c] = fmaf(accr[u][c], twr[c], -__fmul_rn(acci[u][c], twi[c]));
          ci[c] = fmaf(accr[u][c], twi[c], __fmul_rn(acci[u][c], twr[c]));
        }
        *reinterpret_cast<float4*>(ar + k1 * kN2 + c0) =
            make_float4(cr[0], cr[1], cr[2], cr[3]);
        *reinterpret_cast<float4*>(ai + k1 * kN2 + c0) =
            make_float4(ci[0], ci[1], ci[2], ci[3]);
      }
    }
    __syncwarp();
  }
}

// The whole body. On entry ar/ai hold the windowed block (sample t at
// index t) and the CTA is synchronised. Writes wf[g * 128 + k2] for
// g < n1 / q, *mx and *idx.
__device__ __forceinline__ void spectrum_body(float* ar, float* ai,
                                              float* buf, int n1, int q,
                                              float cf, const Tables& tb,
                                              float* __restrict__ wf,
                                              float* __restrict__ mx,
                                              int* __restrict__ idx) {
  __shared__ float red_p[kWarps];
  __shared__ int red_i[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  stage1(ar, ai, buf, n1, tb);
  __syncthreads();

  // ---- stage 2, power, decimation, peak
  const int n_groups = n1 / q;
  const int groups_per_task = q >= kRows ? 1 : kRows / q;
  const int rows_per_task = groups_per_task * q;
  const int n_tasks = (n_groups + groups_per_task - 1) / groups_per_task;
  float best_p = -1.f;
  int best_i = INT_MAX;
  for (int task = warp; task < n_tasks; task += kWarps) {
    const int r_begin = task * rows_per_task;
    const int r_end = min(r_begin + rows_per_task, n1);
    const int n_chunks = (r_end - r_begin + kRows - 1) / kRows;
    const int chunk = (r_end - r_begin + n_chunks - 1) / n_chunks;
    float gmax[kBins];
#pragma unroll
    for (int i = 0; i < kBins; ++i) gmax[i] = 0.f;  // set at each group's first row
    for (int r0 = r_begin; r0 < r_end; r0 += chunk) {
      const int nr = min(chunk, r_end - r0);
      float dr[kRows][kBins], di[kRows][kBins];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kBins; ++i) dr[r][i] = di[r][i] = 0.f;
      for (int c0 = 0; c0 < kN2; c0 += 4) {
        float wr[4][kBins], wi[4][kBins];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int i = 0; i < kBins; ++i) {
            wr[cc][i] = __ldg(tb.w2r + (c0 + cc) * kN2 + lane + 32 * i);
            wi[cc][i] = __ldg(tb.w2i + (c0 + cc) * kN2 + lane + 32 * i);
          }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nr) {
            const float4 cr =
                *reinterpret_cast<const float4*>(ar + (r0 + r) * kN2 + c0);
            const float4 ci =
                *reinterpret_cast<const float4*>(ai + (r0 + r) * kN2 + c0);
#pragma unroll
            for (int i = 0; i < kBins; ++i) {
              cmac(dr[r][i], di[r][i], wr[0][i], wi[0][i], cr.x, ci.x);
              cmac(dr[r][i], di[r][i], wr[1][i], wi[1][i], cr.y, ci.y);
              cmac(dr[r][i], di[r][i], wr[2][i], wi[2][i], cr.z, ci.z);
              cmac(dr[r][i], di[r][i], wr[3][i], wi[3][i], cr.w, ci.w);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) {
          const int k1 = r0 + r;
          const int in_group = k1 % q;
#pragma unroll
          for (int i = 0; i < kBins; ++i) {
            const int k2 = lane + 32 * i;
            const float p = __fmul_rn(
                __fadd_rn(__fmul_rn(dr[r][i], dr[r][i]),
                          __fmul_rn(di[r][i], di[r][i])),
                cf);
            if (better(p, k1 * kN2 + k2, best_p, best_i)) {
              best_p = p;
              best_i = k1 * kN2 + k2;
            }
            const float db = to_db(p);
            gmax[i] = in_group == 0 ? db : fmaxf(gmax[i], db);
            if (in_group == q - 1) wf[(k1 / q) * kN2 + k2] = gmax[i];
          }
        }
      }
    }
  }

  // ---- peak: warp, then CTA
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float p = __shfl_xor_sync(0xffffffffu, best_p, off);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(p, i, best_p, best_i)) {
      best_p = p;
      best_i = i;
    }
  }
  if (lane == 0) {
    red_p[warp] = best_p;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(red_p[w], red_i[w], best_p, best_i)) {
        best_p = red_p[w];
        best_i = red_i[w];
      }
    *mx = to_db(best_p);
    *idx = best_i;
  }
}

}  // namespace
}  // namespace jsdr_spec

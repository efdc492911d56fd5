// The spectrum of one FFT block, computed from shared memory by one CTA or
// by a cluster of kRanks CTAs: the body shared by the waterfall spectrum
// kernel (spectrum_wf.cu) and the merged spectrum + front end kernel
// (spec_front.cu). It is the Hopper form of
// jsdr_tpu/ops/pallas_kernels.py::_spec_stage1_to_scratch +
// _spec_tail_batched; both kernels call this one routine, so their
// waterfall lines and peaks agree bit for bit on the same input.
//
// Contract, for the windowed block a[t] (t < n = n1 * 128), with
// A[j, c] = a[128*j + c]:
//   stage 1   B[k1, c]  = sum_j W_n1^(j*k1) * A[j, c]          (n1-point DFT)
//   twiddle   C[k1, c]  = B[k1, c] * TW[k1, c]
//   stage 2   D[k1, k2] = sum_c C[k1, c] * W_128^(c*k2)        (128-point DFT)
//   power     P[k1, k2] = (Dr^2 + Di^2) * (2/n)^2, natural bin n1*k2 + k1
//   wf[g, k2] = max_{k1 in [g*q, (g+1)*q)} 10*log10(max(P[k1, k2], 1e-30))
//   peak: the FIRST maximum of P in the permuted flat order k1*128 + k2
//   (ties go to the smaller flat index), mx = 10*log10(max(P_max, 1e-30)).
// TW = _twiddles(n1, 128, -1) (jsdr_tpu_torch/ops/mxu_fft.py). Each row's
// power is computed the same way whatever q is, and the waterfall max is
// taken over dB values (log, then max), so the q-decimated lines equal the
// full PSD (q = 1) max-decimated, exactly.
//
// How: a factored FFT, planned on the host (jsdr_tpu_torch/ops/fft_plan.py,
// whose docstring defines every table read here; its plain mirror is tested
// against numpy's FFT on the CPU for every n1 the card takes).
//   stage 1: in place over planar [n1][kCols] planes, one
//     decimation-in-frequency pass per radix (4, 2, 3, 5; butterflies
//     written out), a __syncthreads() between passes. kThreads / kCols
//     threads own each column (thread t: column t % kCols, every
//     kThreads / kCols-th butterfly), so the 32 lanes of a warp touch 32
//     consecutive words of one row: no bank conflicts, and every lane of a
//     warp reads the same twiddle. The product of n1's prime factors above
//     5 (rg, 1 for every rate a user runs) is left to stage 2's row read as
//     a direct rg-point DFT over rg consecutive rows. The rows stay
//     digit-reversed (perm).
//   stage 2: a warp per decimation group of q rows. For row k1 it reads
//     storage row perm[k1] (lane l: c = l + 32*i, i < 4), multiplies by
//     TW, runs a 4-point DFT over its registers, the W_128^(l*u) twiddle,
//     and a 32-point FFT across lanes in five __shfl_xor_sync radix-2
//     stages: lane l then holds k2 = 4*bitrev5(l) + u, four consecutive
//     bins. No shared-memory round trip; the group max and the running
//     (max P, min index) stay in registers, and each lane writes its four
//     bins of a line as one float4.
//
// Where the block lives (kRanks):
//   1: one CTA holds all 128 columns (kCols = 128, two threads a column).
//     Shared memory holds the block only (8 bytes a sample, 1 KB a row),
//     so n1 <= 225 fits beside the merged kernel's static arrays.
//   4: a thread-block cluster of 4 CTAs (Hopper's distributed shared
//     memory) for 225 < n1 <= 512. Rank r holds columns [32r, 32r + 32) of
//     every row as [n1][32] planes (256 B a row, 128 KB at n1 = 512) and
//     runs stage 1 on them with 8 threads a column. After cluster.sync()
//     the cluster's 32 warps share the groups; lane l's register i is
//     column l + 32*i, which lives in rank i at word p*32 + l, so a row
//     read is four coalesced reads through cluster.map_shared_rank. The
//     peak reduces over warps, then rank 0 reads the other ranks'. Every
//     butterfly, twiddle and stage-2 step is the same operation on the
//     same values, so both layouts give the same bits.
//
// Every product and sum is an explicit fmaf / __fmul_rn / __fadd_rn /
// __fsub_rn: the compiler has no contraction left to choose, so the routine
// computes the same bits wherever it is inlined.
//
// What bounds it: at n = 9600 the FFT is ~0.64 MFLOP a block (5 n log2 n)
// on 77 KB of samples, so device memory (8 bytes a sample read, once) and
// the shared-memory passes over the block (4 for 75 = 3*5*5: 3 in place,
// 1 read) are the limits, not the arithmetic. The tables (a few KB) are
// read through the read-only cache.
#pragma once

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Everything has internal linkage: each kernel file gets its own copy.
namespace jsdr_spec {
namespace {

namespace cg = cooperative_groups;

constexpr int kN2 = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegs = kN2 / 32;              // stage 2: values per lane
constexpr int kCluster = kRegs;              // CTAs a block above one CTA's n1
constexpr int kS2Tw = 7;                     // stage 2: twiddles per lane
constexpr float kEps = 1e-30f;

// The plan's device tables (fft_plan.py::plan_tables) and TW.
struct Plan {
  const int* passes;  // [n_pass, 4]: radix, L, stride, twiddle offset
  const float* ptwr;  // pass twiddles W_L^(j*k) at offset + j*(r-1) + k-1
  const float* ptwi;
  const int* perm;    // [n1] storage row of frequency k1
  const float* gwr;   // [rg] W_rg^t
  const float* gwi;
  const float* s2r;   // [32, 7] stage 2's lane twiddles
  const float* s2i;
  const int* k2map;   // [32, 4] k2 of (lane, register)
  const float* twr;   // [n1, 128] TW
  const float* twi;
  int n_pass;
  int rg;
};

// Dynamic shared memory of one CTA: its columns of the block's two planes
// (n1 * 128 / ranks floats each).
__host__ __device__ constexpr size_t smem_bytes(int n1, int ranks) {
  return sizeof(float) * 2 * static_cast<size_t>(n1) * (kN2 / ranks);
}

// This CTA's rank in its block's cluster (0 for one CTA a block).
template <int kRanks>
__device__ __forceinline__ int block_rank() {
  if constexpr (kRanks == 1) {
    return 0;
  } else {
    return static_cast<int>(cg::this_cluster().block_rank());
  }
}

// The block sample t held at word w of a rank's plane: row w / kCols,
// column rank * kCols + w % kCols (t = w for one CTA a block).
template <int kRanks>
__device__ __forceinline__ int block_sample(int w, int rank) {
  constexpr int kCols = kN2 / kRanks;
  return (w / kCols) * kN2 + rank * kCols + w % kCols;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

// a * (wr + i wi)
__device__ __forceinline__ float2 cmul(float2 a, float wr, float wi) {
  return make_float2(fmaf(a.x, wr, -__fmul_rn(a.y, wi)),
                     fmaf(a.x, wi, __fmul_rn(a.y, wr)));
}

// acc += (wr + i wi) * x, four fused multiply-adds in a fixed order
__device__ __forceinline__ void cmac(float2& acc, float wr, float wi,
                                     float2 x) {
  acc.x = fmaf(wr, x.x, acc.x);
  acc.x = fmaf(-wi, x.y, acc.x);
  acc.y = fmaf(wr, x.y, acc.y);
  acc.y = fmaf(wi, x.x, acc.y);
}

// a - i b and a + i b
__device__ __forceinline__ float2 sub_i(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.y), __fsub_rn(a.y, b.x));
}
__device__ __forceinline__ float2 add_i(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.y), __fadd_rn(a.y, b.x));
}

// a + s * b (s real)
__device__ __forceinline__ float2 axpy(float2 a, float s, float2 b) {
  return make_float2(fmaf(s, b.x, a.x), fmaf(s, b.y, a.y));
}

__device__ __forceinline__ float2 scale(float s, float2 b) {
  return make_float2(__fmul_rn(s, b.x), __fmul_rn(s, b.y));
}

__device__ __forceinline__ float to_db(float p) {
  return __fmul_rn(10.f, log10f(fmaxf(p, kEps)));
}

// (p, i) ranks above (bp, bi): larger power, or equal power at a smaller
// flat index (the first maximum)
__device__ __forceinline__ bool better(float p, int i, float bp, int bi) {
  return p > bp || (p == bp && i < bi);
}

// The forward R-point DFT of x, in place (W_R = exp(-2 pi i / R)).
template <int R>
__device__ __forceinline__ void butterfly(float2 (&x)[R]);

template <>
__device__ __forceinline__ void butterfly<2>(float2 (&x)[2]) {
  const float2 a = x[0];
  x[0] = cadd(a, x[1]);
  x[1] = csub(a, x[1]);
}

template <>
__device__ __forceinline__ void butterfly<4>(float2 (&x)[4]) {
  const float2 a = cadd(x[0], x[2]), b = csub(x[0], x[2]);
  const float2 c = cadd(x[1], x[3]), d = csub(x[1], x[3]);
  x[0] = cadd(a, c);
  x[2] = csub(a, c);
  x[1] = sub_i(b, d);
  x[3] = add_i(b, d);
}

template <>
__device__ __forceinline__ void butterfly<3>(float2 (&x)[3]) {
  constexpr float kC = -0.5f;                    // cos(2 pi / 3)
  constexpr float kS = 0.866025403784438647f;    // sin(2 pi / 3)
  const float2 t = cadd(x[1], x[2]);
  const float2 d = scale(kS, csub(x[1], x[2]));
  const float2 m = axpy(x[0], kC, t);
  x[0] = cadd(x[0], t);
  x[1] = sub_i(m, d);
  x[2] = add_i(m, d);
}

template <>
__device__ __forceinline__ void butterfly<5>(float2 (&x)[5]) {
  constexpr float kC1 = 0.309016994374947424f;   // cos(2 pi / 5)
  constexpr float kC2 = -0.809016994374947424f;  // cos(4 pi / 5)
  constexpr float kS1 = 0.951056516295153572f;   // sin(2 pi / 5)
  constexpr float kS2 = 0.587785252292473129f;   // sin(4 pi / 5)
  const float2 a1 = cadd(x[1], x[4]), b1 = csub(x[1], x[4]);
  const float2 a2 = cadd(x[2], x[3]), b2 = csub(x[2], x[3]);
  const float2 m1 = axpy(axpy(x[0], kC1, a1), kC2, a2);
  const float2 m2 = axpy(axpy(x[0], kC2, a1), kC1, a2);
  const float2 n1 = axpy(scale(kS1, b1), kS2, b2);
  const float2 n2 = axpy(scale(kS2, b1), -kS1, b2);
  x[0] = cadd(cadd(x[0], a1), a2);
  x[1] = sub_i(m1, n1);
  x[4] = add_i(m1, n1);
  x[2] = sub_i(m2, n2);
  x[3] = add_i(m2, n2);
}

// One in-place decimation-in-frequency pass of radix R over every column
// of [n1][kCols] planes: butterfly (blk, j) takes rows blk*L + j + m*s
// (m < R), and its output k (times W_L^(j*k)) goes back to row
// blk*L + j + k*s.
template <int R, int kCols>
__device__ __forceinline__ void fft_pass(float* ar, float* ai, int n1,
                                         int len, int s, const float* twr,
                                         const float* twi) {
  constexpr int kPerCol = kThreads / kCols;  // threads per column
  const int c = threadIdx.x % kCols;
  for (int b = threadIdx.x / kCols; b < n1 / R; b += kPerCol) {
    const int blk = b / s;
    const int j = b - blk * s;
    const int at = (blk * len + j) * kCols + c;
    float2 x[R];
#pragma unroll
    for (int m = 0; m < R; ++m)
      x[m] = make_float2(ar[at + m * s * kCols], ai[at + m * s * kCols]);
    butterfly<R>(x);
    if (j != 0) {  // the twiddles of j = 0 are all 1
#pragma unroll
      for (int k = 1; k < R; ++k)
        x[k] = cmul(x[k], __ldg(twr + j * (R - 1) + k - 1),
                    __ldg(twi + j * (R - 1) + k - 1));
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      ar[at + m * s * kCols] = x[m].x;
      ai[at + m * s * kCols] = x[m].y;
    }
  }
}

// Stage 1's in-place passes over [n1][kCols] planes. On entry the CTA is
// synchronised; on exit too.
template <int kCols>
__device__ __forceinline__ void stage1(float* ar, float* ai, int n1,
                                       const Plan& pl) {
  for (int p = 0; p < pl.n_pass; ++p) {
    const int r = __ldg(pl.passes + 4 * p);
    const int len = __ldg(pl.passes + 4 * p + 1);
    const int s = __ldg(pl.passes + 4 * p + 2);
    const int off = __ldg(pl.passes + 4 * p + 3);
    const float* twr = pl.ptwr + off;
    const float* twi = pl.ptwi + off;
    switch (r) {
      case 2: fft_pass<2, kCols>(ar, ai, n1, len, s, twr, twi); break;
      case 3: fft_pass<3, kCols>(ar, ai, n1, len, s, twr, twi); break;
      case 4: fft_pass<4, kCols>(ar, ai, n1, len, s, twr, twi); break;
      case 5: fft_pass<5, kCols>(ar, ai, n1, len, s, twr, twi); break;
      default: break;  // the plan has no other in-place radix
    }
    __syncthreads();
  }
}

// Where stage 2 finds column c = lane + 32*i of storage row p: at
// re[i][p * stride + lane] (im likewise). One CTA: re[i] = its plane +
// 32*i, stride 128. A cluster: re[i] = rank i's plane, read through
// distributed shared memory, stride 32.
struct Rows {
  const float* re[kRegs];
  const float* im[kRegs];
  int stride;
};

// Row k1 of C = B * TW into the lane's registers (c = lane + 32*i): the
// storage row perm[k1], or with a generic radix rg, its direct rg-point
// DFT over the aligned group of rg rows that holds it.
__device__ __forceinline__ void load_row(const Rows& rw, int k1, int lane,
                                         const Plan& pl,
                                         float2 (&x)[kRegs]) {
  const int p = __ldg(pl.perm + k1);
  if (pl.rg == 1) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i)
      x[i] = make_float2(rw.re[i][p * rw.stride + lane],
                         rw.im[i][p * rw.stride + lane]);
  } else {
    const int kg = p % pl.rg;
    const int base = p - kg;
#pragma unroll
    for (int i = 0; i < kRegs; ++i) x[i] = make_float2(0.f, 0.f);
    int t = 0;  // (m * kg) mod rg
    for (int m = 0; m < pl.rg; ++m) {
      const float wr = __ldg(pl.gwr + t), wi = __ldg(pl.gwi + t);
      const int row = (base + m) * rw.stride + lane;
#pragma unroll
      for (int i = 0; i < kRegs; ++i)
        cmac(x[i], wr, wi, make_float2(rw.re[i][row], rw.im[i][row]));
      t += kg;
      if (t >= pl.rg) t -= pl.rg;
    }
  }
#pragma unroll
  for (int i = 0; i < kRegs; ++i)
    x[i] = cmul(x[i], __ldg(pl.twr + k1 * kN2 + lane + 32 * i),
                __ldg(pl.twi + k1 * kN2 + lane + 32 * i));
}

// The whole body. On entry ar/ai hold this CTA's columns of the windowed
// block (word w: block sample block_sample<kRanks>(w, rank)) and the CTA is
// synchronised. Writes wf[g * 128 + k2] for g < n1 / q, *mx and *idx (the
// cluster's rank 0 writes the peak).
template <int kRanks>
__device__ __forceinline__ void spectrum_body(float* ar, float* ai, int n1,
                                              int q, float cf,
                                              const Plan& pl,
                                              float* __restrict__ wf,
                                              float* __restrict__ mx,
                                              int* __restrict__ idx) {
  static_assert(kRanks == 1 || kRanks == kCluster,
                "a block lives in one CTA or in a cluster of kCluster");
  __shared__ float red_p[kWarps];
  __shared__ int red_i[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = block_rank<kRanks>();

  stage1<kN2 / kRanks>(ar, ai, n1, pl);

  Rows rows;
  if constexpr (kRanks == 1) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      rows.re[i] = ar + 32 * i;
      rows.im[i] = ai + 32 * i;
    }
    rows.stride = kN2;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      rows.re[i] = cluster.map_shared_rank(ar, i);
      rows.im[i] = cluster.map_shared_rank(ai, i);
    }
    rows.stride = kN2 / kRanks;
    cluster.sync();  // every rank's stage 1 is done
  }

  // ---- stage 2, power, decimation, peak: a warp per group of q rows
  float2 tw[kS2Tw];
#pragma unroll
  for (int u = 0; u < kS2Tw; ++u)
    tw[u] = make_float2(__ldg(pl.s2r + lane * kS2Tw + u),
                        __ldg(pl.s2i + lane * kS2Tw + u));
  const int k2 = __ldg(pl.k2map + lane * kRegs);  // register u: k2 + u
  float best_p = -1.f;
  int best_i = INT_MAX;
  for (int g = rank * kWarps + warp; g < n1 / q; g += kWarps * kRanks) {
    float gmax[kRegs] = {0.f, 0.f, 0.f, 0.f};  // set at the group's first row
    for (int k1 = g * q; k1 < (g + 1) * q; ++k1) {
      float2 x[kRegs];
      load_row(rows, k1, lane, pl, x);
      butterfly<4>(x);
#pragma unroll
      for (int u = 1; u < kRegs; ++u)
        x[u] = cmul(x[u], tw[u - 1].x, tw[u - 1].y);
#pragma unroll
      for (int st = 0; st < 5; ++st) {
        const int h = 16 >> st;
        const bool upper = (lane & h) != 0;
#pragma unroll
        for (int u = 0; u < kRegs; ++u) {
          const float2 o = make_float2(
              __shfl_xor_sync(0xffffffffu, x[u].x, h),
              __shfl_xor_sync(0xffffffffu, x[u].y, h));
          x[u] = upper ? csub(o, x[u]) : cadd(x[u], o);
          // W_2h^(lane mod h) on the upper lane, 1 on the lower
          if (st < 4) x[u] = cmul(x[u], tw[3 + st].x, tw[3 + st].y);
        }
      }
#pragma unroll
      for (int u = 0; u < kRegs; ++u) {
        const float p = __fmul_rn(
            __fadd_rn(__fmul_rn(x[u].x, x[u].x), __fmul_rn(x[u].y, x[u].y)),
            cf);
        const int flat = k1 * kN2 + k2 + u;
        if (better(p, flat, best_p, best_i)) {
          best_p = p;
          best_i = flat;
        }
        const float db = to_db(p);
        gmax[u] = k1 == g * q ? db : fmaxf(gmax[u], db);
      }
    }
    *reinterpret_cast<float4*>(wf + g * kN2 + k2) =
        make_float4(gmax[0], gmax[1], gmax[2], gmax[3]);
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
    red_p[0] = best_p;
    red_i[0] = best_i;
  }
  if constexpr (kRanks > 1) {
    // ---- then the cluster: rank 0 reads the other ranks' CTA peaks
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA peak is in place; no rank reads planes
    if (rank == 0 && threadIdx.x == 0) {
      for (int r = 1; r < kRanks; ++r) {
        const float p = *cluster.map_shared_rank(&red_p[0], r);
        const int i = *cluster.map_shared_rank(&red_i[0], r);
        if (better(p, i, best_p, best_i)) {
          best_p = p;
          best_i = i;
        }
      }
    }
    cluster.sync();  // keeps every rank's shared memory alive until then
  }
  if (rank == 0 && threadIdx.x == 0) {
    *mx = to_db(best_p);
    *idx = best_i;
  }
}

// Launch a spectrum kernel with one CTA (kRanks = 1) or a cluster of
// kRanks CTAs (grid.x = kRanks * nblk) per (FFT block, stream), with its
// columns' planes as dynamic shared memory; returns the first error.
template <int kRanks, class... Params, class... Args>
cudaError_t launch_blocks(void (*kernel)(Params...), int nblk,
                          int n_streams, int n1, cudaStream_t st,
                          Args... args) {
  const size_t smem = smem_bytes(n1, kRanks);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk * kRanks, n_streams);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = kRanks > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
}  // namespace jsdr_spec

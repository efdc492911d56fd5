// Waterfall spectrum for Hopper (sm_90a): Hamming window + FFT of n =
// n1 * 128 samples + |X|^2 * (2/n)^2 + max over q consecutive k1 + dB, and
// the per-block peak, over contiguous [S, T] stream rows.
//
// Replaces: jsdr_tpu/ops/pallas_kernels.py::_spectrum_wf_kernel (wrappers
// spectrum_fused, q = 1, and spectrum_waterfall, q = wf_group_for(n)).
// Outputs, for FFT block b of stream s (T = nblk * n):
//   wf  [nblk, S, n1/q, 128] dB lines in the permuted layout (element
//       [.., k1/q, k2] covers natural bins n1*k2 + k1),
//   mx  [nblk, S] peak dB, idx [nblk, S] flat permuted argmax k1*128 + k2.
//
// What bounds it on this card: device memory. At 128 x 96000 samples it
// reads 98 MB (8 bytes a sample, once) and writes 7.9 MB of lines, ~0.03
// ms at 3.35 TB/s; a factored FFT's ~0.9 GFLOP there is ~0.014 ms at 67
// TFLOP/s fp32. Within the CTA, the shared-memory passes over the block and
// stage 2's shuffles (spectrum_body.cuh) come on top of the read.
//
// Design: one CTA per (FFT block, stream) for n1 <= 225, and a cluster of
// 4 CTAs per (FFT block, stream) above (to n1 = 512; each rank holds 32
// columns of every row, spectrum_body.cuh). A CTA reads its columns of the
// block once, windowed, into shared memory (76.8 KB at n = 9600, 153.6 KB
// at 19200, 128 KB a rank at 65536), and runs the factored FFT of
// spectrum_body.cuh on it, from the host plan of
// jsdr_tpu_torch/ops/fft_plan.py. The TPU kernel's 8-stream x 4-block
// VMEM tiling, its lcm(8, q)-padded scratch and its dense DFT matrices on
// the MXU (bf16x3 Karatsuba products) are not carried over: everything is
// fp32 FMAs, no tensor cores.
#include <cuda_runtime.h>

#include "spectrum_body.cuh"

namespace {

using jsdr_spec::kThreads;

template <int kRanks>
__global__ void __launch_bounds__(kThreads)
spectrum_wf_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ win, jsdr_spec::Plan pl,
                   float* __restrict__ wf, float* __restrict__ mx,
                   int* __restrict__ idx, int n_streams, int t_len, int n1,
                   int q, float cf) {
  extern __shared__ float4 smem4[];
  float* ar = reinterpret_cast<float*>(smem4);
  const int n = n1 * jsdr_spec::kN2;
  const int words = n / kRanks;  // this CTA's share of the block
  float* ai = ar + words;
  const int rank = jsdr_spec::block_rank<kRanks>();
  const int b = blockIdx.x / kRanks;
  const int s = blockIdx.y;
  const long long at = static_cast<long long>(s) * t_len +
                       static_cast<long long>(b) * n;
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int t = jsdr_spec::block_sample<kRanks>(w, rank);
    const float wv = win[t];
    ar[w] = __fmul_rn(xr[at + t], wv);
    ai[w] = __fmul_rn(xi[at + t], wv);
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
extern "C" int jsdr_spectrum_wf(
    const float* xr, const float* xi, const float* win, const int* passes,
    const float* ptwr, const float* ptwi, const int* perm, const float* gwr,
    const float* gwi, const float* s2r, const float* s2i, const int* k2map,
    const float* twr, const float* twi, float* wf, float* mx, int* idx,
    int n_streams, int t_len, int n1, int q, int n_pass, int rg, float cf,
    int ranks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = t_len / (n1 * jsdr_spec::kN2);
  if (nblk == 0 || n_streams == 0) return 0;
  const jsdr_spec::Plan pl{passes, ptwr, ptwi, perm, gwr, gwi, s2r,
                           s2i,    k2map, twr,  twi,  n_pass, rg};
  cudaError_t e = cudaErrorInvalidValue;
  if (ranks == 1)
    e = jsdr_spec::launch_blocks<1>(spectrum_wf_kernel<1>, nblk, n_streams,
                                    n1, st, xr, xi, win, pl, wf, mx, idx,
                                    n_streams, t_len, n1, q, cf);
  else if (ranks == jsdr_spec::kCluster)
    e = jsdr_spec::launch_blocks<jsdr_spec::kCluster>(
        spectrum_wf_kernel<jsdr_spec::kCluster>, nblk, n_streams, n1, st, xr,
        xi, win, pl, wf, mx, idx, n_streams, t_len, n1, q, cf);
  return static_cast<int>(e);
}

// Bit-timing recovery for Hopper (sm_90a).
//
// Replaces: jsdr_tpu/ops/timing_kernel.py::_timing_kernel (wrapper
// timing_recover_batch), the TPU form of FUNcubeBPSKDemod.java:505-595 as
// reformulated by jsdr_tpu/demod/bpsk.py::_timing_parallel. Per stream,
// the matched-filter stream is cut into bit groups of 8 samples; for each
// group g (state: 8 energy EMAs, peak, new_peak, e_out, last_iq):
//   pk0 = peak, np0 = new_peak, h = (pk0 + 4) % 8
//   slot 0 fires at phase pk0 when pk0 <= h, slot 1 at phase np0 when np0 > h
//   a fired slot v decides differentially against the previous fired slot
//   (last_iq): di = -(l.i*v.i + l.q*v.q), dq = l.i*v.q - l.q*v.i,
//   valid = e2 = |(di, dq)| > gate, bit = di < 0; then last_iq = v and
//   e_out = e_out*(1-s2) + e1(v)*s2
//   every EMA p: ema[p] = ema[p]*(1-s1) + e1[p]*s1; argmax (first maximum)
//   peak = np0, new_peak = argmax
// Output slots (g, 0) and (g, 1) are interleaved in valid/bit [S, 2G].
//
// What bounds it on this card: latency. The recurrence is serial in g
// (the argmax of group g schedules the slots of group g+2), so each
// stream is one thread walking its groups with the whole state in
// registers; the card's parallelism is only the stream count (128 at the
// deployment size: 4 warps on 4 SMs). Memory traffic is small: 64 bytes
// in and 4 bytes out per group per stream, read as 16-byte vectors.
//
// Design: the TPU kernel's phase-planar layout, triangular-matmul EMA and
// log-shift fills exist to feed 128-lane vector units; none of it is
// needed here. Slot reads select among the 8 registers by compare (no
// local-memory indexing). Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, no FMA contraction) in the order the plain
// PyTorch version evaluates it, so the two agree bit for bit; the JAX
// reference composes the EMA in another order and agrees to tolerance.
// Spreading a stream over time (a parallel scan of the EMAs, as the TPU
// kernel does) is left for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kPhases = 8;
constexpr int kThreads = 32;

__device__ __forceinline__ float pick(const float (&v)[kPhases], int p) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < kPhases; ++k) r = (p == k) ? v[k] : r;
  return r;
}

struct Slot {
  unsigned char valid, bit;
};

// decide one slot against (li, lq); on a fired slot update last_iq, e_out
__device__ __forceinline__ Slot emit(bool on, float vi, float vq, float e1,
                                     float& li, float& lq, float& eo,
                                     float s2, float a2, float gate) {
  const float di = -__fadd_rn(__fmul_rn(li, vi), __fmul_rn(lq, vq));
  const float dq = __fsub_rn(__fmul_rn(li, vq), __fmul_rn(lq, vi));
  const float e2 = __fsqrt_rn(__fadd_rn(__fmul_rn(di, di), __fmul_rn(dq, dq)));
  Slot r;
  r.valid = on && (e2 > gate);
  r.bit = di < 0.f;
  if (on) {
    li = vi;
    lq = vq;
    eo = __fadd_rn(__fmul_rn(eo, a2), __fmul_rn(e1, s2));
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
timing_kernel(const float* __restrict__ mf_re, const float* __restrict__ mf_im,
              const float* __restrict__ e_ema, const int* __restrict__ peak_in,
              const int* __restrict__ new_peak_in,
              const float* __restrict__ e_out_in,
              const float* __restrict__ last_iq_in,
              unsigned char* __restrict__ valid, unsigned char* __restrict__ bit,
              float* __restrict__ e_ema_out, int* __restrict__ peak_out,
              int* __restrict__ new_peak_out, float* __restrict__ e_out_out,
              float* __restrict__ last_iq_out, int n_streams, int n_groups,
              float s1, float a1, float s2, float a2, float gate) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  float ema[kPhases];
#pragma unroll
  for (int p = 0; p < kPhases; ++p) ema[p] = e_ema[s * kPhases + p];
  int peak = peak_in[s], new_peak = new_peak_in[s];
  float eo = e_out_in[s];
  float li = last_iq_in[2 * s], lq = last_iq_in[2 * s + 1];

  const long long off = static_cast<long long>(s) * n_groups;
  const float4* pr = reinterpret_cast<const float4*>(mf_re) + 2 * off;
  const float4* pq = reinterpret_cast<const float4*>(mf_im) + 2 * off;
  uchar2* vout = reinterpret_cast<uchar2*>(valid) + off;
  uchar2* bout = reinterpret_cast<uchar2*>(bit) + off;

#pragma unroll 2
  for (int g = 0; g < n_groups; ++g) {
    const float4 r0 = pr[2 * g], r1 = pr[2 * g + 1];
    const float4 q0 = pq[2 * g], q1 = pq[2 * g + 1];
    const float fi[kPhases] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const float fq[kPhases] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    float e1[kPhases];
#pragma unroll
    for (int p = 0; p < kPhases; ++p)
      e1[p] = __fadd_rn(__fmul_rn(fi[p], fi[p]), __fmul_rn(fq[p], fq[p]));

    const int pk0 = peak, np0 = new_peak;
    const int h = (pk0 + 4) & (kPhases - 1);
    const Slot a = emit(pk0 <= h, pick(fi, pk0), pick(fq, pk0), pick(e1, pk0),
                        li, lq, eo, s2, a2, gate);
    const Slot b = emit(np0 > h, pick(fi, np0), pick(fq, np0), pick(e1, np0),
                        li, lq, eo, s2, a2, gate);
    vout[g] = make_uchar2(a.valid, b.valid);
    bout[g] = make_uchar2(a.bit, b.bit);

    int am = 0;
    float mx = 0.f;
#pragma unroll
    for (int p = 0; p < kPhases; ++p) {
      ema[p] = __fadd_rn(__fmul_rn(ema[p], a1), __fmul_rn(e1[p], s1));
      if (p == 0 || ema[p] > mx) {  // first maximum (strict >)
        mx = ema[p];
        am = p;
      }
    }
    peak = np0;
    new_peak = am;
  }

#pragma unroll
  for (int p = 0; p < kPhases; ++p) e_ema_out[s * kPhases + p] = ema[p];
  peak_out[s] = peak;
  new_peak_out[s] = new_peak;
  e_out_out[s] = eo;
  last_iq_out[2 * s] = li;
  last_iq_out[2 * s + 1] = lq;
}

}  // namespace

extern "C" int jsdr_timing_recover(
    const float* mf_re, const float* mf_im, const float* e_ema,
    const int* peak, const int* new_peak, const float* e_out,
    const float* last_iq, unsigned char* valid, unsigned char* bit,
    float* e_ema_out, int* peak_out, int* new_peak_out, float* e_out_out,
    float* last_iq_out, int n_streams, int n_groups, float s1, float a1,
    float s2, float a2, float gate, void* stream) {
  const int blocks = (n_streams + kThreads - 1) / kThreads;
  timing_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mf_re, mf_im, e_ema, peak, new_peak, e_out, last_iq, valid, bit,
      e_ema_out, peak_out, new_peak_out, e_out_out, last_iq_out, n_streams,
      n_groups, s1, a1, s2, a2, gate);
  return static_cast<int>(cudaGetLastError());
}

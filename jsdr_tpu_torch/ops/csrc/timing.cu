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
// What bounds it on this card: latency of the serial chains, not bytes
// (64 bytes in and 4 out per group). Only the 8 per-phase EMA chains are
// serial in g, one dependent multiply and add a group; everything else is
// a function of the EMA trajectory (the argmax, the peak hand-off, which
// slots fire, the decisions) or a chain over the fired slots (e_out).
//
// Design: one CTA per stream, walking it in chunks of C groups (C =
// CHUNK_GROUPS in ops/timing_kernel.py, passed in), with four roles in a
// loop that the whole CTA steps through together (one __syncthreads an
// iteration; in iteration i):
//   loaders (every warp but warp 0) stage chunk i+4 into a ring of six
//     chunk buffers in shared memory with coalesced 16-byte cp.async
//     copies; each copy has three iterations to land before the workers
//     read it (the ring also holds the two chunks the workers read);
//   C worker threads (warps 1..C/32, one a group) compute e1*s1 of chunk
//     i+1 for the chain lanes, then finish chunk i-1: the argmax; pk0/np0
//     from the argmaxes one and two groups back, carried across chunks as
//     (peak, new_peak); the fire flags; each fired slot's rank (an
//     exclusive block scan of the fired counts) places its (vi, vq,
//     e1*s2) in the chunk's list of fired slots, and each slot decides
//     against the entry one rank below its own, or the carried last_iq at
//     rank 0; valid/bit are written as coalesced uchar2 rows; the last
//     entry becomes the carried last_iq. Their steps meet at a named
//     barrier of the workers alone;
//   warp 0, lanes 0-7 (one a phase) run the EMA chains over chunk i, the
//     only serial loop over groups: one multiply and one add a group,
//     reading e1*s1 and writing the trajectory as float4 rows (phase-major,
//     padded so the 8 lanes hit distinct banks), each batch of 8 read
//     before the batch ahead of it is applied;
//   lane 0 of the last warp runs e_out over the list of chunk i-2.
// So the EMA chain of one chunk overlaps the decisions of the one before
// and the e_out chain of the one before that, and the chains set the pace.
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction) in the order the plain PyTorch version evaluates it, so the
// two agree bit for bit on all seven outputs; the JAX reference composes
// the EMA in another order and agrees to tolerance. _timing_chunked_ref in
// ops/timing_kernel.py is this walk in plain PyTorch, tested on the CPU.
#include <cuda_runtime.h>

namespace {

constexpr int kPhases = 8;
constexpr int kMaxChunk = 256;  // its shared memory fits one CTA
constexpr int kMaxThreads = kMaxChunk + 64;
constexpr int kPad = 4;  // row padding of the phase-major arrays (banks)
constexpr int kBatch = 8;  // values a serial lane reads ahead (two float4)
// chunks staged ahead of the one the chain lanes run, and the ring that
// holds them with the two chunks behind (the workers' reads)
constexpr int kAhead = 4;
constexpr int kRing = kAhead + 2;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for all but the newest kAhead - 2 groups of this thread's copies
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 2) : "memory");
}

// barrier 1 over the worker threads only (a multiple of 32)
__device__ __forceinline__ void workers_sync(int n) {
  asm volatile("barrier.sync 1, %0;\n" ::"r"(n) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float energy(float i, float q) {
  return __fadd_rn(__fmul_rn(i, i), __fmul_rn(q, q));
}

// one step of an EMA: x*a + b
__device__ __forceinline__ float ema_step(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// 8 EMA steps over the values (lo, hi), the states after each into (tl, th)
__device__ __forceinline__ void ema8(float& x, float a, float4 lo, float4 hi,
                                     float4& tl, float4& th) {
  tl.x = x = ema_step(x, a, lo.x);
  tl.y = x = ema_step(x, a, lo.y);
  tl.z = x = ema_step(x, a, lo.z);
  tl.w = x = ema_step(x, a, lo.w);
  th.x = x = ema_step(x, a, hi.x);
  th.y = x = ema_step(x, a, hi.y);
  th.z = x = ema_step(x, a, hi.z);
  th.w = x = ema_step(x, a, hi.w);
}

// up to 7 EMA steps (n of them) over (lo, hi), each state at t[k] if t
__device__ __forceinline__ void ema_tail(float& x, float a, float4 lo,
                                         float4 hi, int n, float* t) {
  const float v[kBatch - 1] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z};
#pragma unroll
  for (int k = 0; k < kBatch - 1; ++k) {
    if (k < n) {
      x = ema_step(x, a, v[k]);
      if (t) t[k] = x;
    }
  }
}

// a serial lane: x = x*a + b[g] for g < n, each state into t[g] if
// kStore. Each batch of 8 values is read before the batch ahead of it is
// applied, so no shared-memory latency joins the chain; a batch starts at
// a multiple of 8 below n, and n's buffer holds a multiple of 8, so every
// read stays inside it.
template <bool kStore>
__device__ __forceinline__ void ema_run(const float* b, float* t, int n,
                                        float a, float& x) {
  float4 next_lo = ld4(b), next_hi = ld4(b + 4);
  int g = 0;
  for (; g + kBatch <= n; g += kBatch) {
    const float4 lo = next_lo, hi = next_hi;
    if (g + kBatch < n) {
      next_lo = ld4(b + g + kBatch);
      next_hi = ld4(b + g + kBatch + 4);
    }
    float4 tl, th;
    ema8(x, a, lo, hi, tl, th);
    if (kStore) {
      st4(t + g, tl);
      st4(t + g + 4, th);
    }
  }
  ema_tail(x, a, next_lo, next_hi, n - g, kStore ? t + g : nullptr);
}

// phase p of (lo, hi) by compare and select (no local-memory indexing)
__device__ __forceinline__ float pick(float4 lo, float4 hi, int p) {
  float r = lo.x;
  r = p == 1 ? lo.y : r;
  r = p == 2 ? lo.z : r;
  r = p == 3 ? lo.w : r;
  r = p == 4 ? hi.x : r;
  r = p == 5 ? hi.y : r;
  r = p == 6 ? hi.z : r;
  r = p == 7 ? hi.w : r;
  return r;
}

struct Slot {
  unsigned char valid, bit;
};

// decide slot v against the previous fired slot l
__device__ __forceinline__ Slot decide(bool on, float vi, float vq, float li,
                                       float lq, float gate) {
  const float di = -__fadd_rn(__fmul_rn(li, vi), __fmul_rn(lq, vq));
  const float dq = __fsub_rn(__fmul_rn(li, vq), __fmul_rn(lq, vi));
  const float e2 = __fsqrt_rn(__fadd_rn(__fmul_rn(di, di), __fmul_rn(dq, dq)));
  Slot r;
  r.valid = on && (e2 > gate);
  r.bit = di < 0.f;
  return r;
}

// shared memory, in floats: the chunk ring [kRing][re, im][8C]; e1*s1
// and the EMA trajectory, phase-major [2][8][C + kPad] each; the lists of
// fired slots' vi, vq and e1*s2 [2][2C] each; then ints: argmax [C], warp
// sums [C/32], list lengths [2]
__host__ __device__ constexpr int smem_words(int c) {
  return kRing * 16 * c + 2 * 16 * (c + kPad) + 3 * 4 * c + c + c / 32 + 2;
}

__global__ void __launch_bounds__(kMaxThreads)
timing_kernel(const float* __restrict__ mf_re, const float* __restrict__ mf_im,
              const float* __restrict__ e_ema, const int* __restrict__ peak_in,
              const int* __restrict__ new_peak_in,
              const float* __restrict__ e_out_in,
              const float* __restrict__ last_iq_in,
              unsigned char* __restrict__ valid, unsigned char* __restrict__ bit,
              float* __restrict__ e_ema_out, int* __restrict__ peak_out,
              int* __restrict__ new_peak_out, float* __restrict__ e_out_out,
              float* __restrict__ last_iq_out, int n_groups, int chunk,
              float s1, float a1, float s2, float a2, float gate) {
  extern __shared__ __align__(16) float smem[];
  const int C = chunk, CP = chunk + kPad;
  float* ring = smem;
  float* bbuf = ring + kRing * 16 * C;
  float* traj = bbuf + 16 * CP;
  float* list_i = traj + 16 * CP;
  float* list_q = list_i + 4 * C;
  float* list_c = list_q + 4 * C;
  int* am_s = reinterpret_cast<int*>(list_c + 4 * C);
  int* warp_sum = am_s + C;
  int* n_fired = warp_sum + C / 32;

  const int s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = static_cast<long long>(s) * n_groups * kPhases;
  const int n_chunks = (n_groups + C - 1) / C;
  const bool loader = warp > 0;
  const bool worker = loader && tid < C + 32;
  const bool eo_lane = tid == C + 32;
  const int w = tid - 32;  // a worker's group in its chunk

  auto groups_in = [&](int c) { return min(C, n_groups - c * C); };

  // each loader thread copies its share of chunk c's 16-byte vectors, as
  // one group (empty past the last chunk, so every thread counts alike)
  auto stage = [&](int c) {
    const int cv = c < n_chunks ? groups_in(c) : 0;
    float* dr = ring + (c % kRing) * 16 * C;
    const long long at = row + static_cast<long long>(c) * C * kPhases;
    for (int v = tid - 32; v < 2 * cv; v += C + 32) {
      cp_async16(dr + 4 * v, mf_re + at + 4 * v);
      cp_async16(dr + 8 * C + 4 * v, mf_im + at + 4 * v);
    }
    cp_async_commit();
  };

  // a worker's group of chunk c: re phases 0-3, 4-7, then im
  auto group = [&](int c, float4 (&v)[4]) {
    const float* r = ring + (c % kRing) * 16 * C + 8 * w;
    v[0] = ld4(r);
    v[1] = ld4(r + 4);
    v[2] = ld4(r + 8 * C);
    v[3] = ld4(r + 8 * C + 4);
  };

  // workers: e1*s1 of chunk c, phase-major, for the chain lanes
  auto energies = [&](int c) {
    if (w >= groups_in(c)) return;
    float4 v[4];
    group(c, v);
    float* b = bbuf + (c & 1) * 8 * CP + w;
    b[0 * CP] = __fmul_rn(energy(v[0].x, v[2].x), s1);
    b[1 * CP] = __fmul_rn(energy(v[0].y, v[2].y), s1);
    b[2 * CP] = __fmul_rn(energy(v[0].z, v[2].z), s1);
    b[3 * CP] = __fmul_rn(energy(v[0].w, v[2].w), s1);
    b[4 * CP] = __fmul_rn(energy(v[1].x, v[3].x), s1);
    b[5 * CP] = __fmul_rn(energy(v[1].y, v[3].y), s1);
    b[6 * CP] = __fmul_rn(energy(v[1].z, v[3].z), s1);
    b[7 * CP] = __fmul_rn(energy(v[1].w, v[3].w), s1);
  };

  float ema = 0.f;                                   // chain lanes
  if (warp == 0 && lane < kPhases) ema = e_ema[s * kPhases + lane];
  int pk_c = peak_in[s], np_c = new_peak_in[s];      // workers' carries
  float li_c = last_iq_in[2 * s], lq_c = last_iq_in[2 * s + 1];
  float eo = e_out_in[s];                            // e_out lane
  const long long out_row = static_cast<long long>(s) * n_groups;
  uchar2* vout = reinterpret_cast<uchar2*>(valid) + out_row;
  uchar2* bout = reinterpret_cast<uchar2*>(bit) + out_row;

  if (loader)
    for (int c = 0; c < kAhead; ++c) stage(c);
  cp_async_wait_ahead();  // chunks 0 and 1
  __syncthreads();
  if (worker) energies(0);
  __syncthreads();

  for (int it = 0; it <= n_chunks + 1; ++it) {
    if (loader) stage(it + kAhead);

    if (warp == 0) {
      if (lane < kPhases && it < n_chunks) {
        // the EMA chain of phase `lane` over chunk it
        const int cv = groups_in(it);
        ema_run<true>(bbuf + (it & 1) * 8 * CP + lane * CP,
                      traj + (it & 1) * 8 * CP + lane * CP, cv, a1, ema);
      }
    } else if (worker) {
      if (it + 1 < n_chunks) energies(it + 1);
      if (it >= 1 && it <= n_chunks) {
        // decisions of chunk c, one thread a group
        const int c = it - 1;
        const int cv = groups_in(c);
        const bool live = w < cv;
        int am = 0;
        if (live) {
          const float* tr = traj + (c & 1) * 8 * CP + w;
          float mx = tr[0];
#pragma unroll
          for (int p = 1; p < kPhases; ++p) {
            const float v = tr[p * CP];
            if (v > mx) {  // first maximum (strict >)
              mx = v;
              am = p;
            }
          }
        }
        am_s[w] = am;
        float4 v[4];
        group(c, v);
        workers_sync(C);

        const int np0 = w >= 1 ? am_s[w - 1] : np_c;
        const int pk0 = w >= 2 ? am_s[w - 2] : (w == 1 ? np_c : pk_c);
        const int h = (pk0 + 4) & (kPhases - 1);
        const bool on0 = live && pk0 <= h, on1 = live && np0 > h;
        const float vi0 = pick(v[0], v[1], pk0), vq0 = pick(v[2], v[3], pk0);
        const float vi1 = pick(v[0], v[1], np0), vq1 = pick(v[2], v[3], np0);
        const int cnt = on0 + on1;
        int inc = cnt;  // inclusive scan of the fired counts in the warp
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, inc, d);
          if (lane >= d) inc += y;
        }
        if (lane == 31) warp_sum[warp - 1] = inc;
        workers_sync(C);

        int before = 0, total = 0;
#pragma unroll
        for (int k = 0; k < kMaxChunk / 32; ++k) {
          const int n = k < C / 32 ? warp_sum[k] : 0;
          before += k < warp - 1 ? n : 0;
          total += n;
        }
        const int r0 = before + inc - cnt;  // fired slots before slot 0
        const int r1 = r0 + on0;
        float* li = list_i + (c & 1) * 2 * C;
        float* lq = list_q + (c & 1) * 2 * C;
        float* lc = list_c + (c & 1) * 2 * C;
        if (on0) {
          li[r0] = vi0;
          lq[r0] = vq0;
          lc[r0] = __fmul_rn(energy(vi0, vq0), s2);
        }
        if (on1) {
          li[r1] = vi1;
          lq[r1] = vq1;
          lc[r1] = __fmul_rn(energy(vi1, vq1), s2);
        }
        if (w == 0) n_fired[c & 1] = total;
        workers_sync(C);

        const Slot a = decide(on0, vi0, vq0, r0 > 0 ? li[r0 - 1] : li_c,
                              r0 > 0 ? lq[r0 - 1] : lq_c, gate);
        const Slot b = decide(on1, vi1, vq1, r1 > 0 ? li[r1 - 1] : li_c,
                              r1 > 0 ? lq[r1 - 1] : lq_c, gate);
        if (live) {
          vout[c * C + w] = make_uchar2(a.valid, b.valid);
          bout[c * C + w] = make_uchar2(a.bit, b.bit);
        }
        // the carries into the next chunk (every worker keeps a copy)
        pk_c = cv >= 2 ? am_s[cv - 2] : np_c;
        np_c = am_s[cv - 1];
        if (total > 0) {
          li_c = li[total - 1];
          lq_c = lq[total - 1];
        }
      }
    } else if (eo_lane && it >= 2) {
      // e_out over the fired slots of chunk it-2, in order
      const int c = it - 2;
      ema_run<false>(list_c + (c & 1) * 2 * C, nullptr, n_fired[c & 1], a2,
                     eo);
    }

    cp_async_wait_ahead();  // chunk it+2, for the energies of it+1
    __syncthreads();
  }

  if (warp == 0 && lane < kPhases) e_ema_out[s * kPhases + lane] = ema;
  if (tid == 32) {
    peak_out[s] = pk_c;
    new_peak_out[s] = np_c;
    last_iq_out[2 * s] = li_c;
    last_iq_out[2 * s + 1] = lq_c;
  }
  if (eo_lane) e_out_out[s] = eo;
}

}  // namespace

extern "C" int jsdr_timing_recover(
    const float* mf_re, const float* mf_im, const float* e_ema,
    const int* peak, const int* new_peak, const float* e_out,
    const float* last_iq, unsigned char* valid, unsigned char* bit,
    float* e_ema_out, int* peak_out, int* new_peak_out, float* e_out_out,
    float* last_iq_out, int n_streams, int n_groups, int chunk, float s1,
    float a1, float s2, float a2, float gate, void* stream) {
  if (chunk < 32 || chunk > kMaxChunk || chunk % 32 || n_groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_words(chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        timing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  timing_kernel<<<n_streams, chunk + 64, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      mf_re, mf_im, e_ema, peak, new_peak, e_out, last_iq, valid, bit,
      e_ema_out, peak_out, new_peak_out, e_out_out, last_iq_out, n_groups,
      chunk, s1, a1, s2, a2, gate);
  return static_cast<int>(cudaGetLastError());
}

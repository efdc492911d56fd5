// Reed-Solomon decode of AO-40 frames and the re-encode check for Hopper
// (sm_90a): kernel B of the FEC drain, and the RS decode and the encoder
// alone.
//
// Replaces: jsdr_tpu/fec/rs.py::decode_rs_codeword (syndromes,
// ::_berlekamp_massey as a 32-step fori_loop, ::_chien_forney), the
// descramble + demux of jsdr_tpu/fec/decoder.py::descramble_demux, and the
// re-encode check of decoder.py::_decode_one through
// jsdr_tpu/fec/encode.py::encode_frame_affine, all inside the jitted
// fec_decode; and decode_rs / encode_fec40 on their own. The port's plain
// versions are fec/rs.py::decode_rs_codeword, fec/decoder.py::
// descramble_demux and fec/encode.py::encode_frame; fec/rs.py::
// _decode_rs_lanes and fec/encode.py::_rs_parity_lanes and
// ::_channel_symbols mirror this kernel's walk in plain PyTorch for the CPU
// tests.
//
// Contract (the plain version's control flow): a clean codeword (all 32
// syndromes zero) gives 0 errors and is returned unchanged; else
// Berlekamp-Massey (no erasures), the Chien sweep over all 255 points with
// fail = roots != deg(lambda), the first 32 roots in increasing order into
// fixed slots, Forney's values (num2 with FCR - 1, the derivative over the
// odd lambda coefficients) with den == 0 at a root failing the word; a
// failed codeword gives -1 and the data unchanged. A frame is ok when both
// codewords decode; its payload is the corrected bytes [RSPAD:KK]
// interleaved back (zeros if not ok), and rc is the count of channel
// symbols where the re-encoded payload differs from raw >> 7 (-1 if not
// ok). GF(256) arithmetic is exact, so any order of the XORs gives the
// same bits.
//
// What bounds it on this card: the dependent table lookups of each
// codeword's short chains (32 Berlekamp-Massey steps, a few dozen terms a
// thread elsewhere), not bytes (5,520 in and 269 out a frame) nor
// operations (~0.2 M integer operations a frame). A clean codeword (the
// common case) stops after its syndromes.
//
// Design: 4 warps (128 threads) a codeword, synchronised by a named
// barrier of their own, so that a clean codeword's warps leave while the
// other codeword decodes. The table blob (fec/_device.py::rs_table) is
// copied into shared memory with 16-byte loads; ALPHA_TO is doubled (512
// entries), so alpha^(a + b) is one lookup with no % 255. Syndromes: lane i
// of warp q computes s_i over a quarter of the bytes [first, 255) (first
// = RSPAD for a frame, whose pad is zero), and the quarters are XORed
// through shared memory. Berlekamp-Massey runs in every warp of the
// codeword alike (lane i holds lambda_i and b_i, lambda's coefficient 32
// in every lane; the discrepancy an XOR butterfly, x * b(x) a shuffle up),
// so no warp waits for another. Chien: warp q takes rounds q and q + 4 of
// the 255 points (32 a round); each round's roots are a ballot word in
// shared memory, and a root's slot is its rank over the rounds before it
// and the lanes below it, so the first 32 roots land in increasing order
// as in the plain version. omega (lane i: omega_i) and Forney (lane k:
// slot k) run in warp 0, which corrects the codeword. The frame kernel
// takes one CTA of 256 threads a frame (codeword c on warps 4c ... 4c+3)
// and re-encodes an ok payload: the RS parity is linear over GF(256) in
// the 128 data bytes of a codeword, parity[j] = XOR_k data[k] * R[k][j],
// with R (128 x 32, stored as logs) built on the host from the plain LFSR;
// thread (q, c, j) sums the 32 terms k in quarter q of codeword c's parity
// byte j and the quarters are XORed through shared memory, so no chain is
// left. (The GF(2) form, a 256 x 1,024 bit matrix as in the reference's
// affine re-encode, computes the same bits; the log form keeps the table
// at 4 KB instead of 32 KB in each CTA's shared memory.) The channel
// frame is copied into shared memory by cp.async at the start, in flight
// while the codewords decode. Then each thread takes ~21 channel
// positions against it: the sync column, or the convolutional symbol
// whose state is the 7-bit window of the scrambled bits (no shift
// register), or 0 where nothing is written; the mismatches are summed
// over the CTA.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNN = 255;          // fec/tables.py NN
constexpr int kRoots = 32;        // NROOTS
constexpr int kA0 = 255;          // A0: log of zero
constexpr int kFcr = 112;         // FCR
constexpr int kPrim = 11;         // PRIM
constexpr int kIprim = 116;       // IPRIM
constexpr int kRsPad = 95;        // RSPAD
constexpr int kPayload = 256;     // BLOCKSIZE
constexpr int kData = 128;        // data bytes a codeword
constexpr int kSeq = 320;         // payload + parity bytes
constexpr int kNBits = 2566;      // NBITS
constexpr int kFrame = 5200;      // SYMPBLOCK
constexpr int kRows = 80;         // ROWS
constexpr int kCols = 65;         // COLUMNS
constexpr int kPolyA = 0x4F;      // CPOLYA
constexpr int kPolyB = 0x6D;      // CPOLYB
constexpr unsigned kFull = 0xffffffffu;
// the uint8 table blob (fec/_device.py::rs_table): ALPHA_TO doubled (entry
// i = ALPHA_TO[i % 255]), INDEX_OF, R as logs [128][32], SCRAMBLER[:320],
// SYNC_BITS[65], zero-padded to 16 bytes
constexpr int kTabAlpha = 0;
constexpr int kTabIndex = 512;
constexpr int kTabParity = 768;
constexpr int kTabScr = 4864;
constexpr int kTabSync = 5184;
constexpr int kTabBytes = 5264;
constexpr int kWordWarps = 4;                  // warps a codeword
constexpr int kWordThreads = kWordWarps * 32;
constexpr int kFrameThreads = 2 * kWordThreads;

static_assert(kTabBytes % 16 == 0, "the blob is copied in 16-byte units");
static_assert(kSeq <= 2 * kFrameThreads, "two Viterbi bytes a thread");

#ifdef FEC_PROBE
__device__ long long fec_rs_marks[8];
#define FEC_MARK(k)                                          \
  do {                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0)                 \
      fec_rs_marks[k] = clock64();                           \
  } while (0)
#else
#define FEC_MARK(k) \
  do {              \
  } while (0)
#endif

struct Gf {
  const uint8_t* alpha;   // doubled: alpha[a + b] for logs a, b < 255
  const uint8_t* index;
  __device__ int mul_log(int la, int lb) const {
    const int v = alpha[la + lb];
    return (la == kA0 || lb == kA0) ? 0 : v;
  }
};

// One codeword's scratch, shared by its 4 warps.
struct RsScratch {
  int part[kWordWarps][32];          // syndrome quarters
  int lamlog[kWordWarps][kRoots + 1];  // each warp's copy of lambda (logs)
  unsigned mask[8];                  // Chien: the roots of round q
  int root[kRoots];
  int slog[kRoots];
  int omlog[kRoots];
  int result;
};

__device__ __forceinline__ void word_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kWordThreads) : "memory");
}

// A 16-byte copy from device memory into shared memory that the thread
// does not wait for (cp.async); cp_async_wait waits for all of its own.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copies the table blob into shared memory (all threads of the CTA).
__device__ void load_tables(const uint8_t* tab, uint8_t* tabs) {
  const uint4* s = reinterpret_cast<const uint4*>(tab);
  uint4* d = reinterpret_cast<uint4*>(tabs);
  for (int i = threadIdx.x; i < kTabBytes / 16; i += blockDim.x) d[i] = s[i];
}

// Decodes the codeword cw[0..254] (shared memory) with the 4 warps of
// thread group g (threads 128g ... 128g + 127), whose named barrier is
// 1 + g; the syndromes skip the bytes before ``first``, which must be zero.
// Corrects cw in place and returns the errors corrected, 0 when clean, -1
// when it cannot be corrected (cw unchanged). Every thread of the group
// returns the same value.
__device__ int rs_decode_group(uint8_t* cw, RsScratch& sc, const Gf& g,
                               int first, int bar) {
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x >> 5) & (kWordWarps - 1);
  // ---- syndromes: s_i = XOR_j cw[j] * alpha^(((FCR + i) * PRIM *
  // (254 - j)) % 255), warp q over its quarter of [first, 255)
  const int len = (kNN - first + kWordWarps - 1) / kWordWarps;
  const int lo = first + q * len, hi = min(lo + len, kNN);
  const int c = ((kFcr + lane) * kPrim) % kNN;
  int pw = (c * (kNN - 1 - lo)) % kNN;
  int s = 0;
#pragma unroll 8
  for (int j = lo; j < hi; ++j) {
    const int d = cw[j];
    const int v = g.alpha[g.index[d] + pw];
    s ^= d ? v : 0;
    pw -= c;
    if (pw < 0) pw += kNN;
  }
  sc.part[q][lane] = s;
  word_sync(bar);
  s = sc.part[0][lane] ^ sc.part[1][lane] ^ sc.part[2][lane] ^ sc.part[3][lane];
  FEC_MARK(2);
  if (__ballot_sync(kFull, s != 0) == 0) return 0;
  const int s_log = g.index[s];

  // ---- Berlekamp-Massey, in each warp alike: lane i holds lambda_i
  // (poly) and b_i (log); lambda's coefficient 32 sits in every lane (b's
  // never reaches x * b)
  int lam = lane == 0 ? 1 : 0, lam32 = 0;
  int b = lane == 0 ? 0 : kA0;
  int el = 0;
  for (int r = 1; r <= kRoots; ++r) {
    const int sl = __shfl_sync(kFull, s_log, (r - 1 - lane) & 31);
    int term = lane < r ? g.mul_log(g.index[lam], sl) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) term ^= __shfl_xor_sync(kFull, term, o);
    const int dlog = g.index[term];
    int xb = __shfl_up_sync(kFull, b, 1);
    if (lane == 0) xb = kA0;
    const int xb32 = __shfl_sync(kFull, b, 31);
    const bool no_update = dlog == kA0;
    const bool keep = no_update || 2 * el > r - 1;
    const int bs = lam == 0 ? kA0 : (g.index[lam] - dlog + kNN) % kNN;
    const int t = lam ^ g.mul_log(dlog, xb);
    const int t32 = lam32 ^ g.mul_log(dlog, xb32);
    b = keep ? xb : bs;
    el = keep ? el : r - el;
    if (!no_update) {
      lam = t;
      lam32 = t32;
    }
  }
  const int lam_log = g.index[lam], lam32_log = g.index[lam32];
  int* lamlog = sc.lamlog[q];
  lamlog[lane] = lam_log;
  if (lane == 0) lamlog[kRoots] = lam32_log;
  int deg = static_cast<int>(__reduce_max_sync(
      kFull, lam_log != kA0 ? static_cast<unsigned>(lane) : 0u));
  if (lam32_log != kA0) deg = kRoots;
  __syncwarp();

  // ---- Chien sweep over alpha^i, i = 1..255: warp q takes rounds q and
  // q + 4 of 32 points; a round's roots are a ballot word
  bool is_root[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 32 * (q + 4 * h) + lane + 1;
    int v = 0, p = 0;
#pragma unroll 11
    for (int j = 0; j <= kRoots; ++j) {
      v ^= g.mul_log(lamlog[j], p);
      p += i;
      if (p >= kNN) p -= kNN;
    }
    is_root[h] = i <= kNN && v == 0;
    const unsigned m = __ballot_sync(kFull, is_root[h]);
    if (lane == 0) sc.mask[q + 4 * h] = m;
  }
  word_sync(bar);
  // the first 32 roots into slots in increasing order: rank over the
  // rounds before and the lanes below
  int count = 0, before[2] = {0, 0};
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int n = __popc(sc.mask[rr]);
    if (rr < q) before[0] += n;
    if (rr < q + 4) before[1] += n;
    count += n;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rank = before[h] +
                     __popc(sc.mask[q + 4 * h] & ((1u << lane) - 1u));
    if (is_root[h] && rank < kRoots)
      sc.root[rank] = 32 * (q + 4 * h) + lane + 1;
  }
  if (count != deg) return -1;   // fail: every thread of the group
  word_sync(bar);

  // ---- omega(x) = s(x) * lambda(x) mod x^32 (lane i: omega_i) and
  // Forney (lane k: root slot k), in warp 0
  if (q == 0) {
    sc.slog[lane] = s_log;
    __syncwarp();
    int om = 0;
    for (int j = 0; j <= lane; ++j)
      om ^= g.mul_log(sc.slog[lane - j], lamlog[j]);
    sc.omlog[lane] = g.index[om];
    __syncwarp();
    const bool valid = lane < count;
    int mag = 0, loc = 0;
    bool den_zero = false;
    if (valid) {
      const int rt = sc.root[lane];
      int num1 = 0, den = 0;
      for (int k = 0; k < kRoots; ++k)
        num1 ^= g.mul_log(sc.omlog[k], (k * rt) % kNN);
      const int num2 = g.alpha[(rt * (kFcr - 1) + kNN) % kNN];
      for (int m = 0; m < kRoots / 2; ++m)
        den ^= g.mul_log(lamlog[2 * m + 1], (2 * m * rt) % kNN);
      den_zero = den == 0;
      if (num1 != 0 && den != 0)
        mag = g.alpha[(g.index[num1] + g.index[num2] + kNN - g.index[den]) % kNN];
      loc = (kIprim - 1 + (rt - 1) * kIprim) % kNN;
    }
    const bool bad = __ballot_sync(kFull, den_zero) != 0;
    if (!bad && valid) cw[loc] ^= static_cast<uint8_t>(mag);
    if (lane == 0) sc.result = bad ? -1 : count;
  }
  word_sync(bar);
  return sc.result;
}

// The RS parity of both codewords of the payload (data byte k of codeword
// c is payload[2k + c]) by the CTA's 256 threads as a table product:
// thread (q, c, j) XORs data[k] * R[k][j] over k in [32q, 32q + 32), and
// threads t < 64 XOR the quarters into parity byte j of codeword c,
// written to parity[2j + c]. ``part`` holds 256 ints; the caller syncs
// before (payload ready) and after (parity ready).
__device__ void rs_parity_cta(const uint8_t* payload, const uint8_t* tabs,
                              const Gf& g, uint8_t* parity, int* part) {
  const int t = threadIdx.x;
  const int j = t & 31, c = (t >> 5) & 1, q = t >> 6;
  const uint8_t* rlog = tabs + kTabParity;
  int v = 0;
#pragma unroll 8
  for (int kk = 0; kk < kData / 4; ++kk) {
    const int k = q * (kData / 4) + kk;
    v ^= g.mul_log(g.index[payload[2 * k + c]], rlog[k * kRoots + j]);
  }
  part[t] = v;
  __syncthreads();
  if (t < 2 * kRoots)   // t = 32c + j
    parity[2 * j + c] = static_cast<uint8_t>(part[t] ^ part[t + 64] ^
                                             part[t + 128] ^ part[t + 192]);
}

// The re-encoded channel symbol at frame position p (0/1), from the
// scrambled sequence sb (sb[0] = 0, sb[1 + n] = byte n of the 320, then
// a zero byte for the flush bits): the sync column, the convolutional
// symbol t = row * 65 + col - 65 of the window of bits t/2 - 6 .. t/2, or
// 0 at the three positions nothing is written to.
__device__ __forceinline__ int channel_symbol(int p, const uint8_t* sb,
                                              const uint8_t* sync) {
  const int row = p % kRows, col = p / kRows;
  if (row == 0) return sync[col];
  const int t = row * kCols + col - kCols;
  if (t >= 2 * kNBits) return 0;
  const int i = t >> 1;
  const int l = i >> 3;   // byte of bit i; the window spans bytes l-1, l
  const int state = ((sb[l] << 8 | sb[l + 1]) >> (7 - (i & 7))) & 0x7F;
  return (t & 1) ? 1 - (__popc(state & kPolyB) & 1)
                 : (__popc(state & kPolyA) & 1);
}

// The 322-byte scrambled sequence sb of a payload whose parity sits in
// sb[1 + 256 ...] unscrambled (the caller syncs after).
__device__ void scramble(const uint8_t* payload, uint8_t* sb,
                         const uint8_t* scr) {
  for (int i = threadIdx.x; i < kSeq; i += blockDim.x)
    sb[1 + i] = (i < kPayload ? payload[i] : sb[1 + i]) ^ scr[i];
  if (threadIdx.x == 0) {
    sb[0] = 0;
    sb[1 + kSeq] = 0;
  }
}

__device__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) tot += red[w];
  return tot;
}

// One CTA (8 warps) a frame: descramble + demux the Viterbi bytes, decode
// both codewords, payload / ok / rs_errors, and rc by re-encoding.
__global__ void __launch_bounds__(kFrameThreads)
fec_frame_kernel(const uint8_t* __restrict__ vit,
                 const uint8_t* __restrict__ raw,
                 const uint8_t* __restrict__ tab, uint8_t* __restrict__ payload,
                 bool* __restrict__ ok_out, int* __restrict__ rs_errors,
                 int* __restrict__ rc) {
  __shared__ __align__(16) uint8_t tabs[kTabBytes];
  __shared__ __align__(4) uint8_t cw[2][256];
  __shared__ __align__(4) uint8_t pay[kPayload];
  __shared__ __align__(4) uint8_t sb[kSeq + 4];
  __shared__ __align__(16) uint8_t rawf[kFrame];
  __shared__ RsScratch scratch[2];
  __shared__ int part[kFrameThreads];
  __shared__ int red[kFrameThreads / 32];
  __shared__ int nerr[2];
  const int tid = threadIdx.x, group = tid >> 7;
  const long long f = blockIdx.x;
  FEC_MARK(0);
  // the Viterbi bytes, loaded beside the tables (bytes tid and tid + 256)
  const uint8_t* v = vit + f * kSeq;
  const int v0 = v[tid];
  const int v1 = tid + kFrameThreads < kSeq ? v[tid + kFrameThreads] : 0;
  load_tables(tab, tabs);
  // the channel frame, for the compare: copied while the codewords decode
  const uint8_t* r = raw + f * kFrame;
  if ((reinterpret_cast<uintptr_t>(r) & 15) == 0) {
    for (int i = tid; i < kFrame / 16; i += kFrameThreads)
      cp_async16(rawf + 16 * i, r + 16 * i);
  } else {
    for (int i = tid; i < kFrame; i += kFrameThreads) rawf[i] = r[i];
  }
  const uint8_t* scr = tabs + kTabScr;
  __syncthreads();
  cw[tid & 1][kRsPad + (tid >> 1)] = v0 ^ scr[tid];
  if (tid + kFrameThreads < kSeq) {
    const int i = tid + kFrameThreads;
    cw[i & 1][kRsPad + (i >> 1)] = v1 ^ scr[i];
  }
  for (int i = tid; i < 2 * kRsPad; i += kFrameThreads) cw[i & 1][i >> 1] = 0;
  __syncthreads();
  FEC_MARK(1);
  const Gf g{tabs + kTabAlpha, tabs + kTabIndex};
  const int n = rs_decode_group(cw[group], scratch[group], g, kRsPad,
                                1 + group);
  if ((tid & (kWordThreads - 1)) == 0) nerr[group] = n;
  __syncthreads();
  FEC_MARK(3);
  const bool ok = nerr[0] >= 0 && nerr[1] >= 0;
  for (int i = tid; i < kPayload; i += kFrameThreads) {
    const uint8_t p = ok ? cw[i & 1][kRsPad + (i >> 1)] : 0;
    pay[i] = p;
    payload[f * kPayload + i] = p;
  }
  if (tid < 2) rs_errors[2 * f + tid] = nerr[tid];
  if (tid == 0) ok_out[f] = ok;
  cp_async_wait();
  if (!ok) {
    if (tid == 0) rc[f] = -1;
    return;
  }
  __syncthreads();
  rs_parity_cta(pay, tabs, g, sb + 1 + kPayload, part);
  __syncthreads();
  FEC_MARK(4);
  scramble(pay, sb, scr);
  __syncthreads();
  const uint8_t* sync = tabs + kTabSync;
  int errs = 0;
  for (int p = tid; p < kFrame; p += kFrameThreads)
    errs += channel_symbol(p, sb, sync) != (rawf[p] >> 7);
  FEC_MARK(5);
  const int tot = block_sum(errs, red);
  if (tid == 0) rc[f] = tot;
  FEC_MARK(6);
}

// Two codewords a CTA (4 warps each): [n, 255] -> corrected [n, 255],
// n_errors [n].
__global__ void __launch_bounds__(kFrameThreads)
rs_decode_kernel(const uint8_t* __restrict__ data,
                 const uint8_t* __restrict__ tab,
                 uint8_t* __restrict__ corrected, int* __restrict__ n_err,
                 int n_words) {
  __shared__ __align__(16) uint8_t tabs[kTabBytes];
  __shared__ __align__(4) uint8_t cw[2][256];
  __shared__ RsScratch scratch[2];
  const int group = threadIdx.x >> 7, t = threadIdx.x & (kWordThreads - 1);
  const long long w = static_cast<long long>(blockIdx.x) * 2 + group;
  load_tables(tab, tabs);
  const bool live = w < n_words;
  if (live)
    for (int i = t; i < kNN; i += kWordThreads)
      cw[group][i] = data[w * kNN + i];
  __syncthreads();
  if (!live) return;
  const Gf g{tabs + kTabAlpha, tabs + kTabIndex};
  const int n = rs_decode_group(cw[group], scratch[group], g, 0, 1 + group);
  for (int i = t; i < kNN; i += kWordThreads)
    corrected[w * kNN + i] = cw[group][i];
  if (t == 0) n_err[w] = n;
}

// One CTA (8 warps) a frame: payload [n, 256] -> channel symbols [n, 5200].
__global__ void __launch_bounds__(kFrameThreads)
encode_kernel(const uint8_t* __restrict__ payload,
              const uint8_t* __restrict__ tab, uint8_t* __restrict__ frame) {
  __shared__ __align__(16) uint8_t tabs[kTabBytes];
  __shared__ __align__(4) uint8_t pay[kPayload];
  __shared__ __align__(4) uint8_t sb[kSeq + 4];
  __shared__ int part[kFrameThreads];
  const long long f = blockIdx.x;
  load_tables(tab, tabs);
  for (int i = threadIdx.x; i < kPayload; i += kFrameThreads)
    pay[i] = payload[f * kPayload + i];
  __syncthreads();
  const Gf g{tabs + kTabAlpha, tabs + kTabIndex};
  rs_parity_cta(pay, tabs, g, sb + 1 + kPayload, part);
  __syncthreads();
  scramble(pay, sb, tabs + kTabScr);
  __syncthreads();
  uint8_t* o = frame + f * kFrame;
  for (int p = threadIdx.x; p < kFrame; p += kFrameThreads)
    o[p] = static_cast<uint8_t>(channel_symbol(p, sb, tabs + kTabSync));
}

}  // namespace

// vit: [n, 320] Viterbi bytes; raw: [n, 5200] channel frames; tab: the
// uint8 table blob (16-byte aligned); outputs payload [n, 256] u8, ok [n]
// bool, rs_errors [n, 2] i32, rc [n] i32.
extern "C" int jsdr_fec_frame(const uint8_t* vit, const uint8_t* raw,
                              const uint8_t* tab, uint8_t* payload, bool* ok,
                              int* rs_errors, int* rc, int n_frames,
                              void* stream) {
  if (n_frames < 1 || (reinterpret_cast<uintptr_t>(tab) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fec_frame_kernel<<<n_frames, kFrameThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      vit, raw, tab, payload, ok, rs_errors, rc);
  return static_cast<int>(cudaGetLastError());
}

// data: [n, 255] codewords -> corrected [n, 255] u8, n_err [n] i32.
extern "C" int jsdr_rs_decode(const uint8_t* data, const uint8_t* tab,
                              uint8_t* corrected, int* n_err, int n_words,
                              void* stream) {
  if (n_words < 1 || (reinterpret_cast<uintptr_t>(tab) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((n_words + 1) / 2);
  rs_decode_kernel<<<grid, kFrameThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(data, tab, corrected,
                                                          n_err, n_words);
  return static_cast<int>(cudaGetLastError());
}

// payload: [n, 256] -> frame [n, 5200] hard channel symbols (0/1 u8).
extern "C" int jsdr_fec_encode(const uint8_t* payload, const uint8_t* tab,
                               uint8_t* frame, int n_frames, void* stream) {
  if (n_frames < 1 || (reinterpret_cast<uintptr_t>(tab) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  encode_kernel<<<n_frames, kFrameThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(payload, tab, frame);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FEC_PROBE
extern "C" int jsdr_fec_rs_marks(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, fec_rs_marks, sizeof(fec_rs_marks)));
}
#endif

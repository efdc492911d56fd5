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
// What bounds it on this card: the serial chains of each codeword (255
// syndrome terms a lane, 32 Berlekamp-Massey steps, 128 LFSR steps) and
// table lookups, not bytes (5,520 in and 269 out a frame) nor operations
// (~0.2 M integer operations a frame). A clean codeword (the common case)
// stops after its syndromes.
//
// Design: one warp a codeword. Syndromes: lane i computes s_i over the 255
// bytes, its power stepping down by (FCR + i) * PRIM. Berlekamp-Massey:
// lane i holds lambda_i and b_i, lambda's coefficient 32 every lane;
// the discrepancy is an XOR butterfly of shuffles, x * b(x) a shuffle up.
// Chien: the 255 points in 8 rounds of 32 lanes; roots are counted by
// ballot + popc and ranked in increasing order into 32 slots. omega: lane i
// computes omega_i; Forney: lane k takes root slot k. The frame kernel takes
// one CTA of two warps a frame (codeword c on warp c), then re-encodes: the
// RS parity as a 128-step LFSR a warp (lane k holds reg[k], the feedback by
// shuffle from lane 0, the shift a shuffle down), scrambles, and each
// thread takes channel positions: the sync column, or the convolutional
// symbol whose state is the 7-bit window of the scrambled bits (no shift
// register), or 0 where nothing is written; the mismatches are summed over
// the CTA. The GF(256) tables sit in shared memory as int.
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
constexpr int kSeq = 320;         // payload + parity bytes
constexpr int kNBits = 2566;      // NBITS
constexpr int kFrame = 5200;      // SYMPBLOCK
constexpr int kRows = 80;         // ROWS
constexpr int kCols = 65;         // COLUMNS
constexpr int kPolyA = 0x4F;      // CPOLYA
constexpr int kPolyB = 0x6D;      // CPOLYB
constexpr unsigned kFull = 0xffffffffu;
// the uint8 table blob (fec/_device.py::rs_tables): ALPHA_TO, INDEX_OF,
// the generator's logs g[0..31], SCRAMBLER[:320], SYNC_BITS[65]
constexpr int kTabAlpha = 0;
constexpr int kTabIndex = 256;
constexpr int kTabGen = 512;
constexpr int kTabScr = 544;
constexpr int kTabSync = 864;
constexpr int kRsWarps = 4;       // codewords a CTA of the RS-only kernel
constexpr int kFrameThreads = 64;

struct Gf {
  const int* alpha;
  const int* index;
  __device__ int mul_log(int la, int lb) const {
    return (la == kA0 || lb == kA0) ? 0 : alpha[(la + lb) % kNN];
  }
};

// A warp's scratch for one codeword.
struct RsScratch {
  int slog[kRoots];
  int lamlog[kRoots + 1];
  int omlog[kRoots];
  int root[kRoots];
};

__device__ void load_gf(const uint8_t* tab, int* alpha, int* index) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    alpha[i] = tab[kTabAlpha + i];
    index[i] = tab[kTabIndex + i];
  }
}

// Decodes the codeword cw[0..254] (shared memory) with one warp; corrects
// it in place and returns the errors corrected, 0 when clean, -1 when it
// cannot be corrected (cw unchanged). Every lane returns the same value.
__device__ int rs_decode_warp(uint8_t* cw, RsScratch& sc, const Gf& g) {
  const int lane = threadIdx.x & 31;
  // ---- syndromes: s_i = XOR_j cw[j] * alpha^(((FCR + i) * PRIM * (254 - j)) % 255)
  const int c = ((kFcr + lane) * kPrim) % kNN;
  int pw = (c * (kNN - 1)) % kNN;
  int s = 0;
  for (int j = 0; j < kNN; ++j) {
    const int d = cw[j];
    if (d) s ^= g.alpha[(g.index[d] + pw) % kNN];
    pw -= c;
    if (pw < 0) pw += kNN;
  }
  if (__ballot_sync(kFull, s != 0) == 0) return 0;
  const int s_log = g.index[s];

  // ---- Berlekamp-Massey: lane i holds lambda_i (poly) and b_i (log);
  // lambda's coefficient 32 sits in every lane (b's never reaches x * b)
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
  sc.slog[lane] = s_log;
  sc.lamlog[lane] = lam_log;
  if (lane == 0) sc.lamlog[kRoots] = lam32_log;
  int deg = static_cast<int>(__reduce_max_sync(
      kFull, lam_log != kA0 ? static_cast<unsigned>(lane) : 0u));
  if (lam32_log != kA0) deg = kRoots;
  __syncwarp();

  // ---- Chien sweep over alpha^i, i = 1..255: 8 rounds of 32 lanes; the
  // first 32 roots, ranked by ballot, into slots in increasing order
  int count = 0;
  for (int q = 0; q < 8; ++q) {
    const int i = 32 * q + lane + 1;
    bool is_root = false;
    if (i <= kNN) {
      int v = 0, p = 0;
      for (int j = 0; j <= kRoots; ++j) {
        v ^= g.mul_log(sc.lamlog[j], p);
        p += i;
        if (p >= kNN) p -= kNN;
      }
      is_root = v == 0;
    }
    const unsigned mask = __ballot_sync(kFull, is_root);
    const int rank = count + __popc(mask & ((1u << lane) - 1u));
    if (is_root && rank < kRoots) sc.root[rank] = i;
    count += __popc(mask);
  }
  const bool fail = count != deg;

  // ---- omega(x) = s(x) * lambda(x) mod x^32: lane i computes omega_i
  int om = 0;
  for (int j = 0; j <= lane; ++j)
    om ^= g.mul_log(sc.slog[lane - j], sc.lamlog[j]);
  sc.omlog[lane] = g.index[om];
  __syncwarp();

  // ---- Forney: lane k takes root slot k
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
      den ^= g.mul_log(sc.lamlog[2 * m + 1], (2 * m * rt) % kNN);
    den_zero = den == 0;
    if (num1 != 0 && den != 0)
      mag = g.alpha[(g.index[num1] + g.index[num2] + kNN - g.index[den]) % kNN];
    loc = (kIprim - 1 + (rt - 1) * kIprim) % kNN;
  }
  if (fail || __ballot_sync(kFull, den_zero) != 0) return -1;
  if (valid) cw[loc] ^= static_cast<uint8_t>(mag);
  __syncwarp();
  return count;
}

// RS parity of one codeword of the payload (bytes payload[2k + c], k < 128)
// by one warp: the 128-step LFSR, lane k holding reg[k]. Writes the 32
// parity bytes to parity[2k + c] (k = lane).
__device__ void rs_parity_warp(const uint8_t* payload, int c,
                               const uint8_t* gen, uint8_t* parity,
                               const Gf& g) {
  const int lane = threadIdx.x & 31;
  const int glog = gen[lane];
  int reg = 0;
  for (int k = 0; k < kPayload / 2; ++k) {
    const int fb = g.index[payload[2 * k + c] ^ __shfl_sync(kFull, reg, 0)];
    const int t = fb == kA0 ? 0 : g.alpha[(fb + glog) % kNN];
    const int t0 = fb == kA0 ? 0 : g.alpha[fb];
    const int nx = __shfl_down_sync(kFull, reg ^ t, 1);
    reg = lane == 31 ? t0 : nx;
  }
  parity[2 * lane + c] = static_cast<uint8_t>(reg);
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

// The 322-byte scrambled sequence of a payload whose parity the CTA's two
// warps write into seq[256..319] (the caller syncs between the steps).
__device__ void encode_prep(const uint8_t* payload, uint8_t* sb,
                            const uint8_t* gen, const Gf& g) {
  const int warp = threadIdx.x >> 5;
  rs_parity_warp(payload, warp, gen, sb + 1 + kPayload, g);
}

__device__ void encode_finish(const uint8_t* payload, uint8_t* sb,
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

// One CTA (2 warps) a frame: descramble + demux the Viterbi bytes, decode
// both codewords, payload / ok / rs_errors, and rc by re-encoding.
__global__ void __launch_bounds__(kFrameThreads)
fec_frame_kernel(const uint8_t* __restrict__ vit,
                 const uint8_t* __restrict__ raw,
                 const uint8_t* __restrict__ tab, uint8_t* __restrict__ payload,
                 bool* __restrict__ ok_out, int* __restrict__ rs_errors,
                 int* __restrict__ rc) {
  __shared__ int alpha[256], index[256];
  __shared__ __align__(4) uint8_t cw[2][256];
  __shared__ __align__(4) uint8_t pay[kPayload];
  __shared__ __align__(4) uint8_t sb[kSeq + 4];
  __shared__ RsScratch scratch[2];
  __shared__ int nerr[2];
  __shared__ int red[kFrameThreads / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long f = blockIdx.x;
  load_gf(tab, alpha, index);
  const uint8_t* scr = tab + kTabScr;
  const uint8_t* v = vit + f * kSeq;
  for (int i = tid; i < kSeq; i += kFrameThreads)
    cw[i & 1][kRsPad + (i >> 1)] = v[i] ^ scr[i];
  for (int i = tid; i < 2 * kRsPad; i += kFrameThreads) cw[i & 1][i >> 1] = 0;
  __syncthreads();
  const Gf g{alpha, index};
  const int n = rs_decode_warp(cw[warp], scratch[warp], g);
  if (lane == 0) nerr[warp] = n;
  __syncthreads();
  const bool ok = nerr[0] >= 0 && nerr[1] >= 0;
  for (int i = tid; i < kPayload; i += kFrameThreads) {
    const uint8_t p = ok ? cw[i & 1][kRsPad + (i >> 1)] : 0;
    pay[i] = p;
    payload[f * kPayload + i] = p;
  }
  if (tid < 2) rs_errors[2 * f + tid] = nerr[tid];
  if (tid == 0) ok_out[f] = ok;
  if (!ok) {
    if (tid == 0) rc[f] = -1;
    return;
  }
  __syncthreads();
  encode_prep(pay, sb, tab + kTabGen, g);
  __syncthreads();
  encode_finish(pay, sb, scr);
  __syncthreads();
  const uint8_t* r = raw + f * kFrame;
  const uint8_t* sync = tab + kTabSync;
  int errs = 0;
  for (int p = tid; p < kFrame; p += kFrameThreads)
    errs += channel_symbol(p, sb, sync) != (r[p] >> 7);
  const int tot = block_sum(errs, red);
  if (tid == 0) rc[f] = tot;
}

// One warp a codeword: [n, 255] -> corrected [n, 255], n_errors [n].
__global__ void __launch_bounds__(kRsWarps * 32)
rs_decode_kernel(const uint8_t* __restrict__ data, const uint8_t* __restrict__ tab,
                 uint8_t* __restrict__ corrected, int* __restrict__ n_err,
                 int n_words) {
  __shared__ int alpha[256], index[256];
  __shared__ __align__(4) uint8_t cw[kRsWarps][256];
  __shared__ RsScratch scratch[kRsWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kRsWarps + warp;
  load_gf(tab, alpha, index);
  const bool live = w < n_words;
  if (live)
    for (int i = lane; i < kNN; i += 32) cw[warp][i] = data[w * kNN + i];
  __syncthreads();
  if (!live) return;
  const Gf g{alpha, index};
  const int n = rs_decode_warp(cw[warp], scratch[warp], g);
  for (int i = lane; i < kNN; i += 32) corrected[w * kNN + i] = cw[warp][i];
  if (lane == 0) n_err[w] = n;
}

// One CTA (2 warps) a frame: payload [n, 256] -> channel symbols [n, 5200].
__global__ void __launch_bounds__(kFrameThreads)
encode_kernel(const uint8_t* __restrict__ payload,
              const uint8_t* __restrict__ tab, uint8_t* __restrict__ frame) {
  __shared__ int alpha[256], index[256];
  __shared__ __align__(4) uint8_t pay[kPayload];
  __shared__ __align__(4) uint8_t sb[kSeq + 4];
  const long long f = blockIdx.x;
  load_gf(tab, alpha, index);
  for (int i = threadIdx.x; i < kPayload; i += kFrameThreads)
    pay[i] = payload[f * kPayload + i];
  __syncthreads();
  const Gf g{alpha, index};
  encode_prep(pay, sb, tab + kTabGen, g);
  __syncthreads();
  encode_finish(pay, sb, tab + kTabScr);
  __syncthreads();
  uint8_t* o = frame + f * kFrame;
  for (int p = threadIdx.x; p < kFrame; p += kFrameThreads)
    o[p] = static_cast<uint8_t>(channel_symbol(p, sb, tab + kTabSync));
}

}  // namespace

// vit: [n, 320] Viterbi bytes; raw: [n, 5200] channel frames; tab: the
// uint8 table blob; outputs payload [n, 256] u8, ok [n] bool, rs_errors
// [n, 2] i32, rc [n] i32.
extern "C" int jsdr_fec_frame(const uint8_t* vit, const uint8_t* raw,
                              const uint8_t* tab, uint8_t* payload, bool* ok,
                              int* rs_errors, int* rc, int n_frames,
                              void* stream) {
  if (n_frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  fec_frame_kernel<<<n_frames, kFrameThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      vit, raw, tab, payload, ok, rs_errors, rc);
  return static_cast<int>(cudaGetLastError());
}

// data: [n, 255] codewords -> corrected [n, 255] u8, n_err [n] i32.
extern "C" int jsdr_rs_decode(const uint8_t* data, const uint8_t* tab,
                              uint8_t* corrected, int* n_err, int n_words,
                              void* stream) {
  if (n_words < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((n_words + kRsWarps - 1) / kRsWarps);
  rs_decode_kernel<<<grid, kRsWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(data, tab, corrected,
                                                          n_err, n_words);
  return static_cast<int>(cudaGetLastError());
}

// payload: [n, 256] -> frame [n, 5200] hard channel symbols (0/1 u8).
extern "C" int jsdr_fec_encode(const uint8_t* payload, const uint8_t* tab,
                               uint8_t* frame, int n_frames, void* stream) {
  if (n_frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  encode_kernel<<<n_frames, kFrameThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(payload, tab, frame);
  return static_cast<int>(cudaGetLastError());
}

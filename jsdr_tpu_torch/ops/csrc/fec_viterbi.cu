// Soft-decision Viterbi decoder (k=7, r=1/2) of AO-40 frames for Hopper
// (sm_90a): kernel A of the FEC drain.
//
// Replaces: jsdr_tpu/fec/viterbi.py::_acs_scan (the forward lax.scan),
// ::_traceback (the reverse scan) and ::bits_to_bytes, reached from the
// jitted fec_decode (jsdr_tpu/fec/decoder.py) and viterbi27. The port's
// plain versions are fec/viterbi.py::_acs, ::_traceback and
// ::bits_to_bytes; fec/viterbi.py::_viterbi_lanes mirrors this kernel's
// lanes, window stores and chain-back in plain PyTorch for the CPU tests.
//
// Contract, per frame: the 5132 soft symbols (read through the
// deinterleave of fec/viterbi.py::_DEINT_IDX when the input is a 5200-byte
// channel frame), branch metrics from METTAB, 2566 ACS steps over 64
// states with int32 metrics (initial -999999 except state 0, no
// renormalisation) and the tie rule dec = b > a; new state n (j = n >> 1)
// takes a = m[j] + bm[pa] and b = m[j + 32] + bm[pb], with (pa, pb) =
// (SYM_A[j], SYM_B[j]) for even n and swapped for odd n. The chain-back
// starts at state 0 after step 2565 and emits bit t - 6 = dec[t][s] for
// t = 2565 ... 6, with s = (s >> 1) | (dec[t][s] << 5); the 2560 bits are
// packed MSB-first into 320 bytes.
//
// What bounds it on this card: neither bytes nor operations but the serial
// chain of each frame: 2566 dependent ACS steps. The bytes are 5200 in and
// 320 out a frame (about 1 us for 512 frames at 3.35 TB/s). Frames are
// independent, so any batch up to a few thousand frames runs in about the
// time of one.
//
// Design: one frame a CTA (so up to 132 frames have an SM each). Its 4
// warps stage the frame into shared memory with 16-byte loads and write
// the four pair metrics of every step as int16 (METTAB[a][s0] +
// METTAB[b][s1] for pair (a << 1) | b lies in [-744, 40]); then warp 0
// alone runs the ACS, so that a step reads its lane's metrics with loads
// that do not depend on the chain. Lane l holds states l and l + 32. A
// step pulls the four predecessors of its new states l and l + 32, old
// states l/2, l/2 + 32 and l/2 + 16, l/2 + 48 (registers lo and hi of
// lanes l/2 and l/2 + 16: four shuffles of fixed registers, no select
// after them), and forms both new states in place. A radix-4 ACS (one
// exchange a double step: 8 states pulled, 4 intermediate and 2 new
// states formed) was built and measured slower on this card, 64.3 cycles
// a step against 56.2 (tools/fec_probe.py, NVIDIA H100 80GB HBM3, 700 W):
// both issue 8 shuffles a step, and the radix-4 loop holds a third more
// instructions (1,208 against 906 a window); see PERF.md.
//
// The chain-back leaves the chain by a windowed register exchange. Each
// state carries a 32-bit survivor word beside its metric: at every step a
// state takes the word of the predecessor its decision chose, shifted
// left, with the decision in bit 0 (word = (word_pred << 1) | dec); the
// words go through four shuffles of their own, issued beside the
// metrics'. After 32 steps a word holds exactly the last 32 decisions on
// the survivor path of its state, the earliest in bit 31. Window w covers
// steps 6 + 32w ... 37 + 32w (w = 0 ... 79, 2560 = 80 x 32); at its last
// step every lane stores its two words, W[w][s] (80 x 64 words, 20,480 B
// a frame). The chain-back then takes one dependent step a window:
//   s = 0; for w = 79 ... 0: word = W[w][s]; bits 32w ... 32w + 31 are
//   word's bits 31 ... 0 (its bytes big-endian); s = word >> 26.
// Why s = word >> 26: the state before the window follows from the state
// after it by s_{t-1} = (s_t >> 1) | (d_t << 5) applied 32 times, which
// leaves only the window's six earliest decisions, d_{6+32w} in bit 5 ...
// d_{11+32w} in bit 0: word bits 31 ... 26. Why it is exact: W[w][s] is
// the decisions along s's survivor path, the same path the step-by-step
// chain-back walks from s (each bit is dec[t][s_t] with the same tie
// rule), so the 80 jumps visit the states the 2560 steps visit at the
// window edges and emit the same bits. Decisions of steps 0 ... 5 are
// shifted out of every word by step 37.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNBits = 2566;             // ACS steps (fec/tables.py NBITS)
constexpr int kFlush = 6;                // K_FLUSH: steps that emit nothing
constexpr int kOutBits = kNBits - kFlush;
constexpr int kSyms = 2 * kNBits;        // 5132 symbols a frame
constexpr int kFrame = 5200;             // SYMPBLOCK channel symbols
constexpr int kRows = 80;                // ROWS (symbols per frame row)
constexpr int kCols = 65;                // COLUMNS (frame rows)
constexpr int kInit = -999999;           // initial metric but state 0's
constexpr int kWindow = 32;              // steps a survivor word holds
constexpr int kWindows = kOutBits / kWindow;
constexpr int kTabWords = 576;   // METTAB rows (2 x 256), SYM_A, SYM_B
constexpr int kPairBytes = kNBits * 8;             // int16 [kNBits][4]
constexpr int kWordBytes = kWindows * 64 * 4;      // the window words
constexpr int kSmem = 2048 + kPairBytes + kWordBytes + kWindows * 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;            // 4 warps stage; warp 0 decodes

static_assert(kWindows * kWindow == kOutBits, "windows tile the output");
static_assert(kWordBytes >= kFrame, "the frame is staged in the words");
// up to 48 KB of dynamic shared memory needs no opt-in attribute
static_assert(kSmem <= 48 * 1024, "kSmem above the default limit");

#ifdef FEC_PROBE
__device__ long long fec_viterbi_marks[8];
#define FEC_MARK(k)                                          \
  do {                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0)                 \
      fec_viterbi_marks[k] = clock64();                      \
  } while (0)
#else
#define FEC_MARK(k) \
  do {              \
  } while (0)
#endif

// Registers of one lane: its two states' metrics and survivor words, and
// where its four predecessors' branch metrics sit in a step's 4 pairs.
struct Lane {
  int lo, hi;
  unsigned wlo, whi;
  int pa, pb, pc, pd;
};

// One ACS step t (pair metrics at pm + 4t): new state l from old states
// j = l >> 1 (path a) and j + 32 (path b), new state l + 32 from j + 16
// and j + 48, each with the tie rule dec = b > a; a new state's word is
// the kept path's word shifted, with the decision in bit 0.
__device__ __forceinline__ void acs_step(Lane& r, const short* pm, int j) {
  const int ba = pm[r.pa], bb = pm[r.pb], bc = pm[r.pc], bd = pm[r.pd];
  const int m0 = __shfl_sync(kFull, r.lo, j);
  const int m1 = __shfl_sync(kFull, r.hi, j);
  const int m2 = __shfl_sync(kFull, r.lo, j + 16);
  const int m3 = __shfl_sync(kFull, r.hi, j + 16);
  const unsigned w0 = __shfl_sync(kFull, r.wlo, j);
  const unsigned w1 = __shfl_sync(kFull, r.whi, j);
  const unsigned w2 = __shfl_sync(kFull, r.wlo, j + 16);
  const unsigned w3 = __shfl_sync(kFull, r.whi, j + 16);
  const int a = m0 + ba, b = m1 + bb, c = m2 + bc, d = m3 + bd;
  const bool d1 = b > a, d2 = d > c;
  r.lo = max(a, b);
  r.hi = max(c, d);
  r.wlo = ((d1 ? w1 : w0) << 1) | static_cast<unsigned>(d1);
  r.whi = ((d2 ? w3 : w2) << 1) | static_cast<unsigned>(d2);
}

__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const uint8_t* __restrict__ in, const int* __restrict__ tab,
               uint8_t* __restrict__ out, int deint) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* met = reinterpret_cast<int*>(smem);
  short* pm = reinterpret_cast<short*>(smem + 2048);
  unsigned* words = reinterpret_cast<unsigned*>(smem + 2048 + kPairBytes);
  unsigned* chosen = words + kWindows * 64;
  uint8_t* raw = reinterpret_cast<uint8_t*>(words);  // staged frame
  const int tid = threadIdx.x, lane = tid & 31;
  const long long frame = blockIdx.x;
  FEC_MARK(0);
  for (int i = tid; i < 512; i += kThreads) met[i] = tab[i];

  // ---- stage the frame: 16-byte loads where the row is aligned
  const int n_in = deint ? kFrame : kSyms;
  const uint8_t* src = in + frame * n_in;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n_in % 16 == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(raw);
    for (int i = tid; i < n_in / 16; i += kThreads) d4[i] = s4[i];
  } else if ((reinterpret_cast<uintptr_t>(src) & 3) == 0 && n_in % 4 == 0) {
    const unsigned* s4 = reinterpret_cast<const unsigned*>(src);
    unsigned* d4 = reinterpret_cast<unsigned*>(raw);
    for (int i = tid; i < n_in / 4; i += kThreads) d4[i] = s4[i];
  } else {
    for (int i = tid; i < n_in; i += kThreads) raw[i] = src[i];
  }
  __syncthreads();

  // ---- pre-pass: the four pair metrics of every step, int16
  for (int t = tid; t < kNBits; t += kThreads) {
    int s0, s1;
    if (deint) {   // symbol k = raw[(k % 65) * 80 + k / 65 + 1]
      const int k0 = 2 * t, k1 = 2 * t + 1;
      s0 = raw[(k0 % kCols) * kRows + k0 / kCols + 1];
      s1 = raw[(k1 % kCols) * kRows + k1 / kCols + 1];
    } else {
      s0 = raw[2 * t];
      s1 = raw[2 * t + 1];
    }
    const int a0 = met[s0], a1 = met[256 + s0];
    const int b0 = met[s1], b1 = met[256 + s1];
    const unsigned lo2 = (static_cast<unsigned>(a0 + b0) & 0xffffu) |
                         (static_cast<unsigned>(a0 + b1) << 16);
    const unsigned hi2 = (static_cast<unsigned>(a1 + b0) & 0xffffu) |
                         (static_cast<unsigned>(a1 + b1) << 16);
    reinterpret_cast<uint2*>(pm)[t] = make_uint2(lo2, hi2);
  }
  __syncthreads();
  FEC_MARK(1);
  if (tid >= 32) return;   // warp 0 runs the chain

  // ---- forward add-compare-select with the survivor words. State n's
  // paths: a from j = n >> 1 with pair SYM_A[j] (SYM_B[j] for odd n), b
  // from j + 32 with the other
  const int j = lane >> 1;
  const int* sym_a = tab + 512;
  const int* sym_b = tab + kTabWords - 32;
  Lane r;
  r.lo = lane == 0 ? 0 : kInit;
  r.hi = kInit;
  r.wlo = 0;
  r.whi = 0;
  const bool odd = lane & 1;
  r.pa = odd ? sym_b[j] : sym_a[j];
  r.pb = odd ? sym_a[j] : sym_b[j];
  r.pc = odd ? sym_b[j + 16] : sym_a[j + 16];
  r.pd = odd ? sym_a[j + 16] : sym_b[j + 16];
#pragma unroll
  for (int t = 0; t < kFlush; ++t) acs_step(r, pm + 4 * t, j);
  for (int w = 0; w < kWindows; ++w) {
    const short* p = pm + 4 * (kFlush + w * kWindow);
#pragma unroll
    for (int t = 0; t < kWindow; ++t) acs_step(r, p + 4 * t, j);
    words[w * 64 + lane] = r.wlo;
    words[w * 64 + 32 + lane] = r.whi;
  }
  __syncwarp();
  FEC_MARK(2);

  // ---- chain-back: one dependent step a window, from state 0
  if (lane == 0) {
    unsigned s = 0;
    for (int w = kWindows - 1; w >= 0; --w) {
      const unsigned word = words[w * 64 + s];
      chosen[w] = word;
      s = word >> 26;
    }
  }
  __syncwarp();
  FEC_MARK(3);
  // bits MSB-first: the word's bytes big-endian
  unsigned* o = reinterpret_cast<unsigned*>(out + frame * (kOutBits / 8));
  for (int w = lane; w < kWindows; w += 32)
    o[w] = __byte_perm(chosen[w], 0, 0x0123);
  FEC_MARK(4);
}

}  // namespace

// in: [n_frames, 5200] channel frames (deint = 1) or [n_frames, 5132]
// deinterleaved symbols (deint = 0), uint8; tab: int32 [576] (METTAB row 0,
// row 1, SYM_A, SYM_B); out: [n_frames, 320] uint8 (4-byte aligned).
extern "C" int jsdr_fec_viterbi(const uint8_t* in, const int* tab,
                                uint8_t* out, int n_frames, int deint,
                                void* stream) {
  if (n_frames < 1 || (reinterpret_cast<uintptr_t>(out) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  viterbi_kernel<<<static_cast<unsigned>(n_frames), kThreads, kSmem,
                   static_cast<cudaStream_t>(stream)>>>(in, tab, out, deint);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FEC_PROBE
extern "C" int jsdr_fec_viterbi_marks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, fec_viterbi_marks,
                                               sizeof(fec_viterbi_marks)));
}
#endif

// Soft-decision Viterbi decoder (k=7, r=1/2) of AO-40 frames for Hopper
// (sm_90a): kernel A of the FEC drain.
//
// Replaces: jsdr_tpu/fec/viterbi.py::_acs_scan (the forward lax.scan),
// ::_traceback (the reverse scan) and ::bits_to_bytes, reached from the
// jitted fec_decode (jsdr_tpu/fec/decoder.py) and viterbi27. The port's
// plain versions are fec/viterbi.py::_acs, ::_traceback and
// ::bits_to_bytes; fec/viterbi.py::_viterbi_lanes mirrors this kernel's
// lane layout in plain PyTorch for the CPU tests.
//
// Contract, per frame: the 5132 soft symbols (read through the
// deinterleave of fec/viterbi.py::_DEINT_IDX when the input is a 5200-byte
// channel frame), branch metrics from METTAB as int32, 2566 ACS steps over
// 64 states with int32 metrics (initial -999999 except state 0, no
// renormalisation) and the tie rule dec = b > a; new state 2j takes
// a = m[j] + bm[SYM_A[j]] and b = m[j+32] + bm[SYM_B[j]], new state 2j+1
// the same with the branch pairs swapped. The chain-back starts at state 0
// after step 2565 and emits bit t - 6 = dec[t][s] for t = 2565 ... 6, with
// s = (s >> 1) | (dec[t][s] << 5); the 2560 bits are packed MSB-first into
// 320 bytes.
//
// What bounds it on this card: neither bytes nor operations but the serial
// chain of each frame. The bytes are 5200 in and 320 out a frame (about
// 1 us for 512 frames at 3.35 TB/s); the chain is 2566 dependent ACS steps
// (an add, a max and a shuffle each) and 2560 dependent traceback steps.
// Frames are independent, so any batch up to a few thousand frames runs
// in about the time of one.
//
// Design: one warp a frame, kWarps frames a CTA. Lane l holds old states
// l and l+32 and forms new states 2l and 2l+1; the new metrics go back to
// lanes by four shuffles (state l comes from lane l >> 1, state l+32 from
// lane 16 + (l >> 1), the even or odd one by l's parity). Each step's
// decisions are two ballots, the even and the odd new states, so state s
// lives in word s & 1 at bit s >> 1; lane 0 keeps them in shared memory
// (2566 x 8 B a frame). The frame's symbols are deinterleaved into shared
// memory first, the step's branch metrics are read one step ahead, and
// lane 0 runs the chain-back from shared memory and writes the bytes.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <set>

namespace {

constexpr int kNBits = 2566;             // ACS steps (fec/tables.py NBITS)
constexpr int kFlush = 6;                // K_FLUSH: steps that emit nothing
constexpr int kOutBits = kNBits - kFlush;
constexpr int kSyms = 2 * kNBits;        // 5132 symbols a frame
constexpr int kFrame = 5200;             // SYMPBLOCK channel symbols
constexpr int kRows = 80;                // ROWS (symbols per frame row)
constexpr int kCols = 65;                // COLUMNS (frame rows)
constexpr int kInit = -999999;           // initial metric but state 0's
constexpr int kWarps = 4;                // frames a CTA
constexpr int kSymBytes = 5136;          // kSyms rounded up to 16
constexpr int kWarpBytes = kSymBytes + kNBits * 8;
constexpr int kTabWords = 576;   // METTAB rows (2 x 256), SYM_A, SYM_B
constexpr int kSmem = 2 * 256 * 4 + kWarps * kWarpBytes;
constexpr unsigned kFull = 0xffffffffu;

// The two branch metrics of a lane from one step's symbol pair (low byte
// the pair's first symbol): pair index i = (bitA << 1) | bitB takes
// METTAB[bitA][s0] + METTAB[bitB][s1].
__device__ __forceinline__ void branch(const int* met, unsigned pair, int sa,
                                       int sb, int& bma, int& bmb) {
  const int s0 = pair & 255, s1 = pair >> 8;
  const int a0 = met[s0], a1 = met[256 + s0];
  const int b0 = met[s1], b1 = met[256 + s1];
  bma = ((sa & 2) ? a1 : a0) + ((sa & 1) ? b1 : b0);
  bmb = ((sb & 2) ? a1 : a0) + ((sb & 1) ? b1 : b0);
}

__global__ void __launch_bounds__(kWarps * 32)
viterbi_kernel(const uint8_t* __restrict__ in, const int* __restrict__ tab,
               uint8_t* __restrict__ out, int n_frames, int deint) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* met = reinterpret_cast<int*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 512; i += blockDim.x) met[i] = tab[i];
  const int sa = tab[512 + lane], sb = tab[kTabWords - 32 + lane];
  const long long frame = static_cast<long long>(blockIdx.x) * kWarps + warp;
  unsigned char* sym = smem + 2048 + warp * kWarpBytes;
  uint2* dec = reinterpret_cast<uint2*>(sym + kSymBytes);
  const bool live = frame < n_frames;
  if (live) {
    if (deint) {   // symbol k = raw[(k % 65) * 80 + k / 65 + 1]
      const uint8_t* raw = in + frame * kFrame;
      for (int k = lane; k < kSyms; k += 32)
        sym[k] = raw[(k % kCols) * kRows + k / kCols + 1];
    } else {
      const uint8_t* s = in + frame * kSyms;
      for (int k = lane; k < kSyms; k += 32) sym[k] = s[k];
    }
  }
  __syncthreads();
  if (!live) return;

  // ---- forward add-compare-select: lane l holds states l and l + 32
  const uint16_t* pairs = reinterpret_cast<const uint16_t*>(sym);
  int lo = lane == 0 ? 0 : kInit, hi = kInit;
  int bma, bmb;
  branch(met, pairs[0], sa, sb, bma, bmb);
  const int src = lane >> 1;
  const bool odd = lane & 1;
  for (int t = 0; t < kNBits; ++t) {
    const int ca = bma, cb = bmb;
    if (t + 1 < kNBits) branch(met, pairs[t + 1], sa, sb, bma, bmb);
    const int ea = lo + ca, eb = hi + cb;     // new state 2l: paths a, b
    const int oa = lo + cb, ob = hi + ca;     // new state 2l + 1
    const unsigned de = __ballot_sync(kFull, eb > ea);
    const unsigned dodd = __ballot_sync(kFull, ob > oa);
    const int ne = max(ea, eb), no = max(oa, ob);
    if (lane == 0) dec[t] = make_uint2(de, dodd);
    const int e1 = __shfl_sync(kFull, ne, src);
    const int o1 = __shfl_sync(kFull, no, src);
    const int e2 = __shfl_sync(kFull, ne, src + 16);
    const int o2 = __shfl_sync(kFull, no, src + 16);
    lo = odd ? o1 : e1;
    hi = odd ? o2 : e2;
  }

  // ---- chain-back from state 0, bits packed MSB-first
  if (lane == 0) {
    uint8_t* o = out + frame * (kOutBits / 8);
    unsigned s = 0, byte = 0;
    for (int k = kOutBits - 1; k >= 0; --k) {
      const uint2 w = dec[k + kFlush];
      const unsigned bit = (((s & 1) ? w.y : w.x) >> (s >> 1)) & 1u;
      byte |= bit << (7 - (k & 7));
      if ((k & 7) == 0) {
        o[k >> 3] = static_cast<uint8_t>(byte);
        byte = 0;
      }
      s = (s >> 1) | (bit << 5);
    }
  }
}

// Lets the kernel take kSmem bytes of dynamic shared memory, once a device.
cudaError_t allow_smem() {
  static std::mutex mu;
  static std::set<int> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count(dev)) return cudaSuccess;
  e = cudaFuncSetAttribute(viterbi_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess) done.insert(dev);
  return e;
}

}  // namespace

// in: [n_frames, 5200] channel frames (deint = 1) or [n_frames, 5132]
// deinterleaved symbols (deint = 0), uint8; tab: int32 [576] (METTAB row 0,
// row 1, SYM_A, SYM_B); out: [n_frames, 320] uint8.
extern "C" int jsdr_fec_viterbi(const uint8_t* in, const int* tab,
                                uint8_t* out, int n_frames, int deint,
                                void* stream) {
  if (n_frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((n_frames + kWarps - 1) / kWarps);
  viterbi_kernel<<<grid, kWarps * 32, kSmem,
                   static_cast<cudaStream_t>(stream)>>>(in, tab, out,
                                                        n_frames, deint);
  return static_cast<int>(cudaGetLastError());
}

// Native FLAC decoder — the fast path behind jsdr_tpu.io.flac.read_flac.
//
// The reference gets FLAC ingest from the jflac-codec javax.sound SPI
// (Makefile:9-10, JavaAudio.java:369-395); here the decoder is in-tree.
// Scope matches the Python reference implementation in io/flac.py:
// CONSTANT / VERBATIM / FIXED(0-4) / LPC subframes, Rice & Rice2
// residual with escape partitions, wasted bits, all stereo
// decorrelation modes, CRC-8 header + CRC-16 frame verification.

#include <cstdint>
#include <cstddef>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t len;        // bytes
  size_t pos;        // bits
  bool fail = false;

  uint64_t read(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if ((pos >> 3) >= len) { fail = true; return 0; }
      uint8_t byte = data[pos >> 3];
      int avail = 8 - (int)(pos & 7);
      int take = avail < n ? avail : n;
      int shift = avail - take;
      v = (v << take) | ((byte >> shift) & ((1u << take) - 1));
      pos += take;
      n -= take;
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n > 0 && (v & (1ull << (n - 1)))) return (int64_t)v - (1ll << n);
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    for (;;) {
      if ((pos >> 3) >= len) { fail = true; return 0; }
      uint8_t byte = data[pos >> 3];
      int off = (int)(pos & 7);
      int rem = 8 - off;
      uint8_t chunk = byte & ((1u << rem) - 1);
      if (chunk == 0) { q += rem; pos += rem; continue; }
      int bl = 31 - __builtin_clz(chunk);           // top set bit index
      int lead = rem - 1 - bl;
      q += lead;
      pos += lead + 1;
      return q;
    }
  }

  void align_byte() { pos = (pos + 7) & ~(size_t)7; }
  size_t byte_pos() const { return pos >> 3; }
};

uint8_t crc8_tab[256];
uint16_t crc16_tab[256];
bool tabs_init = false;

void init_tabs() {
  if (tabs_init) return;
  for (int b = 0; b < 256; b++) {
    uint32_t r = b;
    for (int i = 0; i < 8; i++) r = (r & 0x80) ? ((r << 1) ^ 0x07) : (r << 1);
    crc8_tab[b] = (uint8_t)r;
    uint32_t s = b << 8;
    for (int i = 0; i < 8; i++)
      s = (s & 0x8000) ? ((s << 1) ^ 0x8005) : (s << 1);
    crc16_tab[b] = (uint16_t)s;
  }
  tabs_init = true;
}

uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; i++) c = crc8_tab[c ^ d[i]];
  return c;
}

uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; i++)
    c = (uint16_t)((c << 8) ^ crc16_tab[((c >> 8) ^ d[i]) & 0xFF]);
  return c;
}

const int kBlocksize[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                            256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kBps[8] = {0, 8, 12, -1, 16, 20, 24, 32};
const int kFixedCoef[5][4] = {{}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

constexpr int kMaxBlock = 65536;
constexpr int kMaxOrder = 32;

bool decode_residual(BitReader& br, int blocksize, int order, int64_t* out) {
  int method = (int)br.read(2);
  if (method > 1) return false;
  int pbits = 4 + method;
  uint32_t escape = (1u << pbits) - 1;
  int porder = (int)br.read(4);
  int nparts = 1 << porder;
  if (blocksize % nparts) return false;
  int idx = 0;
  for (int p = 0; p < nparts; p++) {
    int n = blocksize / nparts - (p == 0 ? order : 0);
    if (n < 0 || idx + n > blocksize - order) return false;
    uint32_t param = (uint32_t)br.read(pbits);
    if (param == escape) {
      int raw = (int)br.read(5);
      for (int i = 0; i < n; i++)
        out[idx + i] = raw ? br.read_signed(raw) : 0;
    } else {
      for (int i = 0; i < n; i++) {
        uint64_t q = br.read_unary();
        uint64_t v = param ? ((q << param) | br.read(param)) : q;
        out[idx + i] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
    }
    idx += n;
    if (br.fail) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps, int64_t* out) {
  if (br.read(1)) return false;
  int ftype = (int)br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = (int)br.read_unary() + 1;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;
  static thread_local int64_t res[kMaxBlock];
  if (ftype == 0) {
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; i++) out[i] = v;
  } else if (ftype == 1) {
    for (int i = 0; i < blocksize; i++) out[i] = br.read_signed(bps);
  } else if (ftype >= 8 && ftype <= 12) {
    int order = ftype - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    if (!decode_residual(br, blocksize, order, res)) return false;
    const int* c = kFixedCoef[order];
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++) pred += c[j] * out[i - 1 - j];
      out[i] = res[i - order] + pred;
    }
  } else if (ftype >= 32) {
    int order = (ftype & 31) + 1;
    if (order > blocksize || order > kMaxOrder) return false;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    int prec = (int)br.read(4) + 1;
    if (prec == 16) return false;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coef[kMaxOrder];
    for (int j = 0; j < order; j++) coef[j] = br.read_signed(prec);
    if (!decode_residual(br, blocksize, order, res)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++) pred += coef[j] * out[i - 1 - j];
      out[i] = res[i - order] + (pred >> shift);
    }
  } else {
    return false;
  }
  if (br.fail) return false;
  if (wasted)
    for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
  return true;
}

uint64_t read_utf8_coded(BitReader& br) {
  uint32_t b0 = (uint32_t)br.read(8);
  if (b0 < 0x80) return b0;
  int nbytes = 0;
  uint32_t m = b0;
  while (m & 0x80) { nbytes++; m = (m << 1) & 0xFF; }
  uint64_t v = b0 & (0x7Fu >> nbytes);
  for (int i = 0; i < nbytes - 1; i++) v = (v << 6) | (br.read(8) & 0x3F);
  return v;
}

}  // namespace

extern "C" {

// Decode a whole FLAC stream. `data` is the full file; writes up to
// `max_samples` interleaved frames of int32 into `out` (caller sizes it
// from STREAMINFO total_samples x channels). Returns the number of
// inter-channel samples decoded, or -1 on any error (caller falls back
// to the Python decoder for a precise message).
long long jsdr_flac_decode(const uint8_t* data, size_t len, int32_t* out,
                           long long max_samples) {
  init_tabs();
  if (len < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  int rate = 0, channels = 0, bps = 0;
  bool have_si = false;
  for (;;) {
    if (pos + 4 > len) return -1;
    uint8_t hdr = data[pos];
    uint32_t blen = ((uint32_t)data[pos + 1] << 16) |
                    ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    if (pos + 4 + blen > len) return -1;
    if ((hdr & 0x7F) == 0 && blen >= 34) {
      const uint8_t* b = data + pos + 4;
      rate = ((int)b[10] << 12) | ((int)b[11] << 4) | (b[12] >> 4);
      channels = ((b[12] >> 1) & 7) + 1;
      bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      have_si = true;
    }
    pos += 4 + blen;
    if (hdr & 0x80) break;
  }
  (void)rate;
  if (!have_si || channels < 1 || channels > 8) return -1;

  static thread_local int64_t ch[2][kMaxBlock];
  static thread_local int64_t chx[8][kMaxBlock];   // >2 independent channels
  long long done = 0;
  BitReader br{data, len, pos * 8};
  while (br.byte_pos() + 2 < len && done < max_samples) {
    size_t start = br.byte_pos();
    if (br.read(14) != 0x3FFE) return -1;
    br.read(2);                                 // reserved + blocking
    int bs_code = (int)br.read(4);
    int sr_code = (int)br.read(4);
    int chan_asgn = (int)br.read(4);
    int ss_code = (int)br.read(3);
    br.read(1);
    read_utf8_coded(br);
    int blocksize;
    if (bs_code == 0) return -1;
    else if (bs_code == 6) blocksize = (int)br.read(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.read(16) + 1;
    else blocksize = kBlocksize[bs_code];
    if (blocksize <= 0 || blocksize > kMaxBlock) return -1;
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    size_t hdr_end = br.byte_pos();
    if (crc8(data + start, hdr_end - start) != br.read(8)) return -1;
    int fbps = ss_code ? kBps[ss_code] : bps;
    if (fbps <= 0) return -1;

    if (chan_asgn < 8) {
      int nch = chan_asgn + 1;
      if (nch != channels || nch > 8) return -1;
      for (int c = 0; c < nch; c++)
        if (!decode_subframe(br, blocksize, fbps, chx[c])) return -1;
    } else if (chan_asgn <= 10) {
      if (channels != 2) return -1;
      int bps0 = fbps + (chan_asgn == 9 ? 1 : 0);
      int bps1 = fbps + (chan_asgn != 9 ? 1 : 0);
      if (!decode_subframe(br, blocksize, bps0, ch[0])) return -1;
      if (!decode_subframe(br, blocksize, bps1, ch[1])) return -1;
      if (chan_asgn == 8) {          // left/side
        for (int i = 0; i < blocksize; i++) {
          chx[0][i] = ch[0][i];
          chx[1][i] = ch[0][i] - ch[1][i];
        }
      } else if (chan_asgn == 9) {   // side/right
        for (int i = 0; i < blocksize; i++) {
          chx[0][i] = ch[1][i] + ch[0][i];
          chx[1][i] = ch[1][i];
        }
      } else {                       // mid/side
        for (int i = 0; i < blocksize; i++) {
          int64_t m2 = (ch[0][i] << 1) | (ch[1][i] & 1);
          chx[0][i] = (m2 + ch[1][i]) >> 1;
          chx[1][i] = (m2 - ch[1][i]) >> 1;
        }
      }
    } else {
      return -1;
    }
    br.align_byte();
    size_t fend = br.byte_pos();
    if (crc16(data + start, fend - start) != br.read(16)) return -1;
    if (br.fail) return -1;

    long long take = blocksize;
    if (done + take > max_samples) take = max_samples - done;
    for (long long i = 0; i < take; i++)
      for (int c = 0; c < channels; c++)
        out[(done + i) * channels + c] = (int32_t)chx[c][i];
    done += take;
  }
  return done;
}

}  // extern "C"

"""FLAC codec (stdlib-only Python + optional native C++ fast path) — a
copy of :mod:`jsdr_tpu.io.flac`; the fast path is the port's own build of
the sources (:mod:`jsdr_tpu_torch.io.native`).

The reference reads FLAC transparently by registering jflac-codec as a
javax.sound SPI (Makefile:9-10) so `file:capture.flac` sources Just Work
(JavaAudio.java:369-395). A TPU host has no such SPI registry and this
environment ships no libFLAC, so the framework carries its own codec:

- **decoder**: full subset needed for real-world 16/24-bit files —
  CONSTANT / VERBATIM / FIXED(0-4) / LPC subframes, Rice & Rice2
  residual (incl. escape partitions), wasted bits, all four stereo
  decorrelation modes, CRC-8 frame-header and CRC-16 frame checks.
  A native C++ implementation (native/flac_dec.cpp) is preferred when
  the IO library is built; this pure-Python version is the reference
  implementation and the fallback.
- **encoder**: fixture/recorder writer — fixed 4096-sample frames,
  independent channels, CONSTANT / FIXED(2)+Rice / VERBATIM subframe
  choice per channel, correct STREAMINFO (incl. MD5) so any standard
  decoder accepts the output.
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path
from typing import Tuple

import numpy as np

_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
               6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
               11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_CRC8_POLY = 0x07
_CRC16_POLY = 0x8005


def _crc_table(poly: int, width: int):
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    tab = []
    for b in range(256):
        r = b << (width - 8)
        for _ in range(8):
            r = ((r << 1) ^ poly) if (r & top) else (r << 1)
        tab.append(r & mask)
    return tab


_CRC8_TAB = _crc_table(_CRC8_POLY, 8)
_CRC16_TAB = _crc_table(_CRC16_POLY, 16)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8_TAB[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16_TAB[((c >> 8) ^ b) & 0xFF]
    return c


class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8   # absolute bit position

    def read(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        while n > 0:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n)
            shift = avail - take
            v = (v << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
            n -= take
        self.pos = pos
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1."""
        q = 0
        pos = self.pos
        data = self.data
        while True:
            byte = data[pos >> 3]
            off = pos & 7
            rem = 8 - off
            chunk = byte & ((1 << rem) - 1)
            if chunk == 0:
                q += rem
                pos += rem
                continue
            lead = rem - chunk.bit_length()
            q += lead
            pos += lead + 1
            self.pos = pos
            return q

    def align_byte(self):
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3

    def at_end(self) -> bool:
        return self.byte_pos() >= len(self.data)


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align_byte(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _utf8_coded_number(n: int) -> bytes:
    """FLAC frame-number coding (UTF-8-style, up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (6 - nbytes + 5 * nbytes)) and nbytes < 7:
        nbytes += 1
    for i in range(nbytes - 1):
        out.append(0x80 | (n & 0x3F))
        n >>= 6
    lead = (0xFF00 >> nbytes) & 0xFF
    out.append(lead | n)
    return bytes(reversed(out))


def _read_utf8_coded(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    nbytes = 0
    m = b0
    while m & 0x80:
        nbytes += 1
        m = (m << 1) & 0xFF
    v = b0 & (0x7F >> nbytes)
    for _ in range(nbytes - 1):
        v = (v << 6) | (br.read(8) & 0x3F)
    return v


_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    pbits = 4 + method
    escape = (1 << pbits) - 1
    porder = br.read(4)
    nparts = 1 << porder
    if blocksize % nparts:
        raise ValueError("bad partition order")
    out = np.empty(blocksize - order, np.int64)
    idx = 0
    for p in range(nparts):
        n = blocksize // nparts - (order if p == 0 else 0)
        param = br.read(pbits)
        if param == escape:
            raw = br.read(5)
            for i in range(n):
                out[idx + i] = br.read_signed(raw) if raw else 0
        else:
            for i in range(n):
                q = br.read_unary()
                v = (q << param) | br.read(param) if param else q
                out[idx + i] = (v >> 1) ^ -(v & 1)
        idx += n
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("bad subframe pad bit")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    bps -= wasted
    if ftype == 0:          # CONSTANT
        v = br.read_signed(bps)
        out = np.full(blocksize, v, np.int64)
    elif ftype == 1:        # VERBATIM
        out = np.array([br.read_signed(bps) for _ in range(blocksize)],
                       np.int64)
    elif 8 <= ftype <= 12:  # FIXED
        order = ftype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        a = out
        for i in range(order, blocksize):
            pred = 0
            for j, c in enumerate(coefs):
                pred += c * a[i - 1 - j]
            a[i] = res[i - order] + pred
    elif ftype >= 32:       # LPC
        order = (ftype & 31) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        a = out
        for i in range(order, blocksize):
            pred = 0
            for j in range(order):
                pred += coefs[j] * a[i - 1 - j]
            a[i] = res[i - order] + (pred >> shift)
    else:
        raise ValueError(f"reserved subframe type {ftype}")
    if wasted:
        out <<= wasted
    return out


def parse_streaminfo(data: bytes):
    """Returns (rate, channels, bps, total_samples, md5, frames_offset)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file")
    pos = 4
    info = None
    while True:
        hdr = data[pos]
        btype = hdr & 0x7F
        blen = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + blen]
        pos += 4 + blen
        if btype == 0:
            br = _BitReader(body)
            br.read(16); br.read(16)            # min/max blocksize
            br.read(24); br.read(24)            # min/max framesize
            rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            md5 = body[18:34]
            info = (rate, channels, bps, total, md5)
        if hdr & 0x80:
            break
    if info is None:
        raise ValueError("missing STREAMINFO")
    return (*info, pos)


def _decode_frames_py(data: bytes, pos: int, rate: int, channels: int,
                      bps: int, total: int) -> np.ndarray:
    chunks = []
    br = _BitReader(data, pos)
    while br.byte_pos() < len(data) - 1:
        start = br.byte_pos()
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"lost frame sync at byte {start}")
        br.read(1)                      # reserved
        br.read(1)                      # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_asgn = br.read(4)
        ss_code = br.read(3)
        br.read(1)                      # reserved
        _read_utf8_coded(br)            # frame/sample number
        if bs_code == 0:
            raise ValueError("reserved blocksize code")
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        hdr_end = br.byte_pos()
        if crc8(data[start:hdr_end]) != br.read(8):
            raise ValueError("frame header CRC-8 mismatch")
        fbps = _BPS_TABLE[ss_code] if ss_code else bps
        if chan_asgn < 8:
            nch = chan_asgn + 1
            chans = [_decode_subframe(br, blocksize, fbps)
                     for _ in range(nch)]
        elif chan_asgn == 8:    # left/side
            left = _decode_subframe(br, blocksize, fbps)
            side = _decode_subframe(br, blocksize, fbps + 1)
            chans = [left, left - side]
        elif chan_asgn == 9:    # side/right
            side = _decode_subframe(br, blocksize, fbps + 1)
            right = _decode_subframe(br, blocksize, fbps)
            chans = [right + side, right]
        elif chan_asgn == 10:   # mid/side
            mid = _decode_subframe(br, blocksize, fbps)
            side = _decode_subframe(br, blocksize, fbps + 1)
            m2 = (mid << 1) | (side & 1)
            chans = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError("reserved channel assignment")
        br.align_byte()
        fend = br.byte_pos()
        if crc16(data[start:fend]) != br.read(16):
            raise ValueError("frame CRC-16 mismatch")
        chunks.append(np.stack(chans, axis=-1))
        if total and sum(len(c) for c in chunks) >= total:
            break
    out = np.concatenate(chunks) if chunks else np.zeros((0, channels),
                                                         np.int64)
    return out[:total] if total else out


def read_flac(path, prefer_native: bool = True):
    """Decode a FLAC file -> (samples int32 [n, channels], rate, bps).

    Uses the native C++ decoder when the IO library is built
    (native/flac_dec.cpp), falling back to the pure-Python decoder.
    """
    data = Path(path).read_bytes()
    rate, channels, bps, total, _md5, pos = parse_streaminfo(data)
    if prefer_native:
        from . import native
        res = native.flac_decode_native(data, channels, total)
        if res is not None:
            return res.reshape(-1, channels), rate, bps
    out = _decode_frames_py(data, pos, rate, channels, bps, total)
    return out.astype(np.int32), rate, bps


# ---------------------------------------------------------------------------
# Encoder (fixture/recorder writer)
# ---------------------------------------------------------------------------

def _rice_param(res: np.ndarray) -> int:
    mean = float(np.mean(np.abs(res))) if len(res) else 0.0
    k = 0
    while (1 << k) < mean and k < 14:
        k += 1
    return k


def _encode_residual(bw: _BitWriter, res: np.ndarray):
    k = _rice_param(res)
    bw.write(0, 2)          # Rice, 4-bit params
    bw.write(0, 4)          # partition order 0
    bw.write(k, 4)
    for v in np.asarray(res, np.int64):
        u = (int(v) << 1) ^ (int(v) >> 63)   # zigzag
        bw.write_unary(u >> k)
        if k:
            bw.write(u & ((1 << k) - 1), k)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int):
    x = np.asarray(x, np.int64)
    n = len(x)
    if np.all(x == x[0]):
        bw.write(0, 1); bw.write(0, 6); bw.write(0, 1)
        bw.write(int(x[0]), bps)
        return
    order = 2 if n > 2 else 0
    if order:
        res = x[2:] - 2 * x[1:-1] + x[:-2]
        k = _rice_param(res)
        rice_bits = (n - 2) * (k + 2) + int(np.sum(np.abs(res) >> max(k, 1)))
        if rice_bits < n * bps:
            bw.write(0, 1); bw.write(8 + order, 6); bw.write(0, 1)
            for v in x[:order]:
                bw.write(int(v), bps)
            _encode_residual(bw, res)
            return
    bw.write(0, 1); bw.write(1, 6); bw.write(0, 1)   # VERBATIM
    for v in x:
        bw.write(int(v), bps)


_STEREO_MODES = {"independent": None, "left_side": 8, "side_right": 9,
                 "mid_side": 10}


def write_flac(path, samples: np.ndarray, rate: int, bps: int = 16,
               block: int = 4096, stereo: str = "independent") -> None:
    """Encode int samples [n, channels] (or [n]) to a FLAC file.

    ``stereo`` selects the inter-channel decorrelation for 2-channel
    input: independent (default), left_side, side_right, or mid_side.
    """
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    assert x.min() >= lo and x.max() <= hi, "samples exceed bps range"
    x = x.astype(np.int64)
    asgn = _STEREO_MODES[stereo]
    if asgn is not None:
        assert channels == 2, "decorrelation modes need 2 channels"

    frames = bytearray()
    for fi, s0 in enumerate(range(0, n, block)):
        blk = x[s0:s0 + block]
        bs = len(blk)
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1); bw.write(0, 1)               # fixed blocking
        bw.write(7, 4)                               # 16-bit blocksize-1 at end
        bw.write(0, 4)                               # rate from STREAMINFO
        bw.write(channels - 1 if asgn is None else asgn, 4)
        bw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6}[bps], 3)
        bw.write(0, 1)
        for b in _utf8_coded_number(fi):
            bw.write(b, 8)
        bw.write(bs - 1, 16)
        hdr = bw
        hdr_bytes = hdr.buf[:]
        bw.write(crc8(bytes(hdr_bytes)), 8)
        if asgn is None:
            for c in range(channels):
                _encode_subframe(bw, blk[:, c], bps)
        else:
            left, right = blk[:, 0], blk[:, 1]
            side = left - right
            if asgn == 8:
                _encode_subframe(bw, left, bps)
                _encode_subframe(bw, side, bps + 1)
            elif asgn == 9:
                _encode_subframe(bw, side, bps + 1)
                _encode_subframe(bw, right, bps)
            else:
                mid = (left + right) >> 1
                _encode_subframe(bw, mid, bps)
                _encode_subframe(bw, side, bps + 1)
        bw.align_byte()
        body = bw.getvalue()
        frames += body + struct.pack(">H", crc16(body))

    md5 = hashlib.md5()
    width = bps // 8
    inter = x.reshape(-1)
    md5.update(b"".join(int(v).to_bytes(width, "little", signed=True)
                        for v in inter))

    if n == 0:
        minbs = maxbs = block
    elif n <= block:
        minbs = maxbs = n
    else:
        minbs = min(block, n % block or block)
        maxbs = block
    si = _BitWriter()
    si.write(minbs, 16)
    si.write(maxbs, 16)
    si.write(0, 24); si.write(0, 24)                 # min/max framesize unknown
    si.write(rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    si.align_byte()
    body = si.getvalue() + md5.digest()
    assert len(body) == 34
    out = (b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big") + body
           + bytes(frames))
    Path(path).write_bytes(out)

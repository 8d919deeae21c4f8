"""Compressed-DICOM pixel codecs: JPEG lossless (SOF3), JPEG-LS, DICOM RLE.

Counterpart of ``ukbb_cardiac_tpu/data/jpegcodec.py`` (a copy).

The reference converts compressed UKB re-releases by falling back to
SimpleITK when pydicom cannot decode a frame
(``data/biobank_utils.py:352-363``).  Neither pydicom nor SimpleITK is a
dependency here, so this module implements the three transfer syntaxes
that appear in DICOM CMR archives natively:

- **JPEG lossless** (ITU-T T.81 Annex H, SOF3 marker): Huffman-coded DPCM
  with predictor selection values 1-7.  UKB/cvi42 exports use selection
  value 1 (transfer syntax 1.2.840.10008.1.2.4.70).
- **JPEG-LS lossless** (ITU-T T.87 / LOCO-I, SOF55 marker): context-model
  + Golomb coding with run mode (1.2.840.10008.1.2.4.80; the
  near-lossless .81 syntax decodes with the same machinery, NEAR from the
  SOS header).
- **DICOM RLE** (PS3.5 Annex G, 1.2.840.10008.1.2.5): PackBits byte
  planes.

Both an encoder and a decoder are provided for each format: the encoders
generate test fixtures (no compressed UKB data can ship with the repo)
and let :mod:`ukbb_cardiac_tpu_torch.data.dicom` write compressed files; the
decoders take the streams the C++ decoders of ``native/hostops.cc``
(dispatched via ``ukbb_cardiac_tpu_torch.native``) decline (a Python
per-pixel loop costs ~1 s per 208x256 frame; the C++ decoders are ~100x
faster).

Everything here is implemented from the published specifications; no
third-party codec source was consulted.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class JpegDecodeError(ValueError):
    pass


# ===========================================================================
# Bit I/O
# ===========================================================================


class _BitWriter:
    """MSB-first bit writer with either JPEG or JPEG-LS marker avoidance.

    JPEG (T.81): a written 0xFF byte is followed by a stuffed 0x00 byte.
    JPEG-LS (T.87): a byte following a written 0xFF carries only 7 bits
    (its MSB is forced to 0).
    """

    def __init__(self, style: str):
        assert style in ("jpeg", "jpegls")
        self.style = style
        self.out = bytearray()
        self._acc = 0
        self._nbits = 0  # bits currently in _acc
        self._width = 8  # bits the current byte may hold

    def _flush_byte(self):
        byte = self._acc
        self.out.append(byte)
        self._acc = 0
        self._nbits = 0
        if self.style == "jpegls":
            self._width = 7 if byte == 0xFF else 8
        else:
            if byte == 0xFF:
                self.out.append(0x00)
            self._width = 8

    def write(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            bit = (value >> i) & 1
            self._acc = (self._acc << 1) | bit
            self._nbits += 1
            if self._nbits == self._width:
                self._flush_byte()

    def write_unary_zeros(self, n: int):
        """n zeros followed by a one (Golomb unary prefix)."""
        for _ in range(n):
            self.write(0, 1)
        self.write(1, 1)

    def flush(self, pad_bit: int):
        while self._nbits != 0:
            self.write(pad_bit, 1)

    def getvalue(self) -> bytes:
        return bytes(self.out)


class _BitReader:
    """MSB-first bit reader mirroring :class:`_BitWriter`."""

    def __init__(self, buf: bytes, pos: int, style: str):
        self.buf = buf
        self.pos = pos
        self.style = style
        self._acc = 0
        self._nbits = 0
        self._prev_ff = False

    def _fill(self):
        if self.pos >= len(self.buf):
            # missing padding at end of stream: supply zero bits (the
            # encoder's final byte padding is not always present)
            self._acc = (self._acc << 8)
            self._nbits += 8
            return
        byte = self.buf[self.pos]
        if self.style == "jpeg" and self._prev_ff:
            if byte == 0x00:  # stuffed byte
                self.pos += 1
                self._prev_ff = False
                self._fill()
                return
            raise JpegDecodeError(
                f"unexpected marker 0xFF{byte:02X} inside entropy data")
        self.pos += 1
        if self.style == "jpegls" and self._prev_ff:
            # 7-bit byte (MSB is a stuffed 0)
            self._acc = (self._acc << 7) | (byte & 0x7F)
            self._nbits += 7
        else:
            self._acc = (self._acc << 8) | byte
            self._nbits += 8
        self._prev_ff = byte == 0xFF

    def read(self, nbits: int) -> int:
        while self._nbits < nbits:
            self._fill()
        shift = self._nbits - nbits
        val = (self._acc >> shift) & ((1 << nbits) - 1)
        self._acc &= (1 << shift) - 1
        self._nbits = shift
        return val

    def read_bit(self) -> int:
        return self.read(1)

    def read_unary(self, limit: int = 1 << 30) -> int:
        """Count zeros until a one; the one is consumed."""
        n = 0
        while self.read(1) == 0:
            n += 1
            if n > limit:
                raise JpegDecodeError("runaway unary code")
        return n


def _read_markers(data: bytes):
    """Yield (marker, payload_start, payload_len, next_pos) over a JPEG
    stream; stops before entropy-coded data (caller resumes from SOS)."""
    if data[:2] != b"\xFF\xD8":
        raise JpegDecodeError("not a JPEG stream (missing SOI)")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise JpegDecodeError(f"marker expected at {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:  # EOI
            return
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        yield marker, pos + 4, length - 2, pos + 2 + length
        if marker == 0xDA:  # SOS: entropy data follows
            return
        pos = pos + 2 + length


# ===========================================================================
# JPEG lossless (ITU-T T.81 Annex H, SOF3)
# ===========================================================================

# canonical Huffman lengths for the 17 difference categories (0..16):
# categories 0/1 -> 2 bits, category c -> c+1 bits, category 16 -> 16
# bits (JPEG caps code length at 16; Kraft sum = 1/2, valid).
_SOF3_CAT_LENGTHS = [2] + [min(c + 1, 16) for c in range(1, 17)]


def _canonical_codes(lengths: List[int]) -> List[Tuple[int, int]]:
    """(code, nbits) per symbol from code lengths, canonical order."""
    order = sorted(range(len(lengths)), key=lambda s: (lengths[s], s))
    codes: List[Tuple[int, int]] = [(0, 0)] * len(lengths)
    code = 0
    prev_len = 0
    for s in order:
        ln = lengths[s]
        code <<= (ln - prev_len)
        codes[s] = (code, ln)
        code += 1
        prev_len = ln
    return codes


def _predict_sof3(ra: int, rb: int, rc: int, sv: int) -> int:
    if sv == 1:
        return ra
    if sv == 2:
        return rb
    if sv == 3:
        return rc
    if sv == 4:
        return ra + rb - rc
    if sv == 5:
        return ra + ((rb - rc) >> 1)
    if sv == 6:
        return rb + ((ra - rc) >> 1)
    if sv == 7:
        return (ra + rb) >> 1
    raise JpegDecodeError(f"predictor selection value {sv}")


def encode_jpeg_lossless(img: np.ndarray, precision: Optional[int] = None,
                         sv: int = 1) -> bytes:
    """Encode a 2-D unsigned array as single-component JPEG lossless."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2-D image")
    arr = img.astype(np.int64)
    if arr.min() < 0:
        raise ValueError("JPEG lossless encodes unsigned samples")
    P = int(precision) if precision else max(2, int(arr.max()).bit_length())
    if not 2 <= P <= 16:
        raise ValueError(f"precision {P} outside [2, 16]")
    rows, cols = arr.shape

    codes = _canonical_codes(_SOF3_CAT_LENGTHS)
    out = bytearray(b"\xFF\xD8")
    # SOF3
    sof = bytes([P]) + rows.to_bytes(2, "big") + cols.to_bytes(2, "big") + \
        bytes([1, 1, 0x11, 0])
    out += b"\xFF\xC3" + (len(sof) + 2).to_bytes(2, "big") + sof
    # DHT (table class 0, id 0)
    bits = [0] * 16
    for ln in _SOF3_CAT_LENGTHS:
        bits[ln - 1] += 1
    huffval = sorted(range(17), key=lambda s: (_SOF3_CAT_LENGTHS[s], s))
    dht = bytes([0x00]) + bytes(bits) + bytes(huffval)
    out += b"\xFF\xC4" + (len(dht) + 2).to_bytes(2, "big") + dht
    # SOS
    sos = bytes([1, 1, 0x00, sv, 0, 0])
    out += b"\xFF\xDA" + (len(sos) + 2).to_bytes(2, "big") + sos

    w = _BitWriter("jpeg")
    default = 1 << (P - 1)
    for r in range(rows):
        for c in range(cols):
            x = int(arr[r, c])
            if r == 0:
                px = default if c == 0 else int(arr[0, c - 1])
            elif c == 0:
                px = int(arr[r - 1, 0])
            else:
                px = _predict_sof3(int(arr[r, c - 1]), int(arr[r - 1, c]),
                                   int(arr[r - 1, c - 1]), sv)
            diff = (x - px) & 0xFFFF
            if diff >= 0x8000:
                diff -= 0x10000
            if diff == 0:
                ssss = 0
            elif diff == -32768:
                ssss = 16
            else:
                ssss = abs(diff).bit_length()
            code, nbits = codes[ssss]
            w.write(code, nbits)
            if 0 < ssss < 16:
                mag = diff if diff > 0 else diff + (1 << ssss) - 1
                w.write(mag & ((1 << ssss) - 1), ssss)
    w.flush(1)
    out += w.getvalue()
    out += b"\xFF\xD9"
    return bytes(out)


def decode_jpeg_lossless(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG lossless (SOF3) stream → uint16."""
    P = rows = cols = None
    sv = pt = 0
    tables: dict = {}
    sos_end = None
    comp_table = 0
    for marker, start, length, nxt in _read_markers(data):
        seg = data[start:start + length]
        if marker == 0xC3:
            P = seg[0]
            rows = int.from_bytes(seg[1:3], "big")
            cols = int.from_bytes(seg[3:5], "big")
            nf = seg[5]
            if nf != 1:
                raise JpegDecodeError(f"{nf}-component lossless JPEG "
                                      "(expected single-component DICOM)")
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise JpegDecodeError(
                f"SOF{marker - 0xC0} JPEG is not lossless (expected SOF3)")
        elif marker == 0xC4:  # DHT — possibly several tables
            p = 0
            while p < len(seg):
                tc_th = seg[p]
                bits = list(seg[p + 1:p + 17])
                nsym = sum(bits)
                vals = list(seg[p + 17:p + 17 + nsym])
                lengths = []
                for ln, cnt in enumerate(bits, start=1):
                    lengths += [ln] * cnt
                tables[tc_th & 0x0F] = (vals, lengths)
                p += 17 + nsym
        elif marker == 0xDD:
            raise JpegDecodeError("restart intervals not supported")
        elif marker == 0xDA:
            ns = seg[0]
            if ns != 1:
                raise JpegDecodeError("expected a single scan component")
            comp_table = seg[2] >> 4
            sv = seg[3]
            pt = seg[5] & 0x0F
            sos_end = start + length
    if P is None or sos_end is None:
        raise JpegDecodeError("missing SOF3/SOS markers")
    if not 2 <= P <= 16 or pt > P - 1:
        raise JpegDecodeError(f"bad SOF3 precision P={P} pt={pt}")
    if comp_table not in tables:
        raise JpegDecodeError("missing Huffman table")
    if not 1 <= sv <= 7:
        raise JpegDecodeError(f"predictor selection value {sv}")
    if any(v > 16 for v in tables[comp_table][0]):
        raise JpegDecodeError("DHT symbol outside the 0..16 categories")

    vals, lengths = tables[comp_table]
    codes = _canonical_codes(lengths)
    # decode map: (nbits, code) -> symbol
    lut = {(n, c): vals[i] for i, (c, n) in enumerate(codes)}

    r = _BitReader(data, sos_end, "jpeg")
    arr = np.zeros((rows, cols), np.int64)
    default = 1 << (P - 1 - pt)
    for row in range(rows):
        for col in range(cols):
            code, nbits = 0, 0
            while True:
                code = (code << 1) | r.read_bit()
                nbits += 1
                sym = lut.get((nbits, code))
                if sym is not None:
                    break
                if nbits > 16:
                    raise JpegDecodeError("invalid Huffman code")
            if sym == 0:
                diff = 0
            elif sym == 16:
                diff = 32768
            else:
                mag = r.read(sym)
                diff = mag if mag >= (1 << (sym - 1)) else \
                    mag - (1 << sym) + 1
            if row == 0:
                px = default if col == 0 else int(arr[0, col - 1])
            elif col == 0:
                px = int(arr[row - 1, 0])
            else:
                px = _predict_sof3(int(arr[row, col - 1]),
                                   int(arr[row - 1, col]),
                                   int(arr[row - 1, col - 1]), sv)
            arr[row, col] = (px + diff) & 0xFFFF
    return arr.astype(np.uint16)


# ===========================================================================
# JPEG-LS (ITU-T T.87)
# ===========================================================================

_J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
      4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15]
_MIN_C, _MAX_C = -128, 127


def _jls_default_thresholds(maxval: int, near: int) -> Tuple[int, int, int]:
    """Default T1/T2/T3 (T.87 C.2.4.1.1.1)."""

    def clamp(v, lo):
        return min(max(v, lo), maxval)

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) >> 8
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        # small-alphabet branch: FACTOR = 256/(MAXVAL+1),
        # Ti = max(floor_i, BASIC_Ti/FACTOR + k*NEAR)
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3


class _JlsState:
    """Shared encoder/decoder context state (T.87 A.2/A.7)."""

    def __init__(self, maxval: int, near: int, t1: int, t2: int, t3: int,
                 reset: int):
        self.maxval = maxval
        self.near = near
        self.t1, self.t2, self.t3 = t1, t2, t3
        self.reset = reset
        self.range = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = (self.range - 1).bit_length()
        bpp = max(2, (maxval + 1 - 1).bit_length())
        self.limit = 2 * (bpp + max(8, bpp))
        a_init = max(2, (self.range + 32) // 64)
        self.A = [a_init] * 367
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 367
        self.Nn = [0, 0]  # contexts 365, 366
        self.run_index = 0

    def quantize(self, d: int) -> int:
        near = self.near
        if d <= -self.t3:
            return -4
        if d <= -self.t2:
            return -3
        if d <= -self.t1:
            return -2
        if d < -near:
            return -1
        if d <= near:
            return 0
        if d < self.t1:
            return 1
        if d < self.t2:
            return 2
        if d < self.t3:
            return 3
        return 4

    def context(self, d1: int, d2: int, d3: int) -> Tuple[int, int]:
        """(q, sign): q==0 → run mode; else regular context 1..364."""
        q = 81 * self.quantize(d1) + 9 * self.quantize(d2) + self.quantize(d3)
        if q < 0:
            return -q, -1
        return q, 1

    def golomb_k(self, q: int) -> int:
        k = 0
        while (self.N[q] << k) < self.A[q]:
            k += 1
        return k

    def mod_range(self, errval: int) -> int:
        rng = self.range
        if errval < 0:
            errval += rng
        if errval >= (rng + 1) // 2:
            errval -= rng
        return errval

    def update_regular(self, q: int, errval: int):
        self.B[q] += errval * (2 * self.near + 1)
        self.A[q] += abs(errval)
        if self.N[q] == self.reset:
            self.A[q] >>= 1
            self.B[q] = self.B[q] >> 1 if self.B[q] >= 0 else \
                -((1 - self.B[q]) >> 1)
            self.N[q] >>= 1
        self.N[q] += 1
        # bias computation (A.6.2)
        if self.B[q] <= -self.N[q]:
            self.B[q] += self.N[q]
            if self.C[q] > _MIN_C:
                self.C[q] -= 1
            if self.B[q] <= -self.N[q]:
                self.B[q] = -self.N[q] + 1
        elif self.B[q] > 0:
            self.B[q] -= self.N[q]
            if self.C[q] < _MAX_C:
                self.C[q] += 1
            if self.B[q] > 0:
                self.B[q] = 0

    # --- run interruption (A.7.2) -----------------------------------------
    def ri_golomb_k(self, ritype: int) -> int:
        q = 365 + ritype
        temp = self.A[q] + ((self.N[q] >> 1) if ritype else 0)
        k = 0
        while (self.N[q] << k) < temp:
            k += 1
        return k

    def ri_update(self, ritype: int, errval: int, emerrval: int):
        q = 365 + ritype
        if errval < 0:
            self.Nn[ritype] += 1
        self.A[q] += (emerrval + 1 - ritype) >> 1
        if self.N[q] == self.reset:
            self.A[q] >>= 1
            self.N[q] >>= 1
            self.Nn[ritype] >>= 1
        self.N[q] += 1


def _reconstruct(st: _JlsState, px: int, signed_err: int) -> int:
    """Shared sample reconstruction (A.4.5/A.8.2): both sides MUST apply
    the same modulo correction and clamp or near-lossless drifts."""
    rec = px + signed_err * (2 * st.near + 1)
    if rec < -st.near:
        rec += st.range * (2 * st.near + 1)
    elif rec > st.maxval + st.near:
        rec -= st.range * (2 * st.near + 1)
    return max(0, min(st.maxval, rec))


def _med(ra: int, rb: int, rc: int) -> int:
    if rc >= max(ra, rb):
        return min(ra, rb)
    if rc <= min(ra, rb):
        return max(ra, rb)
    return ra + rb - rc


def _golomb_write(w: _BitWriter, val: int, k: int, limit: int, qbpp: int):
    """Limited-length Golomb code LG(k, limit) (A.5.3)."""
    high = val >> k
    if high < limit - qbpp - 1:
        w.write_unary_zeros(high)
        if k:
            w.write(val & ((1 << k) - 1), k)
    else:
        w.write_unary_zeros(limit - qbpp - 1)
        w.write(val - 1, qbpp)


def _golomb_read(r: _BitReader, k: int, limit: int, qbpp: int) -> int:
    high = r.read_unary(limit)
    if high < limit - qbpp - 1:
        return (high << k) | (r.read(k) if k else 0)
    return r.read(qbpp) + 1


def encode_jpegls(img: np.ndarray, precision: Optional[int] = None,
                  near: int = 0) -> bytes:
    """Encode a 2-D unsigned array as single-component JPEG-LS."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2-D image")
    arr = img.astype(np.int64)
    if arr.min() < 0:
        raise ValueError("JPEG-LS encodes unsigned samples")
    P = int(precision) if precision else max(2, int(arr.max()).bit_length())
    if not 2 <= P <= 16:
        raise ValueError(f"precision {P} outside [2, 16]")
    rows, cols = arr.shape
    maxval = (1 << P) - 1
    t1, t2, t3 = _jls_default_thresholds(maxval, near)
    st = _JlsState(maxval, near, t1, t2, t3, 64)

    out = bytearray(b"\xFF\xD8")
    sof = bytes([P]) + rows.to_bytes(2, "big") + cols.to_bytes(2, "big") + \
        bytes([1, 1, 0x11, 0])
    out += b"\xFF\xF7" + (len(sof) + 2).to_bytes(2, "big") + sof
    sos = bytes([1, 1, 0x00, near, 0, 0])
    out += b"\xFF\xDA" + (len(sos) + 2).to_bytes(2, "big") + sos

    w = _BitWriter("jpegls")
    recon = np.zeros((rows, cols), np.int64)  # decoder-visible samples

    for row in range(rows):
        def sample(rr, cc):
            if rr < 0:
                return 0
            if cc < 0:
                # Ra at col 0 is Rb (sample above); handled by caller
                raise AssertionError
            if cc >= cols:
                return int(recon[rr, cols - 1])
            return int(recon[rr, cc])

        col = 0
        while col < cols:
            rb = sample(row - 1, col)
            rd = sample(row - 1, col + 1) if col + 1 < cols else rb
            if col == 0:
                ra = rb
                rc = int(recon[row - 2, 0]) if row >= 2 else 0
            else:
                ra = int(recon[row, col - 1])
                rc = sample(row - 1, col - 1)
            q, sign = st.context(rd - rb, rb - rc, rc - ra)
            x = int(arr[row, col])
            if q == 0:
                # ---- run mode (A.7) --------------------------------------
                runval = ra
                runcnt = 0
                while abs(int(arr[row, col]) - runval) <= near:
                    recon[row, col] = runval if near else int(arr[row, col])
                    runcnt += 1
                    col += 1
                    if col == cols:
                        break
                eol = col == cols
                while runcnt >= (1 << _J[st.run_index]):
                    w.write(1, 1)
                    runcnt -= (1 << _J[st.run_index])
                    if st.run_index < 31:
                        st.run_index += 1
                if eol:
                    if runcnt > 0:
                        w.write(1, 1)
                    continue
                w.write(0, 1)
                if _J[st.run_index]:
                    w.write(runcnt, _J[st.run_index])
                # run interruption sample (A.7.2)
                x = int(arr[row, col])
                rb = sample(row - 1, col)
                ra = int(recon[row, col - 1]) if col else sample(row - 1, 0)
                ritype = 1 if abs(ra - rb) <= near else 0
                px = ra if ritype else rb
                errval = x - px
                if ritype == 0 and ra > rb:
                    errval = -errval
                    ri_sign = -1
                else:
                    ri_sign = 1
                if near:
                    errval = (errval + near) // (2 * near + 1) if errval > 0 \
                        else -((near - errval) // (2 * near + 1))
                errval = st.mod_range(errval)
                k = st.ri_golomb_k(ritype)
                qn, n = st.Nn[ritype], st.N[365 + ritype]
                if errval > 0 and k == 0 and 2 * qn < n:
                    emap = 1
                elif errval < 0 and ((k == 0 and 2 * qn >= n) or k != 0):
                    emap = 1
                else:
                    emap = 0
                emerrval = 2 * abs(errval) - ritype - emap
                _golomb_write(w, emerrval, k,
                              st.limit - _J[st.run_index] - 1, st.qbpp)
                st.ri_update(ritype, errval, emerrval)
                if st.run_index > 0:
                    st.run_index -= 1
                recon[row, col] = _reconstruct(st, px, ri_sign * errval)
                col += 1
                continue
            # ---- regular mode (A.4-A.6) ----------------------------------
            px = _med(ra, rb, rc)
            px += sign * st.C[q]
            px = max(0, min(maxval, px))
            errval = x - px
            if sign < 0:
                errval = -errval
            if near:
                errval = (errval + near) // (2 * near + 1) if errval > 0 \
                    else -((near - errval) // (2 * near + 1))
            errval = st.mod_range(errval)
            k = st.golomb_k(q)
            if near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]:
                merrval = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
            else:
                merrval = 2 * errval if errval >= 0 else -2 * errval - 1
            _golomb_write(w, merrval, k, st.limit, st.qbpp)
            st.update_regular(q, errval)
            recon[row, col] = _reconstruct(st, px, sign * errval)
            col += 1
    w.flush(0)
    out += w.getvalue()
    out += b"\xFF\xD9"
    return bytes(out)


def decode_jpegls(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG-LS stream → uint16 (lossless or
    near-lossless; NEAR read from the SOS header)."""
    P = rows = cols = None
    near = 0
    sos_end = None
    maxval_override = None
    t_override = None
    reset = 64
    for marker, start, length, nxt in _read_markers(data):
        seg = data[start:start + length]
        if marker == 0xF7:  # SOF55
            P = seg[0]
            rows = int.from_bytes(seg[1:3], "big")
            cols = int.from_bytes(seg[3:5], "big")
            if seg[5] != 1:
                raise JpegDecodeError(f"{seg[5]}-component JPEG-LS "
                                      "(expected single-component DICOM)")
        elif marker == 0xF8:  # LSE
            if seg[0] == 1:
                maxval_override = int.from_bytes(seg[1:3], "big")
                t_override = (int.from_bytes(seg[3:5], "big"),
                              int.from_bytes(seg[5:7], "big"),
                              int.from_bytes(seg[7:9], "big"))
                reset = int.from_bytes(seg[9:11], "big") or 64
        elif marker == 0xDA:
            if seg[0] != 1:
                raise JpegDecodeError("expected a single scan component")
            near = seg[3]
            if seg[4] != 0:
                raise JpegDecodeError("interleaved JPEG-LS not supported")
            sos_end = start + length
    if P is None or sos_end is None:
        raise JpegDecodeError("missing SOF55/SOS markers")
    if not 2 <= P <= 16:
        raise JpegDecodeError(f"bad JPEG-LS precision P={P}")
    maxval = maxval_override if maxval_override else (1 << P) - 1
    if t_override and any(t_override):
        t1, t2, t3 = t_override
    else:
        t1, t2, t3 = _jls_default_thresholds(maxval, near)
    st = _JlsState(maxval, near, t1, t2, t3, reset)

    r = _BitReader(data, sos_end, "jpegls")
    recon = np.zeros((rows, cols), np.int64)

    for row in range(rows):
        col = 0
        while col < cols:
            rb = int(recon[row - 1, col]) if row else 0
            if col + 1 < cols:
                rd = int(recon[row - 1, col + 1]) if row else 0
            else:
                rd = rb
            if col == 0:
                ra = rb
                rc = int(recon[row - 2, 0]) if row >= 2 else 0
            else:
                ra = int(recon[row, col - 1])
                rc = int(recon[row - 1, col - 1]) if row else 0
            q, sign = st.context(rd - rb, rb - rc, rc - ra)
            if q == 0:
                # ---- run mode --------------------------------------------
                runval = ra
                broke = False
                while True:
                    if r.read_bit() == 1:
                        seg_len = 1 << _J[st.run_index]
                        n = min(seg_len, cols - col)
                        recon[row, col:col + n] = runval
                        col += n
                        if n == seg_len and st.run_index < 31:
                            st.run_index += 1
                        if col == cols:
                            broke = True
                            break
                    else:
                        if _J[st.run_index]:
                            n = r.read(_J[st.run_index])
                        else:
                            n = 0
                        if n > cols - col - 1:
                            # a '0' segment must leave room for its
                            # interruption sample
                            raise JpegDecodeError(
                                "run literal overruns the line")
                        recon[row, col:col + n] = runval
                        col += n
                        break
                if broke:
                    continue
                # run interruption sample
                rb = int(recon[row - 1, col]) if row else 0
                ra = int(recon[row, col - 1]) if col else \
                    (int(recon[row - 1, 0]) if row else 0)
                ritype = 1 if abs(ra - rb) <= near else 0
                px = ra if ritype else rb
                ri_sign = -1 if (ritype == 0 and ra > rb) else 1
                k = st.ri_golomb_k(ritype)
                emerrval = _golomb_read(r, k, st.limit - _J[st.run_index] - 1,
                                        st.qbpp)
                temp = emerrval + ritype
                emap = temp & 1
                errvalabs = (temp + emap) // 2
                qn, n_ = st.Nn[ritype], st.N[365 + ritype]
                neg_pred = 1 if (k != 0 or 2 * qn >= n_) else 0
                errval = -errvalabs if emap == neg_pred else errvalabs
                st.ri_update(ritype, errval, emerrval)
                if st.run_index > 0:
                    st.run_index -= 1
                recon[row, col] = _reconstruct(st, px, ri_sign * errval)
                col += 1
                continue
            # ---- regular mode --------------------------------------------
            px = _med(ra, rb, rc)
            px += sign * st.C[q]
            px = max(0, min(maxval, px))
            k = st.golomb_k(q)
            merrval = _golomb_read(r, k, st.limit, st.qbpp)
            if near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]:
                errval = (merrval - 1) // 2 if merrval & 1 else \
                    -(merrval // 2) - 1
            else:
                errval = merrval // 2 if merrval % 2 == 0 else \
                    -((merrval + 1) // 2)
            st.update_regular(q, errval)
            recon[row, col] = _reconstruct(st, px, sign * errval)
            col += 1
    return recon.astype(np.uint16)


# ===========================================================================
# DICOM RLE (PS3.5 Annex G) — PackBits byte planes
# ===========================================================================


def encode_rle(img: np.ndarray) -> bytes:
    """Encode a 2-D uint8/uint16 array as a DICOM RLE frame."""
    img = np.asarray(img)
    nbytes = img.dtype.itemsize
    if nbytes not in (1, 2):
        raise ValueError("RLE supports 8/16-bit samples")
    flat = img.astype(f"<u{nbytes}" if img.dtype.kind == "u"
                      else f"<i{nbytes}").tobytes()
    # byte planes, most significant first (PS3.5 G.2)
    planes = [flat[nbytes - 1 - p::nbytes] for p in range(nbytes)]
    segs = [_packbits_encode(p) for p in planes]
    header = [len(segs)]
    off = 64
    for s in segs:
        header.append(off)
        off += len(s)
    header += [0] * (16 - len(header))
    out = b"".join(v.to_bytes(4, "little") for v in header) + b"".join(segs)
    if len(out) % 2:
        out += b"\x00"
    return out


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        lit_start = i
        i += 1
        while i < n and (len(bytes_run := data[i:i + 3]) < 3 or
                         not (bytes_run[0] == bytes_run[1] == bytes_run[2])) \
                and i - lit_start < 128:
            i += 1
        out.append(i - lit_start - 1)
        out += data[lit_start:i]
    if len(out) % 2:
        out.append(0)
    return bytes(out)


def _packbits_decode(data: bytes, expect: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expect:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += bytes([data[i]]) * (257 - h)
            i += 1
        # h == 128: no-op
    if len(out) < expect:
        raise JpegDecodeError(
            f"RLE segment underflow: {len(out)} < {expect}")
    return bytes(out[:expect])


def decode_rle(data: bytes, rows: int, cols: int,
               bytes_per_sample: int) -> np.ndarray:
    """Decode one DICOM RLE frame → (rows, cols) uint8/uint16."""
    if len(data) < 64:
        raise JpegDecodeError("RLE frame shorter than its 64-byte header")
    header = [int.from_bytes(data[i * 4:(i + 1) * 4], "little")
              for i in range(16)]
    nseg = header[0]
    if nseg != bytes_per_sample:
        raise JpegDecodeError(
            f"RLE frame has {nseg} segments; expected {bytes_per_sample} "
            "(single-sample images)")
    npix = rows * cols
    offsets = header[1:1 + nseg] + [len(data)]
    planes = []
    for s in range(nseg):
        seg = data[offsets[s]:offsets[s + 1]]
        planes.append(_packbits_decode(seg, npix))
    out = bytearray(npix * bytes_per_sample)
    for p, plane in enumerate(planes):  # MSB plane first
        out[bytes_per_sample - 1 - p::bytes_per_sample] = plane
    dtype = np.uint8 if bytes_per_sample == 1 else np.dtype("<u2")
    return np.frombuffer(bytes(out), dtype=dtype).reshape(rows, cols)

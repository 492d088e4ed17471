"""Test-side JPEG writers for the forms neither PIL nor OpenCV writes:
arithmetic-coded files (SOF9 sequential, SOF10 progressive; T.81 annexes D,
F.1.4 and G.1.3, as libjpeg's jcarith.c codes them) and lossless files
(SOF3, Huffman-coded sample differences by predictors 1-7 with a point
transform; T.81 annex H).  They code what they are given: seeded quantized
coefficient blocks, or samples, with no forward DCT, so the only decoders
that ever see these files are PIL's (libjpeg-turbo, the reference) and the
port's.
"""

import struct

import numpy as np

# T.81 table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
_QE = [(0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0),
       (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0), (0x001a, 33, 10, 0),
       (0x000d, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
       (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
       (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0), (0x0406, 49, 25, 0),
       (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
       (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0),
       (0x002c, 33, 9, 0), (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
       (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
       (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
       (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0),
       (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
       (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1),
       (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0),
       (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0), (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
       (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
       (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0), (0x34ee, 91, 85, 0),
       (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
       (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0),
       (0x56a8, 95, 96, 1), (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
       (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0),
       (0x4639, 107, 104, 0), (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0),
       (0x4b85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
       (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
FIXED = 113  # the state of the fixed estimate 0.5


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class ArithEncoder:
    """The QM coder of T.81 annex D with libjpeg's byte output (carry
    propagation through stacked 0xFF bytes, zero stuffing, and final zero
    bytes left out)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def _put_buffer(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._flush_zeros()
            self._emit(self.buffer)
        if self.sc:
            self._flush_zeros()
            for _ in range(self.sc):
                self._emit(0xFF)
                self._emit(0)
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self._flush_zeros()
            self._emit(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self._emit(0)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st: list, i: int, val: int):
        """Code decision `val` with the estimate in st[i] (a state, MPS in bit 7)."""
        sv = st[i]
        qe, nl, nm, sw = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nl | (sw << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._put_buffer()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        """Terminate the coded segment (D.1.8)."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._put_buffer()
        if self.c & 0x7FFF800:
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        self.zc = 0


def _shift(v, al):
    """A coefficient's magnitude after the point transform, with its sign."""
    return (v >> al) if v >= 0 else -((-v) >> al)


class _ArithScanCoder:
    """The statistics of one scan and the procedures of jcarith.c."""

    def __init__(self, enc, dac_l, dac_u, dac_k):
        self.e = enc
        self.dc_stats = {t: [0] * 64 for t in range(16)}
        self.ac_stats = {t: [0] * 256 for t in range(16)}
        self.fixed = [FIXED]
        self.dac_l, self.dac_u, self.dac_k = dac_l, dac_u, dac_k

    def magnitude(self, st, i, v, x_bins, x_start):
        """F.8 and F.9 for |v| - 1 = v, the first decision at st[i]."""
        e = self.e
        m = 0
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            if x_start is None:  # DC: X1 at 20
                i = 20
                while v2 >> 1:
                    v2 >>= 1
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
            else:  # AC: the second decision at the same bin, then X2 onwards
                v2 >>= 1
                if v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    st, i = x_bins, x_start
                    while v2 >> 1:
                        v2 >>= 1
                        e.encode(st, i, 1)
                        m <<= 1
                        i += 1
        e.encode(st, i, 0)
        return st, i, m

    def dc(self, tbl, ctx, diff):
        """One DC difference; returns the next conditioning context."""
        e, st = self.e, self.dc_stats[tbl]
        if diff == 0:
            e.encode(st, ctx, 0)
            return 0
        e.encode(st, ctx, 1)
        if diff > 0:
            e.encode(st, ctx + 1, 0)
            i, nctx, v = ctx + 2, 4, diff
        else:
            e.encode(st, ctx + 1, 1)
            i, nctx, v = ctx + 3, 8, -diff
        v -= 1
        st2, i, m = self.magnitude(st, i, v, None, None)
        if m < (1 << self.dac_l[tbl]) >> 1:
            nctx = 0
        elif m > (1 << self.dac_u[tbl]) >> 1:
            nctx += 8
        i += 14
        while m >> 1:
            m >>= 1
            e.encode(st2, i, 1 if m & v else 0)
        return nctx

    def ac(self, tbl, zz, ss, se, al):
        """AC coefficients ss-se of a block (zigzag order), first scan."""
        e, st = self.e, self.ac_stats[tbl]
        ke = se
        while ke >= ss and _shift(int(zz[ke]), al) == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while _shift(int(zz[k]), al) == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            v = _shift(int(zz[k]), al)
            e.encode(st, i + 1, 1)
            e.encode(self.fixed, 0, 0 if v > 0 else 1)
            v = abs(v) - 1
            x_start = 189 if k <= self.dac_k[tbl] else 217
            st2, j, m = self.magnitude(st, i + 2, v, st, x_start)
            j += 14
            while m >> 1:
                m >>= 1
                e.encode(st2, j, 1 if m & v else 0)
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl, zz, ss, se, ah, al):
        e, st = self.e, self.ac_stats[tbl]
        ke = se
        while ke > 0 and (abs(int(zz[ke])) >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (abs(int(zz[kex])) >> ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = int(zz[k])
                mag = abs(v) >> al
                if mag:
                    if mag >> 1:
                        e.encode(st, i + 2, mag & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, 0 if v > 0 else 1)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


SEQUENTIAL = [((0, 1, 2, 3), 0, 63, 0, 0)]
# (components, Ss, Se, Ah, Al): libjpeg's jpeg_simple_progression for YCbCr,
# one scan of each kind with every component where it may have them
PROGRESSION = [((0, 1, 2, 3), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
               ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2, 3), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
               ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0), ((3,), 1, 63, 0, 0)]


def random_blocks(rng, blocks_h, blocks_w, scale=1.0):
    """[bh, bw, 64] int16 quantized coefficients in zigzag order: a smooth
    DC field and AC values that shrink with frequency, many zeros."""
    dc = np.cumsum(np.cumsum(rng.randint(-6, 7, (blocks_h, blocks_w)), 0), 1)
    dc = np.clip(dc * 4, -900, 900)
    k = np.arange(64)
    ac = np.round(rng.laplace(0, 1, (blocks_h, blocks_w, 64)) * scale * 40 / (1 + k)).astype(np.int64)
    ac[rng.rand(blocks_h, blocks_w, 64) < 0.4] = 0
    ac[..., 0] = dc
    return np.clip(ac, -1000, 1000).astype(np.int16)


def arith_jpeg(h, w, sampling, blocks, qtables=None, progressive=False, restart=0, dac=None, ids=None,
               markers=b"", script=None):
    """An arithmetic-coded JPEG of h x w pixels.  sampling: (h, v) a
    component; blocks: one [bh, bw, 64] zigzag array a component, at least
    the component's blocks of the MCU grid (bh = mcu rows x v for more than
    one component, else the component's own rows); qtables: one [64] array
    (zigzag) a component (default: all 1 for the first, 2 for the rest);
    dac: {(class, table): value} conditioning; ids: component ids; markers:
    segments (APPn) after the SOI; script: the scans as PROGRESSION
    (components past the frame's are left out; default PROGRESSION for a
    progressive file, SEQUENTIAL, one scan of every component, else)."""
    nc = len(sampling)
    ids = ids or list(range(1, nc + 1))
    qtables = qtables or [np.full(64, 1 if i == 0 else 2) for i in range(nc)]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    out = bytearray(b"\xff\xd8") + markers
    for i, q in enumerate(qtables):
        out += segment(0xDB, bytes([i]) + bytes(int(x) for x in q))
    dac = dac or {}
    dac_l, dac_u, dac_k = [0] * 16, [1] * 16, [5] * 16
    if dac:
        body = b""
        for (tc, tb), val in dac.items():
            body += bytes([(tc << 4) | tb, val])
            if tc:
                dac_k[tb] = val
            else:
                dac_l[tb], dac_u[tb] = val & 15, val >> 4
        out += segment(0xCC, body)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        struct.pack(">BBB", ids[i], (sampling[i][0] << 4) | sampling[i][1], i) for i in range(nc))
    out += segment(0xCA if progressive else 0xC9, sof)
    scans = script or (PROGRESSION if progressive else SEQUENTIAL)
    for comps, ss, se, ah, al in scans:
        comps = [c for c in comps if c < nc]
        if not comps or (ss and len(comps) != 1):
            continue
        # table ids: DC table = component index, AC table = component index + 4 (any of 0-15)
        sos = bytes([len(comps)]) + b"".join(bytes([ids[c], (c << 4) | ((c + 4) & 15)]) for c in comps)
        out += segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        out += _arith_scan(h, w, sampling, hmax, vmax, blocks, comps, ss, se, ah, al, progressive, restart,
                           dac_l, dac_u, dac_k)
    return bytes(out + b"\xff\xd9")


def _mcu_blocks(h, w, sampling, hmax, vmax, comps):
    """The (component, block row, block column) of each block, MCU by MCU."""
    nc = len(sampling)
    if len(comps) == 1:
        c = comps[0]
        ch, cv = sampling[c] if nc > 1 else (1, 1)
        hm, vm = (hmax, vmax) if nc > 1 else (1, 1)
        dw, dh = -(-w * ch // hm), -(-h * cv // vm)
        return [[(c, by, bx)] for by in range(-(-dh // 8)) for bx in range(-(-dw // 8))]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    mcus = []
    for my in range(mcuy):
        for mx in range(mcux):
            mcus.append([(c, my * sampling[c][1] + y, mx * sampling[c][0] + x) for c in comps
                         for y in range(sampling[c][1]) for x in range(sampling[c][0])])
    return mcus


def _arith_scan(h, w, sampling, hmax, vmax, blocks, comps, ss, se, ah, al, progressive, restart, dac_l, dac_u,
                dac_k):
    enc = ArithEncoder()
    coder = _ArithScanCoder(enc, dac_l, dac_u, dac_k)
    last = {c: 0 for c in comps}
    ctx = {c: 0 for c in comps}
    data = bytearray()
    mcus = _mcu_blocks(h, w, sampling, hmax, vmax, comps)
    for n, mcu in enumerate(mcus):
        if restart and n and n % restart == 0:
            enc.finish()
            data += enc.out + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            enc.out = bytearray()
            enc.reset()
            coder = _ArithScanCoder(enc, dac_l, dac_u, dac_k)
            last = {c: 0 for c in comps}
            ctx = {c: 0 for c in comps}
        for c, by, bx in mcu:
            zz = blocks[c][by, bx]
            if not progressive or (ss == 0 and ah == 0):
                dcv = int(zz[0]) >> al if progressive else int(zz[0])
                ctx[c] = coder.dc(c, ctx[c], dcv - last[c])
                last[c] = dcv
            if progressive and ss == 0 and ah:
                enc.encode(coder.fixed, 0, (int(zz[0]) >> al) & 1)
            if not progressive:
                coder.ac((c + 4) & 15, zz, 1, 63, 0)
            elif ss and not ah:
                coder.ac((c + 4) & 15, zz, ss, se, al)
            elif ss:
                coder.ac_refine((c + 4) & 15, zz, ss, se, ah, al)
    enc.finish()
    return bytes(data + enc.out)


# A DC-class Huffman table for the lossless categories 0-16 (code lengths
# 3-7, canonical codes), and the same lengths for the symbols reversed.
LOSSLESS_COUNTS = [0, 0, 4, 4, 4, 4, 1] + [0] * 9
LOSSLESS_TABLES = (list(range(17)), list(range(16, -1, -1)))


def _huffman_codes(counts, symbols):
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        """Pad the last byte with 1 bits."""
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _predict(rows, y, x, psv, first):
    """The prediction of sample (y, x) as the lossless decoder makes it."""
    if first:
        return rows[y, x - 1] if x else None
    if x == 0:
        return rows[y - 1, 0]
    ra, rb, rc = int(rows[y, x - 1]), int(rows[y - 1, x]), int(rows[y - 1, x - 1])
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
            7: (ra + rb) >> 1}[psv]


def lossless_jpeg(samples, sampling, psv, pt=0, restart=0, ids=None, markers=b"", scans=None,
                  precision=8):
    """A lossless (SOF3) JPEG of samples, one [dh, dw] uint8 array a
    component at its sampled size; predictor psv (1-7), point transform pt;
    restart: the interval in MCUs (a whole number of MCU rows); scans: the
    component groups, each one scan (default: all in one); component i
    codes with Huffman table i % 2 (LOSSLESS_TABLES)."""
    nc = len(samples)
    ids = ids or list(range(1, nc + 1))
    scans = scans or [tuple(range(nc))]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    h = samples[0].shape[0] * vmax // sampling[0][1]  # the first component is the fullest sampled
    w = samples[0].shape[1] * hmax // sampling[0][0]
    out = bytearray(b"\xff\xd8") + markers
    for t, symbols in enumerate(LOSSLESS_TABLES):
        out += segment(0xC4, bytes([t]) + bytes(LOSSLESS_COUNTS) + bytes(symbols))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += segment(0xC3, struct.pack(">BHHB", precision, h, w, nc) + b"".join(
        struct.pack(">BBB", ids[i], (sampling[i][0] << 4) | sampling[i][1], 0) for i in range(nc)))
    codes = [_huffman_codes(LOSSLESS_COUNTS, symbols) for symbols in LOSSLESS_TABLES]
    for comps in scans:
        out += segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], (c % 2) << 4]) for c in comps) +
                       bytes([psv, 0, pt]))
        out += _lossless_scan(samples, sampling, comps, h, w, hmax, vmax, psv, pt, restart, codes)
    return bytes(out + b"\xff\xd9")


def _lossless_scan(samples, sampling, comps, h, w, hmax, vmax, psv, pt, restart, codes):
    nc = len(samples)
    inter = len(comps) > 1
    if inter:
        mcux, mcuy = -(-w // hmax), -(-h // vmax)
    else:
        c = comps[0]
        mcux, mcuy = samples[c].shape[1], samples[c].shape[0]
    rst_rows = restart // mcux if restart else 0
    diffs = {}
    for c in comps:
        x = samples[c].astype(np.int64) >> pt
        dh, dw = x.shape
        d = np.zeros_like(x)
        v = sampling[c][1] if inter and nc > 1 else 1
        for y in range(dh):
            mcu_row = y // v
            first = y % v == 0 and (mcu_row == 0 or (rst_rows and mcu_row % rst_rows == 0))
            for xx in range(dw):
                p = _predict(x, y, xx, psv, first)
                p = (1 << (8 - pt - 1)) if p is None else p
                d[y, xx] = ((int(x[y, xx]) - p + 32768) & 0xFFFF) - 32768
        diffs[c] = d
    bw = _BitWriter()
    data = bytearray()
    n = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n and n % restart == 0:
                bw.flush()
                data += bw.out + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                bw = _BitWriter()
            n += 1
            for c in comps:
                ch, cv = sampling[c] if inter else (1, 1)
                for by in range(cv):
                    for bx in range(ch):
                        y, x = my * cv + by, mx * ch + bx
                        d = diffs[c]
                        diff = int(d[y, x]) if y < d.shape[0] and x < d.shape[1] else 0
                        cat = 16 if diff == -32768 else abs(diff).bit_length()
                        code, length = codes[c % 2][cat]
                        bw.put(code, length)
                        if 0 < cat < 16:
                            bw.put(diff if diff > 0 else diff + (1 << cat) - 1, cat)
    bw.flush()
    return bytes(data + bw.out)

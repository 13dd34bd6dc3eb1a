"""Baseline JPEG (SOF0) decoder in numpy and the standard library.

Counterpart of ``tpu_rt/scene/jpeg.py`` (the ``bitmap`` texture's JPEG
reader), the same code, after ITU T.81 annex F: baseline DCT (SOF0 and
SOF1), 8-bit, grayscale or YCbCr with any sampling factors, restart
markers.  A progressive JPEG (SOF2) is handed to PIL where PIL can be
imported and raises ``ValueError`` otherwise, as in ``tpu_rt``.

Entropy decoding is the canonical mincode / maxcode walk (T.81 F.2.2.3);
the IDCT is one 8x8 DCT-III matrix sandwich over all blocks of a component
at once.  Chroma is upsampled by pixel replication (libjpeg's "fast"
mode).
"""

from __future__ import annotations

import struct

import numpy as np

from tpu_rt_torch.scene.png import srgb_to_linear

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# 8x8 DCT-II basis; IDCT(block) = M.T @ block @ M with orthonormal scaling.
_M = np.zeros((8, 8), np.float64)
for _k in range(8):
    for _n in range(8):
        c = np.sqrt(0.125) if _k == 0 else 0.5
        _M[_k, _n] = c * np.cos((2 * _n + 1) * _k * np.pi / 16.0)


class _Huff:
    """Canonical JPEG Huffman table (T.81 F.2.2.3 decode walk)."""

    def __init__(self, counts, symbols):
        self.mincode = np.zeros(17, np.int64)
        self.maxcode = np.full(17, -1, np.int64)
        self.valptr = np.zeros(17, np.int64)
        self.symbols = symbols
        code = 0
        k = 0
        for l in range(1, 17):
            n = counts[l - 1]
            if n:
                self.valptr[l] = k
                self.mincode[l] = code
                code += n
                k += n
                self.maxcode[l] = code - 1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over an entropy-coded segment (0xFF00
    destuffed on the fly; any other marker byte ends the stream)."""

    def __init__(self, data, pos):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.n = 0

    def _byte(self):
        d, p = self.data, self.pos
        if p >= len(d):
            return 0
        b = d[p]
        self.pos = p + 1
        if b == 0xFF:
            nxt = d[self.pos] if self.pos < len(d) else 0xD9
            if nxt == 0x00:
                self.pos += 1
            else:  # marker — rewind, pad with zeros (caller handles RST)
                self.pos = p
                return 0
        return b

    def bit(self):
        if self.n == 0:
            self.buf = self._byte()
            self.n = 8
        self.n -= 1
        return (self.buf >> self.n) & 1

    def bits(self, count):
        v = 0
        for _ in range(count):
            v = (v << 1) | self.bit()
        return v

    def huff(self, table: _Huff):
        code = 0
        for l in range(1, 17):
            code = (code << 1) | self.bit()
            if code <= table.maxcode[l]:
                return table.symbols[table.valptr[l] + code - table.mincode[l]]
        raise ValueError("JPEG: invalid Huffman code")

    def at_marker(self):
        """Skip to byte boundary; True if positioned at a marker."""
        self.n = 0
        return (self.pos + 1 < len(self.data) and self.data[self.pos] == 0xFF
                and self.data[self.pos + 1] != 0x00)


def _extend(v, nbits):
    """T.81 F.2.2.1 sign extension of a magnitude-coded value."""
    if nbits == 0:
        return 0
    return v if v >= (1 << (nbits - 1)) else v - (1 << nbits) + 1


def read_jpeg(path: str, srgb: bool = True) -> np.ndarray:
    """Decode a JPEG file to float32 (H, W, C) in [0, 1] (linear if srgb)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")

    qt = {}
    huff_dc = {}
    huff_ac = {}
    frame = None
    restart_interval = 0
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: bad marker sync at {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        (seg_len,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + seg_len]
        pos += 2 + seg_len

        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                prec, tid = body[i] >> 4, body[i] & 15
                n = 64 * (2 if prec else 1)
                raw = body[i + 1:i + 1 + n]
                tbl = (np.frombuffer(raw, ">u2") if prec
                       else np.frombuffer(raw, np.uint8)).astype(np.float64)
                q = np.zeros(64, np.float64)
                q[_ZIGZAG] = tbl
                qt[tid] = q.reshape(8, 8)
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                cls, tid = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                total = sum(counts)
                syms = list(body[i + 17:i + 17 + total])
                (huff_ac if cls else huff_dc)[tid] = _Huff(counts, syms)
                i += 17 + total
        elif marker in (0xC0, 0xC1):  # SOF0/1 baseline(+ext sequential)
            prec, h, w, nc = body[0], *struct.unpack(">HH", body[1:5]), body[5]
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG unsupported")
            comps = []
            for c in range(nc):
                cid, samp, tq = body[6 + 3 * c:9 + 3 * c]
                comps.append(dict(id=cid, hs=samp >> 4, vs=samp & 15, tq=tq))
            frame = dict(h=h, w=w, comps=comps)
        elif marker == 0xC2:  # progressive: delegated (see the module docstring)
            try:
                from PIL import Image
            except ImportError:
                raise ValueError(
                    f"{path}: progressive JPEG (SOF2) needs PIL, unavailable")
            arr = np.asarray(Image.open(path).convert("RGB"),
                             np.uint8).astype(np.float32) / 255.0
            return srgb_to_linear(arr) if srgb else arr
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError(f"{path}: SOF{marker & 15} process unsupported")
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:  # SOS — entropy-coded data follows
            if frame is None:
                raise ValueError(f"{path}: SOS before SOF")
            ns = body[0]
            scan = []
            for c in range(ns):
                cs, tables = body[1 + 2 * c], body[2 + 2 * c]
                comp = next(x for x in frame["comps"] if x["id"] == cs)
                scan.append((comp, tables >> 4, tables & 15))
            img = _decode_scan(data, pos, frame, scan, qt, huff_dc, huff_ac,
                               restart_interval)
            arr = img.astype(np.float32) / 255.0
            return srgb_to_linear(arr) if srgb else arr
    raise ValueError(f"{path}: no scan data found")


def _decode_scan(data, pos, frame, scan, qt, huff_dc, huff_ac, dri):
    h, w, comps = frame["h"], frame["w"], frame["comps"]
    hmax = max(c["hs"] for c in comps)
    vmax = max(c["vs"] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))

    # Per-component zig-zag coefficient stacks, filled MCU-interleaved.
    coefs = {c["id"]: np.zeros((mcuy * c["vs"], mcux * c["hs"], 64),
                               np.float64) for c in comps}
    pred = {c["id"]: 0 for c in comps}
    br = _BitReader(data, pos)
    mcu = 0
    n_mcu = mcux * mcuy
    while mcu < n_mcu:
        my, mx = divmod(mcu, mcux)
        for comp, tdc, tac in scan:
            cid = comp["id"]
            dc_t, ac_t = huff_dc[tdc], huff_ac[tac]
            for v in range(comp["vs"]):
                for u in range(comp["hs"]):
                    blk = coefs[cid][my * comp["vs"] + v, mx * comp["hs"] + u]
                    s = br.huff(dc_t)
                    pred[cid] += _extend(br.bits(s), s)
                    blk[0] = pred[cid]
                    k = 1
                    while k < 64:
                        rs = br.huff(ac_t)
                        r, s = rs >> 4, rs & 15
                        if s == 0:
                            if r != 15:
                                break  # EOB
                            k += 16
                        else:
                            k += r
                            blk[k] = _extend(br.bits(s), s)
                            k += 1
        mcu += 1
        if dri and mcu % dri == 0 and mcu < n_mcu:
            if br.at_marker():  # RSTn: resync + reset DC predictors
                br.pos += 2
                br.n = 0
            for c in comps:
                pred[c["id"]] = 0

    # Dequantize + IDCT each component in one vectorized pass.
    planes = []
    for comp in comps:
        cid = comp["id"]
        by, bx, _ = coefs[cid].shape
        zz = coefs[cid].reshape(-1, 64)
        blocks = np.zeros((zz.shape[0], 64), np.float64)
        blocks[:, _ZIGZAG] = zz
        blocks = blocks.reshape(-1, 8, 8) * qt[comp["tq"]]
        spat = np.einsum("kj,njl,lm->nkm", _M.T, blocks, _M) + 128.0
        plane = (spat.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3)
                 .reshape(by * 8, bx * 8))
        # replicate to full sampling grid, crop to image size
        plane = np.repeat(np.repeat(plane, vmax // comp["vs"], 0),
                          hmax // comp["hs"], 1)[:h, :w]
        planes.append(plane)

    if len(planes) == 1:
        return np.clip(planes[0], 0, 255)[..., None].repeat(3, -1)
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], -1), 0, 255)

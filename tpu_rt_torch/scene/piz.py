"""PIZ (wavelet + Huffman) decompressor for OpenEXR scanline chunks.

Counterpart of ``tpu_rt/scene/piz.py``: the OpenEXR PIZ pipeline
(ImfPizCompressor / ImfHuf / ImfWav semantics) in Python and numpy, so a
PIZ-compressed environment map (compression 4) loads without an EXR
library.  ``scene/exr.py`` calls ``piz_uncompress`` once per chunk.

Chunk layout:
  u16 minNonZero, u16 maxNonZero
  u8  bitmap[maxNonZero - minNonZero + 1]      (when max >= min)
  i32 huf_length
  Huffman-coded data:
    u32 im, u32 iM, u32 tableLength, u32 nBits, u32 room
    bit-packed 6-bit code-length table (with zero-run codes 59..63)
    nBits of canonical-Huffman data (MSB-first), with RLE symbol == iM
  -> u16 indices; wavelet-decoded per channel; mapped through the reverse
     LUT from the bitmap.
"""

from __future__ import annotations

import struct

import numpy as np

HUF_ENCSIZE = 65537
SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6


class _BitReader:
    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def get(self, n):
        while self.nbits < n:
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v


def _unpack_enc_table(br: _BitReader, im, iM):
    hcode = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = br.get(8) + SHORTEST_LONG_RUN
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            i += zerun
        else:
            hcode[i] = l
            i += 1
    return hcode


def _canonical_codes(hcode):
    n = np.zeros(59, np.int64)
    lengths = hcode & 63
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    codes = np.zeros_like(hcode)
    for i in np.nonzero(lengths)[0]:
        l = lengths[i]
        codes[i] = n[l]
        n[l] += 1
    return codes, lengths


_DECBITS = 14


def _huf_decode(data: bytes, n_out: int):
    im, iM, _tlen, nbits, _room = struct.unpack_from("<IIIII", data, 0)
    br = _BitReader(data[20:])
    hcode = _unpack_enc_table(br, im, iM)
    codes, lengths = _canonical_codes(hcode)

    # Payload starts at the next whole byte after the packed table
    # (OpenEXR's hufUnpackEncTable drops partial-byte remainder bits).
    payload = data[20 + br.pos :]

    # Fast table: every 14-bit prefix -> (symbol, length) for codes <= 14
    # bits; longer codes go to a dict keyed by (length, code).
    flut_sym = np.full(1 << _DECBITS, -1, np.int32)
    flut_len = np.zeros(1 << _DECBITS, np.int8)
    long_table = {}
    for sym in np.nonzero(lengths)[0]:
        l = int(lengths[sym])
        c = int(codes[sym])
        if l <= _DECBITS:
            lo = c << (_DECBITS - l)
            hi = (c + 1) << (_DECBITS - l)
            flut_sym[lo:hi] = sym
            flut_len[lo:hi] = l
        else:
            long_table[(l, c)] = int(sym)
    flut_sym_l = flut_sym.tolist()
    flut_len_l = flut_len.tolist()

    out = np.zeros(n_out, np.uint16)
    oi = 0
    rlc = int(iM)
    acc = 0
    nacc = 0
    pos = 0
    consumed = 0  # bits consumed from the payload
    buf = payload
    buf_len = len(buf)
    mask14 = (1 << _DECBITS) - 1

    while oi < n_out and consumed < nbits:
        while nacc < _DECBITS and pos < buf_len:
            acc = (acc << 8) | buf[pos]
            pos += 1
            nacc += 8
        if nacc >= _DECBITS:
            peek = (acc >> (nacc - _DECBITS)) & mask14
        else:
            peek = (acc << (_DECBITS - nacc)) & mask14
        sym = flut_sym_l[peek]
        if sym >= 0:
            l = flut_len_l[peek]
        else:
            # long code: extend bit by bit beyond 14
            l = _DECBITS
            c = peek
            found = None
            while found is None and l < 59:
                l += 1
                while nacc < l and pos < buf_len:
                    acc = (acc << 8) | buf[pos]
                    pos += 1
                    nacc += 8
                c = (acc >> (nacc - l)) & ((1 << l) - 1)
                found = long_table.get((l, c))
            if found is None:
                break
            sym = found
        # consume l bits
        nacc -= l
        acc &= (1 << nacc) - 1
        consumed += l
        if sym == rlc:
            while nacc < 8 and pos < buf_len:
                acc = (acc << 8) | buf[pos]
                pos += 1
                nacc += 8
            cs = (acc >> (nacc - 8)) & 0xFF
            nacc -= 8
            acc &= (1 << nacc) - 1
            consumed += 8
            prev = out[oi - 1] if oi > 0 else 0
            out[oi : oi + cs] = prev
            oi += cs
        else:
            out[oi] = sym
            oi += 1
    return out


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    hi = hs
    ai = ls + (hi & 1) + (hi >> 1)
    a = ai.astype(np.int16)
    b = (ai - hi).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


def _wdec16(l, h):
    m = l.astype(np.int64)
    hh = h.astype(np.int64)
    bb = (m - (hh >> 1)) & _MOD_MASK
    aa = (hh + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(buf, nx, ox, ny, oy, mx):
    """In-place 2-D wavelet decode on a flat uint16 numpy array ``buf``."""
    w14 = mx < (1 << 14)
    wdec = _wdec14 if w14 else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    view = buf  # flat
    while p >= 1:
        oy1 = oy * p
        oy2 = oy * p2
        ox1 = ox * p
        ox2 = ox * p2

        py_idx = np.arange(0, oy * (ny - p2) + 1, oy2)
        px_idx = np.arange(0, ox * (nx - p2) + 1, ox2)
        if py_idx.size and px_idx.size:
            base = (py_idx[:, None] + px_idx[None, :]).ravel()
            i00 = view[base]
            i01 = view[base + ox1]
            i10 = view[base + oy1]
            i11 = view[base + oy1 + ox1]
            t00, t10 = wdec(i00, i10)
            t01, t11 = wdec(i01, i11)
            r00, r01 = wdec(t00, t01)
            r10, r11 = wdec(t10, t11)
            view[base] = r00
            view[base + ox1] = r01
            view[base + oy1] = r10
            view[base + oy1 + ox1] = r11

        if nx & p:  # odd remainder column at px = ox * (nx - p)
            col = ox * (nx - p)
            rows = py_idx + col
            if rows.size:
                i00 = view[rows]
                i10 = view[rows + oy1]
                a, b = wdec(i00, i10)
                view[rows] = a
                view[rows + oy1] = b

        if ny & p:  # odd remainder row at py = oy * (ny - p)
            row = oy * (ny - p)
            cols = px_idx + row
            if cols.size:
                i00 = view[cols]
                i01 = view[cols + ox1]
                a, b = wdec(i00, i01)
                view[cols] = a
                view[cols + ox1] = b

        p2 = p
        p >>= 1
    return view


def piz_uncompress(data: bytes, width: int, n_lines: int, channels):
    """Decompress one PIZ chunk.

    Args:
      data: raw chunk bytes.
      width: scanline width in pixels.
      n_lines: scanlines in this chunk.
      channels: list of (name, pixel_type) in file order; HALF (1) channels
        occupy one u16 each, FLOAT (2) / UINT (0) two u16s.
    Returns: list of per-channel uint16 arrays [n_lines, width * size].
    """
    min_nz, max_nz = struct.unpack_from("<HH", data, 0)
    off = 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(data[off : off + nb], np.uint8)
        off += nb
    (huf_len,) = struct.unpack_from("<i", data, off)
    off += 4

    # reverse LUT from bitmap
    bits = np.unpackbits(bitmap, bitorder="little")
    present = np.nonzero(bits)[0]
    if present.size == 0 or present[0] != 0:
        present = np.concatenate([[0], present])
    rlut = np.zeros(65536, np.uint16)
    rlut[: present.size] = present.astype(np.uint16)
    max_value = present.size - 1

    sizes = [1 if ptype == 1 else 2 for _, ptype in channels]
    n_total = sum(width * n_lines * s for s in sizes)
    out = _huf_decode(data[off : off + huf_len], n_total)

    # per-channel wavelet decode (FLOAT/UINT channels are two interleaved
    # u16 planes, each wavelet-coded with stride ``size``)
    pos = 0
    chans = []
    for (_name, _ptype), size in zip(channels, sizes):
        nx, ny = width, n_lines
        cbuf = out[pos : pos + nx * ny * size].copy()
        for j in range(size):
            sl = cbuf[j:]
            _wav2_decode(sl, nx, size, ny, nx * size, max_value)
            cbuf[j:] = sl
        chans.append(rlut[cbuf.reshape(ny, nx * size)])
        pos += nx * ny * size
    return chans

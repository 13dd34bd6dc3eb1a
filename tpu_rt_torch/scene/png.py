"""PNG reader: zlib inflate and per-scanline unfilter, stdlib and numpy.

Counterpart of ``tpu_rt/scene/png.py`` (the ``bitmap`` texture's PNG
reader), the same code.  Bit depth 8 or 16; colour types 0 (gray), 2
(RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA); Adam7 interlacing is
rejected.  Returns float32 in [0, 1], shape (H, W, C) with C in
{1, 2, 3, 4}; a palette image expands to RGB(A).

``read_png(..., srgb=True)`` (the default) applies the IEC 61966-2-1
decode to the colour channels, so a texture is linear by the time it
modulates a BSDF (Mitsuba's ``raw=false``); alpha stays linear.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"

# samples per pixel by color type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    """Paeth predictor over uint8 numpy vectors (int16 math)."""
    a = a.astype(np.int16)
    b = b.astype(np.int16)
    c = c.astype(np.int16)
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse the per-scanline filters; returns (H, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub — sequential in x, vectorized per byte lag
            for x in range(bpp, stride):
                line[x] = (int(line[x]) + int(line[x - bpp])) & 0xFF
        elif ftype == 2:  # Up
            line = (line.astype(np.int16) + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            for x in range(stride):
                left = int(line[x - bpp]) if x >= bpp else 0
                line[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else np.uint8(0)
                ul = prev[x - bpp] if x >= bpp else np.uint8(0)
                line[x] = (int(line[x]) + int(_paeth(
                    np.asarray([left]), prev[x:x + 1],
                    np.asarray([ul]))[0])) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = line
        prev = line
    return out


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 electro-optical transfer (x in [0, 1])."""
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def read_png(path: str, srgb: bool = True) -> np.ndarray:
    """Decode a PNG file to float32 (H, W, C) in [0, 1] (linear if srgb)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG file")

    pos = 8
    width = height = None
    bitdepth = colortype = None
    idat = []
    palette = None
    trns = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, comp, filt, interlace = \
                struct.unpack(">IIBBBBB", body)
            if interlace:
                raise ValueError(f"{path}: Adam7 interlacing unsupported")
            if bitdepth not in (8, 16):
                raise ValueError(f"{path}: bit depth {bitdepth} unsupported")
            if colortype not in _CHANNELS:
                raise ValueError(f"{path}: color type {colortype} unsupported")
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")

    raw = zlib.decompress(b"".join(idat))
    nch = _CHANNELS[colortype]
    bytes_per_sample = bitdepth // 8
    bpp = nch * bytes_per_sample
    stride = width * bpp
    flat = _unfilter(raw, height, stride, bpp)

    if bitdepth == 16:
        img = flat.reshape(height, width, nch, 2)
        vals = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
        arr = vals.astype(np.float32) / 65535.0
    else:
        arr = flat.reshape(height, width, nch).astype(np.float32) / 255.0

    if colortype == 3:  # palette -> RGB(A)
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        idx = (arr[..., 0] * 255.0 + 0.5).astype(np.int32)
        rgb = palette[idx].astype(np.float32) / 255.0
        if trns is not None:
            a = np.ones(256, np.float32)
            a[: len(trns)] = trns.astype(np.float32) / 255.0
            arr = np.concatenate([rgb, a[idx][..., None]], -1)
        else:
            arr = rgb
    elif colortype == 4:  # gray+alpha -> (H, W, 2) kept as-is
        pass

    if srgb:
        if arr.shape[-1] in (2, 4):  # alpha channel stays linear
            color = srgb_to_linear(arr[..., :-1])
            arr = np.concatenate([color, arr[..., -1:]], -1)
        else:
            arr = srgb_to_linear(arr)
    return np.ascontiguousarray(arr, np.float32)

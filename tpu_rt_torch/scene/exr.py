"""Minimal OpenEXR scanline reader: NONE, RLE, ZIPS, ZIP and PIZ compression.

Counterpart of ``tpu_rt/scene/exr.py`` (host code in numpy), the reader of
the ``envmap`` emitter's lat-long map.  Pixel types HALF, FLOAT and UINT;
the channels R, G, B, else Y, else the first one, come back as an (H, W, 3)
float32 RGB array.  PIZ chunks decode through ``scene/piz.py``.  Only an
unknown compression makes ``load_exr_or_fallback`` warn and return a
uniform gray map.
"""

from __future__ import annotations

import struct
import warnings
import zlib

import numpy as np

_PIXEL_SIZES = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}


def _read_attrs(buf, off):
    attrs = {}
    while buf[off] != 0:
        e = buf.index(b"\0", off)
        name = buf[off:e].decode()
        off = e + 1
        e = buf.index(b"\0", off)
        typ = buf[off:e].decode()
        off = e + 1
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        attrs[name] = (typ, buf[off : off + size])
        off += size
    return attrs, off + 1


def _parse_channels(raw):
    chans = []
    off = 0
    while raw[off] != 0:
        e = raw.index(b"\0", off)
        name = raw[off:e].decode()
        off = e + 1
        ptype, _plinear = struct.unpack_from("<iB", raw, off)
        off += 16  # pixel type, pLinear+reserved, xSampling, ySampling
        chans.append((name, ptype))
    return chans


def _unpredict_deinterleave(data: bytes) -> bytes:
    # predictor: d[i] = d[i-1] + raw[i] - 128, expressible as a prefix sum
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    d = np.cumsum(d - 128) + 128  # equivalent to the sequential recurrence
    d = (d & 0xFF).astype(np.uint8)
    # deinterleave two halves
    n = d.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _rle_decompress(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        count = struct.unpack_from("b", data, i)[0]
        i += 1
        if count < 0:
            out += data[i : i - count]
            i += -count
        else:
            out += data[i : i + 1] * (count + 1)
            i += 1
    return bytes(out)


def load_exr(path):
    """Returns an (H, W, 3) float32 RGB array."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"\x76\x2f\x31\x01":
        raise ValueError(f"{path}: not an EXR file")
    attrs, off = _read_attrs(buf, 8)
    chans = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1

    if comp == 0:  # NONE
        lines_per_block = 1

        def decomp(d, n):
            return d

    elif comp == 1:  # RLE
        lines_per_block = 1

        def decomp(d, n):
            return _unpredict_deinterleave(_rle_decompress(d)) if len(d) < n else d

    elif comp in (2, 3):  # ZIPS, ZIP
        lines_per_block = 1 if comp == 2 else 16

        def decomp(d, n):
            return _unpredict_deinterleave(zlib.decompress(d)) if len(d) < n else d

    elif comp == 4:  # PIZ (wavelet + Huffman)
        lines_per_block = 32
        decomp = None
    else:
        raise NotImplementedError(f"{path}: EXR compression {comp} not supported")

    n_blocks = (H + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)

    line_bytes = sum(W * _PIXEL_SIZES[pt] for _, pt in chans)
    img = {name: np.zeros((H, W), np.float32) for name, _ in chans}
    for o in offsets:
        y, size = struct.unpack_from("<ii", buf, o)
        data = buf[o + 8 : o + 8 + size]
        rows = min(lines_per_block, H - (y - ymin))
        if comp == 4:
            from tpu_rt_torch.scene.piz import piz_uncompress

            planes = piz_uncompress(data, W, rows, chans)
            for ci, (name, pt) in enumerate(chans):
                u16 = np.ascontiguousarray(planes[ci])
                if pt == 1:  # HALF
                    vals = u16.view(np.float16).astype(np.float32)
                elif pt == 2:  # FLOAT: u16 pairs -> f32
                    vals = u16.reshape(rows, W, 2).view(np.uint16).copy().view(
                        np.float32
                    )[..., 0]
                else:  # UINT
                    vals = (
                        u16.reshape(rows, W, 2)
                        .copy()
                        .view(np.uint32)[..., 0]
                        .astype(np.float32)
                    )
                img[name][y - ymin : y - ymin + rows] = vals
            continue
        raw = decomp(data, rows * line_bytes)
        pos = 0
        for r in range(rows):
            for name, pt in chans:
                nbytes = W * _PIXEL_SIZES[pt]
                arr = np.frombuffer(raw[pos : pos + nbytes], _PIXEL_DTYPES[pt])
                img[name][y - ymin + r] = arr.astype(np.float32)
                pos += nbytes

    if all(c in img for c in "RGB"):
        return np.stack([img["R"], img["G"], img["B"]], axis=-1)
    if "Y" in img:
        return np.repeat(img["Y"][..., None], 3, axis=-1)
    first = next(iter(img.values()))
    return np.repeat(first[..., None], 3, axis=-1)


def load_exr_or_fallback(path, fallback_value=0.5):
    try:
        return load_exr(path)
    except NotImplementedError as e:
        warnings.warn(f"{e}; using uniform gray environment")
        return np.full((8, 16, 3), fallback_value, np.float32)

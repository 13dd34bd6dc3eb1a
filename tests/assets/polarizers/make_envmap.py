"""Write the polarizers fixture's environment map, tests/assets/polarizers/envmap.exr.

    python tests/assets/polarizers/make_envmap.py            # envmap.exr, ZIP
    python tests/assets/polarizers/make_envmap.py --out x.exr --compression rle

A 256 x 512 lat-long map (the size of the reference scene's envmap.exr),
HALF RGB, in the layout both packages read (scene/exr.py): a smooth sky
over a darker ground and a small sun of radiance about 40, placed so that
``polarizers.xml``'s camera sees it beside the sheets once the envmap's
``to_world`` (ROTATION below, the same two rotations as the XML) turns the
map.  The sun's world direction is SUN_WORLD.

``write_exr`` is a minimal OpenEXR scanline writer with the NONE, RLE,
ZIPS and ZIP compressions (``zlib`` from the standard library), the HALF,
FLOAT and UINT pixel types; the tests use it to write the other variants,
and ``exr_bytes`` to wrap chunks they compress themselves (PIZ).
"""

import argparse
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 256, 512
# The envmap's to_world in polarizers.xml: rotate about y by 150 degrees,
# then about x by 20 (Mitsuba composes each later op on the left).
ROTATION = (((0.0, 1.0, 0.0), 150.0), ((1.0, 0.0, 0.0), 20.0))
SUN_WORLD = (-0.28, 0.18, 1.0)  # up and left of the view axis, beside the sheets
SUN_RADIUS_DEG = 3.0
SUN_RGB = (40.0, 38.0, 34.0)
COMPRESSION = {"none": 0, "rle": 1, "zips": 2, "zip": 3}  # PIZ is 4
_LINES = {0: 1, 1: 1, 2: 1, 3: 16}
_PIXEL = {"uint": (0, np.uint32), "half": (1, np.float16), "float": (2, np.float32)}


def _rotate(axis, angle_deg):
    """Rodrigues rotation, as the scene loaders' ``rotate``."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)]])


def to_world():
    m = np.eye(3)
    for axis, angle in ROTATION:
        m = _rotate(axis, angle) @ m
    return m


def uv_to_dir(u, v):
    """The map's lat-long convention (emitter/sample.py::_uv_to_dir)."""
    phi = (u - 0.5) * 2.0 * np.pi
    theta = v * np.pi
    return np.stack([np.sin(theta) * np.sin(phi), np.cos(theta),
                     -np.sin(theta) * np.cos(phi)], -1)


def sky(h=H, w=W):
    """(h, w, 3) float32 radiance: sky, ground and the sun."""
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
    d = uv_to_dir(u, v)
    y = d[..., 1]
    up = np.clip(y, 0.0, 1.0)[..., None]
    haze = (1.0 - up) ** 4
    rgb = (np.array([0.30, 0.50, 1.00]) * (0.4 + 0.6 * up) + 0.6 * haze) * (y >= 0.0)[..., None]
    ground = np.array([0.25, 0.22, 0.18]) * (0.5 + 0.5 * np.clip(-y, 0.0, 1.0))[..., None]
    rgb = rgb + ground * (y < 0.0)[..., None]
    sun = to_world().T @ (np.asarray(SUN_WORLD) / np.linalg.norm(SUN_WORLD))  # local frame
    ang = np.degrees(np.arccos(np.clip(d @ sun, -1.0, 1.0)))
    rgb = rgb + np.asarray(SUN_RGB) * (ang <= SUN_RADIUS_DEG)[..., None]
    rgb = rgb + 2.0 * np.exp(-(ang / 8.0) ** 2)[..., None]
    return rgb.astype(np.float32)


def _attr(name, typ, data):
    return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(data)) + data


def _predict_interleave(raw):
    """The ZIP / RLE byte preprocessing: even bytes then odd bytes, then
    the difference of neighbours plus 128."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def _rle(data):
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:  # a run of 3 to 128 equal bytes
            out += struct.pack("b", j - i) + data[i:i + 1]
            i = j + 1
            continue
        j = i  # literal bytes up to the next run of 3
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += struct.pack("b", -(j - i)) + data[i:j]
        i = j
    return bytes(out)


def exr_bytes(h, w, comp, ptype, chunks):
    """A scanline OpenEXR file of channels B, G, R (the format's
    alphabetical order) of pixel type ``ptype``, compression ``comp``,
    from its chunks' data, in order of their first lines."""
    chans = b"".join(c.encode() + b"\0" + struct.pack("<iB3xii", ptype, 0, 1, 1)
                     for c in "BGR") + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<i", 2)
              + _attr("channels", "chlist", chans)
              + _attr("compression", "compression", bytes([comp]))
              + _attr("dataWindow", "box2i", box) + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    lines = _LINES.get(comp, 32)  # PIZ: 32 lines a chunk
    chunks = [struct.pack("<ii", y, len(data)) + data
              for y, data in zip(range(0, h, lines), chunks)]
    offsets, pos = [], len(header) + 8 * len(chunks)
    for ch in chunks:
        offsets.append(pos)
        pos += len(ch)
    return header + struct.pack(f"<{len(offsets)}Q", *offsets) + b"".join(chunks)


def write_exr(path, rgb, compression="zip", pixel="half"):
    """Write an (h, w, 3) array as a scanline OpenEXR file (NONE, RLE,
    ZIPS or ZIP)."""
    comp = COMPRESSION[compression]
    ptype, dtype = _PIXEL[pixel]
    h, w = rgb.shape[:2]
    lines = _LINES[comp]
    vals = rgb.astype(dtype)
    chunks = []
    for y in range(0, h, lines):
        raw = b"".join(vals[r, :, c].tobytes() for r in range(y, min(y + lines, h))
                       for c in (2, 1, 0))
        data = raw
        if comp == 1:
            data = _rle(_predict_interleave(raw))
        elif comp in (2, 3):
            data = zlib.compress(_predict_interleave(raw), 9)
        if len(data) >= len(raw):
            data = raw  # stored: the reader takes a full-size chunk as it is
        chunks.append(data)
    with open(path, "wb") as f:
        f.write(exr_bytes(h, w, comp, ptype, chunks))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "envmap.exr"))
    ap.add_argument("--compression", default="zip", choices=sorted(COMPRESSION))
    args = ap.parse_args()
    write_exr(args.out, sky(), args.compression)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()

"""Write the textured-mesh fixtures beside this script.

* ``knot_uv.ply`` (2 240 triangles) and ``knot_69k_uv.ply`` (69 632): the
  torus-knot tubes of ``tests/assets/mesh/make_mesh.py`` with texture
  coordinates.  The seam ring and the seam side are duplicated, so that
  uv = (ring / segments, side / sides) runs from 0 to 1 without a jump;
  positions, normals and the triangle count are the knot's.  Binary PLY
  with ``float x y z nx ny nz u v``.
* ``checker.png``: 8-bit RGB, 1024 x 512, a two-colour checker of 32-pixel
  squares under a smooth colour ramp, written with ``zlib``; its rows use
  the five PNG filters (None, Sub, Up, Average, Paeth), so every unfilter
  path of a reader runs.
* ``gray16.png``: 16-bit gray + alpha, 48 x 40, the same filter mix.
* ``floor.jpg``: a baseline JPEG (SOF0), 512 x 512, 4:2:0 chroma, a
  restart marker every MCU row, written through PIL; skipped where PIL
  cannot be imported (the committed file serves).
* ``textured_gi.xml``: the bunny-class GI scene of
  ``tests/assets/mesh/mesh_big_gi.xml`` (256x256, 16 spp, max_depth 3,
  box filter) with ``knot_69k_uv.ply`` under the checker and the floor
  under ``floor.jpg``; ``textured_small.xml``: the same with
  ``knot_uv.ply`` at 32x32, for the CPU tests.

numpy and the standard library (PIL for the JPEG only), deterministic.

Run:  python tests/assets/textured/make_textured.py
"""

import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "mesh"))
from make_mesh import knot_mesh  # noqa: E402


def knot_uv_mesh(segments, sides):
    """(vertices, normals, uvs, faces) of ``knot_mesh(segments, sides)``
    with its seams duplicated: (segments + 1) x (sides + 1) vertices, the
    last ring and side copies of the first, each with its own uv."""
    verts, normals, _ = knot_mesh(segments, sides)
    i = np.arange(segments + 1)[:, None]
    k = np.arange(sides + 1)[None, :]
    src = ((i % segments) * sides + k % sides).reshape(-1)
    uv = np.stack(np.broadcast_arrays(i / segments, k / sides), -1).reshape(-1, 2)
    v, n = verts[src], normals[src]
    i, k = i[:-1], k[:, :-1]
    a = i * (sides + 1) + k
    b = (i + 1) * (sides + 1) + k
    faces = np.concatenate([np.stack([a, b, b + 1], -1).reshape(-1, 3),
                            np.stack([a, b + 1, a + 1], -1).reshape(-1, 3)], 0)
    # wind every face so that its geometric normal agrees with the tube's
    p0, p1, p2 = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
    ng = np.cross(p1 - p0, p2 - p0)
    flip = (ng * (n[faces[:, 0]] + n[faces[:, 1]] + n[faces[:, 2]])).sum(-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return v, n, uv.astype(np.float32), faces.astype(np.int32)


def write_ply_uv(path, verts, normals, uvs, faces):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        "comment (2,3) torus-knot tube with uvs, tests/assets/textured/make_textured.py\n"
        f"element vertex {verts.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property float u\nproperty float v\n"
        f"element face {faces.shape[0]}\n"
        "property list uchar int vertex_indices\nend_header\n")
    vrec = np.concatenate([verts, normals, uvs], 1).astype("<f4")
    frec = np.zeros(faces.shape[0], dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    frec["n"] = 3
    frec["idx"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def row_filter(y):
    """The PNG filter of row y: one row in 64 each of None, Sub, Average
    and Paeth (the readers unfilter the last three byte by byte in
    Python), Up elsewhere."""
    return {0: 0, 1: 1, 2: 3, 3: 4}.get(y % 64, 2)


def encode_png(samples, color_type, bit_depth):
    """A PNG of ``samples`` [H, W, C] (uint8 or uint16), each row through
    ``row_filter``."""
    h, w, c = samples.shape
    bps = bit_depth // 8
    rows = samples.astype(">u2" if bps == 2 else np.uint8).reshape(h, -1)
    rows = np.frombuffer(rows.tobytes(), np.uint8).reshape(h, w * c * bps).astype(np.int32)
    bpp = c * bps
    raw = bytearray()
    prev = np.zeros(w * c * bps, np.int32)
    for y in range(h):
        line = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = row_filter(y)
        if f == 0:
            pred = np.zeros_like(line)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        raw.append(f)
        raw += ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = line

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9)) + chunk(b"IEND", b""))


def checker_image(h=512, w=1024, square=32):
    y, x = np.mgrid[0:h, 0:w]
    odd = ((x // square) + (y // square)) % 2
    ramp = np.stack([x / (w - 1), y / (h - 1), 1.0 - x / (w - 1)], -1)
    light = 0.55 + 0.4 * ramp
    dark = 0.08 + 0.12 * ramp[..., ::-1]
    img = np.where(odd[..., None] == 1, light, dark)
    return np.round(img * 255).astype(np.uint8)


def gray16_image(h=40, w=48):
    y, x = np.mgrid[0:h, 0:w]
    gray = (x * 1361 + y * 977) % 65536
    alpha = 65535 - (x * 701 + y * 83) % 4096
    return np.stack([gray, alpha], -1).astype(np.uint16)


def floor_image(n=512):
    """Tiles of 64 pixels with grout lines and a soft wood-like grain."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)
    grain = 0.5 + 0.5 * np.sin(x * 0.21 + 3.0 * np.sin(y * 0.037))
    tile = ((x // 64) + 2 * (y // 64)) % 3
    base = np.array([[0.55, 0.38, 0.22], [0.62, 0.45, 0.28], [0.48, 0.33, 0.2]])[tile.astype(int)]
    img = base * (0.8 + 0.2 * grain[..., None])
    grout = (x % 64 < 3) | (y % 64 < 3)
    img[grout] = 0.85
    return np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)


SCENE = """<scene version="3.0.0">
    <!-- {title} (tests/assets/textured/make_textured.py): {mesh_note}
         under a bitmap reflectance (checker.png, 1024 x 512 sRGB) over a
         rectangle floor under another (floor.jpg, a baseline JPEG), lit by
         a 1.5x1.5 rectangle area light of radiance 6; path tracing to
         max_depth 3, box filter.  The bitmaps keep the scene out of the film
         kernel's scope, so it renders through the wavefront, its mesh
         queries through the clustered mesh-intersect kernel.  Override with
         load_file(path, res=..., spp=...). -->
    <default name="res" value="{res}"/>
    <default name="spp" value="{spp}"/>

    <integrator type="path">
        <integer name="max_depth" value="3"/>
    </integrator>

    <sensor type="perspective">
        <float name="fov" value="40"/>
        <transform name="to_world">
            <lookat origin="0, 2.5, 5" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent">
            <integer name="sample_count" value="$spp"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="$res"/>
            <integer name="height" value="$res"/>
            <rfilter type="box"/>
        </film>
    </sensor>

    <shape type="ply" id="knot">
        <string name="filename" value="{ply}"/>
        <bsdf type="diffuse">
            <texture type="bitmap" name="reflectance">
                <string name="filename" value="checker.png"/>
            </texture>
        </bsdf>
    </shape>

    <shape type="rectangle" id="floor">
        <transform name="to_world">
            <scale x="4" y="4" z="1"/>
            <rotate x="1" y="0" z="0" angle="-90"/>
            <translate x="0" y="-0.7" z="0"/>
        </transform>
        <bsdf type="diffuse">
            <texture type="bitmap" name="reflectance">
                <string name="filename" value="floor.jpg"/>
            </texture>
        </bsdf>
    </shape>

    <shape type="rectangle" id="light">
        <transform name="to_world">
            <scale x="1.5" y="1.5" z="1"/>
            <rotate x="1" y="0" z="0" angle="90"/>
            <translate x="0" y="4" z="0"/>
        </transform>
        <emitter type="area">
            <rgb name="radiance" value="6, 6, 6"/>
        </emitter>
    </shape>
</scene>
"""


def main():
    for name, segments, sides in (("knot_uv.ply", 140, 8), ("knot_69k_uv.ply", 2176, 16)):
        v, n, uv, f = knot_uv_mesh(segments, sides)
        write_ply_uv(os.path.join(HERE, name), v, n, uv, f)
        print(f"wrote {name}: {v.shape[0]} vertices, {f.shape[0]} triangles")
    for name, img, ct, bd in (("checker.png", checker_image(), 2, 8),
                              ("gray16.png", gray16_image(), 4, 16)):
        with open(os.path.join(HERE, name), "wb") as fh:
            fh.write(encode_png(img, ct, bd))
        print(f"wrote {name}: {img.shape[1]} x {img.shape[0]}, {bd}-bit, colour type {ct}")
    try:
        from PIL import Image
    except ImportError:
        print("PIL cannot be imported: floor.jpg left as it is")
    else:
        Image.fromarray(floor_image()).save(
            os.path.join(HERE, "floor.jpg"), quality=90, subsampling=2, optimize=False,
            progressive=False, restart_marker_rows=1)
        print("wrote floor.jpg: 512 x 512, baseline, 4:2:0, a restart marker every MCU row")
    for name, title, mesh_note, ply, res, spp in (
            ("textured_gi.xml", "Textured bunny-class mesh GI",
             "the 69 632-triangle torus knot with uvs (knot_69k_uv.ply)", "knot_69k_uv.ply",
             256, 16),
            ("textured_small.xml", "Textured mesh GI for the CPU tests",
             "the 2 240-triangle torus knot with uvs (knot_uv.ply)", "knot_uv.ply", 32, 4)):
        with open(os.path.join(HERE, name), "w") as fh:
            fh.write(SCENE.format(title=title, mesh_note=mesh_note, ply=ply, res=res, spp=spp))
        print(f"wrote {name}")


if __name__ == "__main__":
    main()

"""Write the mesh fixtures ``knot.ply`` and ``knot_69k.ply`` beside this
script.

A (2,3) torus-knot tube: the centre curve winds twice around the y axis
and three times through the torus hole (major radius R = 1, minor radius
r = 0.4), swept by a circle of radius 0.18.  The defaults, 140 segments x
8 sides, give 1 120 vertices and 2 240 triangles (a teapot-class mesh,
``knot.ply``); ``--segments 2176 --sides 16`` gives 34 816 vertices and
69 632 triangles (a bunny-class mesh, ``knot_69k.ply``).  The knot folds
over itself, so it shadows itself and, seen from outside, shows back-facing
shading normals where the tube turns away; a convex mesh has neither.

Each vertex carries its analytic tube normal (``float x y z nx ny nz``);
faces are ``uchar int`` index lists, binary little endian, wound so that
cross(p1 - p0, p2 - p0) points out of the tube.  numpy only, deterministic.

Run:  python tests/assets/mesh/make_mesh.py
      python tests/assets/mesh/make_mesh.py --segments 2176 --sides 16 \
          --out tests/assets/mesh/knot_69k.ply
"""

import argparse
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
P, Q = 2, 3
R_MAJOR, R_MINOR, TUBE = 1.0, 0.4, 0.18
SEGMENTS, SIDES = 140, 8


def knot_mesh(segments=SEGMENTS, sides=SIDES):
    """(vertices [V, 3], normals [V, 3], faces [F, 3]) of the tube, swept
    in ``segments`` rings of ``sides`` vertices."""
    phi = np.arange(segments) * (2.0 * np.pi / segments)
    rad = R_MAJOR + R_MINOR * np.cos(Q * phi)
    # centre curve and its derivative; the symmetry axis is y
    c = np.stack([rad * np.cos(P * phi), R_MINOR * np.sin(Q * phi),
                  rad * np.sin(P * phi)], -1)
    drad = -Q * R_MINOR * np.sin(Q * phi)
    dc = np.stack([drad * np.cos(P * phi) - P * rad * np.sin(P * phi),
                   Q * R_MINOR * np.cos(Q * phi),
                   drad * np.sin(P * phi) + P * rad * np.cos(P * phi)], -1)
    t = dc / np.linalg.norm(dc, axis=-1, keepdims=True)
    # the tangent is never parallel to y (the P-winding dominates), so
    # (b1, b2) = (t x y, t x b1) is a smooth frame around it
    b1 = np.cross(t, np.array([0.0, 1.0, 0.0]))
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = np.cross(t, b1)
    theta = np.arange(sides) * (2.0 * np.pi / sides)
    nrm = (np.cos(theta)[None, :, None] * b1[:, None, :]
           + np.sin(theta)[None, :, None] * b2[:, None, :])  # [S, K, 3]
    verts = c[:, None, :] + TUBE * nrm
    i = np.arange(segments)[:, None]
    k = np.arange(sides)[None, :]
    a = i * sides + k
    b = ((i + 1) % segments) * sides + k
    a1 = i * sides + (k + 1) % sides
    b1_ = ((i + 1) % segments) * sides + (k + 1) % sides
    faces = np.concatenate([np.stack([a, b, b1_], -1).reshape(-1, 3),
                            np.stack([a, b1_, a1], -1).reshape(-1, 3)], 0)
    verts = verts.reshape(-1, 3)
    nrm = nrm.reshape(-1, 3)
    # wind every face so that its geometric normal agrees with the tube's
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    ng = np.cross(p1 - p0, p2 - p0)
    flip = (ng * (nrm[faces[:, 0]] + nrm[faces[:, 1]] + nrm[faces[:, 2]])).sum(-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts.astype(np.float32), nrm.astype(np.float32), faces.astype(np.int32)


def write_ply(path, verts, normals, faces):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        "comment (2,3) torus-knot tube, tests/assets/mesh/make_mesh.py\n"
        f"element vertex {verts.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        f"element face {faces.shape[0]}\n"
        "property list uchar int vertex_indices\nend_header\n")
    vrec = np.concatenate([verts, normals], 1).astype("<f4")
    frec = np.zeros(faces.shape[0], dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    frec["n"] = 3
    frec["idx"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", type=int, default=SEGMENTS)
    ap.add_argument("--sides", type=int, default=SIDES)
    ap.add_argument("--out", default=os.path.join(HERE, "knot.ply"))
    args = ap.parse_args(argv)
    verts, normals, faces = knot_mesh(args.segments, args.sides)
    out = args.out
    write_ply(out, verts, normals, faces)
    print(f"wrote {out}: {verts.shape[0]} vertices, {faces.shape[0]} triangles")


if __name__ == "__main__":
    main()

"""Stanford PLY reader (ascii, binary little and big endian), numpy, host side.

Counterpart of ``tpu_rt/scene/ply.py``: vertex positions, optional
nx/ny/nz normals and u/v (s/t, texture_u/texture_v) coordinates, and face
index lists fan-triangulated by ``_triangulate``.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path):
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)| ('list', idx_t, val_t, name)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").split()
            if not tok:
                continue
            if tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append({"name": tok[1], "count": int(tok[2]), "props": []})
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1]["props"].append(("list", _TYPES[tok[2]], _TYPES[tok[3]], tok[4]))
                else:
                    elements[-1]["props"].append(("scalar", _TYPES[tok[1]], tok[2]))
            elif tok[0] == "end_header":
                break

        data = {}
        if fmt == "ascii":
            _read_ascii(f, elements, data)
        elif fmt == "binary_little_endian":
            _read_binary(f, elements, data, "<")
        elif fmt == "binary_big_endian":
            _read_binary(f, elements, data, ">")
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

    vert = data.get("vertex", {})
    v = np.stack([vert["x"], vert["y"], vert["z"]], axis=-1).astype(np.float32)
    n = None
    if "nx" in vert:
        n = np.stack([vert["nx"], vert["ny"], vert["nz"]], axis=-1).astype(np.float32)
    uv = None
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ukey in vert:
            uv = np.stack([vert[ukey], vert[vkey]], axis=-1).astype(np.float32)
            break
    faces = data.get("face", {}).get("vertex_indices")
    if faces is None:
        faces = data.get("face", {}).get("vertex_index")
    tris = _triangulate(faces) if faces is not None else np.zeros((0, 3), np.int32)
    return {"vertices": v, "faces": tris, "normals": n, "uvs": uv}


def _triangulate(face_lists):
    if isinstance(face_lists, np.ndarray) and face_lists.ndim == 2:
        if face_lists.shape[1] == 3:  # already triangles
            return face_lists.astype(np.int32)
        out = []
        for k in range(1, face_lists.shape[1] - 1):
            out.append(np.stack(
                [face_lists[:, 0], face_lists[:, k], face_lists[:, k + 1]], -1
            ))
        return np.concatenate(out, 0).astype(np.int32)
    tris = []
    for fl in face_lists:
        for k in range(1, len(fl) - 1):
            tris.append((fl[0], fl[k], fl[k + 1]))
    return np.asarray(tris, np.int32).reshape(-1, 3)


def _read_ascii(f, elements, data):
    text = f.read().decode("ascii", "replace").split("\n")
    li = 0
    for el in elements:
        cols = {p[-1]: [] for p in el["props"]}
        simple = all(p[0] == "scalar" for p in el["props"])
        if simple:
            rows = []
            while len(rows) < el["count"]:
                tok = text[li].split()
                li += 1
                if tok:
                    rows.append([float(x) for x in tok])
            arr = np.asarray(rows, np.float64)
            for j, p in enumerate(el["props"]):
                cols[p[-1]] = arr[:, j]
        else:
            for _ in range(el["count"]):
                tok = text[li].split()
                li += 1
                while not tok:
                    tok = text[li].split()
                    li += 1
                pos = 0
                for p in el["props"]:
                    if p[0] == "list":
                        cnt = int(tok[pos]); pos += 1
                        cols[p[-1]].append(np.asarray(tok[pos:pos + cnt], np.float64).astype(np.int64))
                        pos += cnt
                    else:
                        cols[p[-1]].append(float(tok[pos])); pos += 1
        data[el["name"]] = {
            k: (v if (len(v) > 0 and isinstance(v[0], np.ndarray)) else np.asarray(v))
            for k, v in cols.items()
        }


def _read_binary(f, elements, data, endian):
    for el in elements:
        props = el["props"]
        if all(p[0] == "scalar" for p in props):
            dt = np.dtype([(p[2], endian + p[1]) for p in props])
            arr = np.frombuffer(f.read(dt.itemsize * el["count"]), dtype=dt, count=el["count"])
            data[el["name"]] = {p[2]: arr[p[2]].copy() for p in props}
        else:
            cols = {p[-1]: [] for p in props}
            # Fast path: single list property with constant-size check (faces).
            if len(props) == 1 and props[0][0] == "list":
                _, idx_t, val_t, name = props[0]
                idx_dt = np.dtype(endian + idx_t)
                val_dt = np.dtype(endian + val_t)
                raw = f.read()
                buf = np.frombuffer(raw, np.uint8)
                count = el["count"]
                # Vectorized uniform-triangle path: if every list has length
                # 3 the element is a fixed-stride record array.
                stride3 = idx_dt.itemsize + 3 * val_dt.itemsize
                uniform3 = False
                if len(raw) >= count * stride3:
                    rec = np.frombuffer(raw[: count * stride3], np.uint8).reshape(
                        count, stride3
                    )
                    counts = rec[:, : idx_dt.itemsize].copy().view(idx_dt)[:, 0]
                    uniform3 = bool((counts == 3).all()) and len(raw) >= count * stride3
                if uniform3:
                    cols[name] = (
                        rec[:, idx_dt.itemsize :]
                        .copy()
                        .view(val_dt)
                        .astype(np.int64)
                    )  # (count, 3); _triangulate handles 2-D arrays
                    off = count * stride3
                else:
                    off = 0
                    lists = []
                    for _ in range(count):
                        cnt = int(
                            np.frombuffer(
                                buf[off : off + idx_dt.itemsize].tobytes(), idx_dt
                            )[0]
                        )
                        off += idx_dt.itemsize
                        lists.append(
                            np.frombuffer(
                                buf[off : off + cnt * val_dt.itemsize].tobytes(),
                                val_dt,
                                count=cnt,
                            ).astype(np.int64)
                        )
                        off += cnt * val_dt.itemsize
                    cols[name] = lists
                # put back any remaining bytes for subsequent elements
                f_remainder = raw[off:]
                if f_remainder:
                    import io

                    f = io.BytesIO(f_remainder)
            else:
                for _ in range(el["count"]):
                    for p in props:
                        if p[0] == "list":
                            idx_dt = np.dtype(endian + p[1])
                            val_dt = np.dtype(endian + p[2])
                            cnt = int(np.frombuffer(f.read(idx_dt.itemsize), idx_dt)[0])
                            cols[p[-1]].append(
                                np.frombuffer(f.read(cnt * val_dt.itemsize), val_dt).astype(np.int64)
                            )
                        else:
                            dt = np.dtype(endian + p[1])
                            cols[p[-1]].append(np.frombuffer(f.read(dt.itemsize), dt)[0])
            data[el["name"]] = cols

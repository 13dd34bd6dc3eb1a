"""Mitsuba VOL (version 3) grid-volume reader.

Counterpart of ``tpu_rt/scene/vol.py``, the same code: header ``VOL\\x03``,
encoding 1 (float32), then x, y, z resolution, channels and the bounding
box.  Neither package has a caller yet (no volume plugin is ported).
"""

from __future__ import annotations

import struct

import numpy as np


def load_vol(path):
    """Returns dict with data [Z, Y, X, C] float32 and bbox (min, max)."""
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"VOL":
            raise ValueError(f"{path}: bad magic {magic!r}")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"{path}: unsupported VOL version {version}")
        encoding, xres, yres, zres, channels = struct.unpack("<iiiii", f.read(20))
        if encoding != 1:
            raise ValueError(f"{path}: only float32 encoding (1) supported, got {encoding}")
        bbox = struct.unpack("<6f", f.read(24))
        n = xres * yres * zres * channels
        data = np.frombuffer(f.read(4 * n), dtype="<f4", count=n)
    data = data.reshape(zres, yres, xres, channels).astype(np.float32)
    return {
        "data": data,
        "bbox_min": np.asarray(bbox[:3], np.float32),
        "bbox_max": np.asarray(bbox[3:], np.float32),
        "shape": (xres, yres, zres, channels),
    }

"""The plain arithmetic the references share: SplitMix32 sample streams
(uint32 values held in int64), three-vectors as tuples of flat tensors,
and a context that runs a reference in a floating-point type.

Each operation keeps the order of the port's plain routes, so a reference
built on them reproduces their float32 results bit for bit on the same
device.
"""

import contextlib

import numpy as np
import torch

M32 = 0xFFFFFFFF


def mul32(x, c):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def rng_init(seed, tile, lane):
    """SplitMix32 state from (seed, tile, lane), int64 tensors holding
    uint32 values."""
    s = (mul32(seed & M32, 0x9E3779B9) + mul32(tile, 0x85EBCA6B)
         + mul32(lane, 0xC2B2AE35) + 0x165667B1) & M32
    s = mul32(s ^ (s >> 16), 0x7FEB352D)
    s = mul32(s ^ (s >> 15), 0x846CA68B)
    s = s ^ (s >> 16)
    return s | 1


def rng_next(state, dtype):
    """(next state, a uniform draw in [0, 1) in ``dtype``)."""
    state = (state + 0x9E3779B9) & M32
    z = mul32(state ^ (state >> 16), 0x21F0AAAD)
    z = mul32(z ^ (z >> 15), 0x735A2D97)
    z = z ^ (z >> 15)
    bits = (z >> 9) | 0x3F800000
    return state, (bits.to(torch.int32).view(torch.float32) - 1.0).to(dtype)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def where3(m, a, b):
    return tuple(torch.where(m, a[i], b[i]) for i in range(3))


def normalize(a):
    inv = 1.0 / torch.sqrt(torch.clamp(dot(a, a), min=1e-24))
    return scale(a, inv)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=1e-20))


def clamp_abs(x, eps):
    return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps), x)


def frame(n):
    sign = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a = -(1.0 / (sign + n[2]))
    b = n[0] * n[1] * a
    return ((1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]),
            (b, sign + n[1] * n[1] * a, -n[1]))


def to_local(n, s, t, v):
    return (dot(v, s), dot(v, t), dot(v, n))


def to_world(n, s, t, v):
    return (s[0] * v[0] + t[0] * v[1] + n[0] * v[2],
            s[1] * v[0] + t[1] * v[1] + n[1] * v[2],
            s[2] * v[0] + t[2] * v[1] + n[2] * v[2])


def f32(x):
    return float(np.float32(x))


@contextlib.contextmanager
def default_dtype(dtype):
    """Tensors made inside the block without a dtype take ``dtype``."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)

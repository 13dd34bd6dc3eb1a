"""Build the CUDA kernels with nvcc, and the host BVH builder with g++, at
first use, and load them with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers).
Each ``.cu`` file is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library in
``build/tpu_rt_torch/`` at the repository root, named after a hash of the
sources, the shared header and the flags: an edit forces a rebuild.  A
failed build raises with nvcc's output; nothing falls back to another
implementation.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and ``-fmad=false`` so
that the kernel rounds each multiply and add as the plain PyTorch version
(one kernel per operation) does; the two then agree to the bit on the
card except where a lane's control flow differs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_NATIVE = Path(__file__).resolve().parent / "native"
_SOURCES = ("path_film.cu", "us_acq.cu", "us_das.cu", "mesh_direct.cu", "mesh_isect.cu")
_HEADERS = ("common.cuh",)
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_rt_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# tpu_rt's flags for the same builder (tpu_rt/ops/native/__init__.py)
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                           "use and need the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f"tpu_rt_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    nvcc's output (the ptxas register / spill report) is kept beside the
    library with the suffix .log."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src + ".o") for src in _SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(_CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, text in zip(_SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n{text}")
        tmp = os.path.join(tmpdir, out.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        out.with_suffix(".log").write_text("".join(logs) + link.stdout + link.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def host_library(source: str) -> Path:
    """Compile ``native/<source>`` (host C++ with a plain C interface) with
    g++ into ``build/tpu_rt_torch/``, named after a hash of the source and
    the flags, unless that library exists.  A failed build raises with
    g++'s output."""
    src = _NATIVE / source
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    out = _BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {source} is built at first use")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, out.name)
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {source} ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic, as in build()
    return out


@functools.cache
def load_library():
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    # hdr, n_hdr, tab, n_tab, mesh, n_mesh, rays (K4's, else NULL), out,
    # n_pix, seed, n_samples, radius, mode (K1 / K3 / K6 / K5 / K4), regen
    # (K2's loop around K1), rough_cone (the rough conductor's lane and cones), stream
    lib.path_film_launch.argtypes = [p, i, p, i, p, i, p, p, i, i, i, i, i, i, i, p]
    lib.path_film_launch.restype = i
    # records, tab, n_tab, planes, n_pix, n_samples, nv, radius, seed,
    # tile_lanes, stream
    lib.film_splat_launch.argtypes = [p, p, i, p, i, i, i, i, i, i, p]
    lib.film_splat_launch.restype = i
    # hdr, n_hdr, tab, n_tab, rays, n_pairs, rays_per_pair, out, seed, mode
    # (records / deposit), time_samples, stream
    lib.us_acq_launch.argtypes = [p, i, p, i, p, i, i, p, i, i, i, p]
    lib.us_acq_launch.restype = i
    # rf, rows (A E), T, the packed rf2, stream
    lib.us_das_pack_launch.argtypes = [p, i, i, p, p]
    lib.us_das_pack_launch.restype = i
    # rf2 (packed), A, E, T, x grid, Nx, z grid, Nz, elem x, elem z, sin,
    # cos, 1 / c, t_offset, fs, the plan's tile_wz, stage_elems and
    # capacity, out, stream
    f = ctypes.c_float
    lib.us_das_launch.argtypes = [p, i, i, i, p, i, p, i, p, p, p, p, f, f, f, i, i, i, p, p]
    lib.us_das_launch.restype = i
    # the same with rf not packed, then the cotangent g, d rf, the
    # geometric cotangents (or NULL), stream
    lib.us_das_adjoint_launch.argtypes = [p, i, i, i, p, i, p, i, p, p, p, p, f, f, f, p, p, p,
                                          p]
    lib.us_das_adjoint_launch.restype = i
    # rays, n, bounds, tris, shade, tree, tree rows, clusters, lights, n
    # lights, out, stream
    lib.mesh_direct_launch.argtypes = [p, i, p, p, p, p, i, i, p, i, p, p]
    lib.mesh_direct_launch.restype = i
    # bounds, trisw, tree, c0, c1, o, d, tmax, tmin, n, t, lid, u, v, stream
    lib.mesh_isect_launch.argtypes = [p, p, p, i, i, p, p, p, ctypes.c_float, i, p, p, p, p,
                                      p]
    lib.mesh_isect_launch.restype = i
    for name in ("path_film_error_string", "us_acq_error_string", "us_das_error_string",
                 "mesh_direct_error_string", "mesh_isect_error_string"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = ctypes.c_char_p
    return lib

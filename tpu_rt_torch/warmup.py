"""Warm-up: ``python -m tpu_rt_torch.warmup [--full]``.

Counterpart of ``tpu_rt/warmup.py``.  tpu_rt fills XLA's persistent
compile cache so that a cold process does not stall on Mosaic compiles;
the port has no such cache.  Here "warm" means: the CUDA library of the
kernels built with nvcc (``ops/_build.build``: one nvcc per source, the
library kept in ``build/tpu_rt_torch/`` under a hash of the sources and
found there by every later process) and the host BVH builder built with
g++; then, in this process, the CUDA context made and the kernels'
modules loaded by one run of each headline configuration.  A scene's
per-scene caches (packed tables, rays on the device) live with the scene
object and are not kept past this process.

The default run builds both libraries and renders, once each, the
headline configurations on the repository's fixtures: the cbox at 512²,
256 spp, tent (K1); the cbox at 128², box, 2048 spp (the golden
configuration); cbox_pol at 256², 512 spp (K3 in K2's loop).  ``--full``
adds ``simple.xml`` (K9), ``polarizers.xml`` (K5), the primary wave of
``mesh_big_gi.xml`` through K7 and ``mesh_gi.xml`` (K1's mesh mode).  One
line a step with its seconds.  Raises without a CUDA device.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "tests" / "assets"
FIXTURES = {
    "cbox": ASSETS / "cbox" / "cbox.xml",
    "cbox_pol": ASSETS / "cbox_pol" / "cbox_pol.xml",
    "simple": ASSETS / "mesh" / "simple.xml",
    "polarizers": ASSETS / "polarizers" / "polarizers.xml",
    "mesh_big_gi": ASSETS / "mesh" / "mesh_big_gi.xml",
    "mesh_gi": ASSETS / "mesh" / "mesh_gi.xml",
}


def _step(msg, fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    print(f"  {msg}: {time.perf_counter() - t0:.1f}s", flush=True)


def _primary_wave(tt, path, res):
    """The camera's primary rays at pixel centres through the closest-hit
    query (K7 on a mesh with cluster tables)."""
    from tpu_rt_torch.geometry import trace
    from tpu_rt_torch.sensor import camera as cam

    sc = tt.load_file(str(path), res=res, spp=1).to("cuda")
    ys, xs = torch.meshgrid(torch.arange(res, device="cuda"), torch.arange(res, device="cuda"),
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32) + 0.5
    o, d = cam.sample_ray(sc.camera, xy)
    trace.ray_intersect(sc, o, d)


def main(full=False):
    if not torch.cuda.is_available():
        raise RuntimeError("the warm-up builds and loads the CUDA kernels: it needs an "
                           "NVIDIA GPU (torch.cuda.is_available() is false)")
    import tpu_rt_torch as tt
    from tpu_rt_torch.ops import _build

    lib = _build.library_path()
    print(f"warmup on {torch.cuda.get_device_name(0)} (kernels: {lib})", flush=True)
    how = "found" if lib.exists() else "built"
    _step(f"nvcc: the CUDA kernels ({how}) and loaded",
          lambda: (_build.build(), _build.load_library()))
    _step("g++: the host BVH builder", lambda: _build.host_library("bvh_builder.cpp"))

    cbox = tt.load_file(str(FIXTURES["cbox"]), res=512, spp=1)
    _step("cbox film kernel (tent, 512^2, 256 spp)",
          lambda: tt.render(cbox, spp=256, seed=0))
    sc128 = tt.load_file(str(FIXTURES["cbox"]), res=128, spp=1)
    sc128 = sc128.replace(camera=sc128.camera.replace(filter_type=0))
    _step("cbox film kernel (box, 128^2, 2048 spp: the golden configuration)",
          lambda: tt.render(sc128, spp=2048, seed=0))
    pol = tt.load_file(str(FIXTURES["cbox_pol"]))
    _step("cbox_pol Stokes film kernel in K2's loop (256^2, 512 spp)",
          lambda: tt.render(pol, spp=512, seed=0))

    if full:
        simple = tt.load_file(str(FIXTURES["simple"]), res=512, spp=1)
        _step("direct mesh kernel (simple.xml, 512^2)", lambda: tt.render(simple, spp=1))
        polz = tt.load_file(str(FIXTURES["polarizers"]), res=256, spp=1)
        _step("per-sample kernel K5 (polarizers.xml, 256^2, 64 spp)",
              lambda: tt.render(polz, spp=64, seed=0))
        _step("mesh-intersect kernel (mesh_big_gi.xml's primary wave, 512^2)",
              lambda: _primary_wave(tt, FIXTURES["mesh_big_gi"], 512))
        gi = tt.load_file(str(FIXTURES["mesh_gi"]), res=256, spp=1)
        _step("film kernel's mesh mode (mesh_gi.xml, 256^2, 64 spp)",
              lambda: tt.render(gi, spp=64, seed=0))

    print("warmup done", flush=True)


if __name__ == "__main__":
    main(full="--full" in sys.argv)

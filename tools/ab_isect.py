"""Interleaved same-process A/B of builds of the clustered mesh kernels on
one GPU: K7 / K8 (mesh_isect.cu) and K9 (mesh_direct.cu), with K1's mesh
mode (path_film.cu) as the control.

    python tools/ab_isect.py --variant NAME=DIR [--variant NAME=DIR ...]
                             [--out build/ab_isect.json] [--reps 7] [--no-renders]

Each DIR holds a ``mesh_isect.cu``, a ``mesh_direct.cu``, a
``path_film.cu`` and the ``common.cuh`` they include: the package's own
(``tpu_rt_torch/ops/csrc``) or an earlier commit's (``git show
COMMIT:tpu_rt_torch/ops/csrc/...`` into an ignored directory such as
``build/ab/parent``), or a copy of either changed by hand (another group
of lanes a ray, say).  Every source of every variant is compiled by its own nvcc, all started together, with
the package's flags (``_build.NVCC_FLAGS``), into
``build/ab_isect/NAME/``; ptxas's registers and spills are printed per
kernel.  A build whose launch functions take no cluster tree (the
kernels before the hierarchy) is called without one.

Timed, each variant in turn within a round, two warm-ups each, the median
of ``--reps`` rounds, CUDA events around 10 launches: K7 on the three
waves of mesh_big_gi.xml at 256x256 (chip_smoke.py's primaries, bounce
and shadow rays, seed 0) and on the two waves of simple_big.xml's first
sample (its primaries and shadow rays, recorded from a render); K9 on one
simple.xml 256x256 x 64-sample launch (chip_smoke.py's phase-10 rays);
K1's mesh-mode launch on mesh_gi.xml 256x256 x 64 samples.  Every
variant's outputs must equal the first variant's (``torch.equal``), or
the tool fails.  Then whole renders (render(mesh_big_gi.xml),
render(simple_big.xml), render(simple.xml) at their fixtures' sizes), each
variant's kernels patched into the package, one render a turn.  The
card's name and power limit are printed, and everything goes to ``--out``
as JSON.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import ab_common  # noqa: E402
import tpu_rt_torch as tt  # noqa: E402
from ab_common import event_ms  # noqa: E402
from tpu_rt_torch.geometry import trace  # noqa: E402
from tpu_rt_torch.ops import mesh_kernel as mk  # noqa: E402
from tpu_rt_torch.ops import path_kernel as pk  # noqa: E402
from tpu_rt_torch.sensor import camera as cam  # noqa: E402

MESH = os.path.join(ROOT, "tests", "assets", "mesh")
BIG_GI = os.path.join(MESH, "mesh_big_gi.xml")
SIMPLE_BIG = os.path.join(MESH, "simple_big.xml")
SIMPLE = os.path.join(MESH, "simple.xml")
MESH_GI = os.path.join(MESH, "mesh_gi.xml")
SOURCES = ("mesh_isect.cu", "mesh_direct.cu", "path_film.cu")
LAUNCHES = 10  # launches a timing
DEVICE = "cuda"


class Variant:
    """One build: its library and whether its launch functions take the
    cluster tree."""

    def __init__(self, name, lib, takes_tree):
        self.name, self.lib, self.takes_tree = name, lib, takes_tree

    def isect(self, bounds, trisw, tree, *rest):
        if self.takes_tree:
            return self.lib.mesh_isect_launch(bounds, trisw, tree, *rest)
        return self.lib.mesh_isect_launch(bounds, trisw, *rest)

    def direct(self, rays, n, bounds, tris, shade, tree, n_tree, *rest):
        if self.takes_tree:
            return self.lib.mesh_direct_launch(rays, n, bounds, tris, shade, tree, n_tree, *rest)
        return self.lib.mesh_direct_launch(rays, n, bounds, tris, shade, *rest)


class AsPackageLibrary:
    """A variant's library as the package's wrappers call it (with the
    tree), whatever its own launch functions take."""

    def __init__(self, v):
        self._v = v
        self.mesh_isect_launch = v.isect
        self.mesh_direct_launch = v.direct

    def __getattr__(self, name):
        return getattr(self._v.lib, name)


def build(variants):
    """nvcc every variant's sources at once (each once a directory);
    returns {name: Variant} and prints ptxas's registers and spills."""
    from tpu_rt_torch.ops import _build

    jobs, objs = {}, {}
    for name, d in variants.items():
        out = os.path.join(ROOT, "build", "ab_isect", name)
        os.makedirs(out, exist_ok=True)
        for src in SOURCES:
            if (d, src) not in jobs:
                jobs[d, src] = (os.path.join(out, src + ".o"), ["-c", os.path.join(d, src)])
            objs[name, src] = jobs[d, src][0]
    logs = ab_common.nvcc_all(jobs)
    out_vars, ptxas = {}, {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, d in variants.items():
        out = os.path.join(ROOT, "build", "ab_isect", name)
        so = os.path.join(out, "ab_isect.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:2], "-shared", "-o", so,
                        *[objs[name, src] for src in SOURCES]], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        with open(os.path.join(d, "mesh_isect.cu")) as f:
            takes_tree = "const void* tree" in f.read()
        lib.path_film_launch.argtypes = [vp, i, vp, i, vp, i, vp, vp, i, i, i, i, i, i, i, vp]
        lib.path_film_launch.restype = i
        lib.film_splat_launch.argtypes = [vp, vp, i, vp, i, i, i, i, i, i, vp]
        lib.film_splat_launch.restype = i
        if takes_tree:
            lib.mesh_isect_launch.argtypes = [vp, vp, vp, i, i, vp, vp, vp, ctypes.c_float, i,
                                              vp, vp, vp, vp, vp]
            lib.mesh_direct_launch.argtypes = [vp, i, vp, vp, vp, vp, i, i, vp, i, vp, vp]
        else:
            lib.mesh_isect_launch.argtypes = [vp, vp, i, i, vp, vp, vp, ctypes.c_float, i, vp,
                                              vp, vp, vp, vp]
            lib.mesh_direct_launch.argtypes = [vp, i, vp, vp, vp, i, vp, i, vp, vp]
        lib.mesh_isect_launch.restype = lib.mesh_direct_launch.restype = i
        for fn in ("path_film_error_string", "mesh_direct_error_string",
                   "mesh_isect_error_string"):
            getattr(lib, fn).argtypes = [i]
            getattr(lib, fn).restype = ctypes.c_char_p
        out_vars[name] = Variant(name, lib, takes_tree)
        ptxas[name] = ab_common.ptxas(name, "".join(logs[d, src] for src in SOURCES))
    return out_vars, ptxas


def use(v):
    """The package's wrappers launching variant ``v``'s kernels."""
    return ab_common.use(AsPackageLibrary(v))


def record_waves(scene, n, v):
    """The inputs of the first n mesh_intersect calls of render(scene,
    spp=1), rendered with variant v's kernels."""
    got = []
    real = mk.mesh_intersect

    def rec(clusters, o, d, tmin=mk._TMIN, tmax=None, c0=0, c1=None):
        if len(got) < n:
            got.append((o.clone(), d.clone(), float(tmin), tmax.clone()))
        return real(clusters, o, d, tmin=tmin, tmax=tmax, c0=c0, c1=c1)

    rec.launches = 0  # the wrapper counts its launches on the name it is called by
    mk.mesh_intersect = rec
    try:
        with use(v):
            tt.render(scene, spp=1, seed=3, device=DEVICE)
    finally:
        mk.mesh_intersect = real
    return got


def k7_cases(smoke, dev, v):
    """(name, scene, o, d, tmin, tmax) of the K7 launches timed, their
    rays traced with variant v's kernels."""
    big = tt.load_file(BIG_GI).to(dev)
    with use(v):
        waves = smoke.mesh_isect_waves(big, dev, 0)
    out = [(f"K7 mesh_big_gi 256x256 {name}", big, o, d, mk._TMIN, tmax)
           for name, (o, d, tmax) in waves.items()]
    sb = tt.load_file(SIMPLE_BIG).to(dev)
    for name, (o, d, tmin, tmax) in zip(("primary", "shadow"), record_waves(sb, 2, v)):
        out.append((f"K7 simple_big 256x256 {name}", sb, o, d, tmin, tmax))
    return out


def isect_launch(v, scene, o, d, tmin, tmax):
    cl = trace.mesh_clusters(scene.geometry)
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    lid = torch.empty((n,), dtype=torch.int32, device=o.device)
    u, w = torch.empty_like(t), torch.empty_like(t)
    err = v.isect(cl["bounds"].data_ptr(), cl["trisw"].data_ptr(), cl["tree"].data_ptr(), 0,
                  cl["bounds"].shape[0], o.data_ptr(), d.data_ptr(), tmax.data_ptr(),
                  float(tmin), n, t.data_ptr(), lid.data_ptr(), u.data_ptr(), w.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(v.lib.mesh_isect_error_string(err).decode())
    return torch.stack([t.view(torch.int32), lid, u.view(torch.int32), w.view(torch.int32)])


def direct_launch(v, ds, rays):
    n = rays.shape[1]
    out = torch.empty((4, n), dtype=torch.float32, device=rays.device)
    err = v.direct(rays.data_ptr(), n, ds.bounds.data_ptr(), ds.tris.data_ptr(),
                   ds.shade.data_ptr(), ds.tree.data_ptr(), ds.tree.shape[0], ds.n_clusters,
                   ds.lights.data_ptr(), ds.lights.shape[0], out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(v.lib.mesh_direct_error_string(err).decode())
    return out


def direct_case(dev):
    """chip_smoke.py's phase-10 rays: simple.xml 256x256 x 64 samples."""
    simple = tt.load_file(SIMPLE)
    c = simple.camera
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ys, xs = torch.meshgrid(torch.arange(c.height, device=dev),
                            torch.arange(c.width, device=dev), indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    jitter = torch.rand((64, c.height * c.width, 2), generator=gen, device=dev)
    o, d = cam.sample_ray(c, xy + jitter)
    return simple, torch.cat([o, d], -1).reshape(-1, 6).T.contiguous()


def timed(res, name, fns, reps):
    """``ab_common.timed`` over LAUNCHES launches a timing, every output
    equal to the first variant's."""
    ab_common.timed(res, name, fns, reps, LAUNCHES)


def ab_launches(variants, reps, smoke):
    dev = torch.device("cuda")
    res = {}
    for name, scene, o, d, tmin, tmax in k7_cases(smoke, dev, next(iter(variants.values()))):
        fns = {vn: (lambda v=v: isect_launch(v, scene, o, d, tmin, tmax))
               for vn, v in variants.items()}
        timed(res, f"{name} ({o.shape[0]} rays)", fns, reps)
    simple, rays = direct_case(dev)
    ds = mk.bake_direct_scene(simple).to(dev)
    fns = {vn: (lambda v=v: direct_launch(v, ds, rays)) for vn, v in variants.items()}
    timed(res, f"K9 simple.xml 256x256 x 64 ({rays.shape[1]} rays)", fns, reps)
    gi = tt.load_file(MESH_GI)
    tab = pk.pack_tables(pk.bake_scene(gi), gi.camera, 16, dev)

    def k1(v):
        with use(v):
            return pk.film_trace(tab, 100003, 64)

    timed(res, "K1 mesh mode mesh_gi 256x256 x 64 (control)",
          {vn: (lambda v=v: k1(v)) for vn, v in variants.items()}, reps)
    return res


def ab_renders(variants, reps):
    res = {}
    for path in (BIG_GI, SIMPLE_BIG, SIMPLE):
        scene = tt.load_file(path)
        for v in variants.values():
            with use(v):
                tt.render(scene, seed=1000, device="cuda")
        times = {vn: [] for vn in variants}
        for rep in range(reps):
            for vn, v in variants.items():
                with use(v):
                    times[vn].append(event_ms(
                        lambda: tt.render(scene, seed=rep, device="cuda"))[0])
        name = f"render({os.path.basename(path)})"
        res[name] = {v: {"ms": statistics.median(t), "all_ms": t} for v, t in times.items()}
        print(f"{name}: " + ", ".join(f"{v} {r['ms']:.3f} ms" for v, r in res[name].items()),
              flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "ab_isect.json"))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--no-renders", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_isect: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = ab_common.card()
    print(f"card: {smi}", flush=True)
    dirs = dict(v.split("=", 1) for v in args.variant)
    smoke = ab_common.chip_smoke()
    variants, ptxas = build(dirs)
    out = {"card": smi, "variants": dirs, "ptxas": ptxas,
           "launches": ab_launches(variants, args.reps, smoke)}
    if not args.no_renders:
        out["renders"] = ab_renders(variants, args.reps)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

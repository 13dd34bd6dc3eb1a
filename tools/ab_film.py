"""Interleaved same-process A/B of builds of the film kernels on one GPU.

    python tools/ab_film.py --variant NAME=DIR[:CONST=VALUE...] [--variant ...]
                            [--unchunked NAME ...] [--unchecked NAME ...]
                            [--out build/ab_film.json] [--reps 5] [--no-renders]

Each DIR holds a ``path_film.cu`` and the ``common.cuh`` it includes: the
package's own (``tpu_rt_torch/ops/csrc``), the parent commit's (``git show
HEAD:tpu_rt_torch/ops/csrc/path_film.cu``), or a copy changed by hand (a
lane taken out, another layout).  ``:CONST=VALUE`` items make a register-cap
variant: DIR's two files are copied into ``build/ab/NAME`` with each
``constexpr int CONST = ...;`` of ``path_film.cu`` set to VALUE (for
example ``kStokesSampleMinBlocks=4`` or ``kSampleMinBlocks=8``; the tool
fails if a constant is not found).  Every variant is compiled by its own
nvcc, all started together, with the package's flags
(``_build.NVCC_FLAGS``) into ``DIR/ab_film.so``; ptxas's registers and
spills are printed per kernel.  Each variant is launched with its own
build's launch-mode numbers, read by name from the enum of its
``path_film.cu``; its K3 trace is its K6 launch, or, for a build whose K3
had a launch mode of its own, the one mode of its enum that the program
lacks (the first 13 planes a sample are K3's records either way).  A
variant built before the film kernels
were split (no ``film_splat_launch``) is launched as one kernel writing
the planes; a variant named by ``--unchunked`` (built before the
per-sample kernels took a chunk of samples a launch) has its per-sample
chunks launched as that many one-sample launches, and its route renders
run one sample a pass (``spp_per_pass`` 1), as that build's routes did.

Then, on the main paths' launches (K1: cbox 512^2 x 64 tent, mesh_gi
256^2 x 64 box, cbox_rough 512^2 x 64 tent; K3: cbox_pol and
cbox_pol_rough 256^2 x 64 at filter radius 0, 1 and 2, each in the
tables' loop form (the port's K3 has none: its Stokes tables' regen word
is 0, which a build with K2's loop around K3 reads as its per-sample loop);
K6, K5 and K4 one sample, and their routes' chunks: K6 cbox_pol and
cbox_pol_rough 256^2 x 64, K5 polarizers and envmap_rough_cone 128^2 x 10,
K4 16 384 rays x 10 seeds, and the 64-sample chunks of a render at the
default spp_per_pass: K5 polarizers 128^2 and K4 16 384 rays), each
variant's launch is timed by CUDA events,
two warm-ups each, then five rounds in which the variants take turns; the
median is kept, and for a build with film_splat the trace kernel and
film_splat are also timed apart.  Every variant's planes must equal the
first variant's (``torch.equal``), or the tool fails; a variant named by
``--unchecked`` changes the output on purpose (a lane taken out to time
it) and is only timed, with its ray count printed.  Then the same for
whole renders (render(cbox), render(cbox_rough), render(mesh_gi),
render(cbox_pol), render(cbox_pol_rough), render(polarizers) at their
fixtures' sizes, and the per-sample Stokes route
``tests/torch_port_scenes.py::render_stokes_per_sample`` on cbox_pol
256^2 x 512), each variant's kernels patched into the package, every
variant's image equal to the first's.  The card's name and power limit
are printed, and everything goes to ``--out`` as JSON.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import statistics
import sys
from contextlib import contextmanager

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import ab_common  # noqa: E402
import tpu_rt_torch as tt  # noqa: E402
from ab_common import event_ms  # noqa: E402
from tpu_rt_torch.ops import path_kernel as pk  # noqa: E402
from torch_port_scenes import envmap_rough_cone_desc, render_stokes_per_sample  # noqa: E402

ASSETS = os.path.join(ROOT, "tests", "assets")
CBOX = os.path.join(ASSETS, "cbox", "cbox.xml")
CBOX_ROUGH = os.path.join(ASSETS, "cbox", "cbox_rough.xml")
MESH_GI = os.path.join(ASSETS, "mesh", "mesh_gi.xml")
CBOX_POL = os.path.join(ASSETS, "cbox_pol", "cbox_pol.xml")
CBOX_POL_ROUGH = os.path.join(ASSETS, "cbox_pol", "cbox_pol_rough.xml")
POLARIZERS = os.path.join(ASSETS, "polarizers", "polarizers.xml")
SEED = 100003  # the first chunk seed of render(seed=1)


def launch_modes(d):
    """{mode name: number} of the launch-mode enum of DIR's path_film.cu."""
    with open(os.path.join(d, "path_film.cu")) as f:
        enum = re.search(r"enum \{\s*(MODE_FILM = 0[^}]*)\}", f.read()).group(1)
    return {m: int(n) for m, n in re.findall(r"(MODE_\w+) = (\d+)", enum)}


class Build:
    """A variant's library, its build's launch-mode numbers and its K3
    trace's mode: the one mode the program lacks (a build whose K3 had a
    mode of its own), else its K6 mode."""

    def __init__(self, lib, modes):
        self.lib, self.modes = lib, modes
        # more than one mode the program lacks raises: none of them is known to be K3's
        self.k3_mode, = ([n for m, n in modes.items() if not hasattr(pk, "_" + m)]
                         or [modes["MODE_STOKES_SAMPLE"]])

    def launch(self, tables, seed, n, mode, n_out, name, rays=None, regen=False):
        """The package's ``_launch`` in the program's ``mode``, given to
        this build by the name of that mode."""
        own = next(m for m in self.modes if getattr(pk, "_" + m, None) == mode)
        return ORIG_LAUNCH(tables, seed, n, self.modes[own], n_out, name, rays=rays, regen=regen)

    def k3_records(self, tables, seed, n):
        """This build's own K3 trace: its first 13 planes a sample."""
        return ORIG_LAUNCH(tables, seed, n, self.k3_mode, 15, "K3")[:tables.n_val]


ORIG_LAUNCH = pk._launch


def build(variants):
    """nvcc every variant's path_film.cu at once; returns {name: Build}
    and prints ptxas's registers and spills."""
    logs = ab_common.nvcc_all({name: (os.path.join(d, "ab_film.so"),
                                      ["-shared", os.path.join(d, "path_film.cu")])
                               for name, d in variants.items()})
    libs, ptxas = {}, {}
    for name, log in logs.items():
        lib = ctypes.CDLL(os.path.join(variants[name], "ab_film.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.path_film_launch.argtypes = [vp, i, vp, i, vp, i, vp, vp, i, i, i, i, i, i, i, vp]
        lib.path_film_launch.restype = i
        lib.path_film_error_string.argtypes = [i]
        lib.path_film_error_string.restype = ctypes.c_char_p
        if hasattr(lib, "film_splat_launch"):
            lib.film_splat_launch.argtypes = [vp, vp, i, vp, i, i, i, i, i, i, vp]
            lib.film_splat_launch.restype = i
        libs[name] = Build(lib, launch_modes(variants[name]))
        ptxas[name] = ab_common.ptxas(name, log)
    return libs, ptxas


def is_split(b):
    return hasattr(b.lib, "film_splat_launch")


def old_film(b):
    """A film wrapper for a build whose film kernels write the planes."""
    def trace(tables, seed, n_samples, regen=None):
        regen = tables.regen if regen is None else bool(regen)
        out = torch.empty((tables.n_acc + 1, tables.n_pix), dtype=torch.float32,
                          device=tables.tab.device)
        err = b.lib.path_film_launch(
            tables.hdr.data_ptr(), tables.hdr.numel(), tables.tab.data_ptr(),
            tables.tab.numel(), tables.mesh.data_ptr() if tables.mesh is not None else None,
            tables.mesh.numel() if tables.mesh is not None else 0, None, out.data_ptr(),
            tables.n_pix, pk._wrap_i32(seed), n_samples, tables.radius,
            b.k3_mode if tables.stokes else b.modes["MODE_FILM"], int(regen),
            int(tables.rough_cone), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(b.lib.path_film_error_string(err).decode())
        return out
    return trace


@contextmanager
def use(b):
    """The package's wrappers launching build ``b``'s kernels, each mode by
    its number in that build, K3's trace by the build's own."""
    saved = (pk._launch, pk.film_trace, pk.stokes_film_trace)
    pk._launch = b.launch
    if not is_split(b):
        pk.film_trace = pk.stokes_film_trace = old_film(b)
    else:
        pk.stokes_film_trace = lambda t, s, n: pk.split_film(t, s, n, b.k3_records,
                                                             pk.film_splat)
    try:
        with ab_common.use(b.lib):
            yield
    finally:
        pk._launch, pk.film_trace, pk.stokes_film_trace = saved


def tables_of(path, res=None, filter_type=None, stokes=False):
    sc = tt.load_file(path) if res is None else tt.load_file(path, res=res, spp=1)
    if filter_type is not None:
        sc = sc.replace(camera=sc.camera.replace(filter_type=filter_type))
    return pk.pack_tables(pk.bake_scene(sc), sc.camera, 16, "cuda", stokes=stokes)


def cases():
    """(name, tables, samples) of the main paths' film launches."""
    out = [("K1 cbox 512x512x64 tent", tables_of(CBOX), 64),
           ("K1 mesh_gi 256x256x64 box", tables_of(MESH_GI), 64),
           ("K1 cbox_rough 512x512x64 tent", tables_of(CBOX_ROUGH), 64)]
    for path in (CBOX_POL, CBOX_POL_ROUGH):
        for ft in (2, 1, 0):
            t = tables_of(path, filter_type=ft, stokes=True)
            out.append((f"K3 {os.path.basename(path)[:-4]} 256x256x64 radius {t.radius}", t, 64))
    return out


def ab_launches(libs, reps, unchecked=(), unchunked=()):
    res = {}
    for name, tables, n in cases():
        fns = {}
        for v, lib in libs.items():
            def full(lib=lib):
                with use(lib):
                    trace = pk.stokes_film_trace if tables.stokes else pk.film_trace
                    return trace(tables, SEED, n)
            fns[v] = full
        times = {v: [] for v in libs}
        parts = {v: ([], []) for v in libs if is_split(libs[v])}
        first, rays = None, {}
        for v, fn in fns.items():  # two warm-ups; every variant equals the first
            fn()
            got = fn()
            torch.cuda.synchronize()
            if v in unchecked:
                rays[v] = got[-1].double().sum().item()
            elif first is None:
                first = got
            elif not torch.equal(got, first):
                raise AssertionError(f"{name}: variant {v} differs from {next(iter(libs))}")
            del got
        for _ in range(reps):
            for v, fn in fns.items():
                times[v].append(event_ms(fn)[0])
                if v in parts:
                    records = libs[v].k3_records if tables.stokes else pk.film_records
                    with use(libs[v]):
                        ms_t, rec = event_ms(lambda: records(tables, SEED, n))
                        planes = torch.zeros((tables.n_acc + 1, tables.n_pix), device="cuda")
                        ms_s, _ = event_ms(lambda: pk.film_splat(rec, planes, tables, SEED))
                        parts[v][0].append(ms_t)
                        parts[v][1].append(ms_s)
                        del rec, planes
        res[name] = {}
        for v in libs:
            r = {"ms": statistics.median(times[v]), "all_ms": times[v]}
            if v in parts and parts[v][0]:
                r["trace_ms"] = statistics.median(parts[v][0])
                r["splat_ms"] = statistics.median(parts[v][1])
            r["rays"] = rays.get(v, first[-1].double().sum().item())
            res[name][v] = r
        print(f"{name}: " + ", ".join(
            f"{v} {r['ms']:.3f} ms" + (f" (trace {r['trace_ms']:.3f} + splat {r['splat_ms']:.3f})"
                                       if "trace_ms" in r else "")
            + (f" [{r['rays']:.0f} rays]" if v in unchecked else "")
            for v, r in res[name].items()), flush=True)
        del first
    res.update(ab_sample_launches(libs, reps, unchecked, unchunked))
    return res


def sample_cases():
    """(name, tables, mode, planes, rays, samples) of the per-sample
    kernels' launches: one sample, and their routes' chunks (K4 on
    chip_smoke's rays, made by the envmap golden's script)."""
    spec = importlib.util.spec_from_file_location(
        "make_envmap_golden", os.path.join(ROOT, "tests", "golden", "make_envmap_golden.py"))
    env = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(env)

    def rays_of(o, d):
        return torch.cat([torch.from_numpy(o).T, torch.from_numpy(d).T]).contiguous().cuda()

    t_pol, t_cbox = tables_of(POLARIZERS, res=128), tables_of(CBOX)
    t_k6 = tables_of(CBOX_POL, stokes=True)
    erc = tt.load_dict(envmap_rough_cone_desc(tt.ScalarTransform4f, os.path.join(
        ASSETS, "polarizers", "envmap.exr"), 128))
    t_erc = pk.pack_tables(pk.bake_scene(erc), erc.camera, 16, "cuda")
    env_rays = rays_of(*env.k4_env_rays(128 * 128))
    return (("K6 cbox_pol 256x256", t_k6, pk._MODE_STOKES_SAMPLE, 15, None, 1),
            ("K5 cbox 512x512", t_cbox, pk._MODE_RAYGEN_SAMPLE, 6, None, 1),
            ("K5 polarizers 128x128", t_pol, pk._MODE_RAYGEN_SAMPLE, 12, None, 1),
            ("K4 cbox 262144 rays", t_cbox, pk._MODE_RAYS_SAMPLE, 4,
             rays_of(*env.k4_cbox3_rays(512 * 512)), 1),
            ("K4 polarizers 16384 rays", t_pol, pk._MODE_RAYS_SAMPLE, 10, env_rays, 1),
            ("K6 cbox_pol 256x256 x 64 chunk", t_k6, pk._MODE_STOKES_SAMPLE, 15, None, 64),
            ("K6 cbox_pol_rough 256x256 x 64 chunk", tables_of(CBOX_POL_ROUGH, stokes=True),
             pk._MODE_STOKES_SAMPLE, 15, None, 64),
            ("K5 polarizers 128x128 x 10 chunk", t_pol, pk._MODE_RAYGEN_SAMPLE, 12, None, 10),
            ("K5 envmap_rough_cone 128x128 x 10 chunk", t_erc, pk._MODE_RAYGEN_SAMPLE, 12, None,
             10),
            ("K4 polarizers 16384 rays x 10 chunk", t_pol, pk._MODE_RAYS_SAMPLE, 10, env_rays,
             10),
            ("K5 polarizers 128x128 x 64 chunk", t_pol, pk._MODE_RAYGEN_SAMPLE, 12, None, 64),
            ("K4 polarizers 16384 rays x 64 chunk", t_pol, pk._MODE_RAYS_SAMPLE, 10, env_rays,
             64))


def ab_sample_launches(libs, reps, unchecked=(), unchunked=()):
    """K6, K5 and K4 in turns: a chunk is one launch, or for an
    ``unchunked`` variant that many one-sample launches seeded seed + i;
    a timing covers 20 launches of under 2^20 lanes (samples x pixels or
    rays), else 3."""
    res = {}
    for name, tables, mode, n_out, rays, k in sample_cases():
        def one(lib, v):
            with use(lib):
                if k == 1 or v not in unchunked:
                    return lib.launch(tables, 3, k, mode, n_out, name, rays=rays)
                return torch.cat([lib.launch(tables, pk._wrap_i32(3 + i), 1, mode, n_out, name,
                                             rays=rays) for i in range(k)], 1)
        want = one(next(iter(libs.values())), next(iter(libs)))
        for v, lib in libs.items():
            assert v in unchecked or torch.equal(one(lib, v), want), f"{name}: variant {v} differs"
        lanes = k * (tables.n_pix if rays is None else rays.shape[1])
        per = 20 if lanes < 1 << 20 else 3  # small launches: more of them a timing
        times = {v: [] for v in libs}
        for _ in range(reps):
            for v, lib in libs.items():
                times[v].append(event_ms(lambda: [one(lib, v) for _ in range(per)])[0] / per)
        res[name] = {v: {"ms": statistics.median(t), "all_ms": t, "samples": k,
                         "ms_per_sample": statistics.median(t) / k} for v, t in times.items()}
        print(f"{name}: " + ", ".join(
            f"{v} {r['ms']:.4f} ms" + (f" ({r['ms_per_sample']:.4f} a sample)" if k > 1 else "")
            for v, r in res[name].items()), flush=True)
        del want
    return res


def ab_renders(libs, reps, unchunked=()):
    """Whole renders in turns, each variant's image equal to the first's
    (seed 1000, the warm-up); an ``unchunked`` variant renders the
    per-sample routes one sample a pass."""
    routes = [(f"render({os.path.basename(p)})", tt.load_file(p), "film")
              for p in (CBOX, CBOX_ROUGH, MESH_GI, CBOX_POL, CBOX_POL_ROUGH)]
    routes += [("render(polarizers.xml)", tt.load_file(POLARIZERS), "sample"),
               ("render_stokes_per_sample(cbox_pol.xml, 512 spp)", tt.load_file(CBOX_POL),
                "stokes")]
    res = {}
    for name, sc, kind in routes:
        def render(v, seed):
            kw = {"spp_per_pass": 1} if kind != "film" and v in unchunked else {}
            if kind == "stokes":
                return render_stokes_per_sample(sc, 512, seed, "cuda", **kw)[0]
            return tt.render(sc, seed=seed, device="cuda", **kw)

        times = {v: [] for v in libs}
        first = None
        for v, lib in libs.items():
            with use(lib):
                img = render(v, 1000)
            torch.cuda.synchronize()
            if first is None:
                first = img
            elif not torch.equal(img, first):
                raise AssertionError(f"{name}: variant {v}'s image differs from the first's")
        for rep in range(reps):
            for v, lib in libs.items():
                with use(lib):
                    times[v].append(event_ms(lambda: render(v, rep))[0])
        res[name] = {v: {"ms": statistics.median(t), "all_ms": t} for v, t in times.items()}
        print(f"{name}: " + ", ".join(f"{v} {r['ms']:.3f} ms" for v, r in res[name].items()),
              flush=True)
        del first
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="NAME=DIR[:CONST=VALUE...]")
    ap.add_argument("--unchecked", action="append", default=[],
                    help="a variant that changes the output on purpose: timed only")
    ap.add_argument("--unchunked", action="append", default=[],
                    help="a variant whose per-sample kernels trace one sample a launch")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "ab_film.json"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-renders", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_film: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = ab_common.card()
    print(f"card: {smi}", flush=True)
    specs = dict(v.split("=", 1) for v in args.variant)
    variants = {name: ab_common.variant_dir(name, spec, ("path_film.cu",),
                                            os.path.join(ROOT, "build", "ab"))
                for name, spec in specs.items()}
    libs, ptxas = build(variants)
    unchunked = set(args.unchunked)
    out = {"card": smi, "variants": specs, "ptxas": ptxas,
           "unchecked": args.unchecked, "unchunked": args.unchunked,
           "launches": ab_launches(libs, args.reps, set(args.unchecked), unchunked)}
    if not args.no_renders:
        out["renders"] = ab_renders(libs, args.reps, unchunked)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Generate the polarized-kernel golden from tpu_rt (provenance script).

Runs tpu_rt's Pallas kernels in interpret mode on the CPU, at tile_rows 8,
on the in-repo fixtures ``tests/assets/cbox_pol/cbox_pol.xml`` (the
rebuilt cbox_pol) and ``tests/assets/cbox/cbox.xml``, and stores their
outputs in one file, ``tests/golden/stokes_kernels_seed0.npz``:

* ``film_<filter>``: ``pallas_film_trace(stokes=True)`` planes (K3) of
  cbox_pol at 8x8, max_depth 3, 2 samples, seed 5, for the box, tent and
  gaussian filters: (13 * offsets + 1, 64) float32, the ray count last;
* ``regen_stokes``: the same call with ``regen=True`` (K3 inside K2's
  loop) at the scene's own depth 16, gaussian filter;
* ``regen_scalar``: the scalar film kernel with ``regen=True`` (K1 inside
  K2's loop) on the cbox fixture at 8x8, max_depth 16, tent, 2 samples,
  seed 5;
* ``sample_S`` [64, 4, 3], ``sample_jitter`` [64, 2], ``sample_rays``:
  ``pallas_stokes_trace`` (K6) on cbox_pol at 8x8, max_depth 3, seed 3;
* ``render_<spp>`` (H, W, 4, 3) and ``render_<spp>_rays``:
  ``render_stokes_pallas`` of cbox_pol at 32x32, seed 0, for 32 spp (the
  card's gate) and 2 spp (the CPU test), both K3 in K2's loop at depth 16.

The port's kernels draw the same SplitMix32 streams at ``tile_rows=8``, so
the comparisons are tight; ``render_gate`` below states the limit of the
cbox_pol render gate (the CPU tests and chip_smoke.py load it from here;
this module imports JAX only in ``main``).

Run:  python tests/golden/make_stokes_golden.py     (about half an hour)
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "..", "assets")
CBOX_POL = os.path.join(ASSETS, "cbox_pol", "cbox_pol.xml")
CBOX = os.path.join(ASSETS, "cbox", "cbox.xml")
OUT = os.path.join(HERE, "stokes_kernels_seed0.npz")
KERNEL = dict(res=8, k=2, seed=5, depth=3, sample_seed=3, regen_depth=16)
RENDER = dict(res=32, seed=0, spps=(32, 2))
# The render gate: the largest difference of 8x8 block means of I, Q and
# U (all three channels), over the mean of the golden's I.  Same streams:
# the port's plain version on the CPU lands at 3.6e-4 at 32 spp and 1.3e-5
# at 2 spp (a few lanes branch otherwise on an ulp and follow another
# depth-16 path; at 32 spp one ray of 212 255 differs); another seed at
# 2 spp is off by 5.7.  The limit leaves 14x the CPU's 32-spp figure.
RENDER_LIMIT = 0.005


def block_means(S):
    """8x8 block means of a (H, W, 4, 3) Stokes image's I, Q and U."""
    h, w = S.shape[:2]
    x = np.asarray(S, np.float64)[..., :3, :]
    return x.reshape(h // 8, 8, w // 8, 8, 3, 3).mean(axis=(1, 3))


def render_gate(S, golden):
    """Largest |difference| of the I, Q, U block means over the golden's
    mean I; must be <= RENDER_LIMIT."""
    a, b = block_means(S), block_means(golden)
    return float(np.abs(a - b).max() / np.asarray(golden, np.float64)[..., 0, :].mean())


def _planes(accs, nrays, n):
    return np.stack([np.asarray(a).reshape(-1)[:n] for a in accs]
                    + [np.asarray(nrays).reshape(-1)[:n]]).astype(np.float32)


def main():
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tpu_rt
    from tpu_rt.ops import pallas_path as pp

    pp.INTERPRET = True
    out = {}
    r, k, seed = KERNEL["res"], KERNEL["k"], KERNEL["seed"]
    n = r * r
    pol = tpu_rt.load_file(CBOX_POL, res=r, spp=k)
    for name, ft in (("box", 0), ("tent", 1), ("gaussian", 2)):
        sc = pol.replace(max_depth=KERNEL["depth"])
        sc = sc.replace(camera=sc.camera.replace(filter_type=ft))
        accs, nr = pp.pallas_film_trace(pp.bake_scene(sc), sc.camera, seed, k, tile_rows=8,
                                        interpret=True, stokes=True, regen=False)
        out["film_" + name] = _planes(accs, nr, n)
        print(f"film_{name}: {out['film_' + name].shape}", flush=True)
    accs, nr = pp.pallas_film_trace(pp.bake_scene(pol), pol.camera, seed, k, tile_rows=8,
                                    interpret=True, stokes=True, regen=True)
    out["regen_stokes"] = _planes(accs, nr, n)
    cb = tpu_rt.load_file(CBOX, res=r, spp=k).replace(max_depth=KERNEL["regen_depth"])
    accs, nr = pp.pallas_film_trace(pp.bake_scene(cb), cb.camera, seed, k, tile_rows=8,
                                    interpret=True, regen=True)
    out["regen_scalar"] = _planes(accs, nr, n)
    print("regen planes done", flush=True)
    sc = pol.replace(max_depth=KERNEL["depth"])
    S, jit, nr = pp.pallas_stokes_trace(pp.bake_scene(sc), sc.camera, KERNEL["sample_seed"],
                                        tile_rows=8, interpret=True)
    out["sample_S"] = np.asarray(S, np.float32)
    out["sample_jitter"] = np.asarray(jit, np.float32)
    out["sample_rays"] = np.int64(int(nr))
    for spp in RENDER["spps"]:
        sc = tpu_rt.load_file(CBOX_POL, res=RENDER["res"], spp=spp)
        S = pp.render_stokes_pallas(sc, spp=spp, seed=RENDER["seed"], tile_rows=8,
                                    interpret=True)
        out[f"render_{spp}"] = np.asarray(S, np.float32)
        out[f"render_{spp}_rays"] = np.int64(int(pp.render_stokes_pallas.last_ray_count))
        print(f"render_{spp}: mean I {out[f'render_{spp}'][..., 0, :].mean():.6f}, rays "
              f"{int(out[f'render_{spp}_rays'])}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

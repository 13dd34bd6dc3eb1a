"""Generate the rough-conductor and cone lanes' golden from tpu_rt (provenance script).

Runs tpu_rt's Pallas kernels in interpret mode on the CPU, at tile_rows 8,
on the in-repo fixtures whose scenes hold a GGX rough conductor and a cone,
and stores their outputs in one file,
``tests/golden/rough_cone_kernels_seed0.npz``:

* ``k1_planes``: ``pallas_film_trace`` planes (K1) of
  ``tests/assets/cbox/cbox_rough.xml`` at 32x32, tent, max_depth 6, 8
  samples, seed 5: (4 * 9 + 1, 1024) float32, the ray count last;
* ``k1_render`` (H, W, 3) and ``k1_render_rays``: ``render_pallas`` of the
  same scene at 32x32, 8 spp, seed 0;
* ``k3_planes``: ``pallas_film_trace(stokes=True)`` planes (K3, in K2's
  loop at the depth cap 16) of ``tests/assets/cbox_pol/cbox_pol_rough.xml``
  at 32x32, gaussian, 8 samples, seed 5: (13 * 25 + 1, 1024);
* ``k3_render`` (H, W, 4, 3) and ``k3_render_rays``:
  ``render_stokes_pallas`` of the same scene at 32x32, 8 spp, seed 0;
* ``k5_*``: ``pallas_raygen_trace`` (K5) on
  ``torch_port_scenes.envmap_rough_cone_desc`` (the rough ball and the
  cone under the rotated EXR map) at 32x32, its max_depth 4, seed 4: L
  [N, 3], jitter [N, 2], esc_d and esc_thr [N, 3] and the ray count;
* ``k4_*``: ``pallas_path_trace`` (K4) on the same scene, on 2 048 rays
  from around its camera (``k4_rays``), seed 2: L, esc_d, esc_thr and the
  ray count.

The port's kernels draw the same SplitMix32 streams at ``tile_rows=8``.
``render_gate`` and ``stokes_gate`` below state the limits of the render
gates (the CPU tests and chip_smoke.py load them from here; this module
imports JAX only in ``_part``, which ``main`` runs in processes of its
own).

Run:  python tests/golden/make_rough_cone_golden.py     (about 11 minutes, 5 GB)
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "..", "assets")
CBOX_ROUGH = os.path.join(ASSETS, "cbox", "cbox_rough.xml")
POL_ROUGH = os.path.join(ASSETS, "cbox_pol", "cbox_pol_rough.xml")
ENVMAP = os.path.join(ASSETS, "polarizers", "envmap.exr")
OUT = os.path.join(HERE, "rough_cone_kernels_seed0.npz")
KERNEL = dict(res=32, k=8, seed=5, k5_seed=4, k4_n=2048, k4_seed=2)
RENDER = dict(res=32, spp=8, seed=0)
# The render gates: the largest difference of 8x8 block means (all three
# channels; for a Stokes image those of I, Q and U) over the golden's mean
# (of I).  The same streams, so only lanes that branch otherwise on an ulp
# move a block; the limit is the polarizers goldens'.
RENDER_LIMIT = 0.02


def _blocks(x):
    """8x8 block means over the first two axes of an (H, W, ...) array."""
    x = np.asarray(x, np.float64)
    h, w = x.shape[:2]
    return x.reshape(h // 8, 8, w // 8, 8, *x.shape[2:]).mean(axis=(1, 3))


def render_gate(img, golden):
    """(H, W, 3): largest |difference| of the block means over the
    golden's mean; must be <= RENDER_LIMIT."""
    return float(np.abs(_blocks(img) - _blocks(golden)).max()
                 / np.asarray(golden, np.float64).mean())


def stokes_gate(S, golden):
    """(H, W, 4, 3): largest |difference| of the I, Q, U block means over
    the golden's mean I; must be <= RENDER_LIMIT."""
    a, b = _blocks(np.asarray(S)[..., :3, :]), _blocks(np.asarray(golden)[..., :3, :])
    return float(np.abs(a - b).max() / np.asarray(golden, np.float64)[..., 0, :].mean())


def k4_rays(n=KERNEL["k4_n"]):
    """n rays from around the camera of envmap_rough_cone_desc (at
    (0, 1, -4)) toward points spread over the scene (a fixed numpy seed)."""
    rng = np.random.default_rng(8)
    o = np.float32([0.0, 1.0, -4.0]) + rng.uniform(-0.1, 0.1, (n, 3))
    target = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                       rng.uniform(-1.0, 2.0, n)], 1)
    d = target - o
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _planes(accs, nrays, n):
    return np.stack([np.asarray(a).reshape(-1)[:n] for a in accs]
                    + [np.asarray(nrays).reshape(-1)[:n]]).astype(np.float32)


def _part(name):
    """One of the golden's parts, run in a process of its own, so that no
    process holds the interpret-mode compiles of several kernels."""
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    sys.path.insert(0, os.path.join(HERE, ".."))
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import tpu_rt
    from tpu_rt.ops import pallas_path as pp
    from torch_port_scenes import envmap_rough_cone_desc

    pp.INTERPRET = True
    out = {}
    r, k, seed = KERNEL["res"], KERNEL["k"], KERNEL["seed"]
    path = CBOX_ROUGH if name.startswith("k1") else POL_ROUGH
    if name in ("k1_planes", "k3_planes"):
        sc = tpu_rt.load_file(path, res=r, spp=k)
        # K3 in K2's loop, the port's auto form at depth 16 (the per-sample
        # loop gives the same planes, but its 16 unrolled bounces take
        # tpu_rt's interpret mode tens of GB to compile)
        accs, nr = pp.pallas_film_trace(pp.bake_scene(sc), sc.camera, seed, k, tile_rows=8,
                                        interpret=True, stokes=name == "k3_planes",
                                        regen=name == "k3_planes")
        out[name] = _planes(accs, nr, r * r)
    elif name in ("k1_render", "k3_render"):
        sc = tpu_rt.load_file(path, res=RENDER["res"], spp=RENDER["spp"])
        fn = pp.render_pallas if name == "k1_render" else pp.render_stokes_pallas
        img = fn(sc, spp=RENDER["spp"], seed=RENDER["seed"], tile_rows=8, interpret=True)
        out[name] = np.asarray(img, np.float32)
        out[name + "_rays"] = np.int64(int(fn.last_ray_count))
    else:  # K5 and K4 on envmap_rough_cone_desc
        sc = tpu_rt.load_dict(envmap_rough_cone_desc(tpu_rt.ScalarTransform4f, ENVMAP, r))
        bs = pp.bake_scene(sc)
        L, jit, nr, esc_d, esc_thr = pp.pallas_raygen_trace(bs, sc.camera, KERNEL["k5_seed"],
                                                             tile_rows=8, interpret=True)
        for key, v in (("L", L), ("jitter", jit), ("esc_d", esc_d), ("esc_thr", esc_thr)):
            out[f"k5_{key}"] = np.asarray(v, np.float32)
        out["k5_rays"] = np.int64(int(nr))
        o, d = k4_rays()
        L, nr, esc_d, esc_thr = pp.pallas_path_trace(bs, jnp.asarray(o), jnp.asarray(d),
                                                     KERNEL["k4_seed"], tile_rows=8,
                                                     interpret=True)
        for key, v in (("L", L), ("esc_d", esc_d), ("esc_thr", esc_thr)):
            out[f"k4_{key}"] = np.asarray(v, np.float32)
        out["k4_rays"] = np.int64(int(nr))
    return out


def main():
    import multiprocessing

    out = {}
    t_all = time.time()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1, maxtasksperchild=1) as pool:
        for name in ("k1_planes", "k1_render", "k3_planes", "k3_render", "k5_k4"):
            t = time.time()
            out.update(pool.apply(_part, (name,)))
            print(f"{name}: {time.time() - t:.1f} s", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} in {time.time() - t_all:.0f} s")


if __name__ == "__main__":
    main()

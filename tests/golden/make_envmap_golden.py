"""Generate the textured-environment kernels' golden from tpu_rt (provenance script).

Runs tpu_rt's Pallas kernels in interpret mode on the CPU, at tile_rows 8,
on the in-repo fixtures, and stores their outputs in one file,
``tests/golden/envmap_kernels_seed0.npz``:

* ``k5_<res>_*`` for res 8 and 32: ``pallas_raygen_trace`` (K5) on
  ``tests/assets/polarizers/polarizers.xml`` at max_depth 3, seed 11: L
  [N, 3], jitter [N, 2], esc_d and esc_thr [N, 3] and the ray count;
* ``k5_mixed_*``: the same on ``torch_port_scenes.envmap_desc`` (diffuse,
  null, dielectric, polarizer and conductor lanes under the rotated map)
  at 16x16, its max_depth 4, seed 4;
* ``k4_env_*``: ``pallas_path_trace`` (K4) on 1 024 fixed rays through the
  sheets and out to the environment (``k4_env_rays``), the scene's depth
  16, seed 2: L, esc_d, esc_thr and the ray count;
* ``k4_cbox_up`` / ``k4_cbox_out``: K4 on ``tests/assets/cbox/cbox.xml``
  at max_depth 1 from the box's centre up at the luminaire and out of its
  open front (tests/test_pallas_kernel.py:53-68's rays), seed 0;
* ``k4_cbox3_*``: K4 on the cbox at max_depth 3, 2 048 random rays from
  inside the box (two RNG tiles), seed 9;
* ``render_<spp>`` (H, W, 3) and ``render_<spp>_rays``: ``render_pallas``
  of polarizers.xml at 32x32, seed 0, for 16 spp (the card's gate) and 2
  spp (the CPU test): K5 once a sample, the lat-long lookup, the splat;
* ``const_render`` and ``const_render_rays``: ``render_pallas`` of
  ``tests/assets/cbox_pol/polarizers_const.xml`` (a path scene under a
  constant environment: K1's film route with the pass-through lane, in
  K2's loop at depth 16) at 32x32, 4 spp, seed 0.

The port's kernels draw the same SplitMix32 streams at ``tile_rows=8``.
``render_gate`` below states the limits of the render gates (the CPU tests
and chip_smoke.py load them, and the fixtures' rays, from here; this
module imports JAX only in ``main``), so the tests hold the port to
tpu_rt's kernels without running them.

Run:  python tests/golden/make_envmap_golden.py     (under a minute on 8 CPU cores)
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "..", "assets")
POLARIZERS = os.path.join(ASSETS, "polarizers", "polarizers.xml")
ENVMAP = os.path.join(ASSETS, "polarizers", "envmap.exr")
POL_CONST = os.path.join(ASSETS, "cbox_pol", "polarizers_const.xml")
CBOX = os.path.join(ASSETS, "cbox", "cbox.xml")
OUT = os.path.join(HERE, "envmap_kernels_seed0.npz")
K5 = dict(res=(8, 32), depth=3, seed=11, mixed_res=16, mixed_seed=4)
K4 = dict(n=1024, seed=2, cbox_seed=0, cbox3_n=2048, cbox3_seed=9)
RENDER = dict(res=32, seed=0, spps=(16, 2), const_spp=4)
# The render gate: the largest difference of 8x8 block means (all three
# channels) over the golden's mean.  Same streams: the port's plain
# version on the CPU lands at 9.0e-8 (2 spp) and 1.5e-7 (16 spp), the
# ulps of the splat's exp and of the camera rays; CPU_LIMIT holds it there.
# On the card atan2 and arccos round otherwise, so a lookup that sits on a
# texel boundary may read the neighbouring texel; one such read at the
# sun's rim moves a block mean by about 0.01 of the image mean at 16 spp,
# and RENDER_LIMIT allows two.
CPU_LIMIT = 1e-5
RENDER_LIMIT = 0.02


def block_means(img):
    """8x8 block means of an (H, W, 3) image."""
    h, w = img.shape[:2]
    return np.asarray(img, np.float64).reshape(h // 8, 8, w // 8, 8, 3).mean(axis=(1, 3))


def render_gate(img, golden):
    """Largest |difference| of the block means over the golden's mean;
    must be <= RENDER_LIMIT."""
    return float(np.abs(block_means(img) - block_means(golden)).max()
                 / np.asarray(golden, np.float64).mean())


def k4_env_rays(n=K4["n"]):
    """n rays from around the camera of polarizers.xml, spread over the
    sheets and past their edges (a fixed numpy seed)."""
    rng = np.random.default_rng(5)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.2, 0.2, (n, 2))
    o[:, 2] = -4.0
    d = np.concatenate([rng.uniform(-0.35, 0.35, (n, 2)), np.ones((n, 1))], 1)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def k4_cbox3_rays(n=K4["cbox3_n"]):
    """n rays from inside the cbox in uniform directions (a fixed seed)."""
    rng = np.random.default_rng(6)
    o = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(-0.6, 0.0, n)
    d = rng.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def cbox_up_out():
    """tests/test_pallas_kernel.py:57-66's rays: 1 024 from the centre,
    up at the luminaire and out along +z."""
    o = np.zeros((1024, 3), np.float32)
    up = np.tile(np.float32([[0.0, 1.0, 0.0]]), (1024, 1))
    out = np.tile(np.float32([[0.0, 0.0, 1.0]]), (1024, 1))
    return o, up, out


def main():
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    sys.path.insert(0, os.path.join(HERE, ".."))
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import tpu_rt
    from tpu_rt.ops import pallas_path as pp
    from torch_port_scenes import envmap_desc

    pp.INTERPRET = True
    out = {}
    t_all = time.time()

    def k5(prefix, sc, seed):
        t = time.time()
        L, jit, nr, esc_d, esc_thr = pp.pallas_raygen_trace(pp.bake_scene(sc), sc.camera, seed,
                                                             tile_rows=8, interpret=True)
        for k, v in (("L", L), ("jitter", jit), ("esc_d", esc_d), ("esc_thr", esc_thr)):
            out[f"{prefix}_{k}"] = np.asarray(v, np.float32)
        out[f"{prefix}_rays"] = np.int64(int(nr))
        print(f"{prefix}: {time.time() - t:.1f} s, rays {int(nr)}", flush=True)

    for r in K5["res"]:
        sc = tpu_rt.load_file(POLARIZERS, res=r, spp=1).replace(max_depth=K5["depth"])
        k5(f"k5_{r}", sc, K5["seed"])
    mixed = tpu_rt.load_dict(envmap_desc(tpu_rt.ScalarTransform4f, ENVMAP, K5["mixed_res"]))
    k5("k5_mixed", mixed, K5["mixed_seed"])

    def k4(prefix, bs, o, d, seed):
        t = time.time()
        res = pp.pallas_path_trace(bs, jnp.asarray(o), jnp.asarray(d), seed, tile_rows=8,
                                   interpret=True)
        out[f"{prefix}_L"] = np.asarray(res[0], np.float32)
        out[f"{prefix}_rays"] = np.int64(int(res[1]))
        if len(res) == 4:
            out[f"{prefix}_esc_d"] = np.asarray(res[2], np.float32)
            out[f"{prefix}_esc_thr"] = np.asarray(res[3], np.float32)
        print(f"{prefix}: {time.time() - t:.1f} s, rays {int(res[1])}", flush=True)

    pol = tpu_rt.load_file(POLARIZERS, res=8, spp=1)
    o, d = k4_env_rays()
    k4("k4_env", pp.bake_scene(pol), o, d, K4["seed"])
    cb = tpu_rt.load_file(CBOX, res=16, spp=1)
    o, up, fwd = cbox_up_out()
    bs1 = pp.bake_scene(cb.replace(max_depth=1))
    k4("k4_cbox_up", bs1, o, up, K4["cbox_seed"])
    k4("k4_cbox_out", bs1, o, fwd, K4["cbox_seed"])
    o, d = k4_cbox3_rays()
    k4("k4_cbox3", pp.bake_scene(cb.replace(max_depth=3)), o, d, K4["cbox3_seed"])

    for spp in RENDER["spps"]:
        t = time.time()
        sc = tpu_rt.load_file(POLARIZERS, res=RENDER["res"], spp=spp)
        img = pp.render_pallas(sc, spp=spp, seed=RENDER["seed"], tile_rows=8, interpret=True)
        out[f"render_{spp}"] = np.asarray(img, np.float32)
        out[f"render_{spp}_rays"] = np.int64(int(pp.render_pallas.last_ray_count))
        print(f"render_{spp}: {time.time() - t:.1f} s, mean {out[f'render_{spp}'].mean():.6f}, "
              f"rays {int(out[f'render_{spp}_rays'])}", flush=True)
    t = time.time()
    spp = RENDER["const_spp"]
    sc = tpu_rt.load_file(POL_CONST, res=RENDER["res"], spp=spp)
    img = pp.render_pallas(sc, spp=spp, seed=RENDER["seed"], tile_rows=8, interpret=True)
    out["const_render"] = np.asarray(img, np.float32)
    out["const_render_rays"] = np.int64(int(pp.render_pallas.last_ray_count))
    print(f"const_render: {time.time() - t:.1f} s, mean {out['const_render'].mean():.6f}, rays "
          f"{int(out['const_render_rays'])}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} in {time.time() - t_all:.0f} s")


if __name__ == "__main__":
    main()

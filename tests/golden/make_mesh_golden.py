"""Generate the two mesh goldens from tpu_rt (provenance script).

Renders the mesh fixtures of ``tests/assets/mesh/`` with ``tpu_rt.render``
on the CPU, where its Pallas kernels run in interpret mode:

* ``simple.xml`` (the knot under two point lights, ``direct``, box filter)
  at 64x64, 1024 spp, seed 0, through the direct mesh kernel
  (``pallas_mesh.mesh_direct_render``).  Its jitter is ``jax.random``, so
  the port agrees with it statistically only.
* ``mesh_gi.xml`` (the knot over a floor under an area light, ``path``,
  max_depth 3, box filter) at 32x32, 16 spp, seed 0, through the film
  kernel's clustered-mesh mode (``pallas_path.render_pallas``, tile_rows
  8 in interpret mode).  The port's film kernel draws the same SplitMix32
  streams at ``tile_rows=8``.

Output, each with ``img`` (float32 [H, W, 3]), ``res``, ``spp``, ``seed``
and ``rays`` (the render's ray count):
  tests/golden/mesh_direct_64_spp1024_seed0.npz
  tests/golden/mesh_gi_32_spp16_seed0.npz

The gates that hold a render against them are ``direct_gate`` and
``gi_gate`` below; the CPU tests and chip_smoke.py load them from here
(this module imports JAX only in ``main``).

Run:  python tests/golden/make_mesh_golden.py     (about ten minutes)
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MESH = os.path.join(HERE, "..", "assets", "mesh")
DIRECT = dict(scene="simple.xml", res=64, spp=1024, seed=0,
              out="mesh_direct_64_spp1024_seed0.npz")
GI = dict(scene="mesh_gi.xml", res=32, spp=16, seed=0, out="mesh_gi_32_spp16_seed0.npz")
# A 256-spp render with another jitter stream against the 1024-spp golden:
# the block means' noise alone gives a relative RMSE of about 0.6%.
DIRECT_LIMIT = 0.01
# Same streams: the port's plain version matches to 3e-7; another seed is
# off by 9%.  The slack covers the few lanes that branch otherwise on an
# ulp difference (sin, cos and exp differ between libraries).
GI_LIMIT = 5e-3


def _block_means(img):
    h, w, c = img.shape
    return np.asarray(img, np.float64).reshape(h // 8, 8, w // 8, 8, c).mean(axis=(1, 3))


def direct_gate(img, golden):
    """Relative RMSE of the 8x8 block means of ``img`` against the
    golden's; must be <= DIRECT_LIMIT."""
    a, b = _block_means(img), _block_means(golden)
    return float(np.sqrt(((a - b) ** 2).mean()) / b.mean())


def gi_gate(img, golden):
    """Largest difference of 8x8 block means, over the golden's image
    mean; must be <= GI_LIMIT."""
    a, b = _block_means(img), _block_means(golden)
    return float(np.abs(a - b).max() / np.asarray(golden, np.float64).mean())


def main():
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tpu_rt
    from tpu_rt.ops import pallas_mesh, pallas_path

    pallas_mesh.INTERPRET = True
    pallas_path.INTERPRET = True
    for cfg, counter in ((DIRECT, pallas_mesh.mesh_direct_render),
                         (GI, pallas_path.render_pallas)):
        scene = tpu_rt.load_file(os.path.join(MESH, cfg["scene"]), res=cfg["res"],
                                 spp=cfg["spp"])
        img = np.asarray(tpu_rt.render(scene, spp=cfg["spp"], seed=cfg["seed"]), np.float32)
        rays = int(counter.last_ray_count)
        out = os.path.join(HERE, cfg["out"])
        np.savez_compressed(out, img=img, res=cfg["res"], spp=cfg["spp"], seed=cfg["seed"],
                            rays=rays)
        print(f"wrote {out}: mean {img.mean():.6f}, rays {rays}")


if __name__ == "__main__":
    main()

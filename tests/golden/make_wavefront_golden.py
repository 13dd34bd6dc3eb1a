"""Generate the wavefront golden from tpu_rt (provenance script).

Renders ``tests/assets/mesh/mesh_big_gi.xml`` (the 69 632-triangle knot
over a floor under an area light, ``path``, max_depth 3, box filter; 800
clusters, so tpu_rt takes its wavefront tracer with the clustered mesh
kernel K7) at 32x32, 256 spp, seed 0 with ``tpu_rt.render`` on the CPU,
K7 in interpret mode (``pallas_mesh.INTERPRET = True``).

Output ``tests/golden/wavefront_big_gi_32_spp256_seed0.npz`` with ``img``
(float32 [32, 32, 3]), ``res``, ``spp``, ``seed`` and ``rays``.

The port's wavefront draws its randomness from a ``torch.Generator``, not
jax.random, so it is held to this golden statistically: ``gate`` below,
the relative RMSE of the 8x8 block means.  Its limits come from the noise
of the port's plain version over seeds on the CPU: at 16 spp, seeds 0-7,
the gate read 0.0175 to 0.0300 (mean 0.0231), so a 16-spp render is held
to ``CPU_LIMIT`` = 0.06; a 256-spp render's noise scales by
sqrt((1/256 + 1/256) / (1/16 + 1/256)) = 0.34, to about 0.008, and is held
to ``LIMIT`` = 0.02.  The CPU tests and chip_smoke.py load ``gate`` from
here (this module imports JAX only in ``main``).

Run:  python tests/golden/make_wavefront_golden.py     (about ten minutes)
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MESH = os.path.join(HERE, "..", "assets", "mesh")
CFG = dict(scene="mesh_big_gi.xml", res=32, spp=256, seed=0,
           out="wavefront_big_gi_32_spp256_seed0.npz")
LIMIT = 0.02  # a render at CFG["spp"]
CPU_SPP, CPU_LIMIT = 16, 0.06  # the CPU test's render


def _block_means(img):
    h, w, c = img.shape
    return np.asarray(img, np.float64).reshape(h // 8, 8, w // 8, 8, c).mean(axis=(1, 3))


def gate(img, golden):
    """Relative RMSE of the 8x8 block means of ``img`` against the
    golden's: at most LIMIT for a render at ``CFG['spp']``, CPU_LIMIT at
    CPU_SPP."""
    a, b = _block_means(img), _block_means(golden)
    return float(np.sqrt(((a - b) ** 2).mean()) / b.mean())


def main():
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tpu_rt
    from tpu_rt.integrator import path
    from tpu_rt.ops import pallas_mesh, pallas_path

    pallas_mesh.INTERPRET = True
    scene = tpu_rt.load_file(os.path.join(MESH, CFG["scene"]), res=CFG["res"], spp=CFG["spp"])
    assert pallas_path.bake_scene(scene) is None, "the scene must take the wavefront tracer"
    img = np.asarray(tpu_rt.render(scene, spp=CFG["spp"], seed=CFG["seed"]), np.float32)
    rays = int(path.render.last_ray_count)
    out = os.path.join(HERE, CFG["out"])
    np.savez_compressed(out, img=img, res=CFG["res"], spp=CFG["spp"], seed=CFG["seed"],
                        rays=rays)
    print(f"wrote {out}: mean {img.mean():.6f}, rays {rays}")


if __name__ == "__main__":
    main()

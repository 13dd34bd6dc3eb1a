"""Generate the cone ultrasound golden from tpu_rt (provenance script).

Runs ``tpu_rt.us.pipeline.us_render(use_pallas=True)`` on the CPU, where
the acquisition megakernel (``tpu_rt/ops/pallas_us.py``) runs in Pallas
interpret mode, on the Cone_Box-class scene
``tests/torch_port_scenes.py::cone_box_desc`` (a cone in the 5-wall box: 5
angles x 64 elements x 10 000 samples, max_depth 10), 64 rays per
(angle, element) pair, seed 0, on the lambda/4 grid over x in [-4, 4] cm,
z in [1, 90] mm (``Z_BOUNDS``: the cone's echoes start near 6 cm).

Output: tests/golden/us_cone_rpp64_seed0.npz with the fields of
``make_us_golden.summarize`` (axial and per-pair |RF| sums, total |RF|,
8x8 B-mode block means, the image's shape and mean).

Run:  python tests/golden/make_us_cone_golden.py     (about a minute)
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, ".."), os.path.join(HERE, "..", "..")]
OUT = os.path.join(HERE, "us_cone_rpp64_seed0.npz")
RPP, SEED = 64, 0
X_BOUNDS, Z_BOUNDS = (-0.04, 0.04), (0.001, 0.09)


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tpu_rt
    from make_us_golden import summarize
    from torch_port_scenes import cone_box_desc
    from tpu_rt.us.pipeline import us_render

    scene = tpu_rt.load_dict(cone_box_desc(tpu_rt.ScalarTransform4f))
    img, ch, _tx = us_render(scene, seed=SEED, rays_per_pair=RPP, x_bounds=X_BOUNDS,
                             z_bounds=Z_BOUNDS, use_pallas=True, _forward_only=True)
    fields = summarize(img, ch)
    np.savez_compressed(OUT, **fields)
    print(f"wrote {OUT}: image {tuple(fields['img_shape'])} mean "
          f"{fields['img_mean']:.6f}, total |RF| {fields['total_abs']:.6e}")


if __name__ == "__main__":
    main()

"""Generate the USMain ultrasound golden from tpu_rt (provenance script).

Runs ``tpu_rt.us.pipeline.us_render(use_pallas=True)`` on the CPU, where
the acquisition megakernel (``tpu_rt/ops/pallas_us.py``) runs in Pallas
interpret mode, at the USMain configuration
(``tests/torch_port_scenes.py::usmain_desc``: 5 angles x 64 elements x
10 000 samples, max_depth 10), 64 rays per (angle, element) pair, seed 0,
on the default lambda/4 grid over x in [-4, 4] cm, z in [1, 50] mm.

Output: tests/golden/us_usmain_rpp64_seed0.npz with
  axial      [T]        sum of |RF| over angles and elements
  pair       [A, E]     sum of |RF| over time per (angle, element) pair
  total_abs  []         sum of |RF|
  blocks     [79, 130]  8x8 block means of the B-mode image cropped to
                        632 x 1040 (638 rows do not divide by 8)
  img_shape, img_mean   the full B-mode image's shape and mean

The full RF buffer (12.8 MB) is not kept.

Run:  python tests/golden/make_us_golden.py     (about a minute)
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, ".."), os.path.join(HERE, "..", "..")]
OUT = os.path.join(HERE, "us_usmain_rpp64_seed0.npz")
RPP, SEED = 64, 0


def summarize(img, channel_buf):
    """The golden's fields from a B-mode image [Nz, Nx] and an RF buffer
    [A, E, T] (numpy); chip_smoke.py loads this function (this module
    imports JAX only in ``main``) and applies it to the card's output."""
    ch = np.abs(np.asarray(channel_buf, np.float64))
    img = np.asarray(img, np.float64)
    rows = img.shape[0] // 8 * 8
    cols = img.shape[1] // 8 * 8
    blocks = img[:rows, :cols].reshape(rows // 8, 8, cols // 8, 8).mean(axis=(1, 3))
    return dict(
        axial=ch.sum(axis=(0, 1)).astype(np.float32),
        pair=ch.sum(axis=2).astype(np.float32),
        total_abs=np.float64(ch.sum()),
        blocks=blocks.astype(np.float32),
        img_shape=np.asarray(img.shape, np.int64),
        img_mean=np.float64(img.mean()),
    )


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tpu_rt
    from torch_port_scenes import usmain_desc
    from tpu_rt.us.pipeline import us_render

    scene = tpu_rt.load_dict(usmain_desc(tpu_rt.ScalarTransform4f))
    img, ch, _tx = us_render(scene, seed=SEED, rays_per_pair=RPP,
                             use_pallas=True, _forward_only=True)
    fields = summarize(img, ch)
    np.savez_compressed(OUT, **fields)
    print(f"wrote {OUT}: image {tuple(fields['img_shape'])} mean "
          f"{fields['img_mean']:.6f}, total |RF| {fields['total_abs']:.6e}")


if __name__ == "__main__":
    main()

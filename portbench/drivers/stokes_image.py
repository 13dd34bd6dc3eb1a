"""Traffic kind ``stokes_image``: ``tpu_rt_torch.render`` of a ``stokes``
scene file, the (H, W, 4, 3) Stokes image (I, Q, U, V by rgb), one image a
seed, ``spp`` samples a pixel in launches of ``spp_per_pass``.

``Entry`` builds what the program needs once and runs one call of the
timed path (``call``); ``check`` compares kept images with the
configuration's plain reference, block of pixels by block, and keeps the
reference's work counts of the checked image in ``counts``.  ``Control``
puts that reference, computed in bfloat16, in the program's place.
``TINY`` holds the traffic keys that the benchmark's CPU tests override,
to a size they hold; a run never reads it.
"""

from __future__ import annotations

import os

import torch

import yardstick

TINY = dict(spp=8, spp_per_pass=4, overrides={"res": 16})
# pixels of the reference a call: a 256 x 256 image in one block; its
# lanes (pixel, sample) a call: 128 samples of such a block, so the check
# issues a quarter of the launches that 2^21 lanes would
PIXEL_BLOCK = 1 << 16
LANES = 1 << 23


class Entry:
    def __init__(self, cfg, trf, ref, device):
        import tpu_rt_torch as tt

        self.tt, self.trf, self.ref, self.device = tt, trf, ref, device
        self.path = os.path.join(cfg["dir"], cfg["scene"])
        self.overrides = trf.get("overrides", {})
        self.scene = tt.load_file(self.path, **self.overrides)
        sc = ref.load_scene(self.path, **self.overrides)
        cam = sc["camera"]
        self.shapes = dict(W=cam["W"], H=cam["H"], spp=trf["spp"], n_prims=len(sc["prims"]),
                           radius=sc["radius"], launches=-(-trf["spp"] // trf["spp_per_pass"]),
                           n_val=13)
        self.block = PIXEL_BLOCK

    def call(self, seed):
        t = self.trf
        return (self.tt.render(self.scene, spp=t["spp"], seed=seed, device=self.device,
                               spp_per_pass=t["spp_per_pass"], tile_rows=t["tile_rows"]),)

    def reference(self, seed, dtype=torch.float32):
        """The reference's Stokes image of ``seed``, every pixel, [H*W, 4,
        3] (float64 for float32), computed ``block`` pixels at a time; keeps
        the image's work counts in ``counts``."""
        t, sh = self.trf, self.shapes
        n_pix = sh["W"] * sh["H"]
        parts, counts = [], {}
        for p0 in range(0, n_pix, self.block):
            pix = torch.arange(p0, min(n_pix, p0 + self.block), device=self.device)
            img, c = self.ref.image_pixels(self.path, seed, t["spp"], t["tile_rows"] * 128, pix,
                                           self.device, dtype=dtype, lanes_per_call=LANES,
                                           overrides=self.overrides)
            parts.append(img)
            counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        self.counts = counts
        return torch.cat(parts)

    def check(self, kept, seed):
        """Each kept image against the reference's: ``image_err``, the
        largest |I - I_ref| over the largest |I_ref|, and ``pol_err``, the
        same over the Q, U and V planes together, so that a fault in the
        polarization alone does not hide under the scale of I; each the
        worst over the kept images."""
        out = {"image_err": 0.0, "pol_err": 0.0}
        for _, s, (img,) in kept:
            got = img.reshape(-1, 4, 3).to(torch.float64)
            want = self.reference(s)
            out["image_err"] = max(out["image_err"], yardstick.rel_max(got[:, 0], want[:, 0]))
            out["pol_err"] = max(out["pol_err"], yardstick.rel_max(got[:, 1:], want[:, 1:]))
        return out


class Control:
    """The reference computed in bfloat16 in the program's place: its
    Stokes image in the program's shape, as float32."""

    def __init__(self, entry):
        self.entry = entry

    def __getattr__(self, name):
        return getattr(self.entry, name)

    def call(self, seed):
        sh = self.entry.shapes
        img = self.entry.reference(seed, torch.bfloat16)
        return (img.to(torch.float32).reshape(sh["H"], sh["W"], 4, 3),)

"""Traffic kind ``image``: ``tpu_rt_torch.render`` of an optical scene
file, one image a seed, ``spp`` samples a pixel in launches of
``spp_per_pass``.

``Entry`` builds what the program needs once and runs one call of the
timed path (``call``); ``check`` compares kept images with the
configuration's plain reference.  ``Control`` puts that reference,
computed in bfloat16, in the program's place.  ``TINY`` holds the traffic
keys that the benchmark's CPU tests override, to a size they hold; a run
never reads it.
"""

from __future__ import annotations

import os

import torch

import yardstick

TINY = dict(spp=8, spp_per_pass=4, overrides={"res": 16})


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
                           radius=sc["radius"], launches=-(-trf["spp"] // trf["spp_per_pass"]))

    def call(self, seed):
        t = self.trf
        return (self.tt.render(self.scene, spp=t["spp"], seed=seed, device=self.device,
                               spp_per_pass=t["spp_per_pass"], tile_rows=t["tile_rows"]),)

    def reference(self, seed, dtype=torch.float32):
        """The reference's image of ``seed``, every pixel, [H*W, 3]
        (float64 for float32)."""
        t, sh = self.trf, self.shapes
        pix = torch.arange(sh["W"] * sh["H"], device=self.device)
        img, _ = self.ref.image_pixels(self.path, seed, t["spp"], t["tile_rows"] * 128, pix,
                                       self.device, dtype=dtype, overrides=self.overrides)
        return img

    def check(self, kept, seed):
        """Each kept image against the reference's: ``image_err``, the
        largest |image - reference| over the largest |reference|, the
        worst over the kept images."""
        worst = 0.0
        for _, s, (img,) in kept:
            worst = max(worst, yardstick.rel_max(img.reshape(-1, 3).to(torch.float64),
                                                 self.reference(s)))
        return {"image_err": worst}


class Control:
    """The reference computed in bfloat16 in the program's place: its
    image in the program's shape, as float32."""

    def __init__(self, entry):
        self.entry = entry

    def __getattr__(self, name):
        return getattr(self.entry, name)

    def call(self, seed):
        sh = self.entry.shapes
        img = self.entry.reference(seed, torch.bfloat16)
        return (img.to(torch.float32).reshape(sh["H"], sh["W"], 3),)

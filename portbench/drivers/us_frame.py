"""Traffic kind ``us_frame``: ``tpu_rt_torch.us_render``, one acquisition
of the whole plane-wave sequence with ``rays_per_pair`` rays an (angle,
element) pair, its DAS image, envelope and log compression, a seed a
frame.

``Entry`` builds what the program needs once and runs one call of the
timed path (``call``); ``check`` compares kept frames with the
configuration's plain reference.  ``Control`` puts that reference,
computed in bfloat16, in the program's place.  ``TINY`` holds the traffic
keys that the benchmark's CPU tests override, to a size they hold; a run
never reads it.
"""

from __future__ import annotations

import copy

import torch

import yardstick

TINY = dict(rays_per_pair=4, x_bounds=[-0.004, 0.004], z_bounds=[0.046, 0.054])


class Entry:
    def __init__(self, cfg, trf, ref, device):
        import tpu_rt_torch as tt

        self.tt, self.cfg, self.trf, self.ref, self.device = tt, cfg, trf, ref, device
        self.scene = tt.load_dict(copy.deepcopy(cfg["scene"]))
        S = ref.Setup(cfg)
        xg, zg = ref.grid(cfg, trf["x_bounds"], trf["z_bounds"])
        self.shapes = dict(A=S.A, E=S.E, T=S.T, nx=xg.numel(), nz=zg.numel(),
                           n_prims=len(S.rects), rays_per_pair=trf["rays_per_pair"])

    def call(self, seed):
        t = self.trf
        return self.tt.us_render(self.scene, seed=seed, rays_per_pair=t["rays_per_pair"],
                                 x_bounds=tuple(t["x_bounds"]), z_bounds=tuple(t["z_bounds"]),
                                 dynamic_range=t["dynamic_range"], device=self.device)

    def reference(self, seed, dtype=torch.float32):
        """The reference's (B-mode, RF, transmit delays) of ``seed``; keeps
        its work counts in ``counts``."""
        t = self.trf
        rf, tx, self.counts = self.ref.acquisition(self.cfg, seed, t["rays_per_pair"],
                                                   t["tile_rows"] * 128, self.device, dtype)
        bm = self.ref.bmode(self.cfg, rf, t["x_bounds"], t["z_bounds"], t["dynamic_range"])
        return bm, rf, tx

    def check(self, kept, seed):
        """Each kept frame: ``rf_err`` (the largest |RF - reference| over
        the largest |reference RF|), ``tx_err`` (the same of the transmit
        delays) and ``bmode_err`` (the largest |B-mode - reference B-mode|,
        both in [0, 1]), each the worst over the kept frames."""
        out = {"rf_err": 0.0, "tx_err": 0.0, "bmode_err": 0.0}
        for _, s, (bm, rf, tx) in kept:
            bm_r, rf_r, tx_r = self.reference(s)
            out["rf_err"] = max(out["rf_err"], yardstick.rel_max(rf, rf_r))
            out["tx_err"] = max(out["tx_err"], yardstick.rel_max(tx, tx_r))
            out["bmode_err"] = max(out["bmode_err"], float((bm - bm_r).abs().max()))
        return out


class Control:
    """The reference computed in bfloat16 in the program's place: its
    (B-mode, RF, transmit delays), as float32."""

    def __init__(self, entry):
        self.entry = entry

    def __getattr__(self, name):
        return getattr(self.entry, name)

    def call(self, seed):
        return tuple(x.to(torch.float32) for x in self.entry.reference(seed, torch.bfloat16))

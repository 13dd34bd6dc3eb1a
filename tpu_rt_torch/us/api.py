"""ultraspy-compatible API facades.

Counterpart of ``tpu_rt/us/api.py``: ``build_probe`` / ``GridScan`` /
``DelayAndSum`` with ultraspy's call shapes over this package's DAS, so a
user of the USMain script ports it with an import swap.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.sensor.transducer import element_geometry
from tpu_rt_torch.us.beamform import das_beamform, hilbert_envelope


class Probe:
    def __init__(self, geometry_type, nb_elements, pitch, central_freq,
                 bandwidth=70, radius=float("inf")):
        if geometry_type not in ("linear", "convex"):
            raise NotImplementedError("geometry_type must be linear or convex")
        if geometry_type == "convex" and not np.isfinite(radius):
            raise ValueError("convex probes need a finite radius")
        self.geometry_type = geometry_type
        self.nb_elements = int(nb_elements)
        self.pitch = float(pitch)
        self.central_freq = float(central_freq)
        self.bandwidth = float(bandwidth)
        self.radius = float(radius)

    def _positions(self):
        r = self.radius if self.geometry_type == "convex" else float("inf")
        pos, _ = element_geometry(self.nb_elements, self.pitch, r)
        return pos.numpy()

    @property
    def elements_x(self):
        return self._positions()[:, 0]

    @property
    def elements_z(self):
        return self._positions()[:, 2]


def build_probe(geometry_type="linear", nb_elements=128, pitch=0.0003,
                central_freq=5e6, bandwidth=70, radius=float("inf")):
    """ultraspy.probes.factory.build_probe equivalent; convex arrays take a
    finite ``radius``."""
    return Probe(geometry_type, nb_elements, pitch, central_freq, bandwidth, radius)


class GridScan:
    """ultraspy.scan.GridScan equivalent."""

    def __init__(self, x, z):
        self.x = torch.from_numpy(np.asarray(x, np.float32).reshape(-1))
        self.z = torch.from_numpy(np.asarray(z, np.float32).reshape(-1))

    @property
    def shape(self):
        return (self.x.shape[0], self.z.shape[0])


class DelayAndSum:
    """ultraspy.beamformers.das.DelayAndSum equivalent.  ``on_gpu`` is kept
    for API compatibility; the work runs on the device of the data passed
    to ``beamform``."""

    def __init__(self, on_gpu=False):
        self.on_gpu = on_gpu
        self.sampling_freq = None
        self.sound_speed = None
        self.t0 = 0.0
        self.angles_deg = None
        self.probe = None

    def automatic_setup(self, acquisition_info, probe):
        self.sampling_freq = float(acquisition_info["sampling_freq"])
        self.sound_speed = float(acquisition_info.get("sound_speed", 1540.0))
        self.t0 = float(acquisition_info.get("t0", 0.0) or 0.0)
        self.probe = probe
        delays = np.asarray(acquisition_info.get("delays"))
        if delays is not None and delays.ndim == 2:
            # steering angles from the plane-wave delay law t = x sin(a) / c
            x = probe.elements_x
            denom = float(x @ x)
            sin_a = (delays @ x) * self.sound_speed / max(denom, 1e-20)
            self.angles_deg = np.rad2deg(np.arcsin(np.clip(sin_a, -1, 1)))
        return self

    def beamform(self, data, scan: GridScan):
        """data: [A, E, T] RF samples -> beamformed [Nx, Nz]."""
        if self.angles_deg is None:
            raise RuntimeError("call automatic_setup first")
        data = torch.as_tensor(data, dtype=torch.float32)
        return das_beamform(
            data, self.angles_deg, self.probe.elements_x, self.sampling_freq,
            self.sound_speed, scan.x, scan.z, t_offset=self.t0,
            elem_z=self.probe.elements_z)

    def compute_envelope(self, output, scan: GridScan):
        return hilbert_envelope(output, axis=1)

    def __repr__(self):
        return (f"DelayAndSum(fs={self.sampling_freq}, c={self.sound_speed}, "
                f"angles={None if self.angles_deg is None else len(self.angles_deg)})")

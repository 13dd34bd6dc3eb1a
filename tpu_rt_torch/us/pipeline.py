"""End-to-end ultrasound pipeline: acquisition -> DAS -> B-mode.

Counterpart of ``tpu_rt/us/pipeline.py``'s kernel route
(``us_render(use_pallas=True)``): the acquisition runs through the
ultrasound kernel (``ops/us_kernel.py``; ``csrc/us_acq.cu`` on CUDA), then
delay-and-sum over a lambda/4 grid spanning x in [-4, 4] cm and z in
[1, 50] mm, envelope detection and 60 dB log compression.

``us_render_fast`` is ``us_render``: PyTorch runs eagerly, so the JAX
package's cache of jitted closures has no counterpart.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.ops.us_kernel import simulate_acquisition
from tpu_rt_torch.scene.types import Scene
from tpu_rt_torch.sensor.transducer import element_geometry
from tpu_rt_torch.us.beamform import bmode_pipeline, grid_scan


def us_render(scene: Scene, seed=0, rays_per_pair=1, x_bounds=(-0.04, 0.04),
              z_bounds=(0.001, 0.05), dynamic_range=60.0, device="cuda"):
    """Returns (display_image [Nz, Nx], channel_buf [A, E, T],
    tx_delays [A, E]), all on ``device``.  On CUDA the acquisition launches
    the kernel (or raises); on the CPU it runs the kernel's plain version.
    ``seed`` keys the kernel's RNG as tpu_rt's kernel route does."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("us_render(device='cuda') needs a CUDA device; "
                           "pass device='cpu' to run the plain version")
    us = scene.ultrasound
    channel_buf, tx = simulate_acquisition(scene, seed=seed, rays_per_pair=rays_per_pair,
                                           device=device)
    step = float(us.sound_speed) / float(us.frequency) / 4.0
    x_grid, z_grid = grid_scan(x_bounds[0], x_bounds[1], z_bounds[0], z_bounds[1], step, step)
    # true element (x, z) positions: a convex array's arc enters the delays
    pos, _ = element_geometry(us.n_elements, us.pitch, us.radius, us.opening_angle)
    img = bmode_pipeline(channel_buf, us.angles, pos[:, 0], us.sampling_rate,
                         us.sound_speed, x_grid, z_grid, dynamic_range,
                         elem_z=pos[:, 2])
    return img, channel_buf, tx


us_render_fast = us_render

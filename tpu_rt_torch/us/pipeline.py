"""End-to-end ultrasound pipeline: acquisition -> DAS -> B-mode.

Counterpart of ``tpu_rt/us/pipeline.py``'s kernel route
(``us_render(use_pallas=True)``): the acquisition runs through the
ultrasound kernel (``ops/us_kernel.py``; ``csrc/us_acq.cu`` on CUDA), then
delay-and-sum over a lambda/4 grid spanning x in [-4, 4] cm and z in
[1, 50] mm, envelope detection and 60 dB log compression.  The DAS is the
gather form (``us/beamform.py::das_beamform``: ``csrc/us_das.cu`` on
CUDA, its plain version on the CPU); tpu_rt's route takes its MXU form,
``das_beamform_matmul``, which computes the same image to rounding.

``us_render_fast`` is ``us_render``: PyTorch runs eagerly, so the JAX
package's cache of jitted closures has no counterpart; what a frame needs
that depends on the scene alone (the kernel's tables, the rays, the grid
and element positions on the device) is kept per scene object
(``ops/us_kernel.py::per_scene``), so a frame on the card copies nothing
from the host and waits for nothing.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.ops.us_kernel import per_scene, simulate_acquisition
from tpu_rt_torch.scene.types import Scene
from tpu_rt_torch.sensor.transducer import element_geometry
from tpu_rt_torch.us.beamform import bmode_pipeline, grid_scan


def us_render(scene: Scene, seed=0, rays_per_pair=1, x_bounds=(-0.04, 0.04),
              z_bounds=(0.001, 0.05), dynamic_range=60.0, device="cuda"):
    """Returns (display_image [Nz, Nx], channel_buf [A, E, T],
    tx_delays [A, E]), all on ``device``.  On CUDA the acquisition launches
    the kernel (or raises), and so does the DAS; on the CPU both run their
    kernels' plain versions.
    ``seed`` keys the kernel's RNG as tpu_rt's kernel route does."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("us_render(device='cuda') needs a CUDA device; "
                           "pass device='cpu' to run the plain version")
    us = scene.ultrasound
    channel_buf, tx = simulate_acquisition(scene, seed=seed, rays_per_pair=rays_per_pair,
                                           device=device)

    def geometry():
        step = float(us.sound_speed) / float(us.frequency) / 4.0
        x_grid, z_grid = grid_scan(x_bounds[0], x_bounds[1], z_bounds[0], z_bounds[1], step,
                                   step)
        # true element (x, z) positions: a convex array's arc enters the delays
        pos, _ = element_geometry(us.n_elements, us.pitch, us.radius, us.opening_angle)
        return tuple(t.to(device) for t in (x_grid, z_grid, pos[:, 0], pos[:, 2], us.angles))

    x_grid, z_grid, elem_x, elem_z, angles = per_scene(
        scene, ("frame", tuple(x_bounds), tuple(z_bounds), str(device)), geometry)
    img = bmode_pipeline(channel_buf, angles, elem_x, us.sampling_rate, us.sound_speed,
                         x_grid, z_grid, dynamic_range, method="gather", elem_z=elem_z)
    return img, channel_buf, tx


us_render_fast = us_render

"""End-to-end ultrasound pipeline: acquisition -> DAS -> B-mode.

Counterpart of ``tpu_rt/us/pipeline.py::us_render``.  The acquisition
takes one of two routes, chosen by the scene's scope as
``tpu_rt/us/pipeline.py:35-52`` chooses them:

* ``use_kernel=True`` (the default, tpu_rt's ``use_pallas=True``) and a
  scene in the acquisition kernel's scope (``ops/us_kernel.py::
  bake_us_scene``: at most 64 prims of the kinds its sweep takes): the
  kernel K10 (``csrc/us_acq.cu`` on CUDA, its plain version on the CPU);
* otherwise, every scene: the acoustic wavefront
  (``integrator/ultrasound.py``, tpu_rt's default route), whose closest
  hits and shadow rays run through ``geometry/trace.py`` (K7 on a mesh
  with cluster tables).

Never a fallback: a failed build or launch raises.  Then delay-and-sum
over a lambda/4 grid spanning x in [-4, 4] cm and z in [1, 50] mm,
envelope detection and 60 dB log compression.  The DAS is the gather form
(``us/beamform.py::das_beamform``: ``csrc/us_das.cu`` on CUDA, its plain
version on the CPU); tpu_rt's route takes its MXU form,
``das_beamform_matmul``, which computes the same image to rounding.

``us_render_fast`` is ``us_render``: PyTorch runs eagerly, so the JAX
package's cache of jitted closures has no counterpart; what a frame needs
that depends on the scene alone (the kernel's tables or the scene on the
device, the rays, the grid and element positions on the device, the
route) is kept per scene object (``ops/us_kernel.py::per_scene``), so a
frame on the card copies nothing from the host.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.integrator import ultrasound as wavefront
from tpu_rt_torch.ops import us_kernel
from tpu_rt_torch.ops.us_kernel import per_scene
from tpu_rt_torch.scene.types import Scene
from tpu_rt_torch.sensor.transducer import element_geometry
from tpu_rt_torch.us.beamform import bmode_pipeline, grid_scan


def in_kernel_scope(scene: Scene) -> bool:
    """True when the acquisition kernel takes the scene (kept per scene)."""
    return per_scene(scene, ("in_scope",), lambda: us_kernel.bake_us_scene(scene) is not None)


def us_render(scene: Scene, seed=0, rays_per_pair=1, x_bounds=(-0.04, 0.04),
              z_bounds=(0.001, 0.05), dynamic_range=60.0, device="cuda", use_kernel=True):
    """Returns (display_image [Nz, Nx], channel_buf [A, E, T],
    tx_delays [A, E]), all on ``device``.  The acquisition runs through
    the kernel when ``use_kernel`` and the scene is in its scope (on CUDA
    it launches the kernel or raises; ``seed`` keys its RNG as tpu_rt's
    kernel route does), else through the wavefront (``seed`` seeds its
    generator); on CUDA the DAS launches its kernel or raises.  On the CPU
    the kernels' plain versions run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("us_render(device='cuda') needs a CUDA device; "
                           "pass device='cpu' to run the plain version")
    us = scene.ultrasound
    if use_kernel and in_kernel_scope(scene):
        channel_buf, tx = us_kernel.simulate_acquisition(
            scene, seed=seed, rays_per_pair=rays_per_pair, device=device)
    else:
        channel_buf, tx = wavefront.simulate_acquisition(
            scene, seed=seed, rays_per_pair=rays_per_pair, device=device)

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

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
route) is kept per scene object (``utils/memo.py::per_object``), so a
frame on the card copies nothing from the host.  What is kept is
detached; a tensor that requires grad, and what is made from it, is taken
anew each call, so no frame is handed another frame's graph.
``us_render_jit`` is ``us_render`` returning the image alone.

Differentiable on both routes, as tpu_rt's: the kernel route's backward
is the wavefront's (``us_kernel.simulate_acquisition_fastgrad``), the
DAS's its adjoint kernel (``us/beamform.py::das_adjoint``); the envelope
and log compression are torch operations.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.integrator import ultrasound as wavefront
from tpu_rt_torch.ops import us_kernel
from tpu_rt_torch.scene.types import Scene, grad_tensors
from tpu_rt_torch.sensor.transducer import element_geometry
from tpu_rt_torch.us.beamform import bmode_pipeline, grid_scan
from tpu_rt_torch.utils.memo import per_object
from tpu_rt_torch.utils.profiling import span


def in_kernel_scope(scene: Scene) -> bool:
    """True when the acquisition kernel takes the scene (kept per scene)."""
    return per_object(scene, ("in_scope",), lambda: us_kernel.bake_us_scene(scene) is not None)


def _das_geometry(scene, device):
    """The element x and z positions [E] (a convex array's arc enters the
    delays) and the angles [A] on ``device``: kept per scene detached,
    made anew each call when one of their tensors requires grad."""
    def make(us):
        pos, _ = element_geometry(us.n_elements, us.pitch, us.radius, us.opening_angle)
        return pos[:, 0].to(device), pos[:, 2].to(device), us.angles.to(device)

    us = scene.ultrasound
    if grad_tensors(us):
        return make(us)
    return per_object(scene, ("das geometry", str(device)), lambda: make(us.detach()))


def us_render(scene: Scene, seed=0, rays_per_pair=1, x_bounds=(-0.04, 0.04),
              z_bounds=(0.001, 0.05), dynamic_range=60.0, device="cuda", use_kernel=True):
    """Returns (display_image [Nz, Nx], channel_buf [A, E, T],
    tx_delays [A, E]), all on ``device``.  The acquisition runs through
    the kernel when ``use_kernel`` and the scene is in its scope (on CUDA
    it launches the kernel or raises; ``seed`` keys its RNG as tpu_rt's
    kernel route does), else through the wavefront (``seed`` seeds its
    generator); on CUDA the DAS launches its kernel or raises.  On the CPU
    the kernels' plain versions run.

    Differentiable on both routes, as tpu_rt's ``us_render`` is: with
    autograd on and a scene tensor that requires grad, the kernel route
    takes ``simulate_acquisition_fastgrad`` (the kernel's primal, the
    wavefront's gradient), the wavefront is its own backward, and the DAS
    backpropagates through its adjoint kernel on CUDA (through autograd of
    its plain version on the CPU).  Otherwise the kernel route runs
    ``simulate_acquisition`` (tpu_rt's ``_forward_only``)."""
    with span("tpu_rt_torch.us_render"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("us_render(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run the plain version")
        us = scene.ultrasound
        if use_kernel and in_kernel_scope(scene):
            acquire = (us_kernel.simulate_acquisition_fastgrad if grad_tensors(scene)
                       else us_kernel.simulate_acquisition)
        else:
            acquire = wavefront.simulate_acquisition
        channel_buf, tx = acquire(scene, seed=seed, rays_per_pair=rays_per_pair, device=device)

        def grid():
            step = float(us.sound_speed.detach()) / float(us.frequency.detach()) / 4.0
            x_grid, z_grid = grid_scan(x_bounds[0], x_bounds[1], z_bounds[0], z_bounds[1], step,
                                       step)
            return x_grid.to(device), z_grid.to(device)

        x_grid, z_grid = per_object(scene, ("grid", tuple(x_bounds), tuple(z_bounds), str(device)),
                                    grid)
        elem_x, elem_z, angles = _das_geometry(scene, device)
        img = bmode_pipeline(channel_buf, angles, elem_x, us.sampling_rate, us.sound_speed,
                             x_grid, z_grid, dynamic_range, method="gather", elem_z=elem_z)
        return img, channel_buf, tx


us_render_fast = us_render


def us_render_jit(scene: Scene, seed=0, rays_per_pair=1, device="cuda"):
    """The B-mode image alone (tpu_rt's ``us_render_jit``, a jitted forward
    whose scene stays traceable for jax.grad).  PyTorch runs eagerly, so
    this is ``us_render`` with the image taken, differentiable as it is."""
    return us_render(scene, seed=seed, rays_per_pair=rays_per_pair, device=device)[0]

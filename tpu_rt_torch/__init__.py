"""tpu_rt_torch — the PyTorch / CUDA port of ``tpu_rt``.

The JAX package ``tpu_rt`` is the reference this package is held to.  The
port mirrors its layout (``scene/``, ``sensor/``, ``integrator/``, ``ops/``,
``us/``) and its public API: ``load_file`` / ``load_dict`` build a scene,
``render`` renders it, ``us_render`` runs the ultrasound acquisition,
beamforming and B-mode display.  On an NVIDIA GPU the path-tracing bounce
loop with its film accumulation (scalar or polarized, per-sample or in a
regeneration loop), the ultrasound acquisition bounce loop and direct
lighting on a mesh each run in hand-written CUDA kernels
(``ops/csrc/path_film.cu``, ``us_acq.cu``, ``mesh_direct.cu``), and the
delay-and-sum beamformer in a fourth (``us_das.cu``); scenes outside their
scope render through the wavefronts (``integrator/path.py``,
``integrator/stokes.py`` for polarized transport through polarizers,
``integrator/ultrasound.py`` for the acoustic acquisition), whose mesh
queries run in a fifth (``mesh_isect.cu``).  On the CPU the kernels' plain
PyTorch versions run.

Inverse rendering (``opt/inverse.py``, ``opt/checkpoint.py``, the
reference's shims in ``compat.py``) runs on torch's autograd: the
ultrasound frame backpropagates on both acquisition routes (the kernel's
primal with the acoustic wavefront's gradient, ``us_kernel.
simulate_acquisition_fastgrad``) and through the DAS's hand-written
adjoint kernel (``us_das.cu``); an optical scene that requires grad
renders through the wavefront, as the film kernels are forward only, and
``integrator/projective.py`` softens curve shadows so that autograd
reaches a curve's position and radii (``direct_projective``'s gradient).
Bitmap textures (``bsdf/texture.py``) and B-spline curves load as in
``tpu_rt`` and render through the wavefront.

This package imports torch, numpy and the standard library, never jax.
"""

__version__ = "0.1.0"

from tpu_rt_torch.integrator import render  # noqa: F401
from tpu_rt_torch.scene import ScalarTransform4f, load_dict, load_file  # noqa: F401
from tpu_rt_torch.us.pipeline import us_render, us_render_jit  # noqa: F401

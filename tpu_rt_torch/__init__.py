"""tpu_rt_torch — the PyTorch / CUDA port of ``tpu_rt``.

The JAX package ``tpu_rt`` is the reference this package is held to.  The
port mirrors its layout (``scene/``, ``sensor/``, ``integrator/``, ``ops/``,
``us/``) and its public API: ``load_file`` / ``load_dict`` build a scene,
``render`` renders it, ``us_render`` runs the ultrasound acquisition,
beamforming and B-mode display.  On an NVIDIA GPU the path-tracing bounce
loop with its film accumulation, and the ultrasound acquisition bounce
loop, each run in one hand-written CUDA kernel (``ops/csrc/path_film.cu``,
``ops/csrc/us_acq.cu``); on the CPU their plain PyTorch versions run.

This package imports torch, numpy and the standard library, never jax.
"""

__version__ = "0.1.0"

from tpu_rt_torch.integrator import render  # noqa: F401
from tpu_rt_torch.scene import ScalarTransform4f, load_dict, load_file  # noqa: F401
from tpu_rt_torch.us.pipeline import us_render  # noqa: F401

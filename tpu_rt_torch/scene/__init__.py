"""Scene loading API (``mi.load_file`` / ``mi.load_dict`` equivalents).

Counterpart of ``tpu_rt/scene/__init__.py``.
"""

from tpu_rt_torch.scene.build import build_scene
from tpu_rt_torch.scene.convert import scene_from_arrays  # noqa: F401
from tpu_rt_torch.scene.transforms import ScalarTransform4f  # noqa: F401
from tpu_rt_torch.scene.types import Camera, Scene, UltrasoundConfig  # noqa: F401
from tpu_rt_torch.scene.xml_loader import load_xml


def load_file(path, curve_mode="exact", **overrides):
    """Load a Mitsuba XML scene file; ``overrides`` play the role of
    command-line ``-Dname=value`` parameters (e.g. ``res=64, spp=8``).
    ``curve_mode`` "exact" loads a ``bsplinecurve`` as swept-sphere
    prims, "mesh" as a tube mesh (tpu_rt's ``TPU_RT_CURVE_MODE``)."""
    return build_scene(load_xml(path, overrides=overrides or None), curve_mode=curve_mode)


def load_dict(desc, curve_mode="exact"):
    """Load a Mitsuba-style scene dict (``curve_mode`` as in ``load_file``)."""
    return build_scene(desc, curve_mode=curve_mode)

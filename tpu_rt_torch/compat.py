"""Reference-compatible API shims.

Counterpart of ``tpu_rt/compat.py``: the plugin surface of the reference
(ReaganCardoza/Physics-Based-Ray-Tracing), so a user of the reference can
port a script with an import swap:

  * ``UltraIntegrator`` - CustomIntegrator.py:12 (simulate_acquisition /
    simulate_acquisition_parallel / channel_buf / transmission_delays_buf)
  * ``us_render`` - USMain.py:92's pipeline (``us/pipeline.py``)
  * ``traverse`` - mi.traverse: a dict of parameters with ``.update()``
  * ``register_integrator`` etc. - no-op registry shims (the scene builder
    resolves plugins from their type strings)

Both ``simulate_acquisition`` names run the same batched acoustic
wavefront: the reference's 'parallel' variant only worked around its
Python loop.  Its buffers are tensors on the integrator's ``device``.
"""

from __future__ import annotations

from tpu_rt_torch.scene.types import Scene
from tpu_rt_torch.us.pipeline import us_render  # noqa: F401

_REGISTRY = {}


def register_integrator(name, cls=None):
    _REGISTRY[("integrator", name)] = cls


def register_sensor(name, cls=None):
    _REGISTRY[("sensor", name)] = cls


def register_emitter(name, cls=None):
    _REGISTRY[("emitter", name)] = cls


def register_bsdf(name, cls=None):
    _REGISTRY[("bsdf", name)] = cls


class UltraIntegrator:
    """Stateful facade of the reference's UltraIntegrator
    (CustomIntegrator.py:12-49): construct it from a Scene (or through
    ``scene_integrator(scene)``), call ``simulate_acquisition``, read
    ``channel_buf`` [A, E, T], ``transmission_delays_buf`` [A, E] (tensors
    on ``device``) and ``ray_count``."""

    def __init__(self, scene: Scene, device="cuda"):
        if scene.ultrasound is None:
            raise ValueError("scene has no ultrasound integrator")
        self.scene = scene
        self.device = device
        us = scene.ultrasound
        # the reference's attribute names (CustomIntegrator.py:16-46)
        self.max_depth = us.max_depth
        self.frequency = float(us.frequency)
        self.sound_speed = float(us.sound_speed)
        self.attenuation = float(us.attenuation)
        self.wave_cycles = us.wave_cycles
        self.main_beam_angle = float(us.main_beam_angle)
        self.cutoff_angle = float(us.cutoff_angle)
        self.fs = float(us.sampling_rate)
        self.n_elements = us.n_elements
        self.pitch = float(us.pitch)
        self.angles = us.angles.detach().cpu().numpy()
        self.n_angles = us.n_angles
        self.time_samples = us.time_samples
        self.channel_buf = None
        self.transmission_delays_buf = None
        self.ray_count = 0

    def simulate_acquisition(self, scene=None, seed=0, rays_per_pair=1):
        """The acquisition through the acoustic wavefront
        (``integrator/ultrasound.py``), as tpu_rt's runs its XLA one; fills
        the buffers and returns True, as the reference does
        (CustomIntegrator.py:232)."""
        from tpu_rt_torch.integrator.ultrasound import simulate_acquisition

        scene = self.scene if scene is None else scene
        ch, tx = simulate_acquisition(scene, seed=seed, rays_per_pair=rays_per_pair,
                                      device=self.device)
        self.channel_buf = ch
        self.transmission_delays_buf = tx
        self.ray_count = int(self.n_angles * self.n_elements * rays_per_pair * self.max_depth)
        return True

    simulate_acquisition_parallel = simulate_acquisition


def scene_integrator(scene: Scene, device="cuda") -> UltraIntegrator:
    """scene.integrator() (USMain.py:95)."""
    return UltraIntegrator(scene, device=device)


def traverse(scene: Scene):
    """mi.traverse(scene): a dict of the parameters under Mitsuba-style
    keys, whose ``update()`` returns the scene with the changed values set
    (USMain.py:259-266)."""
    from tpu_rt_torch.opt import inverse

    class Params(dict):
        def __init__(self, sc):
            super().__init__()
            self._scene = sc
            self._dirty = {}
            for k in inverse.traverse(sc):
                super().__setitem__(k, inverse.get_param(sc, k))

        def __setitem__(self, key, value):
            self._dirty[key] = value
            super().__setitem__(key, value)

        def update(self, *args, **kwargs):
            sc = self._scene
            for k, v in self._dirty.items():
                sc = inverse.set_param(sc, k, v)
            self._dirty.clear()
            self._scene = sc
            return sc

        @property
        def scene(self):
            return self._scene

    return Params(scene)

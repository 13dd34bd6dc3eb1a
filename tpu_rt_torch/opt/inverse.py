"""Differentiable inverse rendering: mi.traverse()-style parameter access
and a gradient loop.

Counterpart of ``tpu_rt/opt/inverse.py``.  The reference shipped a
finite-difference loop (25 iterations of two full simulations,
USMain.py:262-298); here the pipeline (acquisition -> beamforming -> loss,
or a wavefront render -> loss) is differentiated by torch's autograd, so
an iteration is one forward and one backward.  On the card the ultrasound
forward is the acquisition kernel K10 and the DAS kernel, the backward the
acoustic wavefront's replay and the DAS's adjoint kernel
(``us/pipeline.py``).

Parameters are addressed with Mitsuba-style keys,
"<shape_id>.bsdf.roughness", "<shape_id>.bsdf.impedance", ... (rows of
``scene.bsdf_params``) and "ultrasound.<name>" (the configuration's
tensors), as tpu_rt names them.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_rt_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_POLARIZER,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ULTRASOUND,
    Scene,
)

# param name -> (applicable bsdf types, column range in bsdf_params)
_BSDF_PARAM_SLOTS = {
    "reflectance": ((BSDF_DIFFUSE,), (0, 3)),
    "int_ior": ((BSDF_DIELECTRIC,), (0, 1)),
    "ext_ior": ((BSDF_DIELECTRIC,), (1, 2)),
    "eta": ((BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR), (0, 3)),
    "k": ((BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR), (3, 6)),
    "alpha": ((BSDF_ROUGH_CONDUCTOR,), (9, 10)),
    "theta": ((BSDF_POLARIZER,), (0, 1)),
    "impedance": ((BSDF_ULTRASOUND,), (0, 1)),
    "roughness": ((BSDF_ULTRASOUND,), (1, 2)),
}

# ultrasound config attributes addressable via "ultrasound.<name>" keys
_US_PARAMS = {
    "pitch", "frequency", "sound_speed", "attenuation", "main_beam_angle",
    "cutoff_angle", "sampling_rate", "angles", "elements_width",
    "elements_height", "radius", "directivity",
}


def traverse(scene: Scene):
    """List every differentiable parameter key (mi.traverse equivalent)."""
    keys = []
    shapes = scene.ids["shapes"] if scene.ids else {}
    shape_bsdf = scene.ids["shape_bsdf"] if scene.ids else []
    btypes = scene.bsdf_type.tolist()
    for name, sid in shapes.items():
        b = shape_bsdf[sid]
        for pname, (types, _) in _BSDF_PARAM_SLOTS.items():
            if btypes[b] in types:
                keys.append(f"{name}.bsdf.{pname}")
    if scene.ultrasound is not None:
        keys += [f"ultrasound.{p}" for p in sorted(_US_PARAMS)]
    return keys


def _resolve(scene: Scene, key: str):
    parts = key.split(".")
    if parts[0] == "ultrasound":
        if parts[1] not in _US_PARAMS:
            raise KeyError(key)
        return ("us", parts[1])
    if len(parts) == 3 and parts[1] == "bsdf":
        shape_name, _, pname = parts
        sid = scene.ids["shapes"][shape_name]
        b = scene.ids["shape_bsdf"][sid]
        _, (lo, hi) = _BSDF_PARAM_SLOTS[pname]
        return ("bsdf", b, lo, hi)
    raise KeyError(f"cannot resolve parameter key {key!r}")


def get_param(scene: Scene, key: str):
    """The parameter's tensor (a view of the scene's): 0-d for a one-column
    BSDF slot or a scalar configuration field."""
    r = _resolve(scene, key)
    if r[0] == "us":
        return getattr(scene.ultrasound, r[1])
    _, b, lo, hi = r
    v = scene.bsdf_params[b, lo:hi]
    return v[0] if hi - lo == 1 else v


def set_param(scene: Scene, key: str, value) -> Scene:
    """A new scene with the parameter set (params.update() equivalent).
    Nothing is updated in place: the BSDF table is copied before the slot
    is written, so a ``value`` that requires grad passes its gradient on
    (the optimizer's leaf tensors)."""
    r = _resolve(scene, key)
    if r[0] == "us":
        old = getattr(scene.ultrasound, r[1])
        value = torch.as_tensor(value, dtype=torch.float32, device=old.device)
        us = dataclasses.replace(scene.ultrasound, **{r[1]: value.expand(old.shape)})
        return dataclasses.replace(scene, ultrasound=us)
    _, b, lo, hi = r
    params = scene.bsdf_params.clone()
    value = torch.as_tensor(value, dtype=torch.float32, device=params.device)
    params[b, lo:hi] = value.expand(hi - lo)
    return dataclasses.replace(scene, bsdf_params=params)


def _apply_params(scene: Scene, params) -> Scene:
    """``scene`` with every (key, value) of the dict ``params`` set."""
    for k, v in params.items():
        scene = set_param(scene, k, v)
    return scene


def optimize(scene: Scene, keys, loss_fn, n_iters=25, lr=2e-2, bounds=(1e-4, 1.0),
             verbose=False, checkpoint_path=None, checkpoint_every=5):
    """Adam-optimize scene parameters against ``loss_fn(scene) -> 0-d
    tensor``.

    The autograd realization of the loop the reference ran with finite
    differences (USMain.py:276-298; lr 2e-2, 25 iterations and the clip to
    [1e-4, 1] are its defaults).  The parameters are leaf tensors updated
    by ``torch.optim.Adam`` (beta1 0.9, beta2 0.999, eps 1e-8 outside the
    square root, bias correction: optax's ``adam``), then clipped to
    ``bounds`` under ``torch.no_grad()``.  With ``checkpoint_path`` set,
    the state is saved every ``checkpoint_every`` iterations and at the
    end (``opt/checkpoint.py``), and the loop resumes from a checkpoint
    found there.  Returns (optimized scene, list of losses)."""
    params = {k: get_param(scene, k).detach().clone().to(torch.float32).requires_grad_()
              for k in keys}
    optimizer = torch.optim.Adam(list(params.values()), lr=lr)
    losses = []
    start = 0
    if checkpoint_path:
        from tpu_rt_torch.opt.checkpoint import load_checkpoint, save_checkpoint

        ckpt = load_checkpoint(checkpoint_path)
        if ckpt is not None:
            saved, opt_state, losses, start = ckpt
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(saved[k])
            optimizer.load_state_dict(opt_state)
    for it in range(start, n_iters):
        optimizer.zero_grad()
        loss = loss_fn(_apply_params(scene, params))
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            for v in params.values():
                v.clamp_(bounds[0], bounds[1])
        losses.append(float(loss.detach()))
        if verbose:
            vals = {k: float(v.detach().reshape(-1)[0]) for k, v in params.items()}
            print(f"iter {it}: loss={losses[-1]:.4g} {vals}")
        if checkpoint_path and ((it + 1) % checkpoint_every == 0 or it + 1 == n_iters):
            save_checkpoint(checkpoint_path, params, optimizer.state_dict(), losses, it + 1)
    return _apply_params(scene, {k: v.detach() for k, v in params.items()}), losses

"""Mueller-matrix algebra for polarized (Stokes) light transport.

Counterpart of ``tpu_rt/bsdf/mueller.py``, all of it.  Conventions:

* Stokes vectors are (..., 4[, C]) = (I, Q, U, V) in a right-handed basis
  (b, cross(w, b), w), w the propagation direction and b the horizontal
  reference axis.
* Mueller matrices are (..., 4, 4); where Fresnel values are spectral,
  (..., 3, 4, 4) per RGB channel.
* ``rotator(phi)`` rotates the reference basis by phi around the
  propagation axis (it acts on the Q-U block with 2 phi).

The complex Fresnel amplitudes are torch ``complex64`` tensors, as the JAX
package's are; the film kernel spells the same arithmetic out in (re, im)
pairs (``ops/path_kernel.py::_fres_pol``).  Scalars may be passed as
Python floats; results are float32.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.core.math import cross, dot, normalize, safe_sqrt


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def rotator(phi):
    """Reference-frame rotation Mueller matrix (..., 4, 4)."""
    phi = _f32(phi)
    c = torch.cos(2.0 * phi)
    s = torch.sin(2.0 * phi)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rows = [
        torch.stack([o, z, z, z], -1),
        torch.stack([z, c, s, -z], -1),
        torch.stack([z, -s, c, z], -1),
        torch.stack([z, z, z, o], -1),
    ]
    return torch.stack(rows, -2)


def rotation_angle(w, b_from, b_to):
    """Signed rotation angle around the propagation direction w taking the
    basis b_from to b_to (both unit, both perpendicular to w)."""
    s = dot(cross(b_from, b_to), w)
    c = dot(b_from, b_to)
    return torch.atan2(s, c)


def depolarizer(value):
    """Ideal depolarizer scaled by ``value`` (diffuse surfaces): the output
    is unpolarized with intensity value * I_in."""
    value = _f32(value)
    m = torch.zeros(value.shape + (4, 4), dtype=torch.float32, device=value.device)
    m[..., 0, 0] = value
    return m


def absorber(value):
    """Neutral attenuator: scales all Stokes components."""
    value = _f32(value)
    return value[..., None, None] * torch.eye(4, dtype=torch.float32, device=value.device)


def linear_polarizer(theta, transmittance=1.0):
    """Ideal linear polarizer with its transmission axis at angle ``theta``
    from the reference basis (Mueller matrix, (..., 4, 4))."""
    theta = _f32(theta)
    c = torch.cos(2.0 * theta)
    s = torch.sin(2.0 * theta)
    z = torch.zeros_like(c)
    rows = [
        torch.stack([torch.ones_like(c), c, s, z], -1),
        torch.stack([c, c * c, s * c, z], -1),
        torch.stack([s, s * c, s * s, z], -1),
        torch.stack([z, z, z, z], -1),
    ]
    return 0.5 * _f32(transmittance).to(c.device)[..., None, None] * torch.stack(rows, -2)


def _fresnel_rs_rp_complex(cos_i, eta_c):
    """Complex s and p amplitude reflection coefficients for the relative
    complex IOR ``eta_c`` (conductor: eta + i k; dielectric: real)."""
    cos_i = torch.abs(_f32(cos_i)).to(torch.complex64)
    sin2 = 1.0 - cos_i * cos_i
    root = torch.sqrt(eta_c * eta_c - sin2)
    rs = (cos_i - root) / (cos_i + root)
    rp = (eta_c * eta_c * cos_i - root) / (eta_c * eta_c * cos_i + root)
    return rs, rp


def specular_reflection(cos_i, eta_re, eta_im=None):
    """Fresnel reflection Mueller matrix (..., 4, 4) in the s-p basis
    (s, perpendicular to the plane of incidence, is the Q = +1 axis).
    ``eta_re`` / ``eta_im`` broadcast against ``cos_i``; pass
    ``eta_im=None`` for a dielectric."""
    eta_c = _f32(eta_re).to(torch.complex64)
    if eta_im is not None:
        eta_c = eta_c + 1j * _f32(eta_im).to(torch.complex64)
    rs, rp = _fresnel_rs_rp_complex(cos_i, eta_c)
    Rs = torch.abs(rs) ** 2
    Rp = torch.abs(rp) ** 2
    crs = rs * torch.conj(rp)
    a = 0.5 * (Rs + Rp)
    b = 0.5 * (Rs - Rp)
    c = torch.real(crs)
    s = torch.imag(crs)
    z = torch.zeros_like(a)
    rows = [
        torch.stack([a, b, z, z], -1),
        torch.stack([b, a, z, z], -1),
        torch.stack([z, z, c, s], -1),
        torch.stack([z, z, -s, c], -1),
    ]
    return torch.stack(rows, -2).to(torch.float32)


def specular_transmission(cos_i, cos_t, eta_it):
    """Fresnel transmission Mueller matrix for a real (dielectric)
    relative IOR; the radiance scaling 1/eta^2 is applied by the caller."""
    cos_i, cos_t, eta = _f32(cos_i), _f32(cos_t), _f32(eta_it)
    denom_s = cos_i + eta * cos_t
    denom_p = eta * cos_i + cos_t
    ts = 2.0 * cos_i / torch.clamp(denom_s, min=1e-9)
    tp = 2.0 * cos_i / torch.clamp(denom_p, min=1e-9)
    # amplitude -> power: eta * cos_t / cos_i
    factor = eta * cos_t / torch.clamp(cos_i, min=1e-9)
    Ts = ts * ts * factor
    Tp = tp * tp * factor
    a = 0.5 * (Ts + Tp)
    b = 0.5 * (Ts - Tp)
    c = ts * tp * factor
    z = torch.zeros_like(a)
    rows = [
        torch.stack([a, b, z, z], -1),
        torch.stack([b, a, z, z], -1),
        torch.stack([z, z, c, z], -1),
        torch.stack([z, z, z, c], -1),
    ]
    return torch.stack(rows, -2)


def stokes_basis(w):
    """A deterministic horizontal basis vector perpendicular to w: the
    cross product with the axis least aligned with w."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device).expand(w.shape)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device).expand(w.shape)
    a = torch.where((torch.abs(w[..., 0]) > 0.9)[..., None], ey, ex)
    return normalize(cross(a, w))


def perpendicular_basis(w, reference):
    """``reference`` projected perpendicular to w and normalized
    (``stokes_basis`` where that is degenerate)."""
    proj = reference - dot(w, reference, keepdim=True) * w
    ln2 = (proj * proj).sum(-1, keepdim=True)
    return torch.where(ln2 > 1e-12, proj / safe_sqrt(ln2), stokes_basis(w))

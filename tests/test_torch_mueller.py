"""tpu_rt_torch/bsdf/mueller.py against tpu_rt's, on the CPU.

Every function on the same numpy-seeded inputs through both packages,
within rtol 1e-5 / atol 1e-6 (float32 trig, complex square roots and
reciprocals round differently in XLA and torch by an ulp or two), then
the closed forms of tests/test_stokes.py:15-46 on the port alone:
Malus's law, the rotator group, normal incidence and Brewster's angle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_rt.bsdf import mueller as mu_j
from tpu_rt_torch.bsdf import mueller as mu_t

RTOL, ATOL = 1e-5, 1e-6
N = 64


def _rng():
    return np.random.default_rng(11)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _both(fn_j, fn_t, *args):
    got = fn_t(*[torch.from_numpy(np.asarray(a)) for a in args]).numpy()
    want = np.asarray(fn_j(*[jnp.asarray(a) for a in args]))
    return got, want


def _perp(rng, w):
    """Unit vectors perpendicular to the rows of w."""
    r = rng.normal(size=w.shape).astype(np.float32)
    r = r - (r * w).sum(-1, keepdims=True) * w
    return (r / np.linalg.norm(r, axis=-1, keepdims=True)).astype(np.float32)


CASES = {
    "rotator": lambda r: (mu_j.rotator, mu_t.rotator,
                          r.uniform(-3, 3, N).astype(np.float32)),
    "depolarizer": lambda r: (mu_j.depolarizer, mu_t.depolarizer,
                              r.uniform(0, 2, (N, 3)).astype(np.float32)),
    "absorber": lambda r: (mu_j.absorber, mu_t.absorber,
                           r.uniform(0, 2, N).astype(np.float32)),
    "linear_polarizer": lambda r: (mu_j.linear_polarizer, mu_t.linear_polarizer,
                                   r.uniform(-3, 3, N).astype(np.float32),
                                   r.uniform(0, 1, N).astype(np.float32)),
    "specular_reflection_dielectric": lambda r: (
        mu_j.specular_reflection, mu_t.specular_reflection,
        r.uniform(-1, 1, N).astype(np.float32), r.uniform(0.6, 2.5, N).astype(np.float32)),
    "specular_reflection_conductor": lambda r: (
        mu_j.specular_reflection, mu_t.specular_reflection,
        r.uniform(0, 1, (N, 1)).astype(np.float32), r.uniform(0.1, 2, (N, 3)).astype(np.float32),
        r.uniform(1, 4, (N, 3)).astype(np.float32)),
    "specular_transmission": lambda r: (
        mu_j.specular_transmission, mu_t.specular_transmission,
        r.uniform(0.05, 1, N).astype(np.float32), r.uniform(0.05, 1, N).astype(np.float32),
        r.uniform(0.6, 1.6, N).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_tpu_rt(name):
    fn_j, fn_t, *args = CASES[name](_rng())
    got, want = _both(fn_j, fn_t, *args)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bases_and_rotation_angle_match_tpu_rt():
    rng = _rng()
    w = _unit(rng, N)
    w[0] = [1.0, 0.0, 0.0]  # the degenerate fallback of stokes_basis
    ref = _unit(rng, N)
    ref[1] = w[1]  # reference along w: perpendicular_basis falls back
    for fn_j, fn_t, args in ((mu_j.stokes_basis, mu_t.stokes_basis, (w,)),
                             (mu_j.perpendicular_basis, mu_t.perpendicular_basis, (w, ref))):
        got, want = _both(fn_j, fn_t, *args)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    b_from, b_to = _perp(rng, w), _perp(rng, w)
    got, want = _both(mu_j.rotation_angle, mu_t.rotation_angle, w, b_from, b_to)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_malus_law():
    S0 = torch.tensor([1.0, 0.0, 0.0, 0.0])
    for delta_deg in (0.0, 30.0, 45.0, 60.0, 90.0):
        d = np.deg2rad(delta_deg)
        S = mu_t.linear_polarizer(d) @ (mu_t.linear_polarizer(0.0) @ S0)
        np.testing.assert_allclose(float(S[0]), 0.5 * np.cos(d) ** 2, atol=1e-6)


def test_rotator_group():
    R1 = mu_t.rotator(0.7)
    np.testing.assert_allclose((R1 @ mu_t.rotator(-0.7)).numpy(), np.eye(4), atol=1e-6)
    np.testing.assert_allclose((mu_t.rotator(0.3) @ mu_t.rotator(0.4)).numpy(), R1.numpy(),
                               atol=1e-6)


def test_fresnel_normal_incidence():
    M = mu_t.specular_reflection(1.0, 1.5).numpy()
    F0 = ((1.5 - 1) / (1.5 + 1)) ** 2
    np.testing.assert_allclose(M[0, 0], F0, rtol=1e-5)
    np.testing.assert_allclose(M[1, 1], F0, rtol=1e-5)
    np.testing.assert_allclose(M[0, 1], 0.0, atol=1e-7)


def test_fresnel_brewster_fully_polarized():
    """At Brewster's angle Rp = 0, so M00 == |M01|."""
    M = mu_t.specular_reflection(float(np.cos(np.arctan(1.5))), 1.5).numpy()
    assert M[0, 0] > 0
    np.testing.assert_allclose(abs(M[0, 1]) / M[0, 0], 1.0, rtol=1e-3)

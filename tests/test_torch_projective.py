"""The soft-shadow estimator of ``direct_projective`` (integrator/
projective.py) in tpu_rt_torch against tpu_rt, on the CPU.

* ``curve_segments`` and ``geometry_without_curves`` equal to tpu_rt's on
  the shadow-art fixture; the moved geometry leaves the shapes and every
  other prim as they were.
* ``segment_clearance`` against tpu_rt's on random shadow segments
  (1e-6).
* ``tests/torch_port_scenes.py::hard_band_loss`` and ``soft_band_grad``
  (the finite-difference check's two sides, traced many samples a pixel
  a call): one sample a call, the band of ``render`` exactly and
  ``render_soft``'s band and translation derivative within 1e-5.
* ``render_soft``'s primal against the hard render (the bars of
  tests/test_projective.py:82-97); here both renders draw the same
  numbers, so the soft image differs only by the softened visibility.
* The gradient of the shadow-band loss with respect to the spans' ``a``,
  ``b``, ``r0`` and ``r1``, by torch autograd of ``render_soft`` fed
  tpu_rt's threefry draws, against ``jax.grad`` of tpu_rt's
  ``render_soft``: within 1e-3 of the largest, summed at each node the
  spans share (the end b of span i is the start a of span i + 1; where a
  shadow segment is closest to a node, the minimum over the spans ties,
  and which of the two equal spans takes the gradient turns on the last
  bit; the node's sum does not), and the translation derivative within
  1e-5 relative.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_rt
import tpu_rt_torch
from tpu_rt.integrator import projective as proj_j
from tpu_rt_torch.integrator import path as path_t
from tpu_rt_torch.integrator import projective as proj_t
from tpu_rt_torch.scene.types import CURVE

HERE = os.path.dirname(os.path.abspath(__file__))
XML = os.path.join(HERE, "assets", "shadow_art", "shadow_art.xml")
sys.path.insert(0, HERE)
from torch_port_scenes import (hard_band_loss, rod_desc, shadow_band, soft_band_grad,  # noqa: E402
                               write_rod)

torch.set_num_threads(1)


def test_curve_segments_and_geometry_without_curves_equal_to_tpu_rt():
    sj, st = tpu_rt.load_file(XML), tpu_rt_torch.load_file(XML)
    cj, ct = proj_j.curve_segments(sj.geometry), proj_t.curve_segments(st.geometry)
    assert set(ct) == {"a", "b", "r0", "r1"} and ct["a"].shape == (192, 3)
    for k in ct:
        assert np.asarray(cj[k]).tobytes() == ct[k].numpy().tobytes(), k
    # consecutive spans share their ends
    np.testing.assert_allclose(ct["b"][:-1].numpy(), ct["a"][1:].numpy(), atol=1e-6)
    gj, gt = proj_j.geometry_without_curves(sj.geometry), proj_t.geometry_without_curves(st.geometry)
    assert np.asarray(gj.an_to_object).tobytes() == gt.an_to_object.numpy().tobytes()
    curve = st.geometry.an_type == CURVE
    moved = gt.an_to_object - st.geometry.an_to_object
    assert bool((moved[curve][:, :3, 3] == 1e7).all()) and float(moved[~curve].abs().max()) == 0
    assert float(moved[:, :, :3].abs().max()) == 0 and float(moved[:, 3].abs().max()) == 0
    for k in ("an_type", "an_to_world", "an_param", "tri_p0", "bvh_min", "prim_order"):
        assert torch.equal(getattr(gt, k), getattr(st.geometry, k)), k
    mesh = tpu_rt_torch.load_file(XML, curve_mode="mesh").geometry
    assert proj_t.geometry_without_curves(mesh) is mesh
    with pytest.raises(ValueError, match="no bsplinecurve"):
        proj_t.curve_segments(mesh)


def test_segment_clearance_matches_tpu_rt():
    st = tpu_rt_torch.load_file(XML)
    curves = proj_t.curve_segments(st.geometry)
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.6, 0.6, (2000, 3)).astype(np.float32)
    q = (p + rng.normal(size=p.shape) * rng.uniform(0.01, 2.0, (2000, 1))).astype(np.float32)
    q[:8] = p[:8]  # degenerate segments
    got = proj_t.segment_clearance(torch.from_numpy(p), torch.from_numpy(q), curves).numpy()
    want = np.asarray(proj_j.segment_clearance(
        jnp.asarray(p), jnp.asarray(q), {k: jnp.asarray(v.numpy()) for k, v in curves.items()}))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got < 0).any() and (got > 0.1).any()  # segments through the wire and clear of it


@pytest.fixture(scope="module")
def rod(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rod") / "rod.txt")
    write_rod(path, 0.25, 2.0, 0.08)
    return path


def test_soft_primal_matches_hard_render(rod):
    st = tpu_rt_torch.load_dict(rod_desc(tpu_rt_torch.ScalarTransform4f, rod))
    curves = proj_t.curve_segments(st.geometry)
    hard = path_t.render(st, spp=32, seed=5, max_depth=2, device="cpu").numpy()
    soft = proj_t.render_soft(st, curves, spp=32, seed=5, width=1e-4, device="cpu").numpy()
    W = hard.shape[1]
    band = hard[:, W // 8: W // 2, 0]
    assert band.min() < 0.25 * band.mean()  # the shadow is there
    assert np.abs(soft - hard).mean() < 0.02 * hard.mean()
    # the same draws: the pixels away from the penumbra are equal
    assert (np.abs(soft - hard) <= 1e-5 * np.abs(hard).max()).mean() > 0.9


def test_hard_band_loss_is_the_band_of_the_render(rod):
    st = tpu_rt_torch.load_dict(rod_desc(tpu_rt_torch.ScalarTransform4f, rod, res=16))
    want = float(shadow_band(path_t.render(st, spp=3, seed=2, max_depth=2, device="cpu")))
    assert hard_band_loss(st, 3, 2, "cpu", batch=1) == want
    assert abs(hard_band_loss(st, 3, 2, "cpu", batch=3) - want) < 0.05 * want


def test_soft_band_grad_is_render_soft_s(rod):
    st = tpu_rt_torch.load_dict(rod_desc(tpu_rt_torch.ScalarTransform4f, rod, res=16))
    base = proj_t.curve_segments(st.geometry)
    theta = torch.zeros((), requires_grad=True)
    shift = torch.stack([theta, theta * 0.0, theta * 0.0])
    curves = dict(base, a=base["a"] + shift, b=base["b"] + shift)
    want = shadow_band(proj_t.render_soft(st, curves, spp=3, seed=4, width=0.015, device="cpu"))
    want.backward()
    loss, grad = soft_band_grad(st, 3, 4, 0.015, "cpu", batch=1)
    assert abs(loss - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    assert float(theta.grad) != 0.0 and abs(grad - float(theta.grad)) <= 1e-5 * abs(float(theta.grad))
    loss3, grad3 = soft_band_grad(st, 3, 4, 0.015, "cpu", batch=3)
    assert abs(loss3 - loss) < 0.05 * loss and grad3 * grad > 0


def _tpu_rt_draws(seed, spp, hw, n_iters):
    """render_soft's draws in tpu_rt: a key a pass, split into the jitter's
    and path_trace's, which splits its own into one key a bounce."""
    jit, uni = [], []
    for k in jax.random.split(jax.random.PRNGKey(seed), spp):
        k_jit, k_path = jax.random.split(k)
        jit.append(np.asarray(jax.random.uniform(k_jit, (hw, 2))))
        uni.append(np.stack([np.asarray(jax.random.uniform(kk, (hw, 8)))
                             for kk in jax.random.split(k_path, n_iters)]))
    return torch.from_numpy(np.stack(jit)), torch.from_numpy(np.stack(uni))


def _nodes(g0, g1):
    """Per-node sums of the gradients of the spans' two ends."""
    n = np.zeros((g0.shape[0] + 1,) + g0.shape[1:], np.float64)
    n[:-1] += g0
    n[1:] += g1
    return n


def test_gradient_matches_jax_grad_on_the_same_draws(rod):
    res, spp, width, seed = 24, 4, 0.02, 3
    sj = tpu_rt.load_dict(rod_desc(tpu_rt.ScalarTransform4f, rod, res=res))
    st = tpu_rt_torch.load_dict(rod_desc(tpu_rt_torch.ScalarTransform4f, rod, res=res))
    cj = proj_j.curve_segments(sj.geometry)
    sgj = proj_j.geometry_without_curves(sj.geometry)
    lj, gj = jax.value_and_grad(lambda c: shadow_band(
        proj_j.render_soft(sj, c, spp=spp, seed=seed, width=width, shadow_geom=sgj)))(cj)

    draws = _tpu_rt_draws(seed, spp, res * res, path_t.n_bounces(st, 2))
    ct = {k: v.clone().requires_grad_(True) for k, v in proj_t.curve_segments(st.geometry).items()}
    lt = shadow_band(proj_t.render_soft(st, ct, spp=spp, width=width, device="cpu", draws=draws))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    gt = {k: v.grad.numpy() for k, v in ct.items()}
    gj = {k: np.asarray(v) for k, v in gj.items()}
    for h0, h1 in (("a", "b"), ("r0", "r1")):
        nj, nt = _nodes(gj[h0], gj[h1]), _nodes(gt[h0], gt[h1])
        assert np.abs(nj).max() > 1e-3
        assert np.abs(nt - nj).max() <= 1e-3 * np.abs(nj).max(), (h0, h1)
    # the derivative with respect to a translation of the rod along x
    tx_j = gj["a"][:, 0].sum() + gj["b"][:, 0].sum()
    tx_t = gt["a"][:, 0].sum() + gt["b"][:, 0].sum()
    assert abs(tx_j) > 1e-3 and abs(tx_t - tx_j) <= 1e-5 * abs(tx_j)
    # a thicker rod darkens the band
    assert gt["r0"].sum() + gt["r1"].sum() < 0

"""The Stokes film kernel's plain versions against tpu_rt's Pallas kernels.

K3 (``stokes_film_trace_plain``), K2's loop around K3 and around K1 (the
plain versions serve both loop forms: a lane meets its samples in order
either way) and K6 (``stokes_sample_trace_plain``) on the in-repo
cbox_pol fixture, held to ``tests/golden/stokes_kernels_seed0.npz``:
tpu_rt's interpret-mode outputs at tile_rows 8, stored by
``tests/golden/make_stokes_golden.py`` (a live interpret-mode compile of
the Mueller bounce takes minutes on the CPU).  Both draw the same
SplitMix32 streams.  Tolerance: at least 99% of the entries within
rtol 1e-4 / atol 1e-6, every plane's sum within 1e-3 of the sum of its
magnitudes (Q, U and V planes are signed), the ray count within 1%.  XLA
on the CPU contracts multiply-adds and rounds rsqrt otherwise than
``1 / sqrt``, and depth-3 Mueller rotations amplify an ulp to about 1e-5;
a lane whose lobe choice or roulette draw sits on an ulp takes the other
branch and follows another path.  Then the port's own
identities: K3 against K6 plus ``splat_aligned``, and Stokes-I against
K1's radiance on an all-diffuse scene.
"""

import os

import numpy as np
import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch.ops import path_kernel as pk
from tpu_rt_torch.scene import types as TT
from tpu_rt_torch.sensor import film as film_mod

from torch_port_scenes import render_stokes_per_sample

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CBOX_POL = os.path.join(HERE, "assets", "cbox_pol", "cbox_pol.xml")
CBOX = os.path.join(HERE, "assets", "cbox", "cbox.xml")
FILTERS = {"box": TT.FILTER_BOX, "tent": TT.FILTER_TENT, "gaussian": TT.FILTER_GAUSSIAN}
RES, K, SEED, DEPTH, SAMPLE_SEED = 8, 2, 5, 3, 3


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(HERE, "golden", "stokes_kernels_seed0.npz"))


def _tables(path=CBOX_POL, filt=None, depth=None, stokes=True):
    sc = tpu_rt_torch.load_file(path, res=RES, spp=K)
    if depth is not None:
        sc = sc.replace(max_depth=depth)
    if filt is not None:
        sc = sc.replace(camera=sc.camera.replace(filter_type=FILTERS[filt]))
    return pk.pack_tables(pk.bake_scene(sc), sc.camera, 8, "cpu", stokes=stokes)


def _check(got, want, rtol=1e-4, atol=1e-6):
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of entries agree"
    # Q, U and V planes are signed and near-cancelling: their sums are
    # held against the sum of their magnitudes
    err = np.abs(got[:-1].sum(1, dtype=np.float64) - want[:-1].sum(1, dtype=np.float64))
    assert (err <= 1e-3 * np.abs(want[:-1]).sum(1) + 1e-6).all()
    assert abs(got[-1].sum() - want[-1].sum()) <= 0.01 * want[-1].sum()


@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_stokes_film_plain_matches_pallas_interpret(golden, filt):
    t = _tables(filt=filt, depth=DEPTH)
    assert t.n_val == 13 and not t.regen
    got = pk.stokes_film_trace(t, SEED, K)  # the plain version on the CPU
    assert got.dtype == torch.float32 and got.shape[0] == 13 * (2 * t.radius + 1) ** 2 + 1
    _check(got.numpy(), golden["film_" + filt])
    assert np.abs(got[1:12].numpy()).max() > 1e-4  # Q, U, V are there


def test_regen_depth_16_plain_matches_pallas_interpret_stokes(golden):
    """K3 at cbox_pol's own depth 16, gaussian, against tpu_rt's K2 around
    K3 (the port's K3 has no loop form: its tables' regen word is 0)."""
    t = _tables()
    assert t.hdr_list[pk.HDR_MAX_DEPTH] == 16 and not t.regen and t.radius == 2
    _check(pk.stokes_film_trace_plain(t, SEED, K).numpy(), golden["regen_stokes"])


def test_regen_depth_16_plain_matches_pallas_interpret_scalar(golden):
    """K2 around K1: the cbox fixture at depth 16, tent."""
    t = _tables(CBOX, depth=16, stokes=False)
    assert t.regen and not t.stokes
    _check(pk.film_trace_plain(t, SEED, K).numpy(), golden["regen_scalar"])


def test_stokes_sample_plain_matches_pallas_interpret(golden):
    t = _tables(depth=DEPTH)
    S, jitter, rays = pk.sample_planes_split(pk.stokes_sample_trace(t, SAMPLE_SEED))
    np.testing.assert_array_equal(jitter.numpy(), golden["sample_jitter"])
    close = np.isclose(S.numpy(), golden["sample_S"], rtol=1e-4, atol=1e-6).all((1, 2))
    assert close.mean() >= 0.98, f"only {close.mean():.4f} of lanes agree"
    assert rays.dtype == torch.int64
    assert abs(int(rays) - int(golden["sample_rays"])) <= 0.01 * int(golden["sample_rays"])


@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_stokes_film_equals_per_sample_plus_splat(filt):
    """The film form against K6 + splat_aligned, one sample a chunk, as
    tests/test_pallas_film_stokes.py:289-336 holds tpu_rt's (the gaussian
    tail and the deposit's add order differ by ulps)."""
    sc = tpu_rt_torch.load_file(CBOX_POL, res=RES, spp=3).replace(max_depth=DEPTH)
    sc = sc.replace(camera=sc.camera.replace(filter_type=FILTERS[filt]))
    S_film, rays = pk.render_stokes_film(sc, spp=3, seed=5, device="cpu", spp_per_pass=1,
                                         tile_rows=8)
    S_ref, n = render_stokes_per_sample(sc, 3, 5, "cpu", tile_rows=8)
    np.testing.assert_allclose(S_film.numpy(), S_ref.numpy(), rtol=2e-5, atol=2e-6)
    assert int(rays) == int(n) and S_film.shape == S_ref.shape == (RES, RES, 4, 3)
    # the per-sample route by hand: K6 and splat_aligned
    t = pk.pack_tables(pk.bake_scene(sc), sc.camera, 8, "cpu", stokes=True)
    S, jit, _ = pk.sample_planes_split(pk.stokes_sample_trace(t, 5 * 100003))
    fv, fw = film_mod.splat_aligned(torch.zeros((RES, RES, 12)), torch.zeros((RES, RES)),
                                    jit.reshape(1, RES, RES, 2), S.reshape(1, RES, RES, 12),
                                    torch.ones((1, RES, RES), dtype=torch.bool),
                                    sc.camera.filter_type)
    one, _ = render_stokes_per_sample(sc, 1, 5, "cpu", tile_rows=8)
    assert torch.equal(one, film_mod.develop(fv, fw).reshape(RES, RES, 4, 3))


def test_one_box_sample_is_the_per_sample_values():
    """Box film, one sample: the film planes are K6's values, exactly."""
    t = _tables(filt="box", depth=DEPTH)
    film = pk.stokes_film_trace(t, SAMPLE_SEED, 1)
    one = pk.stokes_sample_trace(t, SAMPLE_SEED)
    ok = torch.isfinite(one[:12]).all(0)
    assert bool(ok.all())
    assert torch.equal(film[:12], one[:12]) and torch.equal(film[13], one[12])
    assert torch.equal(film[12], torch.ones(RES * RES))


def test_diffuse_only_stokes_I_equals_the_scalar_kernel():
    """An all-diffuse scene depolarizes: Stokes-I is K1's radiance (the
    NEE weight associates otherwise, so ulps) and Q, U, V vanish
    (tests/test_pallas_film_stokes.py:248-276's twin)."""
    sc = tpu_rt_torch.load_file(CBOX, res=RES, spp=2).replace(max_depth=DEPTH)
    sc = sc.replace(bsdf_type=torch.full_like(sc.bsdf_type, TT.BSDF_DIFFUSE))
    sc = sc.replace(camera=sc.camera.replace(filter_type=TT.FILTER_GAUSSIAN))
    S, rs = pk.render_stokes_film(sc, spp=2, seed=4, device="cpu", spp_per_pass=2,
                                  tile_rows=8)
    img, ri = pk.render_film(sc, spp=2, seed=4, device="cpu", spp_per_pass=2, tile_rows=8)
    np.testing.assert_allclose(S[..., 0, :].numpy(), img.numpy(), rtol=3e-5, atol=3e-6)
    assert float(S[..., 1:, :].abs().max()) == 0.0
    assert int(rs) == int(ri) and img.mean() > 0


def test_tables_carry_the_stokes_fields():
    t = _tables(filt="tent", depth=DEPTH)
    sc = tpu_rt_torch.load_file(CBOX_POL, res=RES, spp=K)
    np.testing.assert_array_equal(
        np.asarray(t.tab_list[pk.G_CAM_X:pk.G_CAM_X + 3], np.float32),
        sc.camera.to_world.numpy()[:3, 0])
    assert (t.stokes, t.regen, t.n_val, t.n_acc) == (True, False, 13, 117)
    # the regen word is K1's auto form, on from max_depth 8; 0 on Stokes
    # tables, whose K3 has no loop form: film_records, K1's trace kernel,
    # takes no Stokes tables
    for depth in (pk.REGEN_AUTO_DEPTH - 1, pk.REGEN_AUTO_DEPTH, 16):
        assert _tables(filt="tent", depth=depth, stokes=False).regen == (
            depth >= pk.REGEN_AUTO_DEPTH)
        assert not _tables(filt="tent", depth=depth).regen
    with pytest.raises(ValueError, match="stokes=False"):
        pk.film_records(t, 0, 1, regen=True)
    scalar = _tables(filt="tent", depth=DEPTH, stokes=False)
    assert scalar.tab_list[pk.G_CAM_X:pk.G_CAM_X + 3] == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="stokes=True"):
        pk.stokes_film_trace(scalar, 0, 1)
    with pytest.raises(ValueError, match="stokes=False"):
        pk.film_trace(t, 0, 1)


def test_wrappers_on_the_cpu_launch_nothing():
    t = _tables(filt="box", depth=DEPTH)
    before = (pk.stokes_sample_trace.launches, pk.film_splat.launches)
    pk.stokes_film_trace(t, 0, 1)
    pk.stokes_sample_trace(t, 0)
    assert before == (pk.stokes_sample_trace.launches, pk.film_splat.launches)

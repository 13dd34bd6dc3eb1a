"""The wavefront tracer's shading modules against tpu_rt's, on the CPU.

``core/math.py``, ``core/warps.py``, ``bsdf/microfacet.py``,
``bsdf/eval.py`` (``sample`` and ``eval_pdf`` for every BSDF type) and
``emitter/sample.py`` get the same numpy-seeded inputs as their tpu_rt
counterparts.  Tolerance: at least 99.5% of the entries within rtol 1e-5 /
atol 1e-6 and every entry within rtol 1e-3 / atol 1e-4 (XLA on the CPU
contracts multiply-adds into FMAs and its transcendental functions round
otherwise than torch's, a few ulps; the square roots near 0 of the VNDF
sample and the arccos near +-1 of the lat-long lookup amplify those to
about 2e-5 on a few entries); booleans and integer choices are equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_rt
import tpu_rt_torch
from tpu_rt.bsdf import eval as bsdf_j
from tpu_rt.bsdf import microfacet as mf_j
from tpu_rt.core import math as math_j
from tpu_rt.core import warps as warps_j
from tpu_rt.emitter import sample as em_j
from tpu_rt_torch.bsdf import eval as bsdf_t
from tpu_rt_torch.bsdf import microfacet as mf_t
from tpu_rt_torch.core import math as math_t
from tpu_rt_torch.core import warps as warps_t
from tpu_rt_torch.emitter import sample as em_t
from tpu_rt_torch.scene import types as TT

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_warps_and_math import _chi2_uniformity  # noqa: E402
from torch_port_scenes import mixed_desc, shapes_desc  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
N = 512


def _close(got, want, what="", share=0.995):
    got = [got] if not isinstance(got, (tuple, list)) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4, err_msg=f"{what}[{i}]")
            close = np.isclose(g, w, rtol=RTOL, atol=ATOL)
            assert close.mean() >= share, f"{what}[{i}]: only {close.mean():.4f} within tolerance"


def _unit(rng, n, upper=None):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    if upper is not None:
        v[:, 2] = np.abs(v[:, 2]) * upper
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _both(fn_j, fn_t, *args):
    return fn_t(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]), \
        fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])


_rng = np.random.default_rng(0)
_V1, _V2 = _unit(_rng, N), _unit(_rng, N)
_COS = _rng.uniform(-1, 1, N).astype(np.float32)
_ETA = _rng.uniform(1.1, 2.0, N).astype(np.float32)
_M = np.tile(tpu_rt_torch.ScalarTransform4f().translate([0.5, -1, 2]).rotate([1, 2, 3], 40)
             .scale([1.5, 0.7, 2.0]).matrix, (N, 1, 1))
_PDF = _rng.uniform(0, 3, N).astype(np.float32)
_PDF[::7] = 0.0

MATH_CASES = {
    "coordinate_system": (lambda m: m.coordinate_system, (_V1,)),
    "to_local": (lambda m: (lambda n, v: m.to_local(n, *m.coordinate_system(n), v)), (_V1, _V2)),
    "to_world": (lambda m: (lambda n, v: m.to_world(n, *m.coordinate_system(n), v)), (_V1, _V2)),
    "normalize": (lambda m: m.normalize, (_V1 * 3.0,)),
    "reflect": (lambda m: m.reflect, (_V1, _V2)),
    "reflect_local": (lambda m: m.reflect_local, (_V1,)),
    "refract_local": (lambda m: m.refract_local, (_V1, _COS, _ETA)),
    "fresnel_dielectric": (lambda m: m.fresnel_dielectric, (_COS, _ETA)),
    "fresnel_conductor": (lambda m: m.fresnel_conductor,
                          (np.abs(_COS)[:, None], np.float32([[0.2, 0.9, 1.1]]),
                           np.float32([[3.9, 2.4, 2.2]]))),
    "mis_power_heuristic": (lambda m: m.mis_power_heuristic, (_PDF, _PDF[::-1].copy())),
    "transform_point": (lambda m: m.transform_point, (_M, _V1)),
    "transform_vector": (lambda m: m.transform_vector, (_M, _V1)),
    "luminance": (lambda m: m.luminance, (np.abs(_V1),)),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_core_math_matches_tpu_rt(name):
    pick, args = MATH_CASES[name]
    got, want = _both(pick(math_j), pick(math_t), *args)
    _close(got, want, name)


_S2 = _rng.uniform(0, 1, (N, 2)).astype(np.float32)
_S2[0] = 0.5  # the concentric map's origin
WARP_CASES = {
    "square_to_uniform_disk_concentric": (_S2,),
    "square_to_uniform_hemisphere": (_S2,),
    "square_to_cosine_hemisphere": (_S2,),
    "square_to_cosine_hemisphere_pdf": (_V1,),
    "square_to_uniform_sphere": (_S2,),
    "square_to_uniform_triangle": (_S2,),
    "square_to_uniform_cone": (_S2, 0.8),
}


@pytest.mark.parametrize("name", sorted(WARP_CASES))
def test_warps_match_tpu_rt(name):
    got, want = _both(getattr(warps_j, name), getattr(warps_t, name), *WARP_CASES[name])
    _close(got, want, name)
    assert warps_t.square_to_uniform_cone_pdf(0.8) == pytest.approx(
        float(warps_j.square_to_uniform_cone_pdf(0.8)), rel=1e-6)


_ALPHA = _rng.uniform(0.05, 0.8, N).astype(np.float32)
MF_CASES = {
    "ggx_d": (_V1, _ALPHA),
    "ggx_smith_g1": (_V1, _ALPHA),
    "ggx_smith_g": (_V1, _V2, _ALPHA),
    "ggx_sample_vndf": (_V1, _ALPHA, _S2),
    "ggx_vndf_pdf": (_V1, _V2, _ALPHA),
    # the classic theta sampler and its pdf, on draws of their own
    "ggx_sample_theta_invcdf": (np.random.default_rng(16).uniform(0, 1, N).astype(np.float32),
                                _ALPHA),
    "ggx_theta_pdf": (np.random.default_rng(17).uniform(0, np.pi / 2, N).astype(np.float32),
                      _ALPHA),
}


@pytest.mark.parametrize("name", sorted(MF_CASES))
def test_microfacet_matches_tpu_rt(name):
    got, want = _both(getattr(mf_j, name), getattr(mf_t, name), *MF_CASES[name])
    _close(got, want, name)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
def test_ggx_invcdf_matches_its_pdf(alpha):
    """tests/test_warps_and_math.py::test_ggx_invcdf_matches_pdf on the
    port: its inverse-CDF theta sampler's histogram against its own
    analytic pdf, by the same chi-square statistic and bins (uniforms from
    numpy).  Each bin's expected count is the pdf's mean over 32 points
    of the bin, not its value at the centre: at alpha 0.1 the pdf peaks
    within three bins of 0, where the centre's value is off the bin's
    integral by more than the statistic allows at 400 000 samples."""
    xi = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, 400_000).astype(np.float32))
    theta = mf_t.ggx_sample_theta_invcdf(xi, alpha).numpy()
    bins, hi, sub = 64, np.pi / 2, 32
    counts, edges = np.histogram(theta, bins=bins, range=(0, hi))
    fine = torch.from_numpy(edges[0] + (np.arange(bins * sub) + 0.5) * (hi / (bins * sub)))
    pdf = mf_t.ggx_theta_pdf(fine, alpha).numpy().reshape(bins, sub).mean(1)
    assert _chi2_uniformity(counts, pdf * (hi / bins) * len(theta))


def _params(btype, rng, n):
    p = np.zeros((n, 16), np.float32)
    if btype == TT.BSDF_DIFFUSE:
        p[:, 0:3] = rng.uniform(0, 1, (n, 3))
    elif btype == TT.BSDF_DIELECTRIC:
        p[:, 0] = rng.uniform(1.3, 2.4, n)
        p[:, 1] = 1.000277
        p[:, 3:9] = rng.uniform(0.5, 1, (n, 6))
    elif btype in (TT.BSDF_CONDUCTOR, TT.BSDF_ROUGH_CONDUCTOR):
        p[:, 0:3] = rng.uniform(0.1, 2, (n, 3))
        p[:, 3:6] = rng.uniform(1, 5, (n, 3))
        p[::3, 0] = -1.0  # a third are perfect mirrors
        p[:, 6:9] = rng.uniform(0.5, 1, (n, 3))
        p[:, 9] = rng.uniform(0.05, 0.6, n)
    elif btype == TT.BSDF_POLARIZER:
        p[:, 3:6] = rng.uniform(0.3, 1, (n, 3))
    return p


BSDF_TYPES = {"diffuse": TT.BSDF_DIFFUSE, "dielectric": TT.BSDF_DIELECTRIC,
              "conductor": TT.BSDF_CONDUCTOR, "roughconductor": TT.BSDF_ROUGH_CONDUCTOR,
              "polarizer": TT.BSDF_POLARIZER, "null": TT.BSDF_NULL}


def _bsdf_inputs(btype, seed):
    rng = np.random.default_rng(seed)
    wi = _unit(rng, N)
    wi[: N // 2, 2] = np.abs(wi[: N // 2, 2])  # most lanes on the front side
    wo = _unit(rng, N)
    wo[: N // 2, 2] = np.abs(wo[: N // 2, 2])
    s1 = rng.uniform(0, 1, N).astype(np.float32)
    s2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    active = rng.uniform(0, 1, N) < 0.9
    types = np.full(N, btype, np.int32)
    types[::11] = TT.BSDF_DIFFUSE  # a mixed table: other lanes' lobes stay out
    return types, _params(btype, rng, N), wi, wo, s1, s2, active


@pytest.mark.parametrize("name", sorted(BSDF_TYPES))
def test_bsdf_sample_matches_tpu_rt(name):
    types, params, wi, _, s1, s2, active = _bsdf_inputs(BSDF_TYPES[name], 1)
    present = tuple(sorted({BSDF_TYPES[name], TT.BSDF_DIFFUSE}))
    bt = bsdf_t.sample(torch.from_numpy(types), torch.from_numpy(params), torch.from_numpy(wi),
                       torch.from_numpy(s1), torch.from_numpy(s2), torch.from_numpy(active),
                       present=present)
    bj = bsdf_j.sample(jnp.asarray(types), jnp.asarray(params), jnp.asarray(wi),
                       jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(active), present=present)
    for f in ("wo", "pdf", "weight", "delta", "eta"):
        # the GGX pdf's 1 - cos^2 of a half vector near the normal (alpha
        # down to 0.05) amplifies the sampled half vector's ulps to ~1e-4
        # relative on a few percent of the lanes
        share = 0.95 if name == "roughconductor" and f in ("pdf", "weight") else 0.995
        _close(getattr(bt, f), getattr(bj, f), f"{name}.{f}", share)
    assert (bt.pdf.numpy() > 0).mean() > 0.3


@pytest.mark.parametrize("name", sorted(BSDF_TYPES))
def test_bsdf_eval_pdf_matches_tpu_rt(name):
    types, params, wi, wo, _, _, active = _bsdf_inputs(BSDF_TYPES[name], 2)
    got = bsdf_t.eval_pdf(torch.from_numpy(types), torch.from_numpy(params),
                          torch.from_numpy(wi), torch.from_numpy(wo), torch.from_numpy(active))
    want = bsdf_j.eval_pdf(jnp.asarray(types), jnp.asarray(params), jnp.asarray(wi),
                           jnp.asarray(wo), jnp.asarray(active))
    _close(got, want, name)


SCENES = {"mixed": mixed_desc, "shapes": shapes_desc,
          "cbox": os.path.join(os.path.dirname(__file__), "assets", "cbox", "cbox.xml"),
          "simple": os.path.join(os.path.dirname(__file__), "assets", "mesh", "simple.xml")}


def _pair(which):
    src = SCENES[which]
    if callable(src):
        return (tpu_rt.load_dict(src(tpu_rt.ScalarTransform4f)),
                tpu_rt_torch.load_dict(src(tpu_rt_torch.ScalarTransform4f)))
    return tpu_rt.load_file(src, res=8, spp=1), tpu_rt_torch.load_file(src, res=8, spp=1)


@pytest.mark.parametrize("which", sorted(SCENES))
def test_emitter_sampling_matches_tpu_rt(which):
    sj, st = _pair(which)
    rng = np.random.default_rng(3)
    p = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    s_light = rng.uniform(0, 1, N).astype(np.float32)
    s_tri = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    active = rng.uniform(0, 1, N) < 0.9
    dt = em_t.sample_direct(st, torch.from_numpy(p), torch.from_numpy(s_light),
                            torch.from_numpy(s_tri), torch.from_numpy(active))
    dj = em_j.sample_direct(sj, jnp.asarray(p), jnp.asarray(s_light), jnp.asarray(s_tri),
                            jnp.asarray(active))
    for f in ("p", "n", "d", "dist", "pdf", "radiance", "delta"):
        _close(getattr(dt, f), getattr(dj, f), f"{which}.{f}")
    assert (dt.pdf.numpy() > 0).any()

    # the MIS pdfs and radiance of what a BSDF-sampled ray hits or misses
    shape = rng.integers(-1, st.shape_bsdf.shape[0], N).astype(np.int32)
    d = _unit(rng, N)
    dist = rng.uniform(0.1, 5, N).astype(np.float32)
    cos_l = rng.uniform(-1, 1, N).astype(np.float32)
    _close(em_t.pdf_direct_area(st, torch.from_numpy(shape), torch.from_numpy(d),
                                torch.from_numpy(dist), torch.from_numpy(cos_l)),
           em_j.pdf_direct_area(sj, jnp.asarray(shape), jnp.asarray(d), jnp.asarray(dist),
                                jnp.asarray(cos_l)), "pdf_direct_area")
    _close(em_t.eval_area(st, torch.from_numpy(shape), torch.from_numpy(cos_l)),
           em_j.eval_area(sj, jnp.asarray(shape), jnp.asarray(cos_l)), "eval_area")
    _close(em_t.eval_env(st, torch.from_numpy(d)), em_j.eval_env(sj, jnp.asarray(d)), "eval_env")
    _close(em_t.pdf_direct_env(st, torch.from_numpy(d)), em_j.pdf_direct_env(sj, jnp.asarray(d)),
           "pdf_direct_env")


def test_latlong_environment_sampling_matches_tpu_rt():
    """A textured lat-long map of random texels (the EXR fixture's lookup
    is tests/test_torch_envmap_kernel.py's): the same tables handed to both
    packages."""
    sj, st = _pair("mixed")
    rng = np.random.default_rng(4)
    H, W = 8, 16
    env = rng.uniform(0, 2, (H, W, 3)).astype(np.float32)
    lum = env @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    w = lum * np.sin((np.arange(H) + 0.5) / H * np.pi).astype(np.float32)[:, None] + 1e-12
    rows = (np.cumsum(w.sum(1)) / w.sum()).astype(np.float32)
    cols = (np.cumsum(w, 1) / w.sum(1, keepdims=True)).astype(np.float32)
    m = tpu_rt_torch.ScalarTransform4f().rotate([0, 1, 0], 30).matrix
    minv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
    tabs = dict(env_map=env, env_to_world=m, env_to_local=minv, env_cdf_rows=rows,
                env_cdf_cols=cols)
    sj = sj.replace(emitters=sj.emitters.replace(**{k: jnp.asarray(v) for k, v in tabs.items()}))
    st = st.replace(emitters=st.emitters.replace(**{k: torch.from_numpy(v)
                                                    for k, v in tabs.items()}))
    d = _unit(rng, N)
    _close(em_t.eval_env(st, torch.from_numpy(d)), em_j.eval_env(sj, jnp.asarray(d)), "eval_env")
    _close(em_t.pdf_direct_env(st, torch.from_numpy(d)), em_j.pdf_direct_env(sj, jnp.asarray(d)),
           "pdf_direct_env")
    s2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    _close(em_t._sample_env(st.emitters, torch.from_numpy(s2)),
           em_j._sample_env(sj.emitters, jnp.asarray(s2)), "_sample_env")

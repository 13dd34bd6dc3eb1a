"""The per-sample kernels' chunks and the routes that take them, on the CPU.

K6 (``stokes_sample_trace``), K5 (``raygen_trace``, under a constant and
a textured environment) and K4 (``path_trace``) trace a chunk of
``n_samples`` samples a call: sample i of a chunk seeded s must be the
one-sample call seeded s + i (wrapped to int32, also past 2^31), bit for
bit.  A one-sample call is held to tpu_rt's kernels by
tests/test_torch_stokes_kernel.py and tests/test_torch_envmap_kernel.py.
On CPU tensors the wrappers run their plain versions and launch nothing.

The two per-sample routes run their glue once a chunk and add the chunk's
samples onto the film in order (``sensor/film.py::splat_in_order``), so
their images are bit-equal to the one-sample-a-pass loop:
``render(polarizers.xml)`` (K5's route; and within ``CPU_LIMIT`` of
tpu_rt's interpret-mode render, as tests/test_torch_polarizers.py holds the
2-spp render) and ``tests/torch_port_scenes.py::render_stokes_per_sample``
(K6's route), also splatted in pieces of one sample.  No JAX is imported.
"""

import os
import sys

import numpy as np
import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch.ops import path_kernel as pk
from tpu_rt_torch.sensor import film
from tpu_rt_torch.scene import types as TT

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "golden"))
import make_envmap_golden as G  # noqa: E402
from torch_port_scenes import render_stokes_per_sample  # noqa: E402

torch.set_num_threads(1)

CBOX_POL = os.path.join(HERE, "assets", "cbox_pol", "cbox_pol.xml")
RES = 8


def _tables(path, stokes=False):
    sc = tpu_rt_torch.load_file(path, res=RES, spp=1)
    return pk.pack_tables(pk.bake_scene(sc), sc.camera, 8, "cpu", stokes=stokes)


def _k4_rays():
    o, d = G.k4_env_rays(200)
    return torch.from_numpy(o), torch.from_numpy(d)


def _launch_counts():
    return [f.launches for f in (pk.stokes_sample_trace, pk.raygen_trace, pk.path_trace)]


# kernel: (tables' scene, stokes, its planes, call(tables, seed, n_samples))
KERNELS = {
    "K6": (CBOX_POL, True, 15, pk.stokes_sample_trace),
    "K5_constant_env": (G.POL_CONST, False, 6, pk.raygen_trace),
    "K5_textured_env": (G.POLARIZERS, False, 12, pk.raygen_trace),
    "K4": (G.POLARIZERS, False, 10,
           lambda t, s, n=None: pk.path_trace(t, *_k4_rays(), s, n)),
}


@pytest.mark.parametrize("k,seed", [(1, 7), (3, -5), (3, 2**31 - 2)],
                         ids=["one", "three", "three_wrapping"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_chunk_equals_one_sample_calls(kernel, k, seed):
    """Sample i of a chunk is the one-sample call seeded seed + i, every
    plane bit for bit, and the CPU wrappers launch nothing."""
    path, stokes, n_planes, call = KERNELS[kernel]
    tables = _tables(path, stokes)
    assert tables.env_textured == (path == G.POLARIZERS)
    before = _launch_counts()
    chunk = call(tables, seed, k)
    n = 200 if kernel == "K4" else RES * RES
    assert chunk.shape == (n_planes, k, n) and chunk.dtype == torch.float32
    for i in range(k):
        one = call(tables, pk._wrap_i32(seed + i))
        assert one.shape == (n_planes, n)
        assert torch.equal(chunk[:, i], one), f"sample {i} differs"
    assert _launch_counts() == before
    if kernel == "K6":  # the split keeps the sample dimension in front
        S, jitter, rays = pk.sample_planes_split(chunk)
        S1, jitter1, _ = pk.sample_planes_split(chunk[:, -1])
        assert S.shape == (k, n, 4, 3) and jitter.shape == (k, n, 2)
        assert torch.equal(S[-1], S1) and torch.equal(jitter[-1], jitter1)
        assert int(rays) == int(chunk[12].sum())


@pytest.mark.parametrize("n_samples", [0, True, 2.0], ids=["zero", "bool", "float"])
def test_chunk_size_must_be_a_positive_int(n_samples):
    with pytest.raises(ValueError, match="n_samples"):
        pk.raygen_trace(_tables(G.POL_CONST), 0, n_samples)


def test_render_polarizers_in_chunks_is_bit_equal_and_holds_the_golden(monkeypatch):
    """render(polarizers.xml) at 32x32, 16 spp, seed 0, tile_rows 8: chunks
    of 5, 5, 5 and 1 samples give the image and ray count of one sample a
    pass, and the image stays within CPU_LIMIT of tpu_rt's render."""
    sc = tpu_rt_torch.load_file(G.POLARIZERS, res=G.RENDER["res"], spp=16)
    chunks = []
    trace = pk.raygen_trace

    def spy(tables, seed, n_samples=None):
        chunks.append(n_samples)
        return trace(tables, seed, n_samples)

    monkeypatch.setattr(pk, "raygen_trace", spy)
    img = tpu_rt_torch.render(sc, spp=16, seed=0, device="cpu", tile_rows=8, spp_per_pass=5)
    rays = int(tpu_rt_torch.render.last_ray_count)
    assert chunks == [5, 5, 5, 1]
    one = tpu_rt_torch.render(sc, spp=16, seed=0, device="cpu", tile_rows=8, spp_per_pass=1)
    assert chunks[4:] == [1] * 16
    assert torch.equal(img, one) and rays == int(tpu_rt_torch.render.last_ray_count)
    golden = np.load(G.OUT)
    assert G.render_gate(img.numpy(), golden["render_16"]) <= G.CPU_LIMIT
    want_rays = int(golden["render_16_rays"])
    assert abs(rays - want_rays) <= 0.01 * want_rays


def test_stokes_per_sample_route_in_chunks_is_bit_equal():
    """K6's route on cbox_pol at 16x16, 3 spp (gaussian, depth 16): chunks
    of 2 and 1 against one sample a chunk."""
    sc = tpu_rt_torch.load_file(CBOX_POL, res=16, spp=3)
    S2, r2 = render_stokes_per_sample(sc, 3, 4, "cpu", tile_rows=8, spp_per_pass=2)
    S1, r1 = render_stokes_per_sample(sc, 3, 4, "cpu", tile_rows=8, spp_per_pass=1)
    assert S2.shape == (16, 16, 4, 3) and bool(torch.isfinite(S2).all())
    assert torch.equal(S2, S1) and int(r2) == int(r1) > 3 * 16 * 16
    assert S2[..., 1:3, :].abs().max().item() > 1e-4  # polarized


@pytest.mark.parametrize("route", ["K5", "K6"])
def test_routes_splat_in_pieces_bit_equal(route, monkeypatch):
    """``sample_film`` splats a chunk in pieces of at most SPLAT_CHUNK
    samples: with pieces of one sample, K5's route (polarizers.xml, 8x8)
    and K6's (cbox_pol, 8x8, gaussian) give their unpieced images and ray
    counts bit for bit."""
    if route == "K5":
        sc = tpu_rt_torch.load_file(G.POLARIZERS, res=RES, spp=3)

        def run():
            img = tpu_rt_torch.render(sc, spp=3, seed=2, device="cpu", tile_rows=8,
                                      spp_per_pass=3)
            return img, int(tpu_rt_torch.render.last_ray_count)
    else:
        sc = tpu_rt_torch.load_file(CBOX_POL, res=RES, spp=3)

        def run():
            S, rays = render_stokes_per_sample(sc, 3, 2, "cpu", tile_rows=8, spp_per_pass=3)
            return S, int(rays)

    whole, rays = run()
    monkeypatch.setattr(pk, "SPLAT_CHUNK", 1)
    pieces, rays1 = run()
    assert torch.equal(pieces, whole) and rays1 == rays > 3 * RES * RES
    assert bool(torch.isfinite(whole).all()) and whole.abs().sum().item() > 0


@pytest.mark.parametrize("filter_type", [TT.FILTER_BOX, TT.FILTER_TENT, TT.FILTER_GAUSSIAN],
                         ids=["box", "tent", "gaussian"])
def test_splat_in_order_equals_one_pass_at_a_time(filter_type):
    """splat_in_order of a batch of passes equals splat_aligned called once
    a pass, bit for bit; inactive and non-finite samples are left out."""
    rng = np.random.default_rng(filter_type)
    n, H, W, C = 4, 6, 10, 3
    jit = torch.from_numpy(rng.uniform(0, 1, (n, H, W, 2)).astype(np.float32))
    vals = torch.from_numpy(rng.exponential(1.0, (n, H, W, C)).astype(np.float32))
    act = torch.from_numpy(rng.uniform(0, 1, (n, H, W)) > 0.2)
    vals[~act] = float("nan")
    fv0 = torch.from_numpy(rng.uniform(0, 1, (H, W, C)).astype(np.float32))
    fw0 = torch.from_numpy(rng.uniform(0, 1, (H, W)).astype(np.float32))
    fv, fw = film.splat_in_order(fv0, fw0, jit, vals, act, filter_type)
    gv, gw = fv0, fw0
    for i in range(n):
        gv, gw = film.splat_aligned(gv, gw, jit[i:i + 1], vals[i:i + 1], act[i:i + 1],
                                    filter_type)
    assert torch.equal(fv, gv) and torch.equal(fw, gw)
    assert bool(torch.isfinite(fv).all()) and fw.sum().item() > fw0.sum().item()

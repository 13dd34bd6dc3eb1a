"""The hand-written CUDA kernels (the film kernel with its clustered-mesh
mode, its pass-through lane, its Stokes modes K3 and K6, its per-sample
modes K5 and K4 and K2's regeneration loop, the ultrasound acquisition
kernel, the direct mesh kernel and the clustered mesh-intersect kernel)
against their plain PyTorch versions, on the card, and the routes through
them.
Every test here is marked ``cuda`` and skips without a GPU.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

The kernels follow their plain versions operation by operation (built
with -fmad=false), so they are held to them bit for bit: the film kernel's
planes; the acquisition kernel's records (pressures everywhere, time-sample
indices and receive elements wherever the pressure is non-zero: a dead
lane's are don't-cares, which the kernel leaves 0), with its group of
threads a lane splitting the sweeps, also on two coincident prims and on
64 prims; its
deposit mode against ``deposit_rf`` of its own records within 1e-6 of the
largest |RF| (both add in a run-dependent order on the card: atomics and
index_add_); the DAS kernel equal to its plain version with one angle and
one element (each tap the same arithmetic, a one-term sum) and within
2e-5 of the largest |pixel| at USMain's full shape (320 terms summed in
another order), bit-equal to the first DAS kernel's order of sums done one
torch operation at a time (also with its windows split over ring slots),
and its packing kernel bit-equal to its plain version; the DAS adjoint
against autograd of the plain form, also in its
split mode on a 70 000-sample trace;
the direct mesh kernel bit-equal (radiance and rays cast); the
mesh-intersect kernel bit-equal (t, prim, u, v), also with dead lanes
(tmax 0), on cluster ranges that cut the cull hierarchy's nodes and on
duplicated triangles, and its one call bit-equal to the chained segments;
the
Stokes kernels K3 and K6 and K2's loop bit-equal to their plain versions,
K2's loop bit-equal to the per-sample loop for K1, K3's records also on a
grid with a ragged edge; K5 and K4
under a textured environment, K1 with polarizer / null pass-through and
K3 with a null BSDF bit-equal to their plain versions; the rough
conductor's lane and cone prims in K1, K2's loop, K3, K6, K5 and K4, and
cones in the acquisition kernel, bit-equal to their plain versions; the
film kernels' two launches, the trace kernel's sample records and
film_splat on given records, bit-equal to their plain versions, also
across a chunk boundary; K6, K5 and K4 on a chunk of samples a launch,
bit-equal to their plain chunks and to one-sample launches, and the
textured-environment route launching K5 once a chunk.  The acoustic
wavefront (the ultrasound route of scenes outside the acquisition
kernel's scope) on the card against its CPU run fed the same uniforms,
its mesh queries through the mesh-intersect kernel (bit-equal on a
bounce wave), and its trace routes (brute force, chunks, BVH) agreeing
on one wave.  The textured wavefront on the card against its CPU run fed
the same uniforms, K7 bit-equal on the primaries and shadow rays of the
textured knot and of shadow_art's tube mesh, and render_soft's gradient
on the card against the CPU's on the same draws.
"""

import functools
import os

import numpy as np
import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch.geometry import trace
from tpu_rt_torch.integrator import path as wavefront
from tpu_rt_torch.integrator import ultrasound as us_wavefront
from tpu_rt_torch.ops import mesh_kernel, path_kernel, us_kernel
from tpu_rt_torch.sensor import camera
from tpu_rt_torch.sensor.transducer import plane_wave_rays
from tpu_rt_torch.us import beamform
from tpu_rt_torch.us.pipeline import us_render
from torch_port_scenes import (cone_box_desc, envmap_desc, envmap_rough_cone_desc, mixed_desc,
                               plate_desc, polarizer_desc, tie_fixture, usmain_desc,
                               usmain_mesh_desc, usmain_scatterers_desc, usmain_twin_desc)

torch.set_num_threads(1)

CBOX = os.path.join(os.path.dirname(__file__), "assets", "cbox", "cbox.xml")
MESH = os.path.join(os.path.dirname(__file__), "assets", "mesh")
SIMPLE = os.path.join(MESH, "simple.xml")
MESH_GI = os.path.join(MESH, "mesh_gi.xml")
BIG_GI = os.path.join(MESH, "mesh_big_gi.xml")
SIMPLE_BIG = os.path.join(MESH, "simple_big.xml")
CBOX_POL = os.path.join(os.path.dirname(__file__), "assets", "cbox_pol", "cbox_pol.xml")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _tables(res, depth, filter_type, tile_rows=16):
    st = tpu_rt_torch.load_file(CBOX, res=res, spp=1).replace(max_depth=depth)
    st = st.replace(camera=st.camera.replace(filter_type=filter_type))
    return path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, tile_rows, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("filter_type", [1, 0, 2], ids=["tent", "box", "gaussian"])
@pytest.mark.parametrize("res,depth,k,seed", [(16, 3, 2, 5), (48, 6, 4, -3)])
def test_kernel_matches_plain_version(filter_type, res, depth, k, seed):
    _need_cuda()
    tables = _tables(res, depth, filter_type)
    before = path_kernel.film_trace.launches
    got = path_kernel.film_trace(tables, seed, k)
    torch.cuda.synchronize()
    assert path_kernel.film_trace.launches == before + 1
    assert got.shape == (tables.n_acc + 1, res * res) and got.device.type == "cuda"
    _check(got.cpu().numpy(), path_kernel.film_trace_plain(tables, seed, k).cpu().numpy())


def _check(got, want):
    """K1's planes, bit for bit."""
    np.testing.assert_array_equal(got, want)
    assert want[-1].sum() > 0


@pytest.mark.cuda
def test_kernel_matches_plain_version_mixed_scene():
    """Rectangles, an emissive rectangle, a point light, a constant
    environment, an eta/k conductor, hide_emitters, gaussian film."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(mixed_desc(tpu_rt_torch.ScalarTransform4f))
    st = st.replace(max_depth=6)
    tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 16, "cuda")
    got = path_kernel.film_trace(tables, 17, 8).cpu().numpy()
    want = path_kernel.film_trace_plain(tables, 17, 8).cpu().numpy()
    _check(got, want)


@pytest.mark.cuda
def test_render_on_cuda_goes_through_the_kernel():
    _need_cuda()
    st = tpu_rt_torch.load_file(CBOX, res=32, spp=10)
    before = path_kernel.film_trace.launches
    img = tpu_rt_torch.render(st, seed=1, spp_per_pass=4)
    assert path_kernel.film_trace.launches == before + 3  # 4 + 4 + 2 samples
    assert img.device.type == "cuda" and img.shape == (32, 32, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    assert tpu_rt_torch.render.last_ray_count.device.type == "cuda"


def _us_check(got, want):
    """The records bit for bit: the pressures, and the time and element
    records where the pressure is non-zero."""
    assert torch.equal(got[0::3], want[0::3])
    nz = got[0::3] != 0.0
    assert nz.any()
    assert torch.equal(got[1::3][nz], want[1::3][nz])
    assert torch.equal(got[2::3][nz], want[2::3][nz])


@pytest.mark.cuda
@pytest.mark.parametrize("radius,opening,rpp,seed", [
    (float("inf"), None, 8, 0), (float("inf"), None, 64, -3), (0.02, None, 8, 5),
    (0.02, None, 64, 1234), (0.02, 40.0, 64, 77)],
    ids=["linear-rpp8", "linear-rpp64", "convex-rpp8", "convex-rpp64", "convex-arc-rpp64"])
def test_us_kernel_matches_plain_version(radius, opening, rpp, seed):
    """The USMain acquisition (2 560 or 20 480 lanes, depth 10), on a
    linear array, a convex one, and a convex one spread over an opening
    angle."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f, radius=radius,
                                            opening_angle=opening))
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8, "cuda")
    b = plane_wave_rays(st.ultrasound)
    rays = torch.repeat_interleave(torch.cat([b["o"].T, b["d"].T, b["tx_delay"][None]]),
                                   rpp, dim=1).cuda()
    before = us_kernel.us_trace.launches
    got = us_kernel.us_trace(tables, rays, seed)
    torch.cuda.synchronize()
    assert us_kernel.us_trace.launches == before + 1
    assert got.shape == (30, 5 * 64 * rpp) and got.device.type == "cuda"
    _us_check(got, us_kernel.us_trace_plain(tables, rays, seed))


def _launches():
    return (us_kernel.us_trace.launches, us_kernel.us_trace_rf.launches,
            beamform.das_beamform.launches)


@pytest.mark.cuda
def test_us_render_on_cuda_goes_through_the_kernel(monkeypatch):
    """One us_acq launch (its deposit mode) and one us_das launch a frame;
    no records, no index_add_ deposit, no matmul DAS."""
    _need_cuda()

    def refuse(*a, **k):
        raise AssertionError("not on the card's main path")

    monkeypatch.setattr(us_kernel, "deposit_rf", refuse)
    monkeypatch.setattr(beamform, "das_beamform_matmul", refuse)
    monkeypatch.setattr(beamform, "das_beamform_plain", refuse)
    st = tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f))
    before = _launches()
    img, ch, tx = us_render(st, seed=1, rays_per_pair=4, x_bounds=(-0.004, 0.004),
                            z_bounds=(0.046, 0.054), device="cuda")
    assert _launches() == (before[0], before[1] + 1, before[2] + 1)
    assert img.device.type == ch.device.type == tx.device.type == "cuda"
    assert ch.shape == (5, 64, 10000) and tx.shape == (5, 64)
    assert bool(torch.isfinite(img).all()) and 0.0 <= img.min().item() <= img.max().item() <= 1.0
    assert ch.abs().sum().item() > 0


def _direct_rays(st, n_pass, seed):
    c = st.camera
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    ys, xs = torch.meshgrid(torch.arange(c.height, device="cuda"),
                            torch.arange(c.width, device="cuda"), indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    jitter = torch.rand((n_pass, c.height * c.width, 2), generator=gen, device="cuda")
    o, d = camera.sample_ray(c, xy + jitter)
    return torch.cat([o, d], -1).reshape(-1, 6).T.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("res,n_pass,seed", [(32, 1, 0), (64, 4, 7)])
def test_direct_kernel_matches_plain_version(res, n_pass, seed):
    _need_cuda()
    st = tpu_rt_torch.load_file(SIMPLE, res=res, spp=n_pass)
    ds = mesh_kernel.bake_direct_scene(st).to("cuda")
    rays = _direct_rays(st, n_pass, seed)
    before = mesh_kernel.direct_trace.launches
    got = mesh_kernel.direct_trace(ds, rays)
    torch.cuda.synchronize()
    assert mesh_kernel.direct_trace.launches == before + 1
    assert got.shape == (4, res * res * n_pass) and got.device.type == "cuda"
    want = mesh_kernel.direct_trace_plain(ds, rays)
    for plane in range(4):
        assert torch.equal(got[plane], want[plane]), plane
    assert (want[:3].sum(0) > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("res,k,seed", [(16, 2, 5), (48, 4, -3)])
def test_kernel_mesh_mode_matches_plain_version(res, k, seed):
    _need_cuda()
    st = tpu_rt_torch.load_file(MESH_GI, res=res, spp=k)
    tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 16, "cuda")
    assert tables.hdr_list[path_kernel.HDR_MESH_C] > 0
    got = path_kernel.film_trace(tables, seed, k)
    _check(got.cpu().numpy(), path_kernel.film_trace_plain(tables, seed, k).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("path,counter,launches", [
    (SIMPLE, "direct", 3), (MESH_GI, "film", 3)], ids=["simple", "mesh_gi"])
def test_render_mesh_scene_on_cuda_goes_through_the_kernel(path, counter, launches):
    _need_cuda()
    fn = mesh_kernel.direct_trace if counter == "direct" else path_kernel.film_trace
    other = path_kernel.film_trace if counter == "direct" else mesh_kernel.direct_trace
    st = tpu_rt_torch.load_file(path, res=32, spp=10)
    before, before_other = fn.launches, other.launches
    img = tpu_rt_torch.render(st, seed=1, spp_per_pass=4)
    assert fn.launches == before + launches and other.launches == before_other
    assert img.device.type == "cuda" and img.shape == (32, 32, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    rays = tpu_rt_torch.render.last_ray_count
    assert rays.device.type == "cuda" and int(rays) > 32 * 32 * 10


def _big_gi_rays(res, seed):
    """Primaries of mesh_big_gi.xml at res x res, then cosine-like bounce
    rays from their hits and shadow rays toward the light with tmax."""
    st = tpu_rt_torch.load_file(BIG_GI, res=res, spp=1).to("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    c = st.camera
    ys, xs = torch.meshgrid(torch.arange(res, device="cuda"), torch.arange(res, device="cuda"),
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    o, d = camera.sample_ray(c, xy + torch.rand((res * res, 2), generator=gen, device="cuda"))
    o, d = o.contiguous(), d.contiguous()
    si = trace.ray_intersect(st, o, d)
    n = torch.where((si.ng * d).sum(-1, keepdim=True) < 0, si.ng, -si.ng)
    db = torch.nn.functional.normalize(torch.randn(d.shape, generator=gen, device="cuda")
                                       + 1.2 * n, dim=-1)
    ob = si.spawn_origin(db)
    light = torch.tensor([0.0, 4.0, 0.0], device="cuda")
    to_l = light - si.p
    dist = to_l.norm(dim=-1)
    ds = to_l / dist[:, None]
    return st, [(o, d, None), (ob.contiguous(), db.contiguous(), None),
                (si.spawn_origin(ds).contiguous(), ds.contiguous(), dist * (1.0 - 1e-3))]


@pytest.mark.cuda
def test_mesh_intersect_kernel_is_bit_equal_to_plain_version():
    _need_cuda()
    st, waves = _big_gi_rays(64, 3)
    cl = trace.mesh_clusters(st.geometry)
    for o, d, tmax in waves:
        before = mesh_kernel.mesh_intersect.launches
        got = mesh_kernel.mesh_intersect(cl, o, d, tmax=tmax)
        torch.cuda.synchronize()
        assert mesh_kernel.mesh_intersect.launches == before + 1
        tm = torch.full((o.shape[0],), 0.99 * 1e8, device="cuda") if tmax is None else tmax
        t, lid, u, v = mesh_kernel.mesh_intersect_plain(cl["bounds"], cl["trisw"], o, d, tm)
        prim = torch.where(lid >= 0, cl["prim"][lid.clamp(min=0).long()], -1)
        for a, b, name in zip(got, (t, prim.to(torch.int32), u, v), ("t", "prim", "u", "v")):
            assert torch.equal(a, b), name
        assert 0 < (got[1] >= 0).float().mean().item() < 1


@pytest.mark.cuda
def test_mesh_intersect_one_call_equals_chained_segments_on_the_card():
    _need_cuda()
    st, waves = _big_gi_rays(32, 4)
    cl = trace.mesh_clusters(st.geometry)
    o, d, _ = waves[1]
    one = mesh_kernel.mesh_intersect(cl, o, d)
    best = None
    for c0 in range(0, 800, 128):
        seg = mesh_kernel.mesh_intersect(cl, o, d, tmax=None if best is None else best[0],
                                         c0=c0, c1=min(c0 + 128, 800))
        best = seg if best is None else tuple(
            torch.where(seg[1] >= 0, a, b) for a, b in zip(seg, best))
    for a, b, name in zip(one, best, ("t", "prim", "u", "v")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_mesh_intersect_kernel_with_dead_lanes_and_cut_ranges():
    """Lanes with tmax 0 (the wavefront's finished paths) and chains of
    cluster ranges that start and end inside the tree's nodes."""
    _need_cuda()
    st, waves = _big_gi_rays(32, 5)
    cl = trace.mesh_clusters(st.geometry)
    o, d, _ = waves[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    dead = torch.rand(o.shape[0], generator=gen, device="cuda") < 0.3
    tmax = torch.where(dead, 0.0, 0.99 * 1e8)
    for ranges in ([(0, 800)], [(0, 37), (37, 300), (300, 800)], [(5, 6), (190, 411)]):
        got = want = None
        for c0, c1 in ranges:
            seg = mesh_kernel.mesh_intersect(cl, o, d, tmax=tmax if got is None else got[0],
                                             c0=c0, c1=c1)
            t, lid, u, v = mesh_kernel.mesh_intersect_plain(
                cl["bounds"], cl["trisw"], o, d, tmax if want is None else want[0], c0=c0, c1=c1)
            prim = torch.where(lid >= 0, cl["prim"][lid.clamp(min=0).long()], -1)
            pl = (t, prim.to(torch.int32), u, v)
            got = seg if got is None else tuple(
                torch.where(seg[1] >= 0, a, b) for a, b in zip(seg, got))
            want = pl if want is None else tuple(
                torch.where(pl[1] >= 0, a, b) for a, b in zip(pl, want))
        for a, b, name in zip(got, want, ("t", "prim", "u", "v")):
            assert torch.equal(a, b), (ranges, name)
        assert (got[1][dead] == -1).all() and (got[0][dead] == 0).all()


@pytest.mark.cuda
def test_mesh_intersect_kernel_breaks_ties_as_the_plain_version():
    """Duplicated triangles, inside one cluster and across two: the lowest
    lane wins, with the same t, u and v, as in the plain version."""
    _need_cuda()
    cl, o, d = tie_fixture()
    cl = {k: torch.from_numpy(np.asarray(cl[k])).cuda() for k in ("bounds", "trisw", "prim",
                                                                    "tree")}
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    got = mesh_kernel.mesh_intersect(cl, o, d)
    tm = torch.full((o.shape[0],), 0.99 * 1e8, device="cuda")
    t, lid, u, v = mesh_kernel.mesh_intersect_plain(cl["bounds"], cl["trisw"], o, d, tm)
    prim = torch.where(lid >= 0, cl["prim"][lid.clamp(min=0).long()], -1).to(torch.int32)
    for a, b, name in zip(got, (t, prim, u, v), ("t", "prim", "u", "v")):
        assert torch.equal(a, b), name
    assert set(got[1].tolist()) & {5, 10, 70, 140} == {5, 10}


@pytest.mark.cuda
def test_mesh_intersect_on_cuda_needs_the_tree():
    _need_cuda()
    st, waves = _big_gi_rays(16, 1)
    cl = dict(trace.mesh_clusters(st.geometry), tree=None)
    with pytest.raises(ValueError, match="tree"):
        mesh_kernel.mesh_intersect(cl, *waves[0][:2])
    bad = trace.mesh_clusters(st.geometry)["tree"].clone()
    bad[0, 2] = 2  # a header naming a 4-way tree: the kernel walks 8-way ones
    with pytest.raises(ValueError, match="branching"):
        mesh_kernel.mesh_intersect(dict(cl, tree=bad), *waves[0][:2])


@pytest.mark.cuda
def test_argmin_on_cuda_keeps_the_first_of_equal_values():
    """The brute-force route takes torch.argmin's winner, as tpu_rt takes
    jnp.argmin's: of equal distances, the first prim."""
    _need_cuda()
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [5.0, 5.0, 5.0, 5.0], [2.0, 0.5, 9.0, 0.5]] * 1000,
                     device="cuda")
    assert torch.equal(torch.argmin(x, 1).cpu(), torch.tensor([1, 0, 1] * 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("path,max_depth", [(BIG_GI, None), (SIMPLE_BIG, 2)],
                         ids=["big_gi", "simple_big"])
def test_wavefront_on_cuda_goes_through_the_mesh_kernel(path, max_depth):
    _need_cuda()
    st = tpu_rt_torch.load_file(path, res=32, spp=2)
    before = mesh_kernel.mesh_intersect.launches
    img = tpu_rt_torch.render(st, seed=1)
    # per wave: a closest-hit query per bounce, a shadow query per NEE bounce
    bounces = wavefront.n_bounces(st, max_depth)
    cap = wavefront.resolved_depth(st, max_depth)
    per_wave = bounces + sum(1 for depth in range(bounces) if depth + 2 <= cap)
    assert mesh_kernel.mesh_intersect.launches == before + 2 * per_wave
    assert img.device.type == "cuda" and img.shape == (32, 32, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    rays = tpu_rt_torch.render.last_ray_count
    assert rays.device.type == "cuda" and int(rays) > 32 * 32 * 2


@pytest.mark.cuda
def test_wavefront_path_trace_on_cuda_matches_the_cpu():
    """The same rays and uniforms through the wavefront on the card and on
    the CPU: transcendental functions round otherwise there, so at least
    99% of the lanes within rtol 1e-4 / atol 1e-6, the rays cast within
    1%."""
    _need_cuda()
    st = tpu_rt_torch.load_file(BIG_GI, res=16, spp=1)
    gen = torch.Generator()
    gen.manual_seed(9)
    c = st.camera
    ys, xs = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32) + torch.rand(
        (256, 2), generator=gen)
    o, d, t0, t1 = camera.sample_ray_extents(c, xy)
    u = torch.rand((wavefront.n_bounces(st), 256, 8), generator=gen)
    Lc, nc = wavefront.path_trace(st, o, d, uniforms=u, tmin0=t0, tmax0=t1)
    sg = st.to("cuda")
    Lg, ng = wavefront.path_trace(sg, o.cuda(), d.cuda(), uniforms=u.cuda(), tmin0=t0.cuda(),
                                  tmax0=t1.cuda())
    close = torch.isclose(Lg.cpu(), Lc, rtol=1e-4, atol=1e-6).all(-1).float().mean().item()
    assert close >= 0.99, close
    assert abs(int(ng) - int(nc)) <= 0.01 * int(nc)


def _film_tables(path, res, depth, filter_type, stokes):
    st = tpu_rt_torch.load_file(path, res=res, spp=1)
    if depth is not None:
        st = st.replace(max_depth=depth)
    st = st.replace(camera=st.camera.replace(filter_type=filter_type))
    return path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 16, "cuda",
                                   stokes=stokes)


@pytest.mark.cuda
@pytest.mark.parametrize("filter_type", [0, 1, 2], ids=["box", "tent", "gaussian"])
@pytest.mark.parametrize("depth", [3, None], ids=["depth3", "depth16"])
def test_stokes_kernel_is_bit_equal_to_plain_version(filter_type, depth):
    """K3 on cbox_pol (depth 16 is its own), one thread a (pixel,
    sample): one K6 launch and one film_splat."""
    _need_cuda()
    tables = _film_tables(CBOX_POL, 24, depth, filter_type, True)
    before = (path_kernel.stokes_sample_trace.launches, path_kernel.film_splat.launches)
    got = path_kernel.stokes_film_trace(tables, 5, 3)
    torch.cuda.synchronize()
    assert (path_kernel.stokes_sample_trace.launches,
            path_kernel.film_splat.launches) == (before[0] + 1, before[1] + 1)
    want = path_kernel.stokes_film_trace_plain(tables, 5, 3)
    assert got.shape == want.shape == (tables.n_acc + 1, 24 * 24)
    assert torch.equal(got, want)
    assert got[1:12].abs().max().item() > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("filter_type", [0, 1, 2], ids=["box", "tent", "gaussian"])
def test_regen_loop_is_bit_equal_to_the_per_sample_loop(filter_type):
    """K2's loop and the per-sample loop give the same planes, bit for bit,
    at depth 16 (K1 on the cbox fixture; K3 has no loop form)."""
    _need_cuda()
    tables = _film_tables(CBOX, 48, 16, filter_type, False)
    a = path_kernel.film_trace(tables, -7, 4, regen=True)
    b = path_kernel.film_trace(tables, -7, 4, regen=False)
    assert torch.equal(a, b)
    assert a[-1].sum().item() > 4 * 48 * 48


@pytest.mark.cuda
def test_stokes_records_on_a_ragged_grid_equal_plain_records():
    """K3's records (the first 13 planes of a K6 launch) on a grid whose
    last block of each sample row is cut (23 x 23 = 529 pixels, 4 blocks
    of 128 and 17 pixels), a 3-sample chunk at gaussian radius 2 and depth
    16: every (pixel, sample) record written once, at blockIdx.y's stride,
    bit for bit the plain version's.  More samples than the grid holds
    raise before a launch."""
    _need_cuda()
    tables = _film_tables(CBOX_POL, 23, 16, 2, True)
    assert tables.n_pix % 128 != 0 and tables.radius == 2
    before = path_kernel.stokes_sample_trace.launches
    got = path_kernel.stokes_sample_trace(tables, 41, 3)[:tables.n_val]
    torch.cuda.synchronize()
    assert path_kernel.stokes_sample_trace.launches == before + 1
    want = path_kernel.film_records_plain(tables, 41, 3)
    assert got.shape == want.shape == (13, 3, 529)
    assert got.is_contiguous() and torch.equal(got, want)
    with pytest.raises(ValueError, match="at most"):
        path_kernel.stokes_sample_trace(tables, 0, path_kernel.MAX_SAMPLE_CHUNK + 1)


@pytest.mark.cuda
def test_scalar_depth_16_kernel_is_bit_equal_to_plain_version():
    """K1 in K2's loop, which depth 16 switches on, against the plain version."""
    _need_cuda()
    tables = _film_tables(CBOX, 32, 16, 1, False)
    assert tables.regen
    before = path_kernel.film_trace.regen_launches
    got = path_kernel.film_trace(tables, 11, 2)
    assert path_kernel.film_trace.regen_launches == before + 1
    assert torch.equal(got, path_kernel.film_trace_plain(tables, 11, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, None], ids=["depth3", "depth16"])
def test_stokes_sample_kernel_is_bit_equal_to_plain_version(depth):
    """K6 on cbox_pol; and K3's one-sample box planes are its values."""
    _need_cuda()
    tables = _film_tables(CBOX_POL, 32, depth, 0, True)
    before = path_kernel.stokes_sample_trace.launches
    got = path_kernel.stokes_sample_trace(tables, 123)
    torch.cuda.synchronize()
    assert path_kernel.stokes_sample_trace.launches == before + 1
    assert torch.equal(got, path_kernel.stokes_sample_trace_plain(tables, 123))
    film = path_kernel.stokes_film_trace(tables, 123, 1)
    assert torch.equal(film[:12], got[:12]) and torch.equal(film[13], got[12])


@pytest.mark.cuda
def test_render_stokes_on_cuda_goes_through_the_stokes_kernel():
    _need_cuda()
    st = tpu_rt_torch.load_file(CBOX_POL, res=32, spp=10)
    k3 = path_kernel.stokes_sample_trace  # K3's trace kernel is K6's
    before = (k3.launches, path_kernel.film_trace.launches)
    S = tpu_rt_torch.render(st, seed=1, spp_per_pass=4)
    assert (k3.launches, path_kernel.film_trace.launches) == (
        before[0] + 3, before[1])  # 4 + 4 + 2 samples
    assert S.device.type == "cuda" and S.shape == (32, 32, 4, 3)
    assert bool(torch.isfinite(S).all()) and S[..., 0, :].mean().item() > 0
    rays = tpu_rt_torch.render.last_ray_count
    assert rays.device.type == "cuda" and int(rays) > 32 * 32 * 10


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [0.0, 45.0, 90.0])
def test_polarizer_wavefront_on_cuda_follows_malus(delta):
    _need_cuda()
    st = tpu_rt_torch.load_dict(polarizer_desc(tpu_rt_torch.ScalarTransform4f, [0.0, delta],
                                               [0.5, 0.0]))
    before = path_kernel.stokes_sample_trace.launches
    S = tpu_rt_torch.render(st, spp=16, seed=0)
    assert path_kernel.stokes_sample_trace.launches == before
    assert S.device.type == "cuda" and S.shape == (16, 16, 4, 3)
    I = S[6:10, 6:10, 0, :].mean().item()
    assert abs(I - 0.5 * np.cos(np.deg2rad(delta)) ** 2) <= 0.04


POLARIZERS = os.path.join(os.path.dirname(__file__), "assets", "polarizers", "polarizers.xml")
ENVMAP = os.path.join(os.path.dirname(__file__), "assets", "polarizers", "envmap.exr")
POL_CONST = os.path.join(os.path.dirname(__file__), "assets", "cbox_pol", "polarizers_const.xml")


def _envmap_tables(which, res, depth=None):
    """Tables of the polarizers fixture (two sheets under the rotated EXR
    map) or of envmap_desc (every lane under it), on the card."""
    if which == "polarizers":
        st = tpu_rt_torch.load_file(POLARIZERS, res=res, spp=1)
    else:
        st = tpu_rt_torch.load_dict(envmap_desc(tpu_rt_torch.ScalarTransform4f, ENVMAP, res))
    if depth is not None:
        st = st.replace(max_depth=depth)
    tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 16, "cuda")
    assert tables.env_textured
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("which,res,depth,seed", [
    ("polarizers", 32, None, 0), ("polarizers", 40, 3, -9), ("mixed", 24, None, 4),
    ("mixed", 48, 16, 100003)])
def test_raygen_kernel_is_bit_equal_to_plain_version(which, res, depth, seed):
    """K5: the 12 planes (L, rays, jitter, escape direction and throughput)
    under the textured environment."""
    _need_cuda()
    tables = _envmap_tables(which, res, depth)
    before = path_kernel.raygen_trace.launches
    got = path_kernel.raygen_trace(tables, seed)
    torch.cuda.synchronize()
    assert path_kernel.raygen_trace.launches == before + 1
    want = path_kernel.raygen_trace_plain(tables, seed)
    assert got.shape == want.shape == (12, res * res)
    assert torch.equal(got, want)
    assert (got[9:12].sum(0) > 0).any() and got[3].sum().item() >= res * res


@pytest.mark.cuda
@pytest.mark.parametrize("which,n,seed", [("polarizers", 1000, 2), ("mixed", 5000, -1),
                                          ("cbox", 2500, 9)])
def test_rays_kernel_is_bit_equal_to_plain_version(which, n, seed):
    """K4 on rays passed in (n not a multiple of the tile): 10 planes under
    the textured environment, 4 on the cbox."""
    _need_cuda()
    if which == "cbox":
        tables = _film_tables(CBOX, 16, 3, 1, False)
    else:
        tables = _envmap_tables(which, 16)
    gen = torch.Generator()
    gen.manual_seed(n)
    o = (torch.rand((n, 3), generator=gen) - 0.5) * 0.4
    o[:, 2] -= 3.0 if which != "cbox" else 0.0
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen) * 0.3 + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    o, d = o.cuda(), d.cuda()
    before = path_kernel.path_trace.launches
    got = path_kernel.path_trace(tables, o, d, seed)
    torch.cuda.synchronize()
    assert path_kernel.path_trace.launches == before + 1
    want = path_kernel.path_trace_plain(tables, o, d, seed)
    assert got.shape == want.shape == ((4 if which == "cbox" else 10), n)
    assert torch.equal(got, want)
    # the cbox's light reaches L; the environment reaches the escape record
    assert got[0:3 if which == "cbox" else 7].sum().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path,filter_type,depth", [(POL_CONST, 2, None), (POL_CONST, 1, 4),
                                                   ("mixed_const", 2, 6)],
                         ids=["polarizers_const", "polarizers_const_tent", "mixed_const"])
def test_film_kernel_with_pass_through_is_bit_equal_to_plain_version(path, filter_type, depth):
    """K1's pass-through lane: polarizer and null BSDFs under a constant
    environment take the film kernel (polarizers_const.xml in K2's loop at
    depth 16; every lane of envmap_desc with a constant environment)."""
    _need_cuda()
    if path == "mixed_const":
        desc = envmap_desc(tpu_rt_torch.ScalarTransform4f, ENVMAP, 32)
        desc["env"] = {"type": "constant", "radiance": np.array([0.7, 0.8, 0.9])}
        st = tpu_rt_torch.load_dict(desc)
    else:
        st = tpu_rt_torch.load_file(path, res=32, spp=1)
    if depth is not None:
        st = st.replace(max_depth=depth)
    st = st.replace(camera=st.camera.replace(filter_type=filter_type))
    bs = path_kernel.bake_scene(st)
    assert path_kernel.BSDF_POLARIZER in {b for b, _ in bs.bsdfs} and not bs.env_textured
    tables = path_kernel.pack_tables(bs, st.camera, 16, "cuda")
    got = path_kernel.film_trace(tables, 3, 4)
    assert torch.equal(got, path_kernel.film_trace_plain(tables, 3, 4))
    assert got[-1].sum().item() > 4 * 32 * 32


@pytest.mark.cuda
def test_stokes_kernel_with_a_null_bsdf_is_bit_equal_to_plain_version():
    """K3's neutral attenuator: cbox_pol with its low glass sphere turned
    into a null BSDF, depth 16."""
    _need_cuda()
    st = tpu_rt_torch.load_file(CBOX_POL, res=24, spp=1)
    bt = st.bsdf_type.clone()
    bt[4] = path_kernel.BSDF_NULL
    st = st.replace(bsdf_type=bt)
    bs = path_kernel.bake_scene(st)
    assert path_kernel.stokes_in_scope(bs)
    tables = path_kernel.pack_tables(bs, st.camera, 16, "cuda", stokes=True)
    got = path_kernel.stokes_film_trace(tables, 8, 3)
    assert torch.equal(got, path_kernel.stokes_film_trace_plain(tables, 8, 3))
    assert got[1:12].abs().max().item() > 1e-4


@pytest.mark.cuda
def test_render_textured_environment_on_cuda_goes_through_k5():
    _need_cuda()
    st = tpu_rt_torch.load_file(POLARIZERS, res=32, spp=3)
    before = (path_kernel.raygen_trace.launches, path_kernel.film_trace.launches)
    img = tpu_rt_torch.render(st, seed=1)
    assert (path_kernel.raygen_trace.launches, path_kernel.film_trace.launches) == (
        before[0] + 1, before[1])  # one K5 launch for the 3-sample chunk, no film kernel
    assert img.device.type == "cuda" and img.shape == (32, 32, 3)
    assert bool(torch.isfinite(img).all()) and img.max().item() > 5.0
    rays = tpu_rt_torch.render.last_ray_count
    assert rays.device.type == "cuda" and int(rays) >= 32 * 32 * 3


CBOX_ROUGH = os.path.join(os.path.dirname(__file__), "assets", "cbox", "cbox_rough.xml")
POL_ROUGH = os.path.join(os.path.dirname(__file__), "assets", "cbox_pol", "cbox_pol_rough.xml")


@pytest.mark.cuda
@pytest.mark.parametrize("filter_type,depth,regen", [
    (1, None, False), (0, 3, False), (2, None, False), (1, 16, True), (1, 16, False)],
    ids=["tent", "box_depth3", "gaussian", "depth16_regen", "depth16_per_sample"])
def test_film_kernel_rough_cone_is_bit_equal_to_plain_version(filter_type, depth, regen):
    """K1's rough conductor and cone lanes on cbox_rough.xml, and K2's loop
    around them at depth 16."""
    _need_cuda()
    tables = _film_tables(CBOX_ROUGH, 32, depth, filter_type, False)
    assert tables.rough_cone and "cone" in {p.kind for p in path_kernel.bake_scene(
        tpu_rt_torch.load_file(CBOX_ROUGH, res=8, spp=1)).prims}
    before = path_kernel.film_trace.launches
    got = path_kernel.film_trace(tables, 9, 3, regen=regen)
    torch.cuda.synchronize()
    assert path_kernel.film_trace.launches == before + 1
    assert torch.equal(got, path_kernel.film_trace_plain(tables, 9, 3))
    assert got[-1].sum().item() > 3 * 32 * 32


@pytest.mark.cuda
@pytest.mark.parametrize("filter_type", [0, 2], ids=["box", "gaussian"])
def test_stokes_kernel_rough_is_bit_equal_to_plain_version(filter_type):
    """K3's rough lane, with the NEE Mueller chain, on cbox_pol_rough.xml at
    depth 16; and K6 on the same tables."""
    _need_cuda()
    tables = _film_tables(POL_ROUGH, 24, None, filter_type, True)
    assert tables.rough_cone and not tables.regen
    got = path_kernel.stokes_film_trace(tables, 4, 3)
    assert torch.equal(got, path_kernel.stokes_film_trace_plain(tables, 4, 3))
    assert got[1:12].abs().max().item() > 1e-4
    one = path_kernel.stokes_sample_trace(tables, 77)
    assert torch.equal(one, path_kernel.stokes_sample_trace_plain(tables, 77))


@pytest.mark.cuda
@pytest.mark.parametrize("res,seed", [(24, 4), (40, -6)])
def test_per_sample_kernels_rough_cone_are_bit_equal_to_plain_version(res, seed):
    """K5 and K4 on the rough ball and the cone under the textured
    environment (envmap_rough_cone_desc)."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(envmap_rough_cone_desc(tpu_rt_torch.ScalarTransform4f, ENVMAP,
                                                       res))
    tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 16, "cuda")
    assert tables.rough_cone and tables.env_textured
    got = path_kernel.raygen_trace(tables, seed)
    assert torch.equal(got, path_kernel.raygen_trace_plain(tables, seed))
    gen = torch.Generator()
    gen.manual_seed(res)
    o = torch.tensor([0.0, 1.0, -4.0]) + (torch.rand((3000, 3), generator=gen) - 0.5) * 0.2
    d = torch.nn.functional.normalize(
        torch.rand((3000, 3), generator=gen) * torch.tensor([3.0, 2.0, 3.0])
        - torch.tensor([1.5, 1.0, 1.0]) - o, dim=-1)
    o, d = o.cuda(), d.cuda()
    got = path_kernel.path_trace(tables, o, d, seed)
    assert torch.equal(got, path_kernel.path_trace_plain(tables, o, d, seed))
    assert got[0:3].sum().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("box,rpp,seed", [(True, 64, 0), (True, 8, -5), (False, 64, 3)],
                         ids=["box-rpp64", "box-rpp8", "floating-rpp64"])
def test_us_kernel_cone_is_bit_equal_to_plain_version(box, rpp, seed):
    """The acquisition kernel on the Cone_Box / Cone_FLoating class
    (20 480 or 2 560 lanes, depth 10)."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(cone_box_desc(tpu_rt_torch.ScalarTransform4f, box))
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8, "cuda")
    b = plane_wave_rays(st.ultrasound)
    rays = torch.repeat_interleave(torch.cat([b["o"].T, b["d"].T, b["tx_delay"][None]]),
                                   rpp, dim=1).cuda()
    got = us_kernel.us_trace(tables, rays, seed)
    want = us_kernel.us_trace_plain(tables, rays, seed)
    # pressures bit for bit; the time and element records where the echo
    # is there (a dead lane's are don't-cares, which the kernel leaves 0)
    assert torch.equal(got[0::3], want[0::3])
    nz = got[0::3] != 0
    assert nz.any()
    assert torch.equal(got[1::3][nz], want[1::3][nz]) and torch.equal(got[2::3][nz], want[2::3][nz])


@pytest.mark.cuda
def test_render_rough_cone_and_cone_box_go_through_the_kernels():
    """render(cbox_rough.xml) takes K1 alone; us_render on cone_box_desc
    takes K10."""
    _need_cuda()
    st = tpu_rt_torch.load_file(CBOX_ROUGH, res=32, spp=10)
    before = (path_kernel.film_trace.launches, mesh_kernel.mesh_intersect.launches)
    img = tpu_rt_torch.render(st, seed=1, spp_per_pass=4)
    assert (path_kernel.film_trace.launches, mesh_kernel.mesh_intersect.launches) == (
        before[0] + 3, before[1])
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all()) and img.mean() > 0
    us = tpu_rt_torch.load_dict(cone_box_desc(tpu_rt_torch.ScalarTransform4f))
    before = _launches()
    bm, ch, _ = us_render(us, seed=1, rays_per_pair=4, x_bounds=(-0.01, 0.01),
                          z_bounds=(0.05, 0.09), device="cuda")
    assert _launches() == (before[0], before[1] + 1, before[2] + 1)
    assert bool(torch.isfinite(bm).all()) and ch.abs().sum().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("filter_type", [0, 1, 2], ids=["box", "tent", "gaussian"])
@pytest.mark.parametrize("stokes", [False, True], ids=["K1", "K3"])
def test_film_splat_kernel_is_bit_equal_to_plain_splat(filter_type, stokes):
    """film_splat against film_splat_plain on the same records, added onto
    the planes of an earlier chunk (cbox / cbox_pol at 40x40, 6 samples)."""
    _need_cuda()
    tables = _film_tables(CBOX_POL if stokes else CBOX, 40, 6, filter_type, stokes)
    recs = path_kernel.film_records_plain(tables, 21, 6)
    start = path_kernel.film_trace_plain(tables, 15, 6) if not stokes else \
        path_kernel.stokes_film_trace_plain(tables, 15, 6)
    before = path_kernel.film_splat.launches
    got = path_kernel.film_splat(recs, start.clone(), tables, 21)
    torch.cuda.synchronize()
    assert path_kernel.film_splat.launches == before + 1
    want = path_kernel.film_splat_plain(recs, start.clone(), tables, 21)
    assert torch.equal(got, want)
    assert not torch.equal(got, start)


@pytest.mark.cuda
@pytest.mark.parametrize("filter_type", [0, 1, 2], ids=["box", "tent", "gaussian"])
@pytest.mark.parametrize("path,stokes,regen", [
    (CBOX, False, False), (CBOX, False, True), (CBOX_POL, True, None),
    (POL_ROUGH, True, None), (CBOX_ROUGH, False, False), (MESH_GI, False, False)],
    ids=["K1", "K1_K2_loop", "K3", "K3_rough", "K1_rough", "K1_mesh"])
def test_trace_kernel_records_equal_plain_records(path, stokes, regen, filter_type):
    """The trace kernel writes the plain version's records, bit for bit, at
    depth 16 ([value][sample][pixel]), in every form: K1's clustered-mesh
    mode on mesh_gi.xml too; K3's are the first 13 of K6's planes."""
    _need_cuda()
    tables = _film_tables(path, 24, 16, filter_type, stokes)
    before = (path_kernel.stokes_sample_trace.launches, path_kernel.film_trace.launches,
              path_kernel.film_trace.regen_launches)
    if stokes:
        got = path_kernel.stokes_sample_trace(tables, 3, 4)[:tables.n_val]
    else:
        got = path_kernel.film_records(tables, 3, 4, regen=regen)
    torch.cuda.synchronize()
    assert (path_kernel.stokes_sample_trace.launches, path_kernel.film_trace.launches,
            path_kernel.film_trace.regen_launches) == (
        before[0] + int(stokes), before[1] + int(not stokes), before[2] + int(bool(regen)))
    want = path_kernel.film_records_plain(tables, 3, 4)
    assert got.shape == want.shape == (tables.n_val, 4, 24 * 24)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stokes", [False, True], ids=["K1", "K3"])
def test_film_launch_across_a_chunk_boundary_is_bit_equal(stokes, monkeypatch):
    """A launch of more samples than one record buffer holds (70 > 64
    samples: two chunks), and the same split into chunks of 3 samples,
    bit-equal to the plain version."""
    _need_cuda()
    tables = _film_tables(CBOX_POL if stokes else CBOX, 16, 3, 2, stokes)
    trace_fn = path_kernel.stokes_film_trace if stokes else path_kernel.film_trace
    plain_fn = path_kernel.stokes_film_trace_plain if stokes else path_kernel.film_trace_plain
    n = path_kernel.RECORD_CHUNK + 6
    counter = path_kernel.stokes_sample_trace if stokes else path_kernel.film_trace
    before = (counter.launches, path_kernel.film_splat.launches)
    got = trace_fn(tables, -2, n)
    assert (counter.launches, path_kernel.film_splat.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, plain_fn(tables, -2, n))
    monkeypatch.setattr(path_kernel, "RECORD_CHUNK", 3)
    small = trace_fn(tables, 8, 7)
    assert torch.equal(small, plain_fn(tables, 8, 7))


def _chunk_checks(call, plain, seed, k):
    """A chunk launch of ``call`` (a wrapper's partial; counted once)
    against its plain chunk and against k one-sample launches seeded
    seed + i, bit for bit; returns the chunk."""
    before = call.func.launches
    got = call(seed, k)
    torch.cuda.synchronize()
    assert call.func.launches == before + 1
    assert got.dim() == 3 and got.shape[1] == k
    assert torch.equal(got, plain(seed, k))
    singles = torch.stack([call(path_kernel._wrap_i32(seed + i)) for i in range(k)], 1)
    assert torch.equal(got, singles)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("path,depth,k,seed", [
    (CBOX_POL, 3, 4, 11), (CBOX_POL, None, 3, 2**31 - 2), (POL_ROUGH, None, 3, -7)],
    ids=["depth3", "depth16_wrapping", "rough_depth16"])
def test_stokes_sample_chunk_is_bit_equal(path, depth, k, seed):
    """K6 on a chunk of samples: cbox_pol at depths 3 and 16 and the rough
    lane on cbox_pol_rough."""
    _need_cuda()
    tables = _film_tables(path, 24, depth, 2, True)
    got = _chunk_checks(functools.partial(path_kernel.stokes_sample_trace, tables),
                        functools.partial(path_kernel.stokes_sample_trace_plain, tables), seed, k)
    assert got.shape == (15, k, 24 * 24) and got[1:12].abs().max().item() > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("which,k,seed", [("polarizers", 4, 0), ("rough_cone", 3, -6)])
def test_raygen_and_rays_chunks_are_bit_equal(which, k, seed):
    """K5 and K4 on a chunk of samples under the textured environment:
    polarizers.xml (K4 on 1 024 rays through the sheets) and the rough ball
    and cone of envmap_rough_cone_desc."""
    _need_cuda()
    if which == "polarizers":
        tables = _envmap_tables("polarizers", 32)
    else:
        st = tpu_rt_torch.load_dict(envmap_rough_cone_desc(tpu_rt_torch.ScalarTransform4f,
                                                           ENVMAP, 32))
        tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 16, "cuda")
        assert tables.rough_cone
    got = _chunk_checks(functools.partial(path_kernel.raygen_trace, tables),
                        functools.partial(path_kernel.raygen_trace_plain, tables), seed, k)
    assert got.shape == (12, k, 32 * 32) and (got[9:12].sum(0) > 0).any()
    gen = torch.Generator()
    gen.manual_seed(k)
    o = torch.tensor([0.0, 0.0, -3.0]) + (torch.rand((1024, 3), generator=gen) - 0.5) * 0.4
    d = torch.nn.functional.normalize(
        torch.randn((1024, 3), generator=gen) * 0.3 + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    o, d = o.cuda(), d.cuda()
    got = _chunk_checks(functools.partial(path_kernel.path_trace, tables, o, d),
                        functools.partial(path_kernel.path_trace_plain, tables, o, d), seed, k)
    assert got.shape == (10, k, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("spp,spp_per_pass", [(5, 2), (5, 64), (10, 10)])
def test_render_textured_environment_launches_k5_once_a_chunk(spp, spp_per_pass):
    """render(polarizers.xml) launches K5 ceil(spp / spp_per_pass) times,
    and its image is the one-sample-a-pass render's, bit for bit."""
    _need_cuda()
    st = tpu_rt_torch.load_file(POLARIZERS, res=32, spp=spp)
    before = path_kernel.raygen_trace.launches
    img = tpu_rt_torch.render(st, seed=2, spp_per_pass=spp_per_pass)
    rays = int(tpu_rt_torch.render.last_ray_count)
    assert path_kernel.raygen_trace.launches == before + -(-spp // spp_per_pass)
    one = tpu_rt_torch.render(st, seed=2, spp_per_pass=1)
    assert torch.equal(img, one) and rays == int(tpu_rt_torch.render.last_ray_count)


def _us_pairs(st, rpp):
    """The pair rays [7, A * E] on the card, the lanes [7, N] and each
    lane's angle."""
    b = plane_wave_rays(st.ultrasound)
    rays = torch.cat([b["o"].T, b["d"].T, b["tx_delay"][None]]).cuda()
    return (rays, torch.repeat_interleave(rays, rpp, dim=1),
            torch.repeat_interleave(b["angle_idx"], rpp).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("twin", ["after", "before"])
def test_us_kernel_coincident_prims_is_bit_equal_to_plain_version(twin):
    """The plate and a twin at the same place (another impedance): the
    group's threads sweep the two apart and keep the lower prim, as the
    plain version's sweep does."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(usmain_twin_desc(tpu_rt_torch.ScalarTransform4f, twin))
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8, "cuda")
    _, lanes, _ = _us_pairs(st, 16)
    _us_check(us_kernel.us_trace(tables, lanes, 3), us_kernel.us_trace_plain(tables, lanes, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("rpp,seed", [(64, 0), (4, 7)])
def test_us_kernel_on_64_prims_is_bit_equal_to_plain_version(rpp, seed):
    """USMain with 62 scatterers, 64 prims: every thread of a lane's group
    sweeps 16 of them, and the group keeps the plain version's hit."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(usmain_scatterers_desc(tpu_rt_torch.ScalarTransform4f))
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8, "cuda")
    assert tables.hdr_list[us_kernel.UH_N_PRIMS] == 64
    _, lanes, _ = _us_pairs(st, rpp)
    _us_check(us_kernel.us_trace(tables, lanes, seed),
              us_kernel.us_trace_plain(tables, lanes, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("scene,rpp,seed", [("usmain", 64, 0), ("usmain", 8, -4),
                                            ("cone_box", 64, 2), ("scatterers", 16, 1)])
def test_us_deposit_mode_matches_deposit_of_records(scene, rpp, seed):
    """The deposit mode's RF against deposit_rf of the records mode's
    records (bit-equal to the plain version's): both add in a
    run-dependent order on the card (atomics, index_add_), so the RF is
    held within 1e-6 of its largest |value|."""
    _need_cuda()
    desc = {"usmain": usmain_desc, "cone_box": cone_box_desc,
            "scatterers": usmain_scatterers_desc}[scene]
    st = tpu_rt_torch.load_dict(desc(tpu_rt_torch.ScalarTransform4f))
    us = st.ultrasound
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8, "cuda")
    rays, lanes, angle_idx = _us_pairs(st, rpp)
    before = (us_kernel.us_trace.launches, us_kernel.us_trace_rf.launches)
    got = us_kernel.us_trace_rf(tables, rays, seed, us.n_angles, us.time_samples, rpp)
    torch.cuda.synchronize()
    assert (us_kernel.us_trace.launches, us_kernel.us_trace_rf.launches) == (
        before[0], before[1] + 1)
    records = us_kernel.us_trace(tables, lanes, seed)
    _us_check(records, us_kernel.us_trace_plain(tables, lanes, seed))
    want = us_kernel.deposit_rf(records, angle_idx, us.n_angles, us.n_elements, us.time_samples)
    assert got.shape == want.shape == (us.n_angles, us.n_elements, us.time_samples)
    scale = want.abs().max().item()
    assert scale > 0 and (got - want).abs().max().item() <= 1e-6 * scale
    assert torch.equal(got != 0, want != 0)


def _das_case(A, E, T, nx, nz, seed):
    rng = np.random.default_rng(seed)
    rf = torch.from_numpy(rng.standard_normal((A, E, T)).astype(np.float32)).cuda()
    angles = np.linspace(-15.0, 15.0, A) if A > 1 else np.array([6.0])
    ex = (np.arange(E) - (E - 1) / 2) * 1.2e-4
    # the z range reaches past the trace's end (10 000 samples at 50 MHz is
    # 0.154 m there and back) and, with t_offset, before its start
    xg = torch.linspace(-0.04, 0.04, nx).cuda()
    zg = torch.linspace(0.001, 0.17, nz).cuda()
    return rf, angles, ex, xg, zg


@pytest.mark.cuda
def test_das_kernel_single_pair_is_bit_equal_to_plain_version():
    """One angle, one element: each pixel is its two taps, the same
    arithmetic in the kernel and the plain version, a one-term sum."""
    _need_cuda()
    rf, angles, ex, xg, zg = _das_case(1, 1, 10000, 301, 257, 7)
    args = (rf, angles, ex, 50e6, 1540.0, xg, zg)
    before = beamform.das_beamform.launches
    got = beamform.das_beamform(*args, t_offset=2e-6)
    torch.cuda.synchronize()
    assert beamform.das_beamform.launches == before + 1
    want = beamform.das_beamform_plain(*args, t_offset=2e-6)
    assert got.shape == (301, 257) and want.abs().max().item() > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_das_kernel_matches_plain_version_at_usmain():
    """USMain's shape, 5 x 64 x 10 000 on the 1040 x 638 grid: the taps
    are the plain version's, the 320 terms are summed in another order, so
    the image is held within 2e-5 of its largest |pixel|."""
    _need_cuda()
    rf, angles, ex, _, _ = _das_case(5, 64, 10000, 1, 1, 11)
    step = 1540.0 / 5e6 / 4.0
    xg, zg = beamform.grid_scan(-0.04, 0.04, 0.001, 0.05, step, step)
    xg, zg = xg.cuda(), zg.cuda()
    # the element positions as columns of a [E, 3] tensor on the card (not
    # contiguous), a curved row: elem_z enters the delays
    pos = torch.stack([torch.from_numpy(ex), torch.zeros(64, dtype=torch.float64),
                       1e-4 * torch.sin(torch.arange(64.0, dtype=torch.float64))], 1)
    pos = pos.float().cuda()
    args = (rf, angles, pos[:, 0], 50e6, 1540.0, xg, zg)
    got = beamform.das_beamform(*args, elem_z=pos[:, 2])
    want = beamform.das_beamform_plain(*args, elem_z=pos[:, 2])
    assert got.shape == (1040, 638)
    scale = want.abs().max().item()
    assert scale > 0 and (got - want).abs().max().item() <= 2e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 64, 10000), (3, 7, 1001)])
def test_das_pack_kernel_equals_plain_version(shape):
    """The packing kernel, USMain's RF and an odd trace length: equal to
    das_pack_plain (torch.cat and stack) bit for bit."""
    _need_cuda()
    rf = torch.from_numpy(np.random.default_rng(3).standard_normal(shape)
                          .astype(np.float32)).cuda()
    before = beamform.das_pack.launches
    got = beamform.das_pack(rf)
    torch.cuda.synchronize()
    assert beamform.das_pack.launches == before + 1
    assert got.shape == shape[:2] + (shape[2] + 3, 2)
    assert torch.equal(got, beamform.das_pack_plain(rf))


def _das_in_order(rf, angles, ex, ez, xg, zg, t_offset, c=1540.0, fs=50e6):
    """The DAS in the first kernel's order of sums, one float32 torch
    operation at a time on the card: the angles outer, each angle's taps
    added element by element, the angles' sums added in order.  Each tap
    is das_beamform_plain's arithmetic."""
    rad = torch.tensor(angles, dtype=torch.float32).cuda() * np.float32(np.pi / 180)
    inv_c, fs = 1.0 / torch.tensor(c, dtype=torch.float32), torch.tensor(fs, dtype=torch.float32)
    X, Z = torch.meshgrid(xg, zg, indexing="ij")
    T = rf.shape[2]
    out = torch.zeros_like(X)
    for a in range(rf.shape[0]):
        t_tx = (X * torch.sin(rad[a]) + Z * torch.cos(rad[a])) * inv_c
        acc = torch.zeros_like(X)
        for e in range(rf.shape[1]):
            t_rx = torch.sqrt((X - ex[e]) ** 2 + (Z - ez[e]) ** 2) * inv_c
            t_f = (t_tx + t_rx - t_offset) * fs
            i0f = torch.floor(t_f)
            w = t_f - i0f
            i0 = i0f.to(torch.int64)
            v0 = torch.where((i0 >= 0) & (i0 < T), rf[a, e][torch.clamp(i0, 0, T - 1)], 0.0)
            v1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < T),
                             rf[a, e][torch.clamp(i0 + 1, 0, T - 1)], 0.0)
            acc = acc + (v0 * (1.0 - w) + v1 * w)
        out = out + acc
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("A,E,nx,nz", [(11, 13, 37, 301), (5, 64, 64, 130), (2, 3, 5, 3)])
def test_das_kernel_keeps_the_first_kernels_order(A, E, nx, nz):
    """The redesigned forward (elements outer, the angles' accumulators in
    registers, kMaxAngles = 8 a pass): A above a pass (11: a pass of 8 and
    a tail of 3), E not a multiple of any unroll, a convex row (elem_z not
    0), grids that are no multiple of the warp's tile, and a t_offset that
    puts the nearest pixels before the trace's start while the farthest
    lie past its end.  Bit-equal to the first kernel's order of sums
    (_das_in_order), and within 2e-5 of the plain version's largest
    |pixel|."""
    _need_cuda()
    rf, angles, ex, xg, zg = _das_case(A, E, 3000, nx, nz, 13)
    ez = 2e-4 * np.cos(np.arange(E))
    t_offset = 3e-6
    want = _das_in_order(rf, angles, torch.tensor(ex, dtype=torch.float32).tolist(),
                         torch.tensor(ez, dtype=torch.float32).tolist(), xg, zg, t_offset)
    args = (rf, angles, ex, 50e6, 1540.0, xg, zg)
    before = (beamform.das_beamform.launches, beamform.das_pack.launches)
    got = beamform.das_beamform(*args, t_offset=t_offset, elem_z=ez)
    torch.cuda.synchronize()
    assert (beamform.das_beamform.launches, beamform.das_pack.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    tf = ((zg.max() * 2 / 1540.0 - t_offset) * 50e6).item()
    assert tf > 3000 and (0.001 * 2 / 1540.0 - t_offset) < 0
    assert got.shape == (nx, nz) and want.abs().max().item() > 0
    assert torch.equal(got, want)
    plain = beamform.das_beamform_plain(*args, t_offset=t_offset, elem_z=ez)
    assert (got - plain).abs().max().item() <= 2e-5 * plain.abs().max().item()


def _fine_grid(nx, nz, z0=0.001, z1=0.05):
    """A lambda / 4 grid of USMain's 5 MHz (the step its frame takes), nx
    columns about x = 0 and nz rows from z0 to z1 (as close as the step
    falls)."""
    step = 1540.0 / 5e6 / 4.0
    xg = (torch.arange(nx, dtype=torch.float32) - (nx - 1) / 2) * step
    zg = torch.linspace(z0, z1, nz)
    return xg.cuda(), zg.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("A,E,T,nx,nz,split", [(5, 16, 3000, 40, 640, False),
                                                (1, 7, 3000, 37, 301, False),
                                                (75, 4, 3000, 24, 640, False),
                                                (9, 5, 3000, 40, 33, True)],
                         ids=["clipped", "one-angle-ragged", "75-angles", "coarse-split"])
def test_das_kernel_stages_its_windows_in_the_first_kernels_order(A, E, T, nx, nz, split):
    """The forward's taps from the windows staged in shared memory, on
    every shape the planner meets: delays before the trace's start and
    past its end (the windows clipped at 0 and at T), one angle, 75 angles
    (9 passes of 8 and a tail of 3, a ring of fewer
    slots), grids that are no
    multiple of the tile (37, 301, 33), a convex row (elem_z not 0), and a
    coarse grid whose windows exceed a slot (the split mode, which
    das_beamform.split_launches counts).  Bit-equal to the first kernel's
    order of sums (_das_in_order) on each."""
    _need_cuda()
    rf, angles, ex, xg, zg = _das_case(A, E, T, nx, nz, 17)
    if not split:
        xg, zg = _fine_grid(nx, nz)
    ez = 2e-4 * np.cos(np.arange(E))
    t_offset = 3e-6
    t_f = (zg * 2 / 1540.0 - t_offset) * 50e6  # on axis, the delays' reach
    assert t_f.min().item() < 0 and t_f.max().item() > T
    plan = beamform.das_plan(A, T, xg, zg, 50e6, 1.0 / torch.tensor(1540.0))
    assert plan.split == split
    want = _das_in_order(rf, angles, torch.tensor(ex, dtype=torch.float32).tolist(),
                         torch.tensor(ez, dtype=torch.float32).tolist(), xg, zg, t_offset)
    before = (beamform.das_beamform.launches, beamform.das_beamform.split_launches)
    got = beamform.das_beamform(rf, angles, ex, 50e6, 1540.0, xg, zg, t_offset=t_offset,
                                elem_z=ez)
    torch.cuda.synchronize()
    assert (beamform.das_beamform.launches,
            beamform.das_beamform.split_launches) == (before[0] + 1, before[1] + split)
    assert got.shape == (nx, nz) and want.abs().max().item() > 0
    assert torch.equal(got, want)


def _adjoint_args(A, E, T, nx, nz, seed):
    rf, angles, ex, xg, zg = _das_case(A, E, T, nx, nz, seed)
    rad = torch.tensor(angles, dtype=torch.float32).cuda() * np.float32(np.pi / 180)
    ex = torch.tensor(ex, dtype=torch.float32).cuda()
    ez = 1e-4 * torch.sin(torch.arange(E, dtype=torch.float32, device="cuda"))
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((nx, nz))
                         .astype(np.float32)).cuda()
    return (rf, ex, ez, torch.sin(rad), torch.cos(rad), 1.0 / torch.tensor(1540.0),
            torch.tensor(50e6), xg, zg, g)


def _geometry_float64_same_taps(rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, zg, g, t_offset):
    """The geometric cotangents (d elem_x, d elem_z, d sin, d cos,
    d (1 / c), d fs) in float64 at the taps that the float32 arithmetic
    picks: each float32 delay (das_beamform_plain's operations) fixes the
    floor and so v0 and v1; d out / d t_f = v1 - v0 and the delay's
    derivatives are then taken in float64 from the same inputs.  What
    float64 autograd of the plain form would give if no delay rounded
    across a sample."""
    A, E, T = rf.shape
    X, Z = torch.meshgrid(xg, zg, indexing="ij")
    X64, Z64, g64 = X.double(), Z.double(), g.double()
    ic, f = float(inv_c), float(fs)
    d_ex, d_ez = torch.zeros(E, dtype=torch.float64), torch.zeros(E, dtype=torch.float64)
    d_sin, d_cos = torch.zeros(A, dtype=torch.float64), torch.zeros(A, dtype=torch.float64)
    d_ic = d_fs = 0.0
    for a in range(A):
        t_tx = (X * sin_a[a] + Z * cos_a[a]) * inv_c.cuda()
        txn = X64 * sin_a[a].double() + Z64 * cos_a[a].double()
        for e in range(E):
            t_rx = torch.sqrt((X - ex[e]) ** 2 + (Z - ez[e]) ** 2) * inv_c.cuda()
            i0 = torch.floor((t_tx + t_rx - t_offset) * fs.cuda()).to(torch.int64)
            row = rf[a, e].double()
            v0 = torch.where((i0 >= 0) & (i0 < T), row[torch.clamp(i0, 0, T - 1)], 0.0)
            v1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < T), row[torch.clamp(i0 + 1, 0, T - 1)],
                             0.0)
            dtf = g64 * (v1 - v0)
            dx, dz = X64 - ex[e].double(), Z64 - ez[e].double()
            r = torch.sqrt(dx * dx + dz * dz)
            d_fs += (dtf * ((txn + r) * ic - t_offset)).sum().item()
            G = dtf * f
            d_ic += (G * (txn + r)).sum().item()
            d_sin[a] += (G * X64 * ic).sum().item()
            d_cos[a] += (G * Z64 * ic).sum().item()
            q = torch.where(r > 0, G * ic / r, 0.0)
            d_ex[e] -= (q * dx).sum().item()
            d_ez[e] -= (q * dz).sum().item()
    return d_ex, d_ez, d_sin, d_cos, torch.tensor(d_ic), torch.tensor(d_fs)


@pytest.mark.cuda
@pytest.mark.parametrize("A,E,T,nx,nz", [(1, 1, 10000, 301, 257), (3, 12, 4000, 121, 97),
                                         (11, 5, 3000, 90, 140)])
def test_das_adjoint_kernel_matches_plain_version(A, E, T, nx, nz):
    """The adjoint kernel against autograd of the gather form on the card:
    d RF within 1e-5 of its largest (sums of the taps' weights in another
    order, by atomics), the geometric cotangents within 1e-3 of their
    largest against autograd of the same float32 arithmetic, and within
    1e-3 of their largest against float64 at the same taps
    (_geometry_float64_same_taps: float64 autograd of the whole form moves
    taps whose delay rounds across a sample, which puts the float32 plain
    version itself far from it on these cases), and <DAS x, y> =
    <x, DAS^T y> within 1e-5 of sum |DAS x y|."""
    _need_cuda()
    args = _adjoint_args(A, E, T, nx, nz, 5)
    before = beamform.das_adjoint.launches
    got = beamform.das_adjoint(*args, t_offset=2e-6)
    torch.cuda.synchronize()
    assert beamform.das_adjoint.launches == before + 1
    want = beamform.das_adjoint_plain(*args, t_offset=2e-6)
    scale = want[0].abs().max().item()
    assert scale > 0 and (got[0] - want[0]).abs().max().item() <= 1e-5 * scale
    ref = _geometry_float64_same_taps(*args, 2e-6)
    for k, w, r in zip(got[1:], want[1:], ref):
        assert (k.cpu() - w.cpu()).abs().max().item() <= 1e-3 * w.abs().max().item()
        assert (k.double().cpu() - r).abs().max().item() <= 1e-3 * r.abs().max().item()
    rf, g = args[0], args[-1]
    out = beamform._das_launch(*args[:9], 2e-6)
    lhs = out.double() * g.double()
    diff = lhs.sum().item() - (rf.double() * got[0].double()).sum().item()
    assert abs(diff) <= 1e-5 * lhs.abs().sum().item()
    rf_only = beamform.das_adjoint(*args, t_offset=2e-6, geometry=False)
    assert rf_only[1] is None and (rf_only[0] - got[0]).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [False, True], ids=["rf_only", "geometry"])
def test_das_adjoint_split_mode_on_a_long_trace(geometry):
    """T = 70 000 and a grid reaching 1.2 m: each pixel tile's windows of
    samples (its taps, a trace an angle) span far more than one block's
    shared window of 8 192 floats, so the adjoint kernel takes its split
    mode (several passes over the tile); tiles clip at 0 (t_offset puts
    the nearest pixels before the trace) and at T (the farthest lie past
    it), and neither grid size is a multiple of the tile.  Held as above:
    d RF within 1e-5 of its largest against autograd of the plain form,
    the geometric cotangents within 1e-3 against the same autograd, the
    adjoint identity within 1e-5; each output of its shape on its input's
    device (d (1 / c) and d fs on the CPU, where 1 / c and fs are)."""
    _need_cuda()
    A, E, T, nx, nz = 3, 5, 70000, 150, 300
    rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, _, g = _adjoint_args(A, E, T, nx, nz, 21)
    zg = torch.linspace(0.001, 1.2, nz).cuda()
    args = (rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, zg, g)
    t_f = (2 * zg / 1540.0 - 2e-6) * 50e6  # on axis, the delays' reach
    tile_span = (t_f[127] - t_f[0]).item()  # one 128-pixel tile along z, an angle
    assert t_f[0].item() < 0 and t_f[-1].item() > T and A * tile_span > 4 * 8192
    before = beamform.das_adjoint.launches
    got = beamform.das_adjoint(*args, t_offset=2e-6, geometry=geometry)
    torch.cuda.synchronize()
    assert beamform.das_adjoint.launches == before + 1
    assert len(got) == 7 and got[0].shape == rf.shape and got[0].device == rf.device
    want = beamform.das_adjoint_plain(*args, t_offset=2e-6, geometry=geometry)
    scale = want[0].abs().max().item()
    assert scale > 0 and (got[0] - want[0]).abs().max().item() <= 1e-5 * scale
    # taps land near both ends of the traces: the clipped windows keep them
    assert got[0][..., :500].abs().sum().item() > 0 and got[0][..., -500:].abs().sum().item() > 0
    if geometry:
        for k, w, x in zip(got[1:], want[1:], args[1:7]):
            assert k.shape == x.shape and k.device == x.device
            assert (k.cpu() - w.cpu()).abs().max().item() <= 1e-3 * w.abs().max().item()
    else:
        assert all(k is None for k in got[1:])
    out = beamform._das_launch(*args[:9], 2e-6)
    lhs = out.double() * g.double()
    diff = lhs.sum().item() - (rf.double() * got[0].double()).sum().item()
    assert abs(diff) <= 1e-5 * lhs.abs().sum().item()


@pytest.mark.cuda
def test_das_backward_on_cuda_launches_the_adjoint_kernel(monkeypatch):
    """das_beamform's backward on CUDA tensors is the adjoint kernel, never
    the plain version; its gradients in the angles and c are the kernel's
    cotangents chained through sin, cos and 1 / c."""
    _need_cuda()

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    rf, angles, ex, xg, zg = _das_case(3, 8, 3000, 64, 80, 9)
    monkeypatch.setattr(beamform, "das_adjoint_plain", refuse)
    monkeypatch.setattr(beamform, "das_beamform_plain", refuse)
    leaves = [x.requires_grad_() for x in (rf.clone(), torch.tensor(angles, dtype=torch.float32)
                                           .cuda(), torch.tensor(ex, dtype=torch.float32).cuda(),
                                           torch.tensor(1540.0))]
    before = beamform.das_adjoint.launches
    out = beamform.das_beamform(leaves[0], leaves[1], leaves[2], 50e6, leaves[3], xg, zg)
    (out * out).sum().backward()
    torch.cuda.synchronize()
    assert beamform.das_adjoint.launches == before + 1
    for x in leaves:
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        assert x.grad.abs().sum().item() > 0


@pytest.mark.cuda
def test_us_render_backpropagates_on_cuda():
    """The kernel route under autograd on the card: K10's primal, the DAS
    kernel and its adjoint, the wavefront's replay; the plate's impedance
    and roughness get a finite, non-zero gradient."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(plate_desc(tpu_rt_torch.ScalarTransform4f))
    p = st.bsdf_params.clone().requires_grad_()
    n = {k: f.launches for k, f in (("acq", us_kernel.us_trace_rf),
                                    ("das", beamform.das_beamform),
                                    ("adj", beamform.das_adjoint))}
    img, ch, _ = us_render(st.replace(bsdf_params=p), rays_per_pair=4, device="cuda",
                           x_bounds=(-0.004, 0.004), z_bounds=(0.008, 0.012))
    (img * img).mean().backward()
    torch.cuda.synchronize()
    assert us_kernel.us_trace_rf.launches == n["acq"] + 1
    assert beamform.das_beamform.launches == n["das"] + 1
    assert beamform.das_adjoint.launches == n["adj"] + 1
    assert bool(torch.isfinite(p.grad).all()) and p.grad[0, :2].abs().min().item() > 0


# (scene, seed, rays per pair, rtol): tests/test_torch_us_grad.py's cases
# and tolerances
WAVE_GRAD = {"plate": (lambda st: plate_desc(st), 0, 2, 1e-3),
             "usmain_narrow": (lambda st: dict(usmain_desc(st), integrator=dict(
                 usmain_desc(st)["integrator"], angles=np.linspace(-15, 15, 3))), 4, 1, 2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WAVE_GRAD))
def test_us_wavefront_gradient_on_cuda_matches_the_cpu(case):
    """d sum(ch^2) of the acoustic wavefront with respect to the BSDF table
    (impedance, roughness, exterior impedance) and the ultrasound keys, on
    the card against the CPU, fed the same uniforms: each component within
    tests/test_torch_us_grad.py's tolerance against jax.grad, 1e-3
    relative on the plate and 2e-2 on USMain at 3 angles (an ulp of a
    time index moves an echo's share between its taps; the sampling
    rate's and sound speed's gradients reach each echo through two taps
    of opposite sign)."""
    _need_cuda()
    desc, seed, rpp, rtol = WAVE_GRAD[case]
    st = tpu_rt_torch.load_dict(desc(tpu_rt_torch.ScalarTransform4f))
    us = st.ultrasound
    keys = ("pitch", "sound_speed", "attenuation", "frequency", "sampling_rate")
    u = _us_uniforms(us, rpp, seed)
    n = us.n_angles * us.n_elements * rpp
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    u["jitter"] = torch.rand((n, 2), generator=gen)
    grads = {}
    for device in ("cpu", "cuda"):
        leaves = {k: getattr(us, k).clone().requires_grad_() for k in keys}
        leaves["bsdf"] = st.bsdf_params.clone().requires_grad_()
        sc = st.replace(bsdf_params=leaves["bsdf"],
                        ultrasound=us.replace(**{k: leaves[k] for k in keys}))
        ch, _ = us_wavefront.simulate_acquisition(sc, seed=seed, rays_per_pair=rpp,
                                                  device=device, uniforms=u)
        assert ch.device.type == device
        (ch * ch).sum().backward()
        grads[device] = {k: v.grad.detach().cpu() for k, v in leaves.items()}
    want, got = grads["cpu"]["bsdf"][:, :3], grads["cuda"]["bsdf"][:, :3]
    assert want[0, :2].abs().min() > 0, "impedance and roughness get no gradient"
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)
    for k in keys:
        w, g = float(grads["cpu"][k]), float(grads["cuda"][k])
        assert w != 0.0 and abs(g - w) <= rtol * abs(w), (k, g, w)


def _us_uniforms(us, rays_per_pair, seed):
    n = us.n_angles * us.n_elements * rays_per_pair
    gen = torch.Generator()
    gen.manual_seed(seed)
    return {"recv": torch.randint(0, us.n_elements, (us.max_depth, n), generator=gen),
            "u": torch.rand((us.max_depth, n, 4), generator=gen)}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["usmain", "phantom_1000"])
def test_us_wavefront_on_cuda_matches_the_cpu(which):
    """The acoustic wavefront on the card and on the CPU, fed the same
    uniforms (2 rays a pair, 10 bounces): sin, exp, acos and the
    intersectors round otherwise on the card, so total |RF| within 1e-3,
    at least 99% of the non-zero samples within 1e-3 of the largest |RF|
    (an ulp of a time index below 16 384 samples moves 2^-10 of an echo
    between its taps; a lane that takes the other branch on an ulp, a
    shadow ray grazing a sphere, moves its echoes), the rays cast within
    1%."""
    _need_cuda()
    st_ = tpu_rt_torch.ScalarTransform4f
    st = tpu_rt_torch.load_dict(usmain_desc(st_) if which == "usmain" else
                                usmain_scatterers_desc(st_, n=1000, r_min=1e-4, r_max=3e-4))
    u = _us_uniforms(st.ultrasound, 2, 5)
    ch_c, tx_c = us_wavefront.simulate_acquisition(st, rays_per_pair=2, device="cpu", uniforms=u)
    n_c = int(us_wavefront.simulate_acquisition.last_ray_count)
    ch_g, tx_g = us_wavefront.simulate_acquisition(st, rays_per_pair=2, device="cuda",
                                                   uniforms=u)
    n_g = us_wavefront.simulate_acquisition.last_ray_count
    assert ch_g.device.type == n_g.device.type == "cuda"
    ch_g = ch_g.cpu().double()
    ch_c = ch_c.double()
    torch.testing.assert_close(tx_g.cpu(), tx_c, rtol=0, atol=1e-12)
    total = ch_c.abs().sum().item()
    assert total > 0 and abs(ch_g.abs().sum().item() - total) <= 1e-3 * total
    nz = (ch_c != 0) | (ch_g != 0)
    big = ch_c.abs().max().item()
    assert ((ch_g - ch_c)[nz].abs() <= 1e-3 * big).double().mean().item() >= 0.99
    assert abs(int(n_g) - n_c) <= 0.01 * n_c


@pytest.mark.cuda
def test_us_mesh_phantom_on_cuda_goes_through_the_mesh_kernel():
    """The 2 240-triangle knot under an ultrasound_bsdf is outside the
    acquisition kernel's scope: us_render takes the wavefront, whose two
    queries a bounce (closest hit, shadow) launch the mesh-intersect
    kernel, and the DAS kernel beamforms; the first bounce wave's hits
    are bit-equal to the kernel's plain version."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(usmain_mesh_desc(tpu_rt_torch.ScalarTransform4f, ply="knot.ply"))
    assert us_kernel.bake_us_scene(st) is None and st.geometry.cl_trisw is not None
    before = (_launches(), mesh_kernel.mesh_intersect.launches)
    img, ch, tx = us_render(st, seed=1, rays_per_pair=2, x_bounds=(-0.01, 0.01),
                            z_bounds=(0.018, 0.03), device="cuda")
    torch.cuda.synchronize()
    assert _launches() == (before[0][0], before[0][1], before[0][2] + 1)
    assert mesh_kernel.mesh_intersect.launches == before[1] + 2 * st.ultrasound.max_depth
    assert bool(torch.isfinite(img).all()) and ch.abs().sum().item() > 0
    assert 0.0 <= img.min().item() and img.max().item() <= 1.0 + 1e-6

    base = plane_wave_rays(st.ultrasound)
    o = base["o"].repeat_interleave(2, 0).cuda().contiguous()
    d = base["d"].repeat_interleave(2, 0).cuda().contiguous()
    cl = trace.mesh_clusters(st.geometry.to("cuda"))
    tm = torch.full((o.shape[0],), 0.99 * 1e8, device="cuda")
    got = mesh_kernel.mesh_intersect(cl, o, d, tmax=tm)
    t, lid, u, v = mesh_kernel.mesh_intersect_plain(cl["bounds"], cl["trisw"], o, d, tm)
    prim = torch.where(lid >= 0, cl["prim"][lid.clamp(min=0).long()], -1).to(torch.int32)
    for a, b, name in zip(got, (t, prim, u, v), ("t", "prim", "u", "v")):
        assert torch.equal(a, b), name
    assert (got[1] >= 0).float().mean().item() > 0.05


@pytest.mark.cuda
def test_trace_routes_agree_on_cuda():
    """One wave of the 1 000-sphere phantom (1 002 prims) on the card:
    brute force, chunks and the BVH compute a sphere's t with the same
    operations, so the prims and t are equal (an exact tie could part
    them; none on this wave); the BVH's CUDA graph equals its steps one at
    a time."""
    _need_cuda()
    st = tpu_rt_torch.load_dict(usmain_scatterers_desc(tpu_rt_torch.ScalarTransform4f, n=1000,
                                                       r_min=1e-4, r_max=3e-4))
    g = st.geometry.to("cuda")
    base = plane_wave_rays(st.ultrasound)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    o = base["o"].repeat_interleave(8, 0).cuda()
    d = base["d"].repeat_interleave(8, 0).cuda()
    d = torch.nn.functional.normalize(d + 0.05 * torch.randn(d.shape, generator=gen,
                                                             device="cuda"), dim=-1)
    tmax = torch.where(torch.rand(o.shape[0], generator=gen, device="cuda") < 0.3, 0.02, 1e8)
    hits = [r(g, o, d, trace.RAY_EPS, tmax) for r in
            (trace._trace_bruteforce, trace._trace_chunked, trace._trace_bvh)]
    hb = hits[0]
    assert 0.2 < (hb.prim >= 0).float().mean().item() < 1.0
    for h in hits[1:]:
        assert torch.equal(h.prim, hb.prim)
        assert torch.equal(h.t, hb.t)
    # the BVH walk replays its steps as a CUDA graph: the same bits as the
    # steps one at a time, also on a second wave through the kept graph
    for dd in (d, -d):
        graphed = trace._trace_bvh(g, o, dd, trace.RAY_EPS, tmax)
        eager = trace._trace_bvh(g, o, dd, trace.RAY_EPS, tmax, graph=False)
        for f in ("t", "prim", "u", "v"):
            assert torch.equal(getattr(graphed, f), getattr(eager, f)), f


TEXTURED = os.path.join(os.path.dirname(__file__), "assets", "textured")
SHADOW_ART = os.path.join(os.path.dirname(__file__), "assets", "shadow_art", "shadow_art.xml")


@pytest.mark.cuda
def test_textured_path_trace_on_cuda_matches_the_cpu():
    """textured_small.xml (the 2 240-triangle knot under the checker PNG,
    the floor under the baseline JPEG) at 32x32, depth 3, the same rays and
    uniforms on the card and on the CPU: at least 99% of the lanes within
    rtol 1e-4 / atol 1e-6, the image mean within 1e-4 relative, the rays
    cast within 1%; five K7 launches a trace (closest hits and shadow
    rays)."""
    _need_cuda()
    st = tpu_rt_torch.load_file(os.path.join(TEXTURED, "textured_small.xml"), res=32, spp=1)
    assert st.has_textures and path_kernel.bake_scene(st) is None
    gen = torch.Generator()
    gen.manual_seed(4)
    ys, xs = torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32) + torch.rand(
        (1024, 2), generator=gen)
    o, d, t0, t1 = camera.sample_ray_extents(st.camera, xy)
    u = torch.rand((wavefront.n_bounces(st), 1024, 8), generator=gen)
    Lc, nc = wavefront.path_trace(st, o, d, uniforms=u, tmin0=t0, tmax0=t1)
    before = mesh_kernel.mesh_intersect.launches
    Lg, ng = wavefront.path_trace(st.to("cuda"), o.cuda(), d.cuda(), uniforms=u.cuda(),
                                  tmin0=t0.cuda(), tmax0=t1.cuda())
    torch.cuda.synchronize()
    assert mesh_kernel.mesh_intersect.launches == before + 2 * wavefront.n_bounces(st) - 1
    Lg = Lg.cpu()
    close = torch.isclose(Lg, Lc, rtol=1e-4, atol=1e-6).all(-1).float().mean().item()
    assert close >= 0.99, close
    assert abs(Lg.mean().item() - Lc.mean().item()) <= 1e-4 * Lc.mean().item()
    assert abs(int(ng) - int(nc)) <= 0.01 * int(nc)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["textured", "shadow_art_mesh"])
def test_mesh_kernel_on_a_recorded_wave_is_bit_equal(which):
    """K7 on the primaries and on the light samples' shadow rays of the
    textured knot and of shadow_art's tube mesh (curve_mode="mesh"), each
    bit-equal (t, prim, u, v) to its plain version on the card."""
    _need_cuda()
    from tpu_rt_torch.emitter import sample as emitter

    if which == "textured":
        st = tpu_rt_torch.load_file(os.path.join(TEXTURED, "textured_small.xml"), res=64)
    else:
        st = tpu_rt_torch.load_file(SHADOW_ART, curve_mode="mesh", resx=64, resy=32)
    sc = st.to("cuda")
    c = sc.camera
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    ys, xs = torch.meshgrid(torch.arange(c.height, device="cuda"),
                            torch.arange(c.width, device="cuda"), indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    o, d = camera.sample_ray(c, xy + torch.rand(xy.shape, generator=gen, device="cuda"))
    o, d = o.contiguous(), d.contiguous()
    si = trace.ray_intersect(sc, o, d)
    u = torch.rand((o.shape[0], 4), generator=gen, device="cuda")
    ds = emitter.sample_direct(sc, si.p, u[:, 0], u[:, 1:4], si.valid)
    so = si.spawn_origin(ds.d).contiguous()
    cl = trace.mesh_clusters(sc.geometry)
    for oo, dd, tm in ((o, d, torch.full((o.shape[0],), 0.99 * 1e8, device="cuda")),
                       (so, ds.d.contiguous(), torch.where(si.valid, ds.dist * (1 - 1e-3), 0.0))):
        got = mesh_kernel.mesh_intersect(cl, oo, dd, tmax=tm.contiguous())
        t, lid, uu, vv = mesh_kernel.mesh_intersect_plain(cl["bounds"], cl["trisw"], oo, dd, tm)
        prim = torch.where(lid >= 0, cl["prim"][lid.clamp(min=0).long()], -1).to(torch.int32)
        for a, b, name in zip(got, (t, prim, uu, vv), ("t", "prim", "u", "v")):
            assert torch.equal(a, b), name
    assert (si.prim >= 0).float().mean().item() > 0.1


@pytest.mark.cuda
def test_render_soft_gradient_on_cuda_matches_the_cpu():
    """render_soft on shadow_art.xml at 64x32, 2 spp, width 0.01, the same
    draws on the card and on the CPU: the shadow-band loss within 1e-5,
    its derivative for a translation of the wire within 1e-3, and the
    node sums of the gradients with respect to the spans' ends and radii
    within 1e-3 of their largest."""
    _need_cuda()
    from torch_port_scenes import shadow_art_band, soft_band_grads

    st = tpu_rt_torch.load_file(SHADOW_ART, resx=64, resy=32)
    gen = torch.Generator()
    gen.manual_seed(6)
    hw = 64 * 32
    draws = (torch.rand((2, hw, 2), generator=gen),
             torch.rand((2, wavefront.n_bounces(st, 2), hw, 8), generator=gen))
    lc, tc, abc, rc = soft_band_grads(st, draws, 0.01, "cpu", band=shadow_art_band)
    lg, tg, abg, rg = soft_band_grads(st, draws, 0.01, "cuda", band=shadow_art_band)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert tc != 0.0 and abs(tg - tc) <= 1e-3 * abs(tc)
    for g, c in ((abg, abc), (rg, rc)):
        assert (g - c).abs().max().item() <= 1e-3 * c.abs().max().item()


@pytest.mark.cuda
def test_sharded_film_kernel_in_a_world_of_one_under_nccl(tmp_path):
    """render_pallas_sharded in a world of 1 under NCCL: its K1 planes (one
    film_trace of all the samples at int32(seed) * 100003, deposited)
    and its image equal one process's render_film(spp_per_pass=spp), bit
    for bit."""
    _need_cuda()
    import torch.distributed as dist

    from tpu_rt_torch.parallel import render as pr

    st = tpu_rt_torch.load_file(CBOX, res=64, spp=8)
    dist.init_process_group("nccl", init_method=(tmp_path / "rendezvous").as_uri(),
                            world_size=1, rank=0)
    try:
        img = pr.render_pallas_sharded(st, spp=8, seed=4, device="cuda")
        tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 16, "cuda")
        film, rays = path_kernel.film_chunks(tables, path_kernel.film_trace,
                                             [(pr.film_seed(4, 0), 8)])
        assert torch.equal(pr.psum(film), film)
        assert int(pr.render_pallas_sharded.last_ray_count) == int(rays)
    finally:
        dist.destroy_process_group()
    want, n_rays = path_kernel.render_film(st, spp=8, seed=4, device="cuda", spp_per_pass=8)
    assert torch.equal(img, want) and int(n_rays) == int(rays)

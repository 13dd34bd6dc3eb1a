"""The port's data parallelism (``tpu_rt_torch/parallel/``) against
tpu_rt's sharded functions, on the CPU.

The port runs in spawned worlds of 1, 2 and 4 ranks under gloo
(``parallel/dryrun.py::run_world``), each started once for the module,
in the background while tpu_rt computes, each with its own time limit so
that a hung rank fails its tests instead of holding the suite.  Every rank
runs ``dryrun_steps`` with rank 0's single-process references.  tpu_rt
runs on meshes of the same size over the 8 virtual CPU devices of
tests/conftest.py, its Pallas kernels in interpret mode (tile_rows 8, as
the port's ``tile_rows=8`` keys its RNG).

Tolerances, and why:

* ``splat``: rtol 1e-6 / atol 1e-6 against tpu_rt's (scatter-adds in
  another order);
* the collectives: the gradient of 1/2 (sum w x)^2, x = 0..7 split over
  the ranks, is 784 exactly on every rank (JAX's shard_map gives the same);
* a world of 1: bit-equal to the single-process functions (an all-reduce
  over one rank is the identity, a division by 1 exact);
* a world of n: each route within 1e-5 of its largest value of the sum
  (the mean, for the RF) of the ranks' single-process runs at their seeds
  (the all-reduce adds in another order); the DAS bit-equal (each pixel's
  sum runs as in one process);
* against tpu_rt: K1 and the Stokes routes as tests/test_torch_render.py:
  99% of entries within rtol 1e-3 / atol 1e-5, the image mean within 1e-3
  relative (XLA contracts multiply-adds, torch rounds each); K10 at
  tpu_rt's rtol 1e-5 / atol 1e-8 where the plain version meets it, else
  at tests/test_torch_us_kernel.py's bar for deposited RF (total |RF|
  within 1e-3 relative, per-pair energy correlation >= 0.999; stated in
  the test); the DAS at tests/test_torch_us_das.py's rtol 1e-5 / atol
  1e-4 of the largest |pixel| (the two packages' single-process forms
  differ by an ulp of a delay; tpu_rt's rtol 1e-6 / atol 1e-7 between its
  sharded and single-chip DAS is met here bit for bit);
* the wavefront and K9 draw their own random streams: the image means
  and 8x8 block means within 5 standard deviations of a difference of
  two renders, estimated from the port's renders at other seeds;
* the acquisition's gradient through the sharded wavefront fed tpu_rt's
  draws: tests/test_torch_us_grad.py's rtol 1e-3 for the plate.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from test_torch_us_wavefront import tpu_rt_draws
from tpu_rt.ops.pallas_mesh import mesh_direct_render_sharded as k9_sharded_j
from tpu_rt.parallel import render as render_j
from tpu_rt.parallel import ultrasound as us_j
from tpu_rt.sensor import film as film_j
from tpu_rt_torch.parallel import dryrun
from tpu_rt_torch.parallel import render as render_t
from tpu_rt_torch.parallel import ultrasound as us_t
from tpu_rt_torch.scene.types import FILTER_BOX, FILTER_GAUSSIAN, FILTER_TENT
from tpu_rt_torch.sensor import film as film_t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "tests", "assets", "cbox", "cbox.xml")
CBOX_POL = os.path.join(ROOT, "tests", "assets", "cbox_pol", "cbox_pol.xml")
SIMPLE = os.path.join(ROOT, "tests", "assets", "mesh", "simple.xml")
WORLDS = (1, 2, 4)
# seconds a world may take (each takes 10-40 s here)
WORLD_TIMEOUT = {1: 300, 2: 300, 4: 400}
SEED, US_SEED, RPP = 0, 5, 8
K1 = dict(path=CBOX, res=16, spp=4, depth=2)
POL = dict(path=CBOX_POL, res=16, spp=4, depth=2, filters=(FILTER_BOX, FILTER_GAUSSIAN))
K9 = dict(path=SIMPLE, res=32, spp=4)
WAVE = dict(path=CBOX, res=32, spp=16, depth=3)


def das_case():
    """tests/test_parallel_and_grad.py:369-394's inputs: Nx = 13 takes the
    pad path on 2 and 4 ranks."""
    rng = np.random.default_rng(3)
    return dict(rf=rng.standard_normal((3, 5, 128)).astype(np.float32),
                angles=np.asarray([-10.0, 0.0, 10.0], np.float32),
                elem_x=np.linspace(-2e-3, 2e-3, 5, dtype=np.float32),
                x_grid=np.linspace(-3e-3, 3e-3, 13, dtype=np.float32),
                z_grid=np.linspace(0.2e-3, 3e-3, 9, dtype=np.float32), fs=50e6, c=1540.0)


def us_scene_j():
    """tests/test_parallel_and_grad.py:326-343's plate, which is tpu_rt's
    dry-run plate (``dryrun.plate_desc``)."""
    return tpu_rt.load_dict(dryrun.plate_desc(tpu_rt.ScalarTransform4f))


def world_cfg(n):
    sj = us_scene_j()
    rpp_local = -(-RPP // n)
    uniforms = [{k: v.numpy() for k, v in tpu_rt_draws(US_SEED + r * 7919, sj.ultrasound,
                                                       rpp_local).items()} for r in range(n)]
    return dict(
        seed=SEED, tile_rows=8, k1=K1, stokes=POL, k9=K9,
        acq_wave=dict(desc=None, rpp=RPP), acq_kernel=dict(desc=None, rpp=RPP),
        das=dict(inputs=das_case(), methods=("gather", "matmul")),
        wave=WAVE if n == 2 else None,
        acq_grad=dict(desc=dryrun.plate_desc(tpu_rt_torch.ScalarTransform4f), seed=US_SEED,
                      rpp=RPP, uniforms=uniforms) if n > 1 else None)


@pytest.fixture(scope="module")
def worlds():
    """The three worlds, started at once in the background; a test waits
    for the one it reads."""
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    futs = {n: pool.submit(dryrun.run_world, dryrun.dryrun_steps, n, (world_cfg(n),), "gloo",
                           "cpu", WORLD_TIMEOUT[n]) for n in WORLDS}
    yield lambda n: futs[n].result(timeout=WORLD_TIMEOUT[n] + 60)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def meshes():
    return {n: render_j.default_mesh(jax.devices()[:n]) for n in WORLDS}


def _scene_j(path, res, depth=None, filter_type=None):
    sc = tpu_rt.load_file(path, res=res, spp=1)
    if depth is not None:
        sc = sc.replace(max_depth=depth)
    if filter_type is not None:
        sc = sc.replace(camera=sc.camera.replace(filter_type=filter_type))
    return sc


def _agree(got, want, what):
    """tests/test_torch_render.py's bar: 99% of pixels within rtol 1e-3 /
    atol 1e-5, the mean within 1e-3 relative."""
    assert got.shape == want.shape, what
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5)
    close = close.reshape(close.shape[0], close.shape[1], -1).all(-1)
    assert close.mean() >= 0.99, f"{what}: only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean()), what


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filter_type", [FILTER_BOX, FILTER_TENT, FILTER_GAUSSIAN])
def test_splat_matches_tpu_rt(filter_type):
    """Random positions over and off a 9 x 7 film (a margin of 3 pixels),
    some samples inactive; the films and the gradient in the values of a
    weighted sum of the films."""
    rng = np.random.default_rng(filter_type)
    H, W, N, C = 7, 9, 500, 3
    xy = np.stack([rng.uniform(-3, W + 3, N), rng.uniform(-3, H + 3, N)], -1).astype(np.float32)
    vals = rng.normal(size=(N, C)).astype(np.float32)
    active = rng.uniform(size=N) < 0.8
    fv0 = rng.normal(size=(H, W, C)).astype(np.float32)
    fw0 = rng.uniform(size=(H, W)).astype(np.float32)
    wv = rng.normal(size=(H, W, C)).astype(np.float32)
    ww = rng.normal(size=(H, W)).astype(np.float32)

    def loss_j(v):
        fv, fw = film_j.splat(jnp.asarray(fv0), jnp.asarray(fw0), jnp.asarray(xy), v,
                              jnp.asarray(active), filter_type)
        return (fv * wv).sum() + (fw * ww).sum(), (fv, fw)

    (_, (fv_j, fw_j)), g_j = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    fv, fw = film_t.splat(torch.from_numpy(fv0), torch.from_numpy(fw0), torch.from_numpy(xy),
                          v, torch.from_numpy(active), filter_type)
    ((fv * torch.from_numpy(wv)).sum() + (fw * torch.from_numpy(ww)).sum()).backward()
    np.testing.assert_allclose(fv.detach().numpy(), np.asarray(fv_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fw.detach().numpy(), np.asarray(fw_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-6)
    off = (xy[:, 0] < -2) | (xy[:, 0] > W + 2) | (xy[:, 1] < -2) | (xy[:, 1] > H + 2)
    assert off.any() and (v.grad.numpy()[off] == 0).all()  # off-film taps dropped


def test_sharded_routes_need_a_group():
    """No silent one-process mode: without torch.distributed every sharded
    entry point raises."""
    assert not torch.distributed.is_initialized()
    sc = tpu_rt_torch.load_file(CBOX, res=8, spp=1)
    us = tpu_rt_torch.load_dict(dryrun.plate_desc(tpu_rt_torch.ScalarTransform4f))
    calls = [render_t.default_group,
             lambda: render_t.render_pallas_sharded(sc, spp=1, device="cpu"),
             lambda: render_t.render_sharded(sc, spp=1, device="cpu"),
             lambda: us_t.simulate_acquisition_sharded(us, rays_per_pair=1, device="cpu"),
             lambda: render_t.psum(torch.ones(2))]
    for call in calls:
        with pytest.raises(ValueError, match="torch.distributed"):
            call()


def test_run_world_reports_a_failed_and_a_hung_rank():
    from torch_port_scenes import world_fails, world_hangs

    with pytest.raises(RuntimeError, match="rank 1 of a world of 2 failed"):
        dryrun.run_world(world_fails, 2, timeout=120)
    with pytest.raises(TimeoutError, match="not done"):
        dryrun.run_world(world_hangs, 2, timeout=20)


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", WORLDS)
def test_gradient_through_the_collectives(worlds, n):
    """psum forward, pbroadcast's all-reduce backward: 784 on every rank,
    one process's gradient (torch.distributed.nn.functional.all_reduce
    gives 336 and 1232 on two ranks)."""
    for r in worlds(n):
        assert float(r["psum"]["sum"]) == 28.0
        assert float(r["psum"]["grad"]) == 784.0


ROUTES = ("acq_wave", "acq_kernel", "das_gather", "das_matmul", "k1", "k9",
          f"stokes_{FILTER_BOX}", f"stokes_{FILTER_GAUSSIAN}")


def _route(res, name):
    return res["das"][name[4:]] if name.startswith("das_") else res[name]


def _value(d):
    return d["ch"] if "ch" in d else d["img"]


@pytest.mark.parametrize("route", ROUTES)
def test_world_of_one_equals_single_process(worlds, route):
    r0, = worlds(1)
    d = _route(r0, route)
    got, want = _value(d), d["ref"]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("route", ROUTES)
def test_world_equals_its_ranks_single_process_runs(worlds, route, n):
    res = worlds(n)
    d = _route(res[0], route)
    got, want = _value(d), d["ref"]
    for r in res[1:]:  # every rank holds the same result
        np.testing.assert_array_equal(_value(_route(r, route)), got)
    if route.startswith("das_"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.abs(got).max() > 0


def test_render_pallas_sharded_matches_tpu_rt(worlds, meshes):
    """K1 sharded over 2 ranks at 16^2, 4 spp, depth 2, tile_rows 8."""
    r0 = worlds(2)[0]
    want = np.asarray(render_j.render_pallas_sharded(
        _scene_j(CBOX, K1["res"], K1["depth"]), spp=K1["spp"], seed=SEED, mesh=meshes[2],
        tile_rows=8, interpret=True))
    _agree(r0["k1"]["img"], want, "K1 sharded")
    want_rays = render_j.render_pallas_sharded.last_ray_count
    assert abs(int(r0["k1"]["rays"]) - want_rays) <= 0.01 * want_rays


@pytest.mark.parametrize("filter_type", [FILTER_BOX, FILTER_GAUSSIAN])
def test_render_stokes_pallas_sharded_matches_tpu_rt(worlds, meshes, filter_type):
    """Box: K3's branch, also against render_stokes_film(spp,
    spp_per_pass=k); gaussian (cbox_pol's own filter): K6's branch."""
    r0 = worlds(2)[0]
    d = r0[f"stokes_{filter_type}"]
    want = np.asarray(render_j.render_stokes_pallas_sharded(
        _scene_j(CBOX_POL, POL["res"], POL["depth"], filter_type), spp=POL["spp"], seed=SEED,
        mesh=meshes[2], tile_rows=8, interpret=True))
    assert d["img"].shape == want.shape == (16, 16, 4, 3)
    _agree(d["img"], want, "Stokes sharded")
    assert abs(int(d["rays"]) - int(render_j.render_stokes_pallas_sharded.last_ray_count)) \
        <= 0.01 * int(render_j.render_stokes_pallas_sharded.last_ray_count)
    if filter_type == FILTER_BOX:
        np.testing.assert_allclose(d["img"], d["ref_film"], rtol=1e-5, atol=1e-6)


def _rf_agrees(got, want):
    """tpu_rt's rtol 1e-5 / atol 1e-8 where the port's K10 meets it; else
    tests/test_torch_us_kernel.py's bar for deposited RF."""
    if np.allclose(got, want, rtol=1e-5, atol=1e-8):
        return
    total = np.abs(want).sum()
    assert abs(np.abs(got).sum() - total) <= 1e-3 * total
    e_got = (got.astype(np.float64) ** 2).sum(-1).ravel()
    e_want = (want.astype(np.float64) ** 2).sum(-1).ravel()
    assert np.corrcoef(e_got, e_want)[0, 1] >= 0.999


@pytest.mark.parametrize("n", (2, 4))
def test_acquisition_pallas_sharded_matches_tpu_rt(worlds, meshes, n):
    """tests/test_parallel_and_grad.py:319-364's case: rpp 8 over the
    ranks, K10 per rank."""
    r0 = worlds(n)[0]
    ch_j, tx_j = us_j.simulate_acquisition_pallas_sharded(
        us_scene_j(), seed=SEED, rays_per_pair=RPP, mesh=meshes[n], interpret=True)
    ch_j = np.asarray(ch_j)
    assert np.abs(ch_j).sum() > 0
    _rf_agrees(r0["acq_kernel"]["ch"], ch_j)
    np.testing.assert_allclose(r0["acq_kernel"]["tx"], np.asarray(tx_j), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("method", ["gather", "matmul"])
def test_das_sharded_matches_tpu_rt(worlds, meshes, method, n):
    """tpu_rt's sharded DAS equals its single-chip DAS to rtol 1e-6 / atol
    1e-7; the port's equals its single-process DAS bit for bit
    (test_world_equals_its_ranks_single_process_runs).  Across the two
    packages the single-process forms differ by an ulp of a delay
    (tests/test_torch_us_das.py), so the sharded forms are held to that
    file's bar: rtol 1e-5, atol 1e-4 of the largest |pixel|."""
    d = das_case()
    want = np.asarray(us_j.das_beamform_sharded(
        jnp.asarray(d["rf"]), jnp.asarray(d["angles"]), jnp.asarray(d["elem_x"]), d["fs"],
        d["c"], jnp.asarray(d["x_grid"]), jnp.asarray(d["z_grid"]), method=method,
        mesh=meshes[n]))
    got = worlds(n)[0]["das"][method]["img"]
    assert got.shape == want.shape == (13, 9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("method", ["gather", "matmul"])
def test_das_sharded_gradient_is_one_process_gradient(worlds, method, n):
    """d (|img|^2 / 2) / d RF through das_beamform_sharded (each rank's
    tile, the all_gather's transpose, the RF's pbroadcast) equals the
    single-process gradient on every rank, to the adds' order."""
    res = worlds(n)
    want = res[0]["das"][method]["grad_ref"]
    assert np.abs(want).max() > 0
    for r in res:
        np.testing.assert_allclose(r["das"][method]["grad"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def _blocks(img, b=8):
    H, W = img.shape[:2]
    return img.reshape(H // b, b, W // b, b, -1).mean(axis=(1, 3))


def _z_scores(got, want, samples):
    """(the image means' difference, the largest 8x8 block-mean
    difference), each over the standard deviation of a difference of two
    independent renders, estimated from ``samples``: renders of the same
    estimator at other seeds (a block's deviation floored at 1e-3 of the
    image mean)."""
    m = want.mean()
    sd_mean = np.std([s.mean() for s in samples], ddof=1) * np.sqrt(2)
    sd = np.maximum(np.stack([_blocks(s) for s in samples]).std(0, ddof=1), 1e-3 * m)
    return (abs(got.mean() - m) / sd_mean,
            (np.abs(_blocks(got) - _blocks(want)) / (sd * np.sqrt(2))).max())


def test_sharded_wavefront_matches_tpu_rt_statistically(worlds, meshes):
    """render_sharded on 2 ranks against tpu_rt's at 32^2, 16 spp, depth
    3, other random streams: the image means and every 8x8 block mean
    within 5 standard deviations of a difference of two renders, the
    deviations from the port's wavefront at six other seeds (a block's
    is 6-21% of the image mean here, the image mean's about 2%)."""
    from tpu_rt_torch.integrator import path as wavefront

    got = worlds(2)[0]["wave"]["img"]
    want = np.asarray(render_j.render_sharded(
        _scene_j(CBOX, WAVE["res"], WAVE["depth"]), spp=WAVE["spp"], seed=SEED,
        mesh=meshes[2]))
    st = tpu_rt_torch.load_file(CBOX, res=WAVE["res"], spp=1).replace(max_depth=WAVE["depth"])
    samples = [wavefront.render(st, spp=WAVE["spp"], seed=s, device="cpu").numpy()
               for s in range(1, 7)]
    assert np.isfinite(got).all()
    z_mean, z_block = _z_scores(got, want, samples)
    assert z_mean <= 5 and z_block <= 5, (z_mean, z_block)


def test_sharded_direct_mesh_matches_tpu_rt_statistically(worlds, meshes):
    """K9 sharded on 2 ranks against tpu_rt's at 32^2, 4 spp (point
    lights: only the jitter is random, which moves the knot's edges): the
    image means and every 8x8 block mean within 5 standard deviations, as
    above, from the port's K9 at eight other seeds."""
    from tpu_rt_torch.ops import mesh_kernel

    got = worlds(2)[0]["k9"]["img"]
    want = np.asarray(k9_sharded_j(_scene_j(SIMPLE, K9["res"]), spp=K9["spp"], seed=SEED,
                                   mesh=meshes[2], interpret=True))
    st = tpu_rt_torch.load_file(SIMPLE, res=K9["res"], spp=1)
    samples = [mesh_kernel.mesh_direct_render(st, spp=K9["spp"], seed=s, device="cpu").numpy()
               for s in range(1, 9)]
    z_mean, z_block = _z_scores(got, want, samples)
    assert z_mean <= 5 and z_block <= 5, (z_mean, z_block)


@pytest.mark.parametrize("n", (2, 4))
def test_dryrun_train_step(worlds, n):
    """A finite loss, the same parameters on every rank after Adam, the
    gradient one process's over the same pixels and draws."""
    res = worlds(n)
    t0 = res[0]["train"]
    assert np.isfinite(t0["loss"]) and t0["loss"] > 0
    for r in res:
        np.testing.assert_array_equal(r["train"]["params"], t0["params"])
        np.testing.assert_array_equal(r["train"]["grad"], t0["grad"])
    assert np.abs(t0["grad"]).max() > 0
    np.testing.assert_allclose(t0["grad"], t0["grad_ref"], rtol=1e-5,
                               atol=1e-5 * np.abs(t0["grad_ref"]).max())


@pytest.mark.parametrize("n", (2, 4))
def test_acquisition_gradient_matches_jax_grad_of_tpu_rt(worlds, meshes, n):
    """The sharded acoustic wavefront's RF and d sum(ch^2) / d the BSDF
    table, each rank fed the threefry draws of its tpu_rt device (seed 5
    + r * 7919), against tpu_rt's simulate_acquisition_sharded and
    jax.grad of it."""
    sj = us_scene_j()

    def loss(params):
        ch, _ = us_j.simulate_acquisition_sharded(sj.replace(bsdf_params=params), seed=US_SEED,
                                                  rays_per_pair=RPP, mesh=meshes[n])
        return jnp.sum(ch * ch), ch

    want, ch_j = jax.jit(jax.grad(loss, has_aux=True))(sj.bsdf_params)
    want, ch_j = np.asarray(want)[:, :3], np.asarray(ch_j)
    res = worlds(n)
    # the RF itself at tests/test_torch_us_wavefront.py's bar for fed draws
    ch_t, big = res[0]["acq_grad"]["ch"], np.abs(ch_j).max()
    assert abs(np.abs(ch_t).sum() - np.abs(ch_j).sum()) <= 1e-3 * np.abs(ch_j).sum()
    np.testing.assert_allclose(ch_t, ch_j, rtol=0, atol=1e-3 * big)
    got = res[0]["acq_grad"]["grad"][:, :3]
    for r in res[1:]:
        np.testing.assert_array_equal(r["acq_grad"]["grad"][:, :3], got)
    assert np.abs(want[0, :2]).min() > 0, "impedance and roughness get no gradient"
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    res = dryrun.dryrun_multichip(2, device="cpu", timeout=300)
    out = capsys.readouterr().out
    assert len(res) == 2 and out.count("dryrun_multichip(2):") == 8

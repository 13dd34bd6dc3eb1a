"""Bitmap textures and their readers in tpu_rt_torch against tpu_rt, on
the CPU.

* The readers: ``read_png`` bit-equal to tpu_rt's on the committed
  fixtures (tests/assets/textured/, written by make_textured.py) and on
  PNGs of every colour type and both bit depths written here, PIL as a
  witness; ``read_jpeg`` (baseline) within 1/255 of tpu_rt's, and its luma
  within 2/255 of PIL's (PIL's chroma upsampling is the "fancy" one, the
  readers' pixel replication, so only the luma is compared); a progressive
  JPEG through PIL, and the same ValueError as tpu_rt's without it;
  ``load_vol`` equal to tpu_rt's.
* The loader: the atlas, ``tex_hw``, ``bsdf_tex`` and the mean rows of
  textured_small.xml byte-equal to tpu_rt's; one decode per file and
  ``raw``; an EXR texture.
* ``eval_bitmap`` against tpu_rt's on random uv, edges and negative uv
  included (1e-6).
* ``path_trace`` on textured_small.xml fed tpu_rt's threefry draws (its
  mesh queries through K7, in interpret mode in tpu_rt, the plain version
  here; the K7 wave itself compared on the textured scene's primaries),
  the exact-ratio test of tests/test_textures.py:189-237, a textured
  ``stokes`` scene against tpu_rt's Stokes wavefront (which reads the
  textures' mean rows), and ``render`` of a textured scene.
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_rt
import tpu_rt_torch
from tpu_rt.bsdf import texture as tex_j
from tpu_rt.integrator import path as path_j
from tpu_rt.integrator import stokes as stokes_j
from tpu_rt.ops import pallas_mesh
from tpu_rt.scene import jpeg as jpeg_j
from tpu_rt.scene import png as png_j
from tpu_rt.scene import vol as vol_j
from tpu_rt.sensor import camera as cam_j
from tpu_rt_torch.bsdf import texture as tex_t
from tpu_rt_torch.integrator import path as path_t
from tpu_rt_torch.integrator import stokes as stokes_t
from tpu_rt_torch.ops import mesh_kernel, path_kernel
from tpu_rt_torch.scene import jpeg as jpeg_t
from tpu_rt_torch.scene import png as png_t
from tpu_rt_torch.scene import types as TT
from tpu_rt_torch.scene import vol as vol_t

HERE = os.path.dirname(os.path.abspath(__file__))
TEX = os.path.join(HERE, "assets", "textured")
SMALL = os.path.join(TEX, "textured_small.xml")
sys.path.insert(0, TEX)
sys.path.insert(0, HERE)
from make_textured import encode_png  # noqa: E402
from torch_port_scenes import textured_rect_desc, texture_ratio_error  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_mesh, "INTERPRET", True)


# ---- readers ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["checker.png", "gray16.png"])
@pytest.mark.parametrize("srgb", [False, True])
def test_read_png_fixtures_bit_equal_to_tpu_rt(name, srgb):
    path = os.path.join(TEX, name)
    got = png_t.read_png(path, srgb=srgb)
    want = png_j.read_png(path, srgb=srgb)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_read_png_fixtures_against_pil():
    Image = pytest.importorskip("PIL.Image")
    got = png_t.read_png(os.path.join(TEX, "checker.png"), srgb=False)
    ref = np.asarray(Image.open(os.path.join(TEX, "checker.png"))).astype(np.float32) / 255.0
    assert got.shape == (512, 1024, 3)
    np.testing.assert_array_equal(got, ref)
    # PIL opens the 16-bit gray + alpha image at 8 bits a sample (the high
    # byte), as RGBA
    g16 = np.round(png_t.read_png(os.path.join(TEX, "gray16.png"), srgb=False) * 65535.0)
    ref = np.asarray(Image.open(os.path.join(TEX, "gray16.png")))
    assert g16.shape == (40, 48, 2) and ref.shape == (40, 48, 4)
    np.testing.assert_array_equal(g16[..., 0].astype(np.int64) >> 8, ref[..., 0])
    np.testing.assert_array_equal(g16[..., 1].astype(np.int64) >> 8, ref[..., 3])


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _palette_png(idx, palette, trns):
    h, w = idx.shape
    raw = b"".join(b"\x00" + row.astype(np.uint8).tobytes() for row in idx)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
            + _chunk(b"tRNS", trns.astype(np.uint8).tobytes())
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,bits", [(0, 8), (2, 8), (4, 8), (6, 8), (0, 16), (2, 16),
                                        (6, 16), (3, 8)])
def test_read_png_every_colour_type(tmp_path, ctype, bits):
    rng = np.random.default_rng(ctype * 100 + bits)
    f = tmp_path / "t.png"
    if ctype == 3:
        idx = rng.integers(0, 6, (9, 70))
        palette, trns = rng.integers(0, 256, (6, 3)), rng.integers(0, 256, 4)
        f.write_bytes(_palette_png(idx, palette, trns))
        alpha = np.concatenate([trns / 255.0, np.ones(2)])[idx]
        want = np.concatenate([palette[idx] / 255.0, alpha[..., None]], -1)
    else:
        c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        samples = rng.integers(0, 1 << bits, (70, 9, c))
        f.write_bytes(encode_png(samples.astype(np.uint16 if bits == 16 else np.uint8),
                                 ctype, bits))
        want = samples / float((1 << bits) - 1)
    for srgb in (False, True):
        got = png_t.read_png(str(f), srgb=srgb)
        assert got.tobytes() == png_j.read_png(str(f), srgb=srgb).tobytes()
    np.testing.assert_allclose(png_t.read_png(str(f), srgb=False), want, atol=1e-7)


def test_read_png_rejects_adam7(tmp_path):
    f = tmp_path / "i.png"
    f.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0,
                                                                        0, 1)))
    for reader in (png_t.read_png, png_j.read_png):
        with pytest.raises(ValueError, match="Adam7"):
            reader(str(f))


def test_read_jpeg_baseline_against_tpu_rt_and_pil():
    path = os.path.join(TEX, "floor.jpg")
    for srgb in (False, True):
        got = jpeg_t.read_jpeg(path, srgb=srgb)
        want = jpeg_j.read_jpeg(path, srgb=srgb)
        assert got.shape == (512, 512, 3)
        assert np.abs(got - want).max() <= 1.0 / 255.0
    Image = pytest.importorskip("PIL.Image")
    ref = np.asarray(Image.open(path).convert("RGB")).astype(np.float32) / 255.0
    got = jpeg_t.read_jpeg(path, srgb=False)
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    inside = ((got > 0) & (got < 1)).all(-1) & ((ref > 0) & (ref < 1)).all(-1)
    dl = np.abs(got @ luma - ref @ luma)[inside]
    assert inside.mean() > 0.9 and dl.max() <= 2.0 / 255.0 and dl.mean() <= 0.5 / 255.0


def test_progressive_jpeg_through_pil_or_valueerror(tmp_path, monkeypatch):
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "p.jpg")
    Image.fromarray((np.random.default_rng(1).random((24, 40, 3)) * 255).astype(
        np.uint8)).save(path, progressive=True)
    got = jpeg_t.read_jpeg(path)
    assert got.tobytes() == jpeg_j.read_jpeg(path).tobytes() and got.shape == (24, 40, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a host without PIL
    for reader in (jpeg_t.read_jpeg, jpeg_j.read_jpeg):
        with pytest.raises(ValueError, match="progressive JPEG"):
            reader(path)


def test_load_vol_equal_to_tpu_rt(tmp_path):
    rng = np.random.default_rng(4)
    data = rng.random((5, 4, 3, 2)).astype("<f4")  # z, y, x, c
    f = tmp_path / "v.vol"
    f.write_bytes(b"VOL\x03" + struct.pack("<iiiii", 1, 3, 4, 5, 2)
                  + struct.pack("<6f", -1, -2, -3, 1, 2, 3) + data.tobytes())
    got, want = vol_t.load_vol(str(f)), vol_j.load_vol(str(f))
    assert got["shape"] == want["shape"] == (3, 4, 5, 2)
    for k in ("data", "bbox_min", "bbox_max"):
        assert got[k].tobytes() == want[k].tobytes()
    np.testing.assert_array_equal(got["data"], data)
    f.write_bytes(b"VOX\x03")
    with pytest.raises(ValueError, match="bad magic"):
        vol_t.load_vol(str(f))


# ---- loader -----------------------------------------------------------------

def _pair(path=SMALL, **kw):
    return tpu_rt.load_file(path, **kw), tpu_rt_torch.load_file(path, **kw)


def test_textured_small_atlas_equal_to_tpu_rt():
    sj, st = _pair()
    assert st.has_textures and sj.has_textures
    for k in ("tex_data", "tex_hw", "bsdf_tex", "bsdf_params", "tri_uv0"):
        a = np.asarray(getattr(sj, k) if k != "tri_uv0" else sj.geometry.tri_uv0)
        b = (getattr(st, k) if k != "tri_uv0" else st.geometry.tri_uv0).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
    assert st.tex_data.shape == (2, 512, 1024, 3)
    assert st.tex_hw.tolist() == [[512.0, 1024.0], [512.0, 512.0]]
    assert st.bsdf_tex.tolist() == [0, 1, -1]
    assert float(st.tex_data[1, :, 512:].abs().max()) == 0.0  # the padding


def test_one_decode_per_file_and_raw_and_exr():
    png = os.path.join(TEX, "checker.png")
    exr = os.path.join(HERE, "assets", "polarizers", "envmap.exr")

    def desc(st):
        d = textured_rect_desc(st, {"type": "bitmap", "filename": png})
        d["rect2"] = {"type": "rectangle", "to_world": st().translate([3, 0, 0]),
                      "bsdf": {"type": "diffuse", "reflectance": {"type": "bitmap",
                                                                 "filename": png}}}
        d["rect3"] = {"type": "rectangle", "to_world": st().translate([-3, 0, 0]),
                      "bsdf": {"type": "diffuse", "reflectance": {
                          "type": "bitmap", "filename": png, "raw": True}}}
        d["rect4"] = {"type": "rectangle", "to_world": st().translate([0, 3, 0]),
                      "bsdf": {"type": "diffuse", "reflectance": {"type": "bitmap",
                                                                 "filename": exr}}}
        return d

    sj = tpu_rt.load_dict(desc(tpu_rt.ScalarTransform4f))
    st = tpu_rt_torch.load_dict(desc(tpu_rt_torch.ScalarTransform4f))
    assert st.bsdf_tex.tolist() == [0, 0, 1, 2]
    for k in ("tex_data", "tex_hw", "bsdf_tex", "bsdf_params"):
        assert np.asarray(getattr(sj, k)).tobytes() == getattr(st, k).numpy().tobytes(), k
    # raw keeps the stored values; the sRGB decode darkens the mid tones
    assert float(st.tex_data[1].mean()) > float(st.tex_data[0].mean())


def test_eval_bitmap_matches_tpu_rt():
    sj, st = _pair()
    rng = np.random.default_rng(9)
    n = 4096
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    uv[:64] = rng.integers(-2, 3, (64, 2))  # texel corners and wrap seams
    uv[64:128] = np.round(rng.uniform(0, 1, (64, 2)) * 1024) / 1024.0
    idx = rng.integers(-1, 2, n).astype(np.int32)
    want = np.asarray(tex_j.eval_bitmap(sj.tex_data, sj.tex_hw, jnp.asarray(idx), jnp.asarray(uv)))
    got = tex_t.eval_bitmap(st.tex_data, st.tex_hw, torch.from_numpy(idx),
                            torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[idx < 0] == 0).all() and got[idx >= 0].max() > 0.1


# ---- rendering ----------------------------------------------------------------

def _rays(sj, res, seed=17):
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2) + rng.uniform(0, 1, (res * res, 2))
    return [np.array(x) for x in cam_j.sample_ray_extents(sj.camera, jnp.asarray(xy, jnp.float32))]


def test_textured_path_trace_matches_tpu_rt_on_identical_draws():
    """The textured GI scene at 16x16, depth 3 (K7's plain version here,
    tpu_rt's interpret-mode K7 there): the rays cast equal, 99% of the
    lanes within rtol 1e-4 / atol 1e-6, the image within 1e-4 relative."""
    sj, st = _pair(res=16, spp=1)
    assert st.geometry.cl_trisw is not None  # the mesh queries go through K7
    o, d, t0, t1 = _rays(sj, 16)
    key = jax.random.PRNGKey(3)
    n_iters = path_t.n_bounces(st)
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (o.shape[0], 8)))
                         for k in jax.random.split(key, n_iters)])
    Lj, nj = path_j.path_trace(sj, jnp.asarray(o), jnp.asarray(d), key,
                               tmin0=jnp.asarray(t0), tmax0=jnp.asarray(t1))
    Lt, nt = path_t.path_trace(st, torch.from_numpy(o), torch.from_numpy(d),
                               uniforms=torch.from_numpy(uniforms),
                               tmin0=torch.from_numpy(t0), tmax0=torch.from_numpy(t1))
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert int(nt) == int(nj)
    close = np.isclose(Lt, Lj, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of lanes agree"
    assert abs(Lt.mean() - Lj.mean()) <= 1e-4 * Lj.mean()
    assert (Lj.sum(-1) > 0).mean() > 0.3 and np.isfinite(Lt).all()
    # the same lanes untextured differ: the texture lookup is on the path
    Lw, _ = path_t.path_trace(st.replace(has_textures=False), torch.from_numpy(o),
                              torch.from_numpy(d), uniforms=torch.from_numpy(uniforms),
                              tmin0=torch.from_numpy(t0), tmax0=torch.from_numpy(t1))
    assert not np.allclose(Lw.numpy(), Lt, rtol=1e-3)


def test_k7_on_a_textured_wave_matches_tpu_rt_interpret_mode():
    sj, st = _pair(res=16, spp=1)
    o, d, _, _ = _rays(sj, 16, seed=2)
    gj = sj.geometry
    cj = {"tris": gj.cl_tris, "bounds": gj.cl_bounds, "prim": gj.cl_prim, "trisw": gj.cl_trisw}
    want = [np.asarray(x) for x in pallas_mesh.mesh_intersect(
        cj, jnp.asarray(o), jnp.asarray(d), tmin=1e-4)]
    g = st.geometry
    got = [x.numpy() for x in mesh_kernel.mesh_intersect(
        {"bounds": g.cl_bounds, "trisw": g.cl_trisw, "prim": g.cl_prim, "tree": g.cl_tree},
        torch.from_numpy(o), torch.from_numpy(d))]
    hit = want[1] >= 0
    assert hit.mean() > 0.1 and (got[1] == want[1]).all()
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5)
    np.testing.assert_allclose(got[2][hit], want[2][hit], atol=1e-4)


def test_textured_reflectance_ratio_is_exact():
    """Textured render / white render = the bilinear texture at the hit uv
    (the same seed traces the same rays, so every shading factor cancels):
    the camera rays of render's first wave met with z = 0 analytically."""
    err, lit = texture_ratio_error(os.path.join(TEX, "checker.png"), "cpu")
    assert lit > 0.2 and err < 1e-3, err


def test_textured_stokes_matches_tpu_rt_stokes_wavefront():
    """A textured ``stokes`` scene is outside the Stokes kernel's scope and
    takes the Stokes wavefront, which reads the textures' mean rows in both
    packages: stokes_trace on identical rays and draws, depth 3."""
    sj, st = _pair(res=12, spp=1)
    sj = sj.replace(integrator=TT.INTEGRATOR_STOKES)
    st = st.replace(integrator=TT.INTEGRATOR_STOKES)
    assert not path_kernel.stokes_in_scope(path_kernel.bake_scene(st))
    o, d, t0, t1 = _rays(sj, 12, seed=4)
    key = jax.random.PRNGKey(8)
    depth = stokes_t.resolved_depth(st, 3)
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (o.shape[0], 8)))
                         for k in jax.random.split(key, depth)])
    Sj = np.asarray(stokes_j.stokes_trace(sj, jnp.asarray(o), jnp.asarray(d), key, max_depth=3,
                                          tmin0=jnp.asarray(t0), tmax0=jnp.asarray(t1)))
    St, _ = stokes_t.stokes_trace(st, torch.from_numpy(o), torch.from_numpy(d),
                                  uniforms=torch.from_numpy(uniforms), max_depth=3,
                                  tmin0=torch.from_numpy(t0), tmax0=torch.from_numpy(t1))
    close = np.isclose(St.numpy(), Sj, rtol=1e-4, atol=1e-6).all((1, 2))
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of lanes agree"
    assert (Sj[:, 0].sum(-1) > 0).mean() > 0.3
    S = tpu_rt_torch.render(st, spp=1, device="cpu")
    assert S.shape == (12, 12, 4, 3) and bool(torch.isfinite(S).all())


def test_render_of_a_textured_scene_takes_the_wavefront(monkeypatch):
    calls = []
    wave = path_t.render
    monkeypatch.setattr(path_t, "render", lambda *a, **k: calls.append(k) or wave(*a, **k))
    sc = tpu_rt_torch.load_file(SMALL, res=8, spp=1)
    assert path_kernel.bake_scene(sc) is None
    img = tpu_rt_torch.render(sc, device="cpu")
    assert len(calls) == 1 and img.shape == (8, 8, 3)
    assert bool(torch.isfinite(img).all()) and img.mean() > 0
    # a textured direct scene: out of the direct mesh kernel's scope too
    d = tpu_rt_torch.load_file(SMALL, res=8, spp=1).replace(integrator=TT.INTEGRATOR_DIRECT)
    assert mesh_kernel.bake_direct_scene(d) is None
    img = tpu_rt_torch.render(d, device="cpu")
    assert len(calls) == 2 and calls[1]["max_depth"] == 2 and img.mean() > 0

"""tpu_rt_torch.render against tpu_rt.render on the CPU, and the port's
independence from JAX.

tpu_rt renders through its Pallas kernel in interpret mode (tile_rows 8);
tpu_rt_torch renders with device="cpu", tile_rows=8, which keys its RNG
the same way.  At least 99% of pixels agree within rtol 1e-3 / atol 1e-5
and the image mean within 1e-3 relative (the slack covers the rare lane
that branches the other way on an ulp difference).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_path
from torch_port_scenes import mixed_desc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "tests", "assets", "cbox", "cbox.xml")


def _scenes(which):
    if which == "cbox":
        return (tpu_rt.load_file(CBOX, res=16, spp=2).replace(max_depth=3),
                tpu_rt_torch.load_file(CBOX, res=16, spp=2).replace(max_depth=3))
    return (tpu_rt.load_dict(mixed_desc(tpu_rt.ScalarTransform4f)),
            tpu_rt_torch.load_dict(mixed_desc(tpu_rt_torch.ScalarTransform4f)))


@pytest.mark.parametrize("which", ["cbox", "mixed"])
def test_public_render_matches_tpu_rt(monkeypatch, which):
    monkeypatch.setattr(pallas_path, "INTERPRET", True)
    sj, st = _scenes(which)
    want = np.asarray(tpu_rt.render(sj, spp=2, seed=0))
    want_rays = int(pallas_path.render_pallas.last_ray_count)
    got = tpu_rt_torch.render(st, spp=2, seed=0, device="cpu", tile_rows=8)
    assert got.shape == (16, 16, 3) and got.dtype == torch.float32
    assert got.device.type == "cpu"
    got = got.numpy()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    rays = tpu_rt_torch.render.last_ray_count
    assert rays.dim() == 0 and abs(int(rays) - want_rays) <= 0.01 * want_rays


def test_render_chunks_and_seeds():
    """spp beyond spp_per_pass runs several chunks (plus a remainder)
    whose deposits add up: the image stays finite and positive and the
    ray count grows with spp."""
    st = tpu_rt_torch.load_file(CBOX, res=8, spp=5).replace(max_depth=3)
    img = tpu_rt_torch.render(st, seed=3, device="cpu", spp_per_pass=2)
    rays5 = int(tpu_rt_torch.render.last_ray_count)
    assert torch.isfinite(img).all() and img.mean() > 0
    tpu_rt_torch.render(st, spp=1, seed=3, device="cpu")
    assert int(tpu_rt_torch.render.last_ray_count) < rays5


def test_port_never_imports_jax():
    code = (
        "import sys, tpu_rt_torch as tt\n"
        f"sc = tt.load_file({CBOX!r}, res=8, spp=1)\n"
        "img = tt.render(sc, device='cpu')\n"
        "assert img.shape == (8, 8, 3) and bool(img.isfinite().all())\n"
        "from tpu_rt_torch.opt import checkpoint, inverse\n"
        "from tpu_rt_torch import compat\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpu_rt')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_render_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    st = tpu_rt_torch.load_file(CBOX, res=8, spp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpu_rt_torch.render(st)


def test_luminance_pixel_format():
    """hdrfilm pixel_format="luminance" develops to one BT.709 luminance
    channel, as tpu_rt's render does."""
    st = tpu_rt_torch.load_file(CBOX, res=8, spp=1).replace(max_depth=2)
    rgb = tpu_rt_torch.render(st, seed=4, device="cpu")
    lum = tpu_rt_torch.render(st.replace(camera=st.camera.replace(pixel_format="luminance")),
                              seed=4, device="cpu")
    assert lum.shape == (8, 8, 1)
    want = rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169
    np.testing.assert_array_equal(lum[..., 0].numpy(), want.numpy())

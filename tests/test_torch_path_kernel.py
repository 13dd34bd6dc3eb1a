"""The film kernel's plain PyTorch version against tpu_rt's Pallas kernel.

tpu_rt runs ``pallas_film_trace`` in interpret mode with tile_rows=8, as
its own tests do; the port runs the plain version of its kernel on the
same tables with the same RNG keying, so both trace the same paths.  The
tolerance allows the rare lane that takes the other branch on an ulp
difference between XLA on the CPU and torch: at least 99% of the
(plane, lane) entries agree within rtol 1e-4 / atol 1e-6, every plane's
sum within 1e-3 relative, the ray count within 1%.  The CUDA kernel is
held to the plain version on the card by tests/test_torch_cuda.py, which
imports no JAX so that it runs on GPU hosts without JAX.
"""

import os

import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_path
from tpu_rt_torch.ops import path_kernel

torch.set_num_threads(1)

CBOX = os.path.join(os.path.dirname(__file__), "assets", "cbox", "cbox.xml")
RES, K, DEPTH, SEED = 16, 2, 3, 5


def _scenes(filter_type):
    sj = tpu_rt.load_file(CBOX, res=RES, spp=K).replace(max_depth=DEPTH)
    st = tpu_rt_torch.load_file(CBOX, res=RES, spp=K).replace(max_depth=DEPTH)
    return (sj.replace(camera=sj.camera.replace(filter_type=filter_type)),
            st.replace(camera=st.camera.replace(filter_type=filter_type)))


def _check(got, want, rtol=1e-4, atol=1e-6):
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of entries agree"
    sums_g, sums_w = got[:-1].sum(1), want[:-1].sum(1)
    np.testing.assert_allclose(sums_g, sums_w, rtol=1e-3, atol=1e-6)
    assert abs(got[-1].sum() - want[-1].sum()) <= 0.01 * want[-1].sum()


@pytest.mark.parametrize("filter_type", [1, 0], ids=["tent", "box"])
def test_plain_version_matches_pallas_interpret(filter_type):
    sj, st = _scenes(filter_type)
    accs, nrays = pallas_path.pallas_film_trace(
        pallas_path.bake_scene(sj), sj.camera, SEED, K, tile_rows=8, interpret=True)
    n = RES * RES
    want = np.stack([np.asarray(a).reshape(-1)[:n] for a in accs]
                    + [np.asarray(nrays).reshape(-1)[:n]])
    tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 8, "cpu")
    got = path_kernel.film_trace(tables, SEED, K)
    assert got.shape == want.shape and got.dtype == torch.float32
    _check(got.numpy(), want)


def test_film_trace_cpu_uses_plain_version_without_launch():
    _, st = _scenes(1)
    tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 8, "cpu")
    before = path_kernel.film_trace.launches
    out = path_kernel.film_trace(tables, SEED, 1)
    assert path_kernel.film_trace.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  path_kernel.film_trace_plain(tables, SEED, 1).numpy())


@pytest.mark.parametrize("which", ["cbox", "mixed"])
def test_pack_tables_unchanged_by_the_shared_prim_packer(which):
    """K1's packed tables, byte for byte, as they were before its prim
    records moved into ``pack_prims`` (shared with the ultrasound kernel):
    tests/golden/film_tables_cbox_mixed.npz holds the earlier tables of the
    cbox fixture at 16x16 and of mixed_desc, tile_rows 8.  The header has
    since grown by the Stokes, regen, textured-environment and rough
    flags, all off for these scalar scenes of depth 6 and 3 under no or a
    constant environment and without a rough conductor."""
    from torch_port_scenes import mixed_desc

    ref = np.load(os.path.join(os.path.dirname(__file__), "golden", "film_tables_cbox_mixed.npz"))
    sc = (tpu_rt_torch.load_file(CBOX, res=16, spp=2) if which == "cbox"
          else tpu_rt_torch.load_dict(mixed_desc(tpu_rt_torch.ScalarTransform4f)))
    t = path_kernel.pack_tables(path_kernel.bake_scene(sc), sc.camera, 8, "cpu")
    n_old = ref[which + "_hdr"].shape[0]
    np.testing.assert_array_equal(np.asarray(t.hdr_list[:n_old], np.int32), ref[which + "_hdr"])
    assert t.hdr_list[n_old:] == [0, 0, 0, 0] and n_old == path_kernel.HDR_STOKES
    assert np.asarray(t.tab_list, np.float32).tobytes() == ref[which + "_tab"].tobytes()
    assert t.tab.numpy().tobytes() == ref[which + "_tab"].tobytes()

"""The film kernels' two-launch form on the CPU: sample records and the
splat that adds them onto the filter planes.

On the card K1 and K3 (either loop form) are a trace kernel that writes
one record per finished sample, [value][sample][pixel],
and ``film_splat``, which adds a chunk of records onto the planes in
sample order (``path_kernel.split_film``).  Their plain versions,
``film_records_plain`` and ``film_splat_plain``, must give
``film_trace_plain``'s planes bit for bit (``torch.equal``), for every
filter, K1 and K3, tables of either loop form and a sample count that is
not a multiple of the chunk; the records must be laid out as the
per-sample kernels K5 and K6 see the same samples.  One case is held to
tpu_rt's Pallas film kernel in interpret mode (tpu_rt's own tests run it
so on the CPU), with the tolerance of ``tests/test_torch_path_kernel.py``:
at least 99% of the entries within rtol 1e-4 / atol 1e-6, each plane's sum
within 1e-3 relative, the ray count within 1% (XLA on the CPU contracts
multiply-adds, so a lane whose branch sits on an ulp may take the other).
"""

import os

import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_path
from tpu_rt_torch.ops import path_kernel as pk

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CBOX = os.path.join(HERE, "assets", "cbox", "cbox.xml")
CBOX_POL = os.path.join(HERE, "assets", "cbox_pol", "cbox_pol.xml")
RES = 8


def _tables(stokes, filter_type, depth, res=RES, tile_rows=8):
    sc = tpu_rt_torch.load_file(CBOX_POL if stokes else CBOX, res=res, spp=1)
    sc = sc.replace(max_depth=depth)
    sc = sc.replace(camera=sc.camera.replace(filter_type=filter_type))
    return pk.pack_tables(pk.bake_scene(sc), sc.camera, tile_rows, "cpu", stokes=stokes)


def _plain(tables, seed, n):
    fn = pk.stokes_film_trace_plain if tables.stokes else pk.film_trace_plain
    return fn(tables, seed, n)


@pytest.mark.parametrize("filter_type", [0, 1, 2], ids=["box", "tent", "gaussian"])
@pytest.mark.parametrize("stokes", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("depth", [3, 8], ids=["per_sample_loop", "K2_loop"])
def test_plain_records_and_splat_equal_the_plain_film(filter_type, stokes, depth, monkeypatch):
    """7 samples in chunks of 3 (3 + 3 + 1): chunk boundaries are exact."""
    tables = _tables(stokes, filter_type, depth)
    assert tables.regen == (depth >= pk.REGEN_AUTO_DEPTH and not stokes)  # K3 has no loop
    monkeypatch.setattr(pk, "RECORD_CHUNK", 3)
    got = pk.split_film(tables, -5, 7, pk.film_records_plain, pk.film_splat_plain)
    want = _plain(tables, -5, 7)
    assert got.shape == want.shape == (tables.n_acc + 1, RES * RES)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stokes", [False, True], ids=["K1", "K3"])
def test_records_are_value_sample_pixel(stokes):
    """records[k, i, p] is value k of sample i of pixel p: the values and
    ray count that K5 (K1) or K6 (K3) gives for the stream of seed + i."""
    tables = _tables(stokes, 2, 3)
    recs = pk.film_records_plain(tables, 11, 3)
    assert recs.shape == (tables.n_val, 3, RES * RES) and recs.dtype == torch.float32
    for i in range(3):
        if stokes:
            one = pk.stokes_sample_trace_plain(tables, 11 + i)[:13]
        else:
            one = pk.raygen_trace_plain(tables, 11 + i)[:4]
        assert torch.equal(recs[:, i], one)
    assert recs[-1].min().item() >= 1.0  # every sample casts its camera ray


def test_splat_adds_onto_the_planes_passed_in():
    """A second chunk onto the first one's planes equals one launch of both
    chunks' samples; the ray count adds up."""
    tables = _tables(True, 1, 3)
    first = _plain(tables, 4, 2)
    got = pk.film_splat_plain(pk.film_records_plain(tables, 6, 2), first.clone(), tables, 6)
    assert torch.equal(got, _plain(tables, 4, 4))
    assert got[-1].sum() > first[-1].sum()


def test_film_splat_on_the_cpu_runs_the_plain_version_without_launch():
    tables = _tables(False, 1, 3)
    recs = pk.film_records(tables, 2, 2)
    before = pk.film_splat.launches
    got = pk.film_splat(recs, torch.zeros((tables.n_acc + 1, tables.n_pix)), tables, 2)
    assert pk.film_splat.launches == before
    assert torch.equal(got, pk.film_trace_plain(tables, 2, 2))


def test_split_plain_film_matches_pallas_interpret(monkeypatch):
    """K1, tent, 16x16 x 3 samples, depth 3: the plain records and splat
    against tpu_rt's pallas_film_trace in interpret mode."""
    res, k, depth, seed = 16, 3, 3, 7
    sj = tpu_rt.load_file(CBOX, res=res, spp=k).replace(max_depth=depth)
    sj = sj.replace(camera=sj.camera.replace(filter_type=1))
    accs, nrays = pallas_path.pallas_film_trace(
        pallas_path.bake_scene(sj), sj.camera, seed, k, tile_rows=8, interpret=True)
    n = res * res
    want = np.stack([np.asarray(a).reshape(-1)[:n] for a in accs]
                    + [np.asarray(nrays).reshape(-1)[:n]])
    tables = _tables(False, 1, depth, res=res)
    monkeypatch.setattr(pk, "RECORD_CHUNK", 2)
    got = pk.split_film(tables, seed, k, pk.film_records_plain, pk.film_splat_plain).numpy()
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of entries agree"
    np.testing.assert_allclose(got[:-1].sum(1), want[:-1].sum(1), rtol=1e-3, atol=1e-6)
    assert abs(got[-1].sum() - want[-1].sum()) <= 0.01 * want[-1].sum()

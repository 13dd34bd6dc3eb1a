"""The port's EXR reader (scene/exr.py, scene/piz.py) against tpu_rt's.

* NONE, RLE, ZIPS and ZIP files of HALF, FLOAT and UINT pixels, written by
  tests/assets/polarizers/make_envmap.py, read by both packages: equal
  arrays, and equal to what was written.
* PIZ without a PIZ file from elsewhere: the port's piz.py held to
  tpu_rt's function by function.  The wavelet decode on random uint16
  arrays of several shapes; the Huffman table and payload decode on
  streams written by the small OpenEXR-format Huffman encoder below
  (canonical codes, zero-run codes 59..63 in the table, the run-length
  symbol iM in the payload, codes longer than the 14-bit fast table);
  ``piz_uncompress`` and ``load_exr`` end to end on blocks built from
  those.
* ``load_exr_or_fallback`` warns only for an unknown compression.
* The fixture's envmap through both loaders: the same env_map, CDFs,
  env_to_world and env_to_local.
"""

import heapq
import os
import struct
import sys
import warnings

import numpy as np
import pytest

import tpu_rt
import tpu_rt_torch
from tpu_rt.scene import exr as exr_j
from tpu_rt.scene import piz as piz_j
from tpu_rt_torch.scene import exr as exr_t
from tpu_rt_torch.scene import piz as piz_t

HERE = os.path.dirname(os.path.abspath(__file__))
POLARIZERS = os.path.join(HERE, "assets", "polarizers", "polarizers.xml")
sys.path.insert(0, os.path.join(HERE, "assets", "polarizers"))
import make_envmap as ME  # noqa: E402


@pytest.mark.parametrize("compression", ["none", "rle", "zips", "zip"])
@pytest.mark.parametrize("pixel", ["half", "float", "uint"])
def test_scanline_variants_read_as_tpu_rt_reads_them(tmp_path, compression, pixel):
    rgb = ME.sky(40, 72)
    if pixel == "uint":
        rgb = np.round(rgb * 1000.0)
    path = str(tmp_path / f"sky_{compression}_{pixel}.exr")
    ME.write_exr(path, rgb, compression, pixel)
    got, want = exr_t.load_exr(path), exr_j.load_exr(path)
    assert got.dtype == np.float32 and got.shape == (40, 72, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rgb.astype(ME._PIXEL[pixel][1]).astype(np.float32))


def test_fixture_is_a_zip_half_map_with_a_sun():
    path = os.path.join(HERE, "assets", "polarizers", "envmap.exr")
    with open(path, "rb") as f:
        buf = f.read()
    attrs, _ = exr_t._read_attrs(buf, 8)
    assert attrs["compression"][1][0] == 3
    assert [pt for _, pt in exr_t._parse_channels(attrs["channels"][1])] == [1, 1, 1]
    img = exr_t.load_exr(path)
    np.testing.assert_array_equal(img, exr_j.load_exr(path))
    np.testing.assert_array_equal(img, ME.sky().astype(np.float16).astype(np.float32))
    assert img.shape == (256, 512, 3) and img.max() > 5.0 and np.median(img) < 1.0


# ---- a small OpenEXR-format Huffman encoder (ImfHuf's stream layout) ----

class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> (n - 1 - k)) & 1 for k in range(n)]

    def bytes(self):
        pad = (-len(self.bits)) % 8
        b = np.packbits(np.asarray(self.bits + [0] * pad, np.uint8))
        return b.tobytes()


def _huffman_lengths(freq):
    """Code lengths of a Huffman code over the symbols of non-zero freq."""
    heap = [(int(f), i, [s]) for i, (s, f) in enumerate(freq.items())]
    heapq.heapify(heap)
    length = {s: 0 for s in freq}
    tie = len(heap)
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        for s in a + b:
            length[s] += 1
        heapq.heappush(heap, (fa + fb, tie, a + b))
        tie += 1
    return length


def _canonical(length):
    """OpenEXR's canonical code assignment (hufCanonicalCodeTable)."""
    n = [0] * 59
    for ln in length.values():
        n[ln] += 1
    c = 0
    for i in range(58, 0, -1):
        n[i], c = c, (c + n[i]) >> 1
    codes = {}
    for s in sorted(length):
        codes[s] = n[length[s]]
        n[length[s]] += 1
    return codes


def _pack_table(bw, length, im, iM):
    """6-bit code lengths from im to iM, zero runs as codes 59..63."""
    i = im
    while i <= iM:
        z = 0
        while i + z <= iM and length.get(i + z, 0) == 0 and z < 255 + 6:
            z += 1
        if z >= 6:
            bw.put(63, 6)
            bw.put(z - 6, 8)
            i += z
        elif z >= 2:
            bw.put(59 + z - 2, 6)
            i += z
        else:
            bw.put(length.get(i, 0), 6)
            i += 1


def huf_encode(data, unary=False):
    """A Huffman block of uint16 ``data``: runs of one value become the
    value, then the run-length symbol (max value + 1) and an 8-bit count.
    ``unary`` gives the m symbols, most frequent first, the complete code
    of lengths 1, 2, ..., m - 1, m - 1 instead of Huffman's, so codes run
    longer than the decoder's 14-bit fast table."""
    data = [int(x) for x in data]
    rlc = max(data) + 1
    tokens, i = [], 0
    while i < len(data):
        r = 1
        while i + r < len(data) and data[i + r] == data[i] and r < 256:
            r += 1
        tokens.append((data[i], None))
        if r >= 3:
            tokens.append((rlc, r - 1))
        else:
            tokens += [(data[i], None)] * (r - 1)
        i += r
    freq = {}
    for s, _ in tokens:
        freq[s] = freq.get(s, 0) + 1
    if len(freq) == 1:
        freq[rlc] = freq.get(rlc, 0) + 1
    if unary:
        syms = sorted(freq, key=lambda s: (-freq[s], s))
        length = {s: min(k + 1, len(syms) - 1) for k, s in enumerate(syms)}
    else:
        length = _huffman_lengths(freq)
    codes = _canonical(length)
    im, iM = min(length), rlc
    table = _BitWriter()
    _pack_table(table, length, im, iM)
    payload = _BitWriter()
    for s, cnt in tokens:
        payload.put(codes[s], length[s])
        if cnt is not None:
            payload.put(cnt, 8)
    tb = table.bytes()
    head = struct.pack("<IIIII", im, iM, len(tb), len(payload.bits), 0)
    return head + tb + payload.bytes(), length, tb


def _skewed(rng, n, n_sym):
    """About n uint16 values whose symbol counts halve from one symbol to
    the next (each at least once, so with many symbols some codes are
    longer than 14 bits), shuffled, with runs of repeats."""
    counts = np.maximum(1, (n * 0.5 ** np.arange(1, n_sym + 1)).astype(np.int64))
    x = rng.permutation(np.repeat(np.arange(n_sym), counts)).astype(np.uint16) + 3
    for start in rng.choice(x.size - 40, 6, replace=False):
        x[start:start + rng.integers(3, 40)] = x[start]
    return x


@pytest.mark.parametrize("n_sym,n,unary", [(4, 500, False), (40, 20000, False),
                                           (26, 3000, True), (45, 8000, True)])
def test_huffman_table_and_payload_decode_as_tpu_rt(n_sym, n, unary):
    rng = np.random.default_rng(n_sym)
    data = _skewed(rng, n, n_sym)
    n = data.size
    block, length, tb = huf_encode(data, unary)
    if unary:  # the long-code path runs
        assert max(length.values()) > piz_t._DECBITS
    im, iM = struct.unpack_from("<II", block, 0)
    got = piz_t._unpack_enc_table(piz_t._BitReader(tb), im, iM)
    np.testing.assert_array_equal(got, piz_j._unpack_enc_table(piz_j._BitReader(tb), im, iM))
    assert {int(s): int(ln) for s, ln in enumerate(got) if ln} == length
    codes_t, lens_t = piz_t._canonical_codes(got)
    codes_j, lens_j = piz_j._canonical_codes(got)
    np.testing.assert_array_equal(codes_t, codes_j)
    np.testing.assert_array_equal(lens_t, lens_j)
    out = piz_t._huf_decode(block, n)
    np.testing.assert_array_equal(out, piz_j._huf_decode(block, n))
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("nx,ny,mx", [(8, 8, 1000), (37, 5, 9000), (16, 32, 60000),
                                      (33, 31, 70), (1, 9, 20000)])
def test_wavelet_decode_as_tpu_rt(nx, ny, mx):
    rng = np.random.default_rng(nx * 100 + ny)
    for size in (1, 2):  # HALF channels: stride 1; FLOAT / UINT: 2 planes
        buf = rng.integers(0, mx + 1, nx * ny * size).astype(np.uint16)
        for j in range(size):
            a, b = buf[j:].copy(), buf[j:].copy()
            piz_t._wav2_decode(a, nx, size, ny, nx * size, mx)
            piz_j._wav2_decode(b, nx, size, ny, nx * size, mx)
            np.testing.assert_array_equal(a, b)
    lo, hi = rng.integers(0, 1 << 16, (2, 64)).astype(np.uint16)
    for name in ("_wdec14", "_wdec16"):
        for x, y in zip(getattr(piz_t, name)(lo, hi), getattr(piz_j, name)(lo, hi)):
            np.testing.assert_array_equal(x, y)


def piz_block(rng, width, lines, sizes):
    """A PIZ chunk: a bitmap of the values present, then the Huffman-coded
    LUT indices of every channel's (wavelet-coded) data."""
    values = np.unique(np.concatenate([[0], rng.integers(1, 65535, 300)])).astype(np.int64)
    bitmap = np.zeros(8192, np.uint8)
    for v in values[1:]:
        bitmap[v >> 3] |= 1 << (v & 7)
    nz = np.nonzero(bitmap)[0]
    lo, hi = int(nz[0]), int(nz[-1])
    n = sum(width * lines * s for s in sizes)
    idx = np.minimum(_skewed(rng, n, 30)[:n], len(values) - 1).astype(np.uint16)
    huf, _, _ = huf_encode(idx)
    return (struct.pack("<HH", lo, hi) + bitmap[lo:hi + 1].tobytes()
            + struct.pack("<i", len(huf)) + huf)


@pytest.mark.parametrize("ptype", [1, 2, 0], ids=["half", "float", "uint"])
def test_piz_block_and_file_decode_as_tpu_rt(tmp_path, ptype):
    rng = np.random.default_rng(ptype)
    chans = [("B", ptype), ("G", ptype), ("R", ptype)]
    size = 1 if ptype == 1 else 2
    block = piz_block(rng, 24, 7, [size] * 3)
    got = piz_t.piz_uncompress(block, 24, 7, chans)
    want = piz_j.piz_uncompress(block, 24, 7, chans)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.shape == (7, 24 * size)
        np.testing.assert_array_equal(a, b)
    # a 40-line file: one full 32-line chunk and a 8-line one
    path = str(tmp_path / "piz.exr")
    with open(path, "wb") as f:
        f.write(ME.exr_bytes(40, 24, 4, ptype, [piz_block(rng, 24, 32, [size] * 3),
                                                piz_block(rng, 24, 8, [size] * 3)]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        img = exr_t.load_exr_or_fallback(path)
    ref = exr_j.load_exr(path)
    assert img.shape == (40, 24, 3)
    np.testing.assert_array_equal(np.isnan(img), np.isnan(ref))
    np.testing.assert_array_equal(np.nan_to_num(img), np.nan_to_num(ref))


def test_fallback_warns_only_for_an_unknown_compression(tmp_path):
    ok = str(tmp_path / "ok.exr")
    ME.write_exr(ok, ME.sky(8, 16), "zips")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(exr_t.load_exr_or_fallback(ok), exr_j.load_exr(ok))
    odd = str(tmp_path / "b44.exr")
    with open(odd, "wb") as f:  # B44 (6): a header the reader parses, no chunks
        f.write(ME.exr_bytes(8, 16, 6, 1, []))
    with pytest.warns(UserWarning, match="compression 6"):
        img = exr_t.load_exr_or_fallback(odd)
    np.testing.assert_array_equal(img, np.full((8, 16, 3), 0.5, np.float32))
    with pytest.raises(NotImplementedError):
        exr_t.load_exr(odd)
    with pytest.raises(ValueError, match="not an EXR"):
        exr_t.load_exr(POLARIZERS)


def test_fixture_envmap_loads_identically_in_both_packages():
    sj = tpu_rt.load_file(POLARIZERS, res=16, spp=1)
    st = tpu_rt_torch.load_file(POLARIZERS, res=16, spp=1)
    ej, et = sj.emitters, st.emitters
    assert ej.has_env and et.has_env
    for k in ("env_map", "env_cdf_rows", "env_cdf_cols", "env_to_world", "env_to_local"):
        np.testing.assert_array_equal(getattr(et, k).numpy(), np.asarray(getattr(ej, k)),
                                      err_msg=k)
    assert float(et.env_scale) == float(ej.env_scale) == 1.0
    # the map carries the XML's scale; the frame its two rotations
    np.testing.assert_allclose(et.env_map.numpy(), 1.5 * exr_t.load_exr(
        os.path.join(HERE, "assets", "polarizers", "envmap.exr")), rtol=1e-7)
    np.testing.assert_allclose(et.env_to_world.numpy()[:3, :3], ME.to_world(), atol=1e-6)
    assert (et.n_area, et.n_point) == (0, 0)

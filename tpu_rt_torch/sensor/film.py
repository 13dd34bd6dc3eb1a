"""Film reconstruction filters, splats, deposit and develop.

Counterpart of ``tpu_rt/sensor/film.py``: the 1-D filter kernels (box /
tent / Mitsuba's gaussian), the scatter splat of samples at arbitrary
film positions (``splat``, the sharded wavefront's), the aligned splat of
one sample a pixel, the dense shifted add that deposits one filter
offset's plane into the film, and the develop step that divides by the
accumulated weight.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.scene.types import FILTER_BOX, FILTER_GAUSSIAN, FILTER_TENT
from tpu_rt_torch.utils.profiling import span


def filter_weight(filter_type: int, x):
    """1-D filter kernel (separable), x = distance in pixels."""
    ax = torch.abs(x)
    if filter_type == FILTER_BOX:
        return (ax <= 0.5).to(torch.float32)
    if filter_type == FILTER_TENT:
        return torch.clamp(1.0 - ax, min=0.0)
    # Mitsuba gaussian: stddev 0.5, radius 2, offset subtracted
    sigma, r = 0.5, 2.0
    tail = torch.exp(torch.full_like(x, -0.5 * (r / sigma) ** 2))
    g = torch.exp(-0.5 * (x / sigma) ** 2) - tail
    return torch.clamp(g, min=0.0) * (ax <= r)


_FOOTPRINT = {FILTER_BOX: 1, FILTER_TENT: 2, FILTER_GAUSSIAN: 4}


def splat(film_vals, film_wts, film_xy, values, active, filter_type: int):
    """Add samples at continuous film positions to the film
    (``tpu_rt.sensor.film.splat``): each cell of the filter's footprint is
    an ``index_add`` of the weighted values, and a tap off the film, of an
    inactive sample or of zero weight adds 0 (``mode="drop"``).

    ``film_vals`` [H, W, C], ``film_wts`` [H, W], ``film_xy`` [N, 2] in
    pixels, ``values`` [N, C], ``active`` [N] bool.  Returns the updated
    (film_vals, film_wts), new tensors: differentiable in ``values`` (and
    in the films passed in)."""
    H, W = film_wts.shape
    k = _FOOTPRINT[filter_type]
    x, y = film_xy[..., 0], film_xy[..., 1]
    # the top-left pixel of the footprint, in tpu_rt's float32 order
    base_x = torch.floor(x - 0.5 * (k - 1) - 0.5 + 0.5).to(torch.int64)
    base_y = torch.floor(y - 0.5 * (k - 1) - 0.5 + 0.5).to(torch.int64)
    fv = film_vals.reshape(H * W, -1)
    fw = film_wts.reshape(H * W)
    for dy in range(k):
        py = base_y + dy
        wy = filter_weight(filter_type, (py.to(torch.float32) + 0.5) - y)
        for dx in range(k):
            px = base_x + dx
            wx = filter_weight(filter_type, (px.to(torch.float32) + 0.5) - x)
            w = wx * wy
            ok = active & (px >= 0) & (px < W) & (py >= 0) & (py < H) & (w > 0)
            w = torch.where(ok, w, 0.0)
            idx = torch.clamp(py, 0, H - 1) * W + torch.clamp(px, 0, W - 1)
            fv = fv.index_add(0, idx, w[..., None] * values)
            fw = fw.index_add(0, idx, w)
    return fv.reshape(H, W, -1), fw.reshape(H, W)


def _shift_add(acc, img, dy, dx):
    """acc[..., p + (dy, dx)] += img[..., p], in place; returns acc.

    Leading dims are batch dims (one call deposits r, g, b and w)."""
    H, W = acc.shape[-2], acc.shape[-1]
    ys_a, ye_a = max(dy, 0), H + min(dy, 0)
    ys_i, ye_i = max(-dy, 0), H + min(-dy, 0)
    xs_a, xe_a = max(dx, 0), W + min(dx, 0)
    xs_i, xe_i = max(-dx, 0), W + min(-dx, 0)
    if ys_a < ye_a and xs_a < xe_a:
        acc[..., ys_a:ye_a, xs_a:xe_a] += img[..., ys_i:ye_i, xs_i:xe_i]
    return acc


_FOOT_RADIUS = {FILTER_BOX: 0, FILTER_TENT: 1, FILTER_GAUSSIAN: 2}


def splat_terms(jitter, values, active, filter_type: int):
    """What each sample pass of ``splat_aligned``'s batch adds to the film:
    (values [..., H, W, C], weights [..., H, W]), with the batch dims of
    ``values``.  Each output pixel gathers its (2r+1)^2 neighbours'
    samples, each weighted by the filter at its distance; every operation
    is elementwise, so a pass's terms do not depend on the batch around
    it."""
    H, W = values.shape[-3], values.shape[-2]
    r = _FOOT_RADIUS[filter_type]
    vals = torch.where(active[..., None], values, 0.0)
    if r == 0:
        return vals, active.to(torch.float32)

    def pad(a, lead):  # zero-pad the H and W dims by r
        return torch.nn.functional.pad(a, (0, 0) * lead + (r, r, r, r))

    xp, yp = pad(jitter[..., 0], 0), pad(jitter[..., 1], 0)
    vp, ap = pad(vals, 1), pad(active.to(torch.float32), 0) > 0.0
    out_v = torch.zeros_like(vals)
    out_w = torch.zeros_like(xp[..., r:r + H, r:r + W])
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ys, xs = slice(r - dy, r - dy + H), slice(r - dx, r - dx + W)
            wy = filter_weight(filter_type, (dy + 0.5) - yp[..., ys, xs])
            wx = filter_weight(filter_type, (dx + 0.5) - xp[..., ys, xs])
            w = torch.where(ap[..., ys, xs], wx * wy, 0.0)
            out_v = out_v + w[..., None] * vp[..., ys, xs, :]
            out_w = out_w + w
    return out_v, out_w


def splat_aligned(film_vals, film_wts, jitter, values, active, filter_type: int):
    """Add samples taken at pixel + jitter (one per pixel, jitter in
    [0, 1)^2) to the film; counterpart of ``tpu_rt.sensor.film.splat_aligned``.

    ``jitter`` [..., H, W, 2], ``values`` [..., H, W, C], ``active``
    [..., H, W]: leading dims are a batch of sample passes, summed into
    ``film_vals`` [H, W, C] and ``film_wts`` [H, W] (``splat_terms``).
    Returns the updated (film_vals, film_wts)."""
    out_v, out_w = splat_terms(jitter, values, active, filter_type)
    batch = tuple(range(values.dim() - 3))
    return film_vals + out_v.sum(batch), film_wts + out_w.sum(batch)


def splat_in_order(film_vals, film_wts, jitter, values, active, filter_type: int):
    """``splat_aligned`` of a batch of n passes ([n, H, W, ...]) added onto
    the film one pass at a time, in order, so the film equals n calls of
    ``splat_aligned`` with one pass each, bit for bit (a batch's ``.sum``
    rounds otherwise).  Returns the updated (film_vals, film_wts)."""
    out_v, out_w = splat_terms(jitter, values, active, filter_type)
    for v, w in zip(out_v, out_w):
        film_vals = film_vals + v
        film_wts = film_wts + w
    return film_vals, film_wts


def develop(film_vals, film_wts):
    """Normalize accumulated samples by filter weights:
    (H, W, C) / (H, W)."""
    with span("tpu_rt_torch.develop"):
        return film_vals / torch.clamp(film_wts[..., None], min=1e-12)

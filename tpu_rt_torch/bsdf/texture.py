"""Bitmap textures: bilinear lookup with repeat wrap.

Counterpart of ``tpu_rt/bsdf/texture.py``: a BSDF parameter (a diffuse
reflectance here) read per hit from an image by uv, Mitsuba's ``bitmap``
texture.

All of a scene's textures live in one padded atlas ``tex_data``
[K, Hm, Wm, 3] with their true sizes in ``tex_hw`` [K, 2]; each lane
carries a texture index (-1: the constant parameter).  Each of the four
bilinear taps is one gather into the flattened atlas [K * Hm * Wm, 3], so
a lookup has no per-texture branch.

Conventions (Mitsuba's bitmap defaults, as in tpu_rt): uv (0, 0) is the
first stored pixel (the image's top left) and v grows with the row; wrap
mode "repeat" on the true size, so the padding is never read; bilinear
filter with half-texel centring (uv * size - 0.5); the sRGB decode to
linear happens when the scene is loaded (``raw`` false).
"""

from __future__ import annotations

import torch


def eval_bitmap(tex_data, tex_hw, tex_idx, uv):
    """Bilinear lookup of each lane's texture.

    tex_data [K, Hm, Wm, 3] float32 atlas; tex_hw [K, 2] float32 true
    (h, w); tex_idx [N] int texture index, -1 giving 0 (the caller keeps
    its constant there); uv [N, 2] float32.  Returns [N, 3] float32."""
    k, hm, wm, _ = tex_data.shape
    flat = tex_data.reshape(k * hm * wm, 3)
    idx = torch.clamp(tex_idx, min=0).long()
    hw = tex_hw[idx]
    h, w = hw[:, 0], hw[:, 1]

    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]

    def wrap(i, size):
        return torch.remainder(i, size).long()

    x0, x1 = wrap(x0f, w), wrap(x0f + 1.0, w)
    y0, y1 = wrap(y0f, h), wrap(y0f + 1.0, h)
    base = idx * (hm * wm)

    def tap(yi, xi):
        return flat[base + yi * wm + xi]

    top = tap(y0, x0) * (1.0 - fx) + tap(y0, x1) * fx
    bot = tap(y1, x0) * (1.0 - fx) + tap(y1, x1) * fx
    out = top * (1.0 - fy) + bot * fy
    return torch.where((tex_idx >= 0)[:, None], out, 0.0)


def apply_reflectance_textures(scene, b_c, b_params, uv):
    """The gathered BSDF rows ``b_params`` [N, 16] with the textured
    reflectance at the hit uv [N, 2] in place of [0:3], for the lanes
    whose BSDF ``b_c`` [N] (clamped rows) has a texture.  Callers gate on
    ``scene.has_textures``, so an untextured scene runs as before."""
    t_idx = scene.bsdf_tex[b_c]
    rgb = eval_bitmap(scene.tex_data, scene.tex_hw, t_idx, uv)
    refl = torch.where((t_idx >= 0)[:, None], rgb, b_params[:, 0:3])
    return torch.cat([refl, b_params[:, 3:]], 1)

"""Plain PyTorch reference of the ``cbox_pol`` configuration's Stokes image.

A polarized path tracer of the Mitsuba ``stokes`` integrator wrapping
``path`` on the scene file the configuration names: triangles (OBJ) and
spheres, diffuse, smooth dielectric and smooth (mirror or eta / k)
conductor BSDFs, area luminaires sampled by next-event estimation with the
power heuristic, Russian roulette from ``rr_depth``, a box, tent or
gaussian reconstruction filter.  Every lane carries T (3, 4, 4, N), the
camera-side Mueller matrix per rgb channel, and the reference basis of its
Stokes vector; at each scattering event the basis is turned onto the
scattering plane's s axis and the event's Mueller matrix is chained onto
T; each emission adds its radiance through T's first column.

It is a frozen copy of the arithmetic of the port's plain Stokes film
route (sample streams keyed on (seed, tile, lane) by SplitMix32, one
stream a sample; a bounce's draws in the same order), cut to what this
scene class uses.  It reads the raw scene files itself, imports nothing of
the port, and computes any set of pixels: each pixel's value takes the
samples of its filter footprint, so a sample of pixels costs a sample of
the work.  The 4 x 4 products are written out element by element, so no
matrix multiply (and no TF32) enters.

Where it departs from Mitsuba's published Stokes mode (as the port does):

* rgb: eta and k of a conductor and the reflectances are three rgb
  values, not spectra, and each channel carries its own Mueller chain;
* the depth cap: a path with no ``max_depth`` runs 16 bounces at most;
* frames: the output basis is the camera's x axis projected
  perpendicular to each primary ray; at a vertex the s axis is
  normalize(cross(-wo, -wi)) (the degenerate case falls back to a fixed
  horizontal basis), and cos 2phi, sin 2phi of the turn come from dot and
  cross products, not from Mitsuba's ``rotate_mueller_basis``;
* weights: each event's Mueller matrix is normalized by its M00 and
  scaled by the scalar sampling weight, so Stokes-I is the scalar
  estimate; diffuse scattering and its light sample depolarize (T's first
  column times the scalar weight); dielectric transmission takes the real
  Fresnel amplitudes, reflection the complex form (total internal
  reflection included); emitters are unpolarized;
* Russian roulette on the scalar throughput's largest channel over
  eta^2, as the scalar ``path`` integrator.

``dtype`` runs every floating-point operation in that type (float32 as
the configuration states; bfloat16 is the benchmark's control).
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from plainmath import (M32, add, clamp_abs, cross, default_dtype, dot, f32, frame, normalize,
                      rng_init, rng_next, safe_sqrt, scale, to_local, to_world, where3)

INV_PI = 1.0 / math.pi
BIG = 1e8
DEPTH_CAP = 16
DIFFUSE, DIELECTRIC, CONDUCTOR = 0, 1, 2
TRI, SPHERE = 0, 1
IOR = {"bk7": 1.5046, "air": 1.000277, "water": 1.3330, "diamond": 2.419}
FILTER_RADIUS = {"box": 0, "tent": 1, "gaussian": 2}
GAUSS_TAIL = float(np.float32(np.exp(-8.0)))
# the values a sample splats: (I, Q, U, V) x (r, g, b), row-major
N_STOKES = 12


# ---------------------------------------------------------------------------
# the scene file
# ---------------------------------------------------------------------------

def _look_at(origin, target, up):
    origin, target, up = (np.asarray(v, np.float64) for v in (origin, target, up))
    d = target - origin
    d = d / max(np.linalg.norm(d), 1e-12)
    left = np.cross(up / max(np.linalg.norm(up), 1e-12), d)
    left = left / max(np.linalg.norm(left), 1e-12)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(d, left), d, origin
    return m


def _vec(s):
    return [float(x) for x in s.replace(",", " ").split()]


def _props(el, defaults):
    """name -> value of a plugin's float / integer / rgb / string / point
    children ($name resolved against the scene's defaults)."""
    out = {}
    for ch in el:
        name = ch.get("name")
        raw = ch.get("value")
        if raw is not None and raw.startswith("$"):
            raw = defaults[raw[1:]]
        if ch.tag in ("float", "integer"):
            out[name] = float(raw) if ch.tag == "float" else int(raw)
        elif ch.tag == "rgb":
            out[name] = _vec(raw)
        elif ch.tag == "string":
            out[name] = raw
        elif ch.tag == "point":
            out[name] = [float(ch.get(k)) for k in "xyz"]
    return out


def _bsdf(el, defaults):
    kind = el.get("type")
    p = _props(el, defaults)
    if kind == "diffuse":
        return (DIFFUSE, dict(refl=[f32(x) for x in p.get("reflectance", [0.5] * 3)]))
    if kind == "dielectric":
        i_ior, e_ior = p.get("int_ior", "bk7"), p.get("ext_ior", "air")
        i_ior = IOR[i_ior] if isinstance(i_ior, str) else i_ior
        e_ior = IOR[e_ior] if isinstance(e_ior, str) else e_ior
        return (DIELECTRIC, dict(eta=f32(f32(i_ior) / max(f32(e_ior), 1e-6))))
    if kind == "conductor":
        spec = [f32(x) for x in p.get("specular_reflectance", [1.0] * 3)]
        if "eta" in p:
            return (CONDUCTOR, dict(mirror=False, eta=[f32(x) for x in p["eta"]],
                                    k=[f32(x) for x in p.get("k", [1.0] * 3)], spec=spec))
        return (CONDUCTOR, dict(mirror=True, eta=[0.0] * 3, k=[1.0] * 3, spec=spec))
    raise ValueError(f"the reference has no BSDF {kind!r}")


def _read_obj(path):
    v, faces = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                v.append([float(x) for x in tok[1:4]])
            elif tok[0] == "f":
                idx = [int(s.split("/")[0]) for s in tok[1:]]
                idx = [i - 1 if i > 0 else len(v) + i for i in idx]
                faces += [(idx[0], idx[k], idx[k + 1]) for k in range(1, len(idx) - 1)]
    return np.asarray(v, np.float32), np.asarray(faces, np.int64)


def load_scene(path, **overrides):
    """The scene file as plain data: camera (with its x axis, the Stokes
    output basis), prims (triangles first, in file order, then spheres),
    their BSDFs and emitters, the luminaires.  ``overrides`` set the file's
    defaults (e.g. ``res``)."""
    root = ET.parse(path).getroot()
    base = os.path.dirname(os.path.abspath(path))
    defaults = {d.get("name"): d.get("value") for d in root.findall("default")}
    defaults.update({k: str(v) for k, v in overrides.items()})
    named = {b.get("id"): _bsdf(b, defaults) for b in root.findall("bsdf")}
    sc = dict(max_depth=DEPTH_CAP, rr_depth=5, hide_emitters=False)
    outer = root.find("integrator")
    integ = None if outer is None or outer.get("type") != "stokes" else outer.find("integrator")
    if integ is None or integ.get("type") != "path":
        raise ValueError("the reference renders stokes scenes wrapping path")
    ip = _props(integ, defaults)
    if ip.get("max_depth", DEPTH_CAP) > 0:
        sc["max_depth"] = min(int(ip.get("max_depth", DEPTH_CAP)), DEPTH_CAP)
    sc["rr_depth"] = int(ip.get("rr_depth", 5))
    sc["hide_emitters"] = bool(ip.get("hide_emitters", False))
    sen = root.find("sensor")
    sp = _props(sen, defaults)
    film = sen.find("film")
    fp = _props(film, defaults)
    W, H = int(fp.get("width", 768)), int(fp.get("height", 576))
    la = sen.find("transform").find("lookat")
    m = _look_at(_vec(la.get("origin")), _vec(la.get("target")), _vec(la.get("up")))
    tan_half = math.tan(math.radians(float(sp.get("fov", 34.0))) * 0.5)
    if sp.get("fov_axis", "x") != "x":
        raise ValueError("the reference takes fov_axis x")
    sc["camera"] = dict(R=[[f32(x) for x in m[i, :3]] for i in range(3)],
                        origin=[f32(x) for x in m[:3, 3]], x_axis=[f32(x) for x in m[:3, 0]],
                        W=W, H=H, tfx=f32(tan_half), tfy=f32(tan_half / (W / H)),
                        near=f32(sp.get("near_clip", 1e-2)), far=f32(sp.get("far_clip", 1e4)))
    rf = film.find("rfilter")
    sc["radius"] = FILTER_RADIUS[rf.get("type") if rf is not None else "gaussian"]
    tris, spheres, lights = [], [], []
    for sh in root.findall("shape"):
        ref = sh.find("ref")
        b_el = sh.find("bsdf")
        bsdf = named[ref.get("id")] if ref is not None else _bsdf(b_el, defaults)
        em = sh.find("emitter")
        emitter = -1
        if em is not None:
            if em.get("type") != "area" or sh.get("type") != "obj":
                raise ValueError("the reference takes area luminaires on meshes")
            emitter = len(lights)
        p = _props(sh, defaults)
        if sh.get("type") == "obj":
            if sh.find("transform") is not None:
                raise ValueError("the reference takes meshes in world space")
            v, faces = _read_obj(os.path.join(base, p["filename"]))
            p0, p1, p2 = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
            e1, e2 = (p1 - p0).astype(np.float32), (p2 - p0).astype(np.float32)
            first = len(tris)
            for i in range(faces.shape[0]):
                ng = np.cross(e1[i], e2[i])
                ng = ng / max(np.linalg.norm(ng), 1e-20)
                tris.append(dict(kind=TRI, data=[p0[i], e1[i], e2[i], ng], bsdf=bsdf,
                                 emitter=emitter))
            if emitter >= 0:
                areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
                total = float(areas.sum())
                cdf = (np.cumsum(areas) / max(total, 1e-20)).astype(np.float32)
                lights.append(dict(radiance=[f32(x) for x in _props(em, defaults)["radiance"]],
                                   inv_area=f32(1.0 / total),
                                   tris=[(first + j, float(cdf[j])) for j in range(len(cdf))]))
        elif sh.get("type") == "sphere":
            c, r = np.asarray(p.get("center", [0.0] * 3), np.float32), float(
                np.float32(p.get("radius", 1.0)))
            spheres.append(dict(kind=SPHERE, data=[c, r], bsdf=bsdf, emitter=emitter))
        else:
            raise ValueError(f"the reference has no shape {sh.get('type')!r}")
    sc["prims"] = tris + spheres
    sc["lights"] = lights
    return sc


# ---------------------------------------------------------------------------
# the polarized path tracer, flat (N,) tensors a component, T (3, 4, 4, N)
# ---------------------------------------------------------------------------

class Scene:
    """Constants (float32 values as Python floats) and per-prim attribute
    rows of a loaded scene, on one device."""

    ATTR = ("btype", "r", "g", "b", "eta", "ce0", "ce1", "ce2", "ck0", "ck1", "ck2",
            "mirror", "s0", "s1", "s2", "em")

    def __init__(self, sc, device, dtype):
        self.sc, self.dev, self.dt = sc, device, dtype
        cam = sc["camera"]
        self.W, self.H = cam["W"], cam["H"]
        self.R, self.org, self.cam_x = cam["R"], cam["origin"], cam["x_axis"]
        self.tfx, self.tfy = cam["tfx"], cam["tfy"]
        self.inv_w, self.inv_h = f32(1.0 / self.W), f32(1.0 / self.H)
        self.near, self.far_near = cam["near"], f32(cam["far"] - cam["near"])
        self.has_far = cam["far"] < 1e8
        self.max_depth, self.rr_depth = sc["max_depth"], sc["rr_depth"]
        self.hide_emitters = sc["hide_emitters"]
        self.radius = sc["radius"]
        n_l = len(sc["lights"])
        self.n_lights = n_l
        self.inv_nl, self.nl, self.nl_m1 = f32(1.0 / max(n_l, 1)), f32(n_l), f32(n_l - 1)
        self.prims = []
        for p in sc["prims"]:
            if p["kind"] == TRI:
                self.prims.append((TRI, [[f32(x) for x in v] for v in p["data"]]))
            else:
                c, r = p["data"]
                self.prims.append((SPHERE, [f32(c[0]), f32(c[1]), f32(c[2]), f32(r * r),
                                            f32(1.0 / r)]))
        rows = []
        for p in sc["prims"] + [None]:
            row = dict(btype=-1.0, r=0.0, g=0.0, b=0.0, eta=1.0, ce0=0.0, ce1=0.0, ce2=0.0,
                       ck0=1.0, ck1=1.0, ck2=1.0, mirror=0.0, s0=1.0, s1=1.0, s2=1.0, em=-1.0)
            if p is not None:
                bt, prm = p["bsdf"]
                row["btype"], row["em"] = float(bt), float(p["emitter"])
                if bt == DIFFUSE:
                    row["r"], row["g"], row["b"] = prm["refl"]
                elif bt == DIELECTRIC:
                    row["eta"] = prm["eta"]
                else:
                    row["mirror"] = 1.0 if prm["mirror"] else 0.0
                    if not prm["mirror"]:
                        row["ce0"], row["ce1"], row["ce2"] = prm["eta"]
                        row["ck0"], row["ck1"], row["ck2"] = prm["k"]
                    row["s0"], row["s1"], row["s2"] = prm["spec"]
            rows.append([row[k] for k in self.ATTR])
        self.attr = torch.tensor(rows, dtype=torch.float32, device=device).to(dtype)
        self.lights = []
        for li in sc["lights"]:
            tris, prev = [], 0.0
            for tp, cdf_hi in li["tris"]:
                tris.append((self.prims[tp][1], f32(prev), f32(cdf_hi + 1e-9)))
                prev = cdf_hi
            self.lights.append((li["radiance"], li["inv_area"], tris))

    def attrs(self, prim_f):
        idx = torch.where(prim_f >= 0.0, prim_f, float(len(self.prims))).to(torch.int64)
        rows = self.attr[idx]
        return {k: rows[:, i] for i, k in enumerate(self.ATTR)}

    def col3(self, vals):
        """Three per-channel constants as a (3, 1) tensor."""
        return torch.tensor(vals, dtype=torch.float32, device=self.dev).to(self.dt)[:, None]


def _rdiv(c, x):
    return torch.full_like(x, c) / x


def _mis(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)
    return torch.where(pdf_a > 0.0, w, 0.0)


def sweep(S: Scene, o, d, tmin, tmax, any_hit=False):
    """Closest hit over every prim: (t, prim index as a float or -1,
    normal); with ``any_hit`` the hit mask alone."""
    zeros = torch.zeros_like(o[0])
    best_t = torch.full_like(o[0], BIG)
    best_prim = zeros - 1.0
    n = (zeros, zeros, zeros)
    for pi, (kind, q) in enumerate(S.prims):
        if kind == TRI:
            p0, e1, e2, ng = q
            pv = cross(d, e2)
            det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
            inv = 1.0 / clamp_abs(det, 1e-9)
            tv = (o[0] - p0[0], o[1] - p0[1], o[2] - p0[2])
            u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
            qv = cross(tv, e1)
            v = dot(d, qv) * inv
            t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv
            ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
            pn = (ng[0] + zeros, ng[1] + zeros, ng[2] + zeros)
        else:
            cx, cy, cz, r2, inv_r = q
            oc = (o[0] - cx, o[1] - cy, o[2] - cz)
            b2 = dot(oc, d)
            cc = dot(oc, oc) - r2
            disc = b2 * b2 - cc * dot(d, d)
            sq = safe_sqrt(disc)
            a_ = dot(d, d)
            t0 = (-b2 - sq) / a_
            t1 = (-b2 + sq) / a_
            t = torch.where((t0 > tmin) & (t0 < tmax), t0, t1)
            ok = (disc >= 0.0) & (t > tmin) & (t < tmax)
            pn = ((o[0] + t * d[0] - cx) * inv_r, (o[1] + t * d[1] - cy) * inv_r,
                  (o[2] + t * d[2] - cz) * inv_r)
        closer = ok & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_prim = torch.where(closer, float(pi), best_prim)
        n = where3(closer, pn, n)
    if any_hit:
        return best_prim >= 0.0
    return best_t, best_prim, n


def _fres_cond(cos_f, c_eta, c_k, is_mirror):
    """The scalar conductor Fresnel reflectance per channel (mirror: 1)."""
    c2 = cos_f * cos_f
    s2 = 1.0 - c2
    out = []
    for ch in range(3):
        e2_ = c_eta[ch] * c_eta[ch]
        k2_ = c_k[ch] * c_k[ch]
        t0_ = e2_ - k2_ - s2
        a2b2 = safe_sqrt(t0_ * t0_ + 4.0 * e2_ * k2_)
        t1_ = a2b2 + c2
        a_ = safe_sqrt(torch.clamp(0.5 * (a2b2 + t0_), min=0.0))
        t2_ = 2.0 * a_ * cos_f
        rs_ = (t1_ - t2_) / torch.clamp(t1_ + t2_, min=1e-12)
        t3_ = c2 * a2b2 + s2 * s2
        t4_ = t2_ * s2
        rp_ = rs_ * (t3_ - t4_) / torch.clamp(t3_ + t4_, min=1e-12)
        out.append(torch.where(is_mirror, 1.0, 0.5 * (rs_ + rp_)))
    return tuple(out)


def _perp_basis(w, ref):
    """ref projected perpendicular to the unit w and normalized; where that
    is degenerate, a fixed horizontal basis cross((ax, 1 - ax, 0), w)."""
    dp = dot(w, ref)
    proj = (ref[0] - w[0] * dp, ref[1] - w[1] * dp, ref[2] - w[2] * dp)
    ln2 = dot(proj, proj)
    ax = torch.where(torch.abs(w[0]) > 0.9, 0.0, 1.0)
    fb = normalize(cross((ax, 1.0 - ax, torch.zeros_like(ax)), w))
    inv = 1.0 / torch.sqrt(torch.clamp(ln2, min=1e-24))
    return where3(ln2 > 1e-12, scale(proj, inv), fb)


def _cdiv(ar, ai, br, bi):
    """(ar + i ai) / (br + i bi) as (re, im)."""
    den = torch.clamp(br * br + bi * bi, min=1e-30)
    return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den


def _fres_pol(cos_f, e_re, e_im):
    """The polarization terms of Fresnel reflection for the complex
    relative IOR e_re + i e_im at |cos_f|: (a, b, c, s), a = (|rs|^2 +
    |rp|^2) / 2, b = (|rs|^2 - |rp|^2) / 2, c + i s = rs conj(rp)."""
    c = torch.abs(cos_f)
    sin2 = torch.clamp(1.0 - c * c, min=0.0)
    zr = e_re * e_re - e_im * e_im - sin2
    zi = 2.0 * e_re * e_im
    mag = torch.sqrt(torch.clamp(zr * zr + zi * zi, min=0.0))
    u = torch.sqrt(torch.clamp(0.5 * (mag + zr), min=0.0))
    v = torch.sqrt(torch.clamp(0.5 * (mag - zr), min=0.0))
    rs_r, rs_i = _cdiv(c - u, -v, c + u, v)
    e2r = (zr + sin2) * c
    e2i = zi * c
    rp_r, rp_i = _cdiv(e2r - u, e2i - v, e2r + u, e2i + v)
    Rs = rs_r * rs_r + rs_i * rs_i
    Rp = rp_r * rp_r + rp_i * rp_i
    return (0.5 * (Rs + Rp), 0.5 * (Rs - Rp), rs_r * rp_r + rs_i * rp_i,
            rs_i * rp_r - rs_r * rp_i)


def _mueller_chain(T, basis, p_B, p_A, M6):
    """T <- T R(phi) M, M = [[m00, m01, 0, 0], [m10, m11, 0, 0], [0, 0, mc,
    ms], [0, 0, -ms, mc]] per channel from M6 = (m00, m01, m10, m11, mc,
    ms), each (3, N); phi turns the carried basis onto the scattering
    plane's s axis around p_B (toward the camera).  Returns (T, basis)."""
    s_raw = cross(p_A, p_B)
    ln2 = dot(s_raw, s_raw)
    degen = ln2 < 1e-12
    inv = 1.0 / torch.sqrt(torch.clamp(ln2, min=1e-24))
    s_axis = where3(degen, _perp_basis(p_B, basis), scale(s_raw, inv))
    cs = dot(s_axis, basis)
    sn = dot(cross(s_axis, basis), p_B)
    n2 = torch.clamp(cs * cs + sn * sn, min=1e-20)
    C2 = (cs * cs - sn * sn) / n2
    S2 = 2.0 * cs * sn / n2
    m00, m01, m10, m11, mc, ms = (m[:, None] for m in M6)
    t0, t1, t2, t3 = T[:, :, 0], T[:, :, 1], T[:, :, 2], T[:, :, 3]
    rot_a = t1 * C2 - t2 * S2
    rot_b = t1 * S2 + t2 * C2
    T_new = torch.stack([t0 * m00 + rot_a * m10, t0 * m01 + rot_a * m11,
                         rot_b * mc - t3 * ms, rot_b * ms + t3 * mc], 2)
    return T_new, where3(degen, _perp_basis(p_A, s_axis), s_axis)


def _add_emission(S, T, w, f=1.0):
    """Unpolarized emission: S[i][ch] += T[ch][i][0] w[ch] f."""
    return S + T[:, :, 0].transpose(0, 1) * w * f


def _camera_ray(S: Scene, idx, jx, jy):
    py = (idx // S.W).to(jx.dtype)
    px = (idx % S.W).to(jx.dtype)
    u = (px + jx) * S.inv_w
    v = (py + jy) * S.inv_h
    cx = (2.0 * u - 1.0) * S.tfx
    cy = (1.0 - 2.0 * v) * S.tfy
    R = S.R
    d = normalize((R[0][0] * cx + R[0][1] * cy + R[0][2],
                    R[1][0] * cx + R[1][1] * cy + R[1][2],
                    R[2][0] * cx + R[2][1] * cy + R[2][2]))
    t_near = S.near * torch.sqrt(cx * cx + cy * cy + 1.0)
    og = S.org
    return (og[0] + t_near * d[0], og[1] + t_near * d[1], og[2] + t_near * d[2]), d


def _bounce(S: Scene, depth, st):
    """One bounce: closest hit, emitter hit with MIS, one light sample
    with a shadow ray, BSDF sampling, the event's Mueller matrix chained
    onto T, Russian roulette."""
    dt = S.dt
    rng, o, d, thr = st["rng"], st["o"], st["d"], st["thr"]
    T, Sv, basis = st["T"], st["S"], st["basis"]
    active, prev_pdf, prev_delta = st["active"], st["prev_pdf"], st["prev_delta"]
    eta_scale = st["eta_scale"]
    zeros = torch.zeros_like(o[0])
    t, prim_f, n = sweep(S, o, d, 1e-4, BIG)
    n_g = n
    hit = (prim_f >= 0.0) & active
    if S.has_far and depth == 0:
        R = S.R
        dz = d[0] * R[0][2] + d[1] * R[1][2] + d[2] * R[2][2]
        hit = hit & (t <= _rdiv(S.far_near, torch.clamp(dz, min=1e-9)))
    n_closest = st["n_closest"] + torch.where(active, 1.0, 0.0)
    n_any = st["n_any"]
    n_mueller = st["n_mueller"] + torch.where(hit, 1.0, 0.0)
    show_em = not (depth == 0 and S.hide_emitters)
    p_hit = add(o, scale(d, torch.where(hit, t, 0.0)))
    wi = scale(d, -1.0)
    cos_l = dot(n, wi)
    at = S.attrs(prim_f)

    if S.lights and show_em:
        for e, (rad, inv_area, _) in enumerate(S.lights):
            m = hit & (at["em"] == float(e)) & (cos_l > 0.0)
            pdf_light = inv_area * t * t / torch.clamp(cos_l, min=1e-6) * S.inv_nl
            w_b = torch.where(prev_delta, 1.0, _mis(prev_pdf, pdf_light))
            wfac = torch.where(m, w_b, 0.0)
            Sv = _add_emission(Sv, T, S.col3(rad), wfac)

    btype = at["btype"]
    refl = (at["r"], at["g"], at["b"])
    eta_rel = at["eta"]
    c_eta = (at["ce0"], at["ce1"], at["ce2"])
    c_k = (at["ck0"], at["ck1"], at["ck2"])
    is_mirror = at["mirror"] > 0.0
    spec_c = (at["s0"], at["s1"], at["s2"])

    s_fr, t_fr = frame(n)
    wi_l = to_local(n, s_fr, t_fr, wi)
    cos_i = wi_l[2]
    u = []
    for _ in range(9):
        rng, ui = rng_next(rng, dt)
        u.append(ui)
    u0, u1, u2, u3, u4, u5, u6 = u[:7]
    is_diffuse = btype == float(DIFFUSE)

    if S.n_lights > 0 and depth + 2 <= S.max_depth:
        li_f = torch.clamp(torch.floor(u0 * S.nl), max=S.nl_m1)
        lp = ln = l_rad = (zeros, zeros, zeros)
        pdf_a = zeros
        for light_idx, (rad, inv_area, tris) in enumerate(S.lights):
            m_l = li_f == float(light_idx)
            for (p0, e1, e2, ng), lo, hi in tris:
                m_t = m_l & (u1 >= lo) & (u1 < hi)
                st_ = safe_sqrt(1.0 - u2)
                ub = 1.0 - st_
                vb = st_ * u3
                cand = (p0[0] + ub * e1[0] + vb * e2[0], p0[1] + ub * e1[1] + vb * e2[1],
                        p0[2] + ub * e1[2] + vb * e2[2])
                lp = where3(m_t, cand, lp)
                ln = where3(m_t, [x + zeros for x in ng], ln)
            l_rad = where3(m_l, [x + zeros for x in rad], l_rad)
            pdf_a = torch.where(m_l, inv_area, pdf_a)
        to_l = (lp[0] - p_hit[0], lp[1] - p_hit[1], lp[2] - p_hit[2])
        dist2 = torch.clamp(dot(to_l, to_l), min=1e-20)
        dist = torch.sqrt(dist2)
        wl = scale(to_l, 1.0 / dist)
        cos_sl = dot(n, wl)
        cos_ll = -dot(wl, ln)
        is_delta_l = pdf_a == 0.0
        pdf_nee = torch.where(is_delta_l, S.inv_nl,
                              pdf_a * dist2 / torch.clamp(cos_ll, min=1e-6) * S.inv_nl)
        nee_f = scale(refl, INV_PI * torch.clamp(cos_sl, min=0.0))
        pdf_bsdf_l = torch.clamp(cos_sl, min=0.0) * INV_PI
        nee_ok = hit & is_diffuse & (cos_i > 0.0) & (cos_sl > 0.0)
        nee_ok = nee_ok & (is_delta_l | (cos_ll > 1e-6))
        shadow_o = add(p_hit, scale(n_g, 1e-4 * torch.where(dot(n_g, wl) >= 0, 1.0, -1.0)))
        occ = sweep(S, shadow_o, wl, 1e-4, dist * (1.0 - 1e-3), any_hit=True)
        vis = nee_ok & ~occ
        n_any = n_any + torch.where(nee_ok, 1.0, 0.0)
        w_nee = torch.where(is_delta_l, 1.0, _mis(pdf_nee, pdf_bsdf_l))
        scale_area = w_nee / torch.clamp(pdf_nee, min=1e-20)
        scale_delta = _rdiv(S.nl, dist2)
        scf = torch.where(vis, torch.where(is_delta_l, scale_delta, scale_area), 0.0)
        # a diffuse light sample depolarizes: (T R M_dep)[:, 0] = T[:, 0] w
        nee_w = torch.stack([nee_f[c] * l_rad[c] * scf for c in range(3)])
        Sv = _add_emission(Sv, T, nee_w)

    # diffuse: cosine hemisphere through the concentric disk
    sx_ = 2.0 * u4 - 1.0
    sy_ = 2.0 * u5 - 1.0
    is_zero = (sx_ == 0.0) & (sy_ == 0.0)
    quad_x = torch.abs(sx_) > torch.abs(sy_)
    r_d = torch.where(quad_x, sx_, sy_)
    safe_sx = torch.where(sx_ == 0.0, 1.0, sx_)
    safe_sy = torch.where(sy_ == 0.0, 1.0, sy_)
    phi_d = torch.where(quad_x, (math.pi / 4.0) * (sy_ / safe_sx),
                        (math.pi / 2.0) - (math.pi / 4.0) * (sx_ / safe_sy))
    phi_d = torch.where(is_zero, 0.0, phi_d)
    dx_d = r_d * torch.cos(phi_d)
    dy_d = r_d * torch.sin(phi_d)
    dz_d = safe_sqrt(1.0 - dx_d * dx_d - dy_d * dy_d)
    sign_i = torch.where(cos_i == 0.0, 1.0, torch.sign(cos_i))
    wo_diff = (dx_d * sign_i, dy_d * sign_i, dz_d * sign_i)
    pdf_diff = torch.abs(dz_d) * INV_PI

    # smooth dielectric: a Fresnel pick of reflection or refraction
    outside = cos_i >= 0.0
    eta_it = torch.where(outside, eta_rel, 1.0 / eta_rel)
    eta_ti = 1.0 / eta_it
    c2t = 1.0 - eta_ti * eta_ti * (1.0 - cos_i * cos_i)
    abs_ci = torch.abs(cos_i)
    ct = safe_sqrt(c2t)
    rs = (abs_ci - eta_it * ct) / torch.clamp(abs_ci + eta_it * ct, min=1e-9)
    rp = (eta_it * abs_ci - ct) / torch.clamp(eta_it * abs_ci + ct, min=1e-9)
    F = 0.5 * (rs * rs + rp * rp)
    F = torch.where(c2t <= 0.0, 1.0, F)
    pick_refl = u6 <= F
    ct_signed = torch.where(cos_i >= 0.0, -ct, ct)
    wo_die = where3(pick_refl, (-wi_l[0], -wi_l[1], wi_l[2]),
                    (-eta_ti * wi_l[0], -eta_ti * wi_l[1], ct_signed))
    w_die_s = torch.where(pick_refl, 1.0, eta_ti * eta_ti)
    eta_fac = torch.where(pick_refl, 1.0, eta_it)

    # smooth conductor: the mirror direction, Fresnel at |cos_i|
    wo_con = (-wi_l[0], -wi_l[1], wi_l[2])
    cos_f = torch.abs(cos_i)
    Fc = _fres_cond(cos_f, c_eta, c_k, is_mirror)
    Fc = (Fc[0] * spec_c[0], Fc[1] * spec_c[1], Fc[2] * spec_c[2])

    is_die = btype == float(DIELECTRIC)
    is_con = btype == float(CONDUCTOR)
    wo_l = where3(is_diffuse, wo_diff, where3(is_die, wo_die, wo_con))
    pdf_s = torch.where(is_diffuse, pdf_diff,
                        torch.where(is_die, torch.where(pick_refl, F, 1.0 - F), 1.0))
    delta_s = ~is_diffuse
    valid_s = (is_diffuse & (cos_i > 0.0)) | (is_con & (cos_i > 0.0)) | is_die
    w_s = where3(is_diffuse, refl, where3(is_die, (w_die_s, w_die_s, w_die_s), Fc))
    eta_s = torch.where(is_die, eta_fac, 1.0)

    d_new = normalize(to_world(n, s_fr, t_fr, wo_l))
    off_sign = torch.where(dot(n_g, d_new) >= 0.0, 1.0, -1.0)
    o_new = add(p_hit, scale(n_g, 1e-4 * off_sign))
    thr_new = (thr[0] * w_s[0], thr[1] * w_s[1], thr[2] * w_s[2])
    alive = hit & valid_s & (pdf_s > 0.0)
    eta_scale = eta_scale * eta_s
    thr_max = torch.maximum(thr_new[0], torch.maximum(thr_new[1], thr_new[2]))
    alive = alive & (thr_max > 0.0)

    # the event's Mueller matrix per channel, M00 the scalar weight w_s and
    # only the lobe's polarization ratios b/a, c/a, s/a on top: dielectric
    # reflection in the complex form (total internal reflection included),
    # transmission in the real one; diffuse depolarizes
    a_dr, b_dr, c_dr, s_dr = _fres_pol(cos_i, eta_it, zeros)
    inv_adr = 1.0 / torch.clamp(a_dr, min=1e-12)
    ts_ = 2.0 * abs_ci / torch.clamp(abs_ci + eta_it * ct, min=1e-9)
    tp_ = 2.0 * abs_ci / torch.clamp(eta_it * abs_ci + ct, min=1e-9)
    Ts_, Tp_ = ts_ * ts_, tp_ * tp_
    inv_adt = 1.0 / torch.clamp(0.5 * (Ts_ + Tp_), min=1e-12)
    rb_die = torch.where(pick_refl, b_dr * inv_adr, 0.5 * (Ts_ - Tp_) * inv_adt)
    rc_die = torch.where(pick_refl, c_dr * inv_adr, ts_ * tp_ * inv_adt)
    rs_die = torch.where(pick_refl, s_dr * inv_adr, 0.0)
    specf = torch.where(is_die | is_con, 1.0, 0.0)
    M6 = [[] for _ in range(6)]
    for ch in range(3):
        a_c, b_c, c_c, s_c = _fres_pol(cos_f, torch.where(is_mirror, 1e6, c_eta[ch]),
                                       torch.where(is_mirror, 1e8, c_k[ch]))
        inv_ac = 1.0 / torch.clamp(a_c, min=1e-12)
        rb = torch.where(is_die, rb_die, b_c * inv_ac)
        rc = torch.where(is_die, rc_die, c_c * inv_ac)
        rs_ = torch.where(is_die, rs_die, s_c * inv_ac)
        w_ch = w_s[ch]
        for k, m in enumerate((w_ch, w_ch * rb * specf, w_ch * rb * specf, w_ch * specf,
                               w_ch * (rc * specf), w_ch * rs_ * specf)):
            M6[k].append(m)
    T_new, basis_new = _mueller_chain(T, basis, scale(d, -1.0), scale(d_new, -1.0),
                                      [torch.stack(m) for m in M6])

    if depth >= S.rr_depth:  # roulette on the intensity over eta^2
        rng, u_rr = rng_next(rng, dt)
        inv_e2 = 1.0 / torch.clamp(eta_scale * eta_scale, min=1e-12)
        q = torch.clamp(thr_max * inv_e2, max=0.95)
        survive = u_rr < q
        inv_q = 1.0 / torch.clamp(q, min=1e-12)
        thr_new = tuple(torch.where(survive, x * inv_q, 0.0) for x in thr_new)
        alive = alive & survive
        T_new = T_new * torch.where(survive, inv_q, 0.0)
    return dict(rng=rng, o=where3(alive, o_new, o), d=where3(alive, d_new, d),
                thr=where3(alive, thr_new, (zeros, zeros, zeros)), active=alive,
                prev_pdf=pdf_s, prev_delta=delta_s, eta_scale=eta_scale,
                T=T_new * torch.where(alive, 1.0, 0.0), S=Sv,
                basis=where3(alive, basis_new, basis),
                n_closest=n_closest, n_any=n_any, n_mueller=n_mueller)


OUT = ("S", "n_closest", "n_any", "n_mueller")


def _lanes(st, keep):
    """The state of the lanes ``keep`` (indices of the last dimension)."""
    return {k: tuple(x[..., keep] for x in v) if isinstance(v, tuple) else v[..., keep]
            for k, v in st.items()}


def trace(S: Scene, pix, stream, tile_lanes):
    """Trace one sample a lane: pixel index ``pix`` and sample stream
    ``stream`` (int64 tensors).  Returns (S (4, 3, N): I, Q, U, V by rgb,
    jx, jy, per lane its closest-hit sweeps, shadow sweeps and scattering
    events with a Mueller matrix).  A lane whose path has ended adds
    nothing more, so each bounce runs on the live lanes alone; every
    operation is elementwise, so a lane's arithmetic is the same."""
    rng = rng_init(stream, pix // tile_lanes, pix % tile_lanes)
    rng, jx = rng_next(rng, S.dt)
    rng, jy = rng_next(rng, S.dt)
    o, d = _camera_ray(S, pix, jx, jy)
    n = pix.shape[0]
    zeros = torch.zeros(pix.shape, dtype=S.dt, device=pix.device)
    ones = zeros + 1.0
    T = torch.zeros((3, 4, 4, n), dtype=S.dt, device=pix.device)
    for i in range(4):
        T[:, i, i] = 1.0
    st = dict(rng=rng, o=o, d=d, thr=(ones, ones, ones), active=ones > 0.0, prev_pdf=ones,
              prev_delta=ones > 0.0, eta_scale=ones, T=T,
              S=torch.zeros((4, 3, n), dtype=S.dt, device=pix.device),
              basis=_perp_basis(scale(d, -1.0), [x + zeros for x in S.cam_x]),
              n_closest=zeros, n_any=zeros, n_mueller=zeros)
    out = {k: st[k].clone() for k in OUT}
    ids = torch.arange(n, device=pix.device)
    for depth in range(S.max_depth):
        st = _bounce(S, depth, st)
        # two reads of the device a bounce: the indices of the lanes that
        # go on and of those whose path ended
        keep, done = st["active"].nonzero()[:, 0], (~st["active"]).nonzero()[:, 0]
        for k in OUT:
            out[k][..., ids[done]] = st[k][..., done]
        ids = ids[keep]
        st = _lanes(st, keep)
        if ids.numel() == 0:
            break
    for k in OUT:
        out[k][..., ids] = st[k]
    return out["S"], jx, jy, (out["n_closest"], out["n_any"], out["n_mueller"])


def _w1d(radius, d, j):
    x = (d + 0.5) - j
    if radius == 1:
        return torch.clamp(1.0 - torch.abs(x), min=0.0)
    g = torch.exp(-2.0 * x * x) - GAUSS_TAIL
    return torch.where(torch.abs(x) <= 2.0, torch.clamp(g, min=0.0), 0.0)


def render_seed(seed):
    """The first sample stream of an image rendered with ``seed``: the
    stream of sample g is (seed * 100003 + g) mod 2^32."""
    return (seed * 100003) & M32


def image_pixels(scene_path, seed, spp, tile_lanes, pixels, device, dtype=torch.float32,
                 lanes_per_call=1 << 21, overrides=None):
    """The developed (H, W, 4, 3) Stokes image's values at the flat pixel
    indices ``pixels`` [K] of a render with ``seed`` and ``spp`` samples a
    pixel: [K, 4, 3], float64 for float32 (every sample of each pixel's
    filter footprint, weighted and summed in float64), ``dtype`` otherwise.
    Also returns the work of the samples traced at those pixels (their own,
    not their neighbours'): ``closest`` and ``any`` (closest-hit and shadow
    sweeps; their sum is the ray count) and ``mueller`` (scattering events
    at which a Mueller matrix is chained), so counts over a partition of
    the image add up to the image's."""
    with default_dtype(dtype):
        return _image_pixels(load_scene(scene_path, **(overrides or {})), seed, spp, tile_lanes,
                             pixels, device, dtype, lanes_per_call)


def _image_pixels(sc, seed, spp, tile_lanes, pixels, device, dtype, lanes_per_call):
    S = Scene(sc, device, dtype)
    W, H, r = S.W, S.H, S.radius
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    K = pixels.shape[0]
    acc_t = torch.float64 if dtype == torch.float32 else dtype
    # source pixels: every pixel of the targets' footprints
    py, px = pixels // W, pixels % W
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    src = torch.unique(torch.cat([(torch.clamp(py - dy, 0, H - 1) * W
                                   + torch.clamp(px - dx, 0, W - 1)) for dy, dx in offs]))
    target_of = torch.full((H * W,), -1, dtype=torch.int64, device=device)
    target_of[pixels] = torch.arange(K, device=device)
    num = torch.zeros((K, N_STOKES), dtype=acc_t, device=device)
    den = torch.zeros(K, dtype=acc_t, device=device)
    counts = dict(closest=0, any=0, mueller=0)
    s0 = render_seed(seed)
    per = max(1, lanes_per_call // max(src.shape[0], 1))
    for g0 in range(0, spp, per):
        g = torch.arange(g0, min(spp, g0 + per), dtype=torch.int64, device=device)
        pix = src.repeat(g.shape[0])
        stream = (s0 + g.repeat_interleave(src.shape[0])) & M32
        Sv, jx, jy, work = trace(S, pix, stream, tile_lanes)
        own = target_of[pix] >= 0
        for name, c in zip(("closest", "any", "mueller"), work):
            counts[name] += int(c[own].to(torch.int64).sum().item())
        vals = Sv.reshape(N_STOKES, -1)
        ok = torch.abs(vals[0]) < math.inf
        for v in vals[1:]:
            ok = ok & (torch.abs(v) < math.inf)
        okf = torch.where(ok, 1.0, 0.0)
        vals = torch.where(ok, vals, 0.0).T.to(acc_t)
        qy, qx = pix // W, pix % W
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                w = okf if r == 0 else _w1d(r, dy, jy) * _w1d(r, dx, jx) * okf
                ty, tx = qy + dy, qx + dx
                inside = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
                tgt = target_of[torch.clamp(ty, 0, H - 1) * W + torch.clamp(tx, 0, W - 1)]
                keep = inside & (tgt >= 0)
                w = w.to(acc_t)[keep]
                num.index_add_(0, tgt[keep], vals[keep] * w[:, None])
                den.index_add_(0, tgt[keep], w)
    out = num / torch.clamp(den, min=1e-12)[:, None]
    return out.reshape(K, 4, 3), counts

"""Scene descriptions and helpers shared by the tpu_rt_torch tests (no JAX
import, so the card-side tests and chip_smoke.py can use them)."""

import numpy as np


def mixed_desc(st):
    """Every prim kind, light kind and filter lane the cbox leaves out: a
    rectangle floor, an emissive rectangle (two triangles), a point light,
    a constant environment, an eta/k conductor, a twosided BSDF,
    hide_emitters and a gaussian film."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3, "hide_emitters": True},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": st().look_at(origin=[0, 1, -4], target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16,
                            "rfilter": {"type": "gaussian"}},
                   "sampler": {"type": "independent", "sample_count": 2}},
        "floor": {"type": "rectangle",
                  "to_world": st().translate([0, -1, 0]).rotate([1, 0, 0], -90).scale(3),
                  "bsdf": {"type": "diffuse", "reflectance": np.array([0.6, 0.5, 0.4])}},
        "ball": {"type": "sphere", "center": [0, -0.3, 0], "radius": 0.7,
                 "bsdf": {"type": "twosided", "b": {"type": "diffuse"}}},
        "metal": {"type": "sphere", "center": [1.2, -0.5, 0.5], "radius": 0.5,
                  "bsdf": {"type": "conductor", "eta": np.array([0.2, 0.9, 1.1]),
                           "k": np.array([3.9, 2.4, 2.2])}},
        "lamp": {"type": "rectangle",
                 "to_world": st().translate([0, 2, 0]).rotate([1, 0, 0], 90).scale(0.5),
                 "emitter": {"type": "area", "radiance": np.array([5.0, 5.0, 5.0])}},
        "pt": {"type": "point", "position": [2, 2, -2],
               "intensity": np.array([10.0, 8.0, 6.0])},
        "env": {"type": "constant", "radiance": np.array([0.2, 0.2, 0.3])},
    }


def usmain_desc(st, radius=float("inf"), opening_angle=None):
    """The USMain ultrasound configuration (tools/bench_us_e2e.py:26-78,
    tests/test_scene_loading.py::test_usmain_dict): 5 plane-wave angles
    from -15 to 15 degrees, 64 elements at 0.12 mm pitch, 10 000 samples at
    50 MHz, max_depth 10, a 45-degree plate and a back wall.  ``radius``
    other than inf makes the array convex; ``opening_angle`` (degrees)
    adds a transducer emitter that spreads its elements over that arc."""
    desc = {
        "type": "scene",
        "integrator": {
            "type": "ultrasound_integrator",
            "max_depth": 10,
            "sampling_rate": 50e6,
            "frequency": 5e6,
            "sound_speed": 1540,
            "attenuation": 0.2,
            "wave_cycles": 5,
            "main_beam_angle": 24,
            "cutoff_angle": 30,
            "n_elements": 64,
            "pitch": 0.00003 * 4,
            "time_samples": 10000,
            "angles": np.linspace(-15, 15, 5),
        },
        "sensor": {
            "type": "ultrasound_sensor",
            "num_elements_lateral": 1280,
            "elements_width": 0.003,
            "elements_height": 0.01,
            "pitch": 0.0003,
            "radius": radius,
            "center_frequency": 5e6,
            "sound_speed": 1540,
            "directivity": 1.0,
            "to_world": st().look_at(origin=[0, 0, 0.0], target=[0, 0, 0.03],
                                     up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 512, "height": 512,
                     "pixel_format": "luminance"},
        },
        "flat_plate": {
            "type": "rectangle",
            "to_world": (st().translate([0, 0, 0.05])
                         @ st().rotate([0, 1, 0], 45)
                         @ st().scale([0.17, 0.17, 0.14])),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8,
                     "roughness": 0.7},
        },
        "wall_back": {
            "type": "rectangle",
            "to_world": (st().translate([0, 0, 1])
                         @ st().rotate([0, 1, 0], 180)
                         @ st().scale([0.05, 0.05, 1])),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8,
                     "roughness": 0.7},
        },
    }
    if opening_angle is not None:
        desc["probe"] = {"type": "ultraray", "opening_angle": opening_angle}
    return desc


def plate_desc(st, impedance=7.8, roughness=0.5, angles=(-5.0, 0.0, 5.0), z=0.01,
               time_samples=800, max_depth=3):
    """tests/test_parallel_and_grad.py:93-130: 3 angles, 16 elements, 800
    samples, depth 3, a plate at 1 cm; its recovery tests (:137-245) take
    the plate at 8 mm, 600 samples, depth 2 and other angles."""
    return {
        "type": "scene",
        "integrator": {"type": "ultrasound_integrator", "max_depth": max_depth, "n_elements": 16,
                       "time_samples": time_samples, "pitch": 0.0005,
                       "angles": np.asarray(angles, np.float32)},
        "sensor": {"type": "ultrasound_sensor", "num_elements_lateral": 16, "pitch": 0.0005,
                   "radius": float("inf"), "to_world": st()},
        "plate": {"type": "rectangle",
                  "to_world": st().translate([0, 0, z]) @ st().rotate([0, 1, 0], 180)
                  @ st().scale([0.02, 0.02, 1]),
                  "bsdf": {"type": "ultrasound_bsdf", "impedance": impedance,
                           "roughness": roughness}},
    }


def usmain_twin_desc(st, twin="after", impedance=1.5):
    """USMain with a twin of its plate: a rectangle at the plate's place
    with another impedance, put after the plate (``twin="after"``: the
    plate is the lower prim), before it (``"before"``), or alone in the
    plate's place (``"alone"``).  The sweeps meet the two at the same t."""
    desc = usmain_desc(st)
    plate = desc.pop("flat_plate")
    wall = desc.pop("wall_back")
    twin_shape = dict(plate, bsdf={"type": "ultrasound_bsdf", "impedance": impedance,
                                   "roughness": 0.7})
    shapes = {"after": [("flat_plate", plate), ("plate_twin", twin_shape)],
              "before": [("plate_twin", twin_shape), ("flat_plate", plate)],
              "alone": [("plate_twin", twin_shape)]}[twin]
    desc.update(shapes)
    desc["wall_back"] = wall
    return desc


def usmain_scatterers_desc(st, n=62, seed=5, r_min=3e-4, r_max=1e-3):
    """USMain with n small spheres (radius r_min to r_max, 0.3-1 mm by
    default, impedance 1.8) strewn over x in [-2, 2] cm and z in
    [1, 4.5] cm, before its plate, from a numpy seed: with the plate and
    the back wall n + 2 prims, 64 at n 62, the most the acquisition kernel
    takes.  Past that the scene is a speckle phantom for the acoustic
    wavefront: 150 spheres (152 prims) take the brute-force sweep, 1 000
    the chunked one, 10 000 the BVH."""
    desc = usmain_desc(st)
    rng = np.random.default_rng(seed)
    for k in range(n):
        desc[f"scatterer_{k:02d}"] = {
            "type": "sphere",
            "center": [float(rng.uniform(-0.02, 0.02)), 0.0, float(rng.uniform(0.01, 0.045))],
            "radius": float(rng.uniform(r_min, r_max)),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 1.8, "roughness": 0.5}}
    return desc


def usmain_mesh_desc(st, ply="knot_69k.ply"):
    """USMain's transducer and back wall with a segmented-organ stand-in:
    the torus knot of ``tests/assets/mesh/<ply>`` (69 632 triangles for
    ``knot_69k.ply``, 2 240 for ``knot.ply``) under an ``ultrasound_bsdf``
    (impedance 1.8, roughness 0.5), scaled by 8.3 mm a unit and moved to
    z = 3.25 cm: about 2.4 cm across in x, over z 2-4.5 cm, its tube cut
    by the imaging plane y = 0.  More than 192 triangles give it mesh
    cluster tables, so both queries of every bounce go through K7."""
    import os

    desc = usmain_desc(st)
    del desc["flat_plate"]
    desc["organ"] = {
        "type": "ply",
        "filename": os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "mesh",
                                 ply),
        "to_world": st().translate([0.0, 0.0, 0.0325]) @ st().scale(0.0083),
        "bsdf": {"type": "ultrasound_bsdf", "impedance": 1.8, "roughness": 0.5}}
    return desc


def shapes_desc(st):
    """The analytic shapes and BSDFs that only the wavefront tracer takes:
    a disk floor, a cylinder given by its end points, a cone, a rough
    conductor (GGX, alpha 0.25), a perfect-mirror rough conductor, a
    null-BSDF sphere, a dielectric and a diffuse ball, lit by an area
    light, a point light and a constant environment."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {"type": "perspective", "fov": 50,
                   "to_world": st().look_at(origin=[0, 1.5, -5], target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 2}},
        "floor": {"type": "disk",
                  "to_world": st().translate([0, -1, 0]).rotate([1, 0, 0], -90).scale(4),
                  "bsdf": {"type": "diffuse", "reflectance": np.array([0.6, 0.5, 0.4])}},
        "pillar": {"type": "cylinder", "p0": [-1.5, -1, 0.5], "p1": [-1.2, 1.0, 0.8],
                   "radius": 0.4,
                   "bsdf": {"type": "roughconductor", "alpha": 0.25,
                            "eta": np.array([0.2, 0.9, 1.1]), "k": np.array([3.9, 2.4, 2.2])}},
        "cone": {"type": "cone",
                 "to_world": st().translate([1.3, -1, 0.3]).rotate([1, 0, 0], -90).scale(0.8),
                 "bsdf": {"type": "roughconductor", "alpha": 0.1}},
        "veil": {"type": "sphere", "center": [0.3, -0.2, -1.2], "radius": 0.45,
                 "bsdf": {"type": "null"}},
        "glass": {"type": "sphere", "center": [0.0, -0.4, 0.6], "radius": 0.6,
                  "bsdf": {"type": "dielectric"}},
        "ball": {"type": "sphere", "center": [-0.4, 0.6, 1.6], "radius": 0.5,
                 "bsdf": {"type": "diffuse"}},
        "lamp": {"type": "rectangle",
                 "to_world": st().translate([0, 2.5, 0]).rotate([1, 0, 0], 90).scale(0.7),
                 "emitter": {"type": "area", "radiance": np.array([6.0, 6.0, 6.0])}},
        "pt": {"type": "point", "position": [2, 2, -2],
               "intensity": np.array([10.0, 8.0, 6.0])},
        "env": {"type": "constant", "radiance": np.array([0.2, 0.2, 0.3])},
    }


def polarizer_desc(st, angles_deg, z_positions, res=16, theta_props=None):
    """tests/test_stokes.py::_polarizer_scene's dict: polarizer sheets
    (3 x 3 rectangles, each rotated about the view axis by its angle, or
    given a ``theta`` property) in front of a camera that looks down +z at
    a constant white environment; stokes integrator, box filter, 16 spp."""
    d = {
        "type": "scene",
        "integrator": {"type": "stokes"},
        "sensor": {
            "type": "perspective",
            "fov": 30,
            "to_world": st().look_at(origin=[0, 0, -4], target=[0, 0, 0], up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": 16},
        },
        "env": {"type": "constant", "radiance": np.ones(3)},
    }
    for i, (ang, z) in enumerate(zip(angles_deg, z_positions)):
        bsdf = {"type": "polarizer"}
        if theta_props is not None:
            bsdf["theta"] = theta_props[i]
        d[f"pol{i}"] = {
            "type": "rectangle",
            "to_world": st().translate([0, 0, z]) @ st().rotate([0, 0, 1], ang)
            @ st().scale([3.0, 3.0, 1.0]),
            "bsdf": bsdf,
        }
    return d


def envmap_desc(st, filename, res=16):
    """Every lane of the per-sample kernels under a textured environment:
    a diffuse floor lit by a point light, a null-BSDF sphere, a dielectric
    sphere, a polarizer sheet and a conductor ball under the EXR map
    ``filename``, turned by a rotation and scaled by 1.5; path integrator,
    max_depth 4, gaussian film."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {"type": "perspective", "fov": 50,
                   "to_world": st().look_at(origin=[0, 1, -4], target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": 2}},
        "floor": {"type": "rectangle",
                  "to_world": st().translate([0, -1, 0]).rotate([1, 0, 0], -90).scale(2),
                  "bsdf": {"type": "diffuse", "reflectance": np.array([0.6, 0.5, 0.4])}},
        "veil": {"type": "sphere", "center": [-0.8, -0.2, -0.5], "radius": 0.5,
                 "bsdf": {"type": "null"}},
        "glass": {"type": "sphere", "center": [0.7, -0.4, 0.3], "radius": 0.5,
                  "bsdf": {"type": "dielectric"}},
        "ball": {"type": "sphere", "center": [0.0, 0.2, 1.2], "radius": 0.45,
                 "bsdf": {"type": "conductor", "eta": np.array([0.2, 0.9, 1.1]),
                          "k": np.array([3.9, 2.4, 2.2])}},
        "sheet": {"type": "rectangle",
                  "to_world": st().translate([0.2, 0.3, -1.5]).rotate([0, 0, 1], 30).scale(0.4),
                  "bsdf": {"type": "polarizer", "transmittance": np.array([0.9, 0.8, 0.7])}},
        "pt": {"type": "point", "position": [1, 2, -2],
               "intensity": np.array([6.0, 6.0, 6.0])},
        "env": {"type": "envmap", "filename": filename, "scale": 1.5,
                "to_world": st().rotate([0, 1, 0], 150) @ st().rotate([1, 0, 0], 20)},
    }


def envmap_rough_cone_desc(st, filename, res=16):
    """``envmap_desc`` with its conductor ball made a GGX rough conductor
    (alpha 0.3, the same eta / k) and a diffuse cone on the floor, its
    to_world leaving a non-uniform scale: the rough and cone lanes of the
    per-sample kernels under the textured environment."""
    desc = envmap_desc(st, filename, res)
    desc["ball"]["bsdf"] = dict(desc["ball"]["bsdf"], type="roughconductor", alpha=0.3)
    desc["cone"] = {"type": "cone",
                    "to_world": st().translate([-0.9, -1, 0.6]).rotate([1, 0, 0], -90)
                    .scale([0.35, 0.25, 0.9]),
                    "bsdf": {"type": "diffuse", "reflectance": np.array([0.3, 0.6, 0.4])}}
    return desc


def cone_box_desc(st, box=True):
    """A Cone_Box / Cone_FLoating-class ultrasound scene (SURVEY.md:180;
    the reference's MitsubaScenes XMLs are not in the repository):
    ultrasound_integrator at max_depth 10, 50 MHz sampling, 3 MHz, c 1480,
    attenuation 0.1; 64 elements at 0.12 mm pitch, 10 000 samples, 5
    plane-wave angles over -15...15 degrees (USMain's count); every surface
    ``ultrasound_bsdf`` of impedance 7.8.  The cone (the unit cone: base
    radius 1 at z = 0, apex at z = 1) lies on its side across the beam,
    its axis along x, base radius 12 mm and length 30 mm, centred at
    z = 72 mm, so its surface starts near z = 0.06 m, where
    tests/test_all_scenes_smoke.py:78-93 puts Cone_FLoating's first echo
    (0.05-0.066 m).  With ``box`` the 5-wall rectangle box of the *_Box
    scenes closes it in: a back wall at z = 0.1 m and four side walls at
    |x|, |y| = 0.03 m, open toward the probe."""
    bsdf = {"type": "ultrasound_bsdf", "impedance": 7.8}
    desc = {
        "type": "scene",
        "integrator": {
            "type": "ultrasound_integrator",
            "max_depth": 10,
            "sampling_rate": 50e6,
            "frequency": 3e6,
            "sound_speed": 1480,
            "attenuation": 0.1,
            "n_elements": 64,
            "pitch": 0.00012,
            "time_samples": 10000,
            "angles": np.linspace(-15, 15, 5),
        },
        "sensor": {
            "type": "ultrasound_sensor",
            "center_frequency": 3e6,
            "sound_speed": 1480,
            "to_world": st().look_at(origin=[0, 0, 0.0], target=[0, 0, 0.03], up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 512, "height": 512,
                     "pixel_format": "luminance"},
        },
        "cone": {"type": "cone",
                 "to_world": (st().translate([-0.015, 0, 0.072]) @ st().rotate([0, 1, 0], 90)
                              @ st().scale([0.012, 0.012, 0.03])),
                 "bsdf": dict(bsdf)},
    }
    if box:
        walls = {
            "wall_back": st().translate([0, 0, 0.1]) @ st().rotate([0, 1, 0], 180)
            @ st().scale([0.03, 0.03, 1]),
            "wall_left": st().translate([-0.03, 0, 0.05]) @ st().rotate([0, 1, 0], 90)
            @ st().scale([0.05, 0.03, 1]),
            "wall_right": st().translate([0.03, 0, 0.05]) @ st().rotate([0, 1, 0], -90)
            @ st().scale([0.05, 0.03, 1]),
            "wall_top": st().translate([0, 0.03, 0.05]) @ st().rotate([1, 0, 0], 90)
            @ st().scale([0.03, 0.05, 1]),
            "wall_bottom": st().translate([0, -0.03, 0.05]) @ st().rotate([1, 0, 0], -90)
            @ st().scale([0.03, 0.05, 1]),
        }
        for name, tw in walls.items():
            desc[name] = {"type": "rectangle", "to_world": tw, "bsdf": dict(bsdf)}
    return desc


def render_stokes_per_sample(scene, spp, seed, device, tile_rows=16, spp_per_pass=64):
    """The JAX package's per-sample Stokes route (render_stokes_pallas:
    2257-2295), the reference that K3's film planes are held to:
    ``path_kernel.sample_film`` on K6, ``spp_per_pass`` samples a launch,
    then developed.  Sample j draws the stream of seed * 100003 + j, as in
    the film route; the image is bit-equal whatever the chunk.  Returns
    the (H, W, 4, 3) Stokes image and the ray count (0-d int64)."""
    from tpu_rt_torch.ops import path_kernel as pk
    from tpu_rt_torch.sensor import film

    c = scene.camera
    tables = pk.pack_tables(pk.bake_scene(scene), c, tile_rows, device, stokes=True)
    fv, fw, n_rays = pk.sample_film(tables, pk.stokes_sample_trace, pk.sample_planes_split, spp,
                                    pk._wrap_i32(seed * 100003), spp_per_pass, c.filter_type)
    return film.develop(fv, fw).reshape(c.height, c.width, 4, 3), n_rays


def tie_fixture():
    """Cluster tables with exact ties: 300 small triangles on a grid in
    z = 0, in triangle order (clusters of 128, no BVH), triangle 70 a copy
    of 5 (the same cluster) and 140 a copy of 10 (the next cluster); 56
    rays straight down onto the centroids of 5, 10, their copies and
    three others.  Returns (``mesh_kernel.build_clusters``' tables, o, d
    (56, 3) float32)."""
    from tpu_rt_torch.ops import mesh_kernel

    rng = np.random.default_rng(4)
    ij = np.stack(np.meshgrid(np.arange(20), np.arange(15), indexing="ij"), -1).reshape(-1, 2)
    p0 = np.concatenate([ij * 1.0, np.zeros((300, 1))], 1) + rng.uniform(0, 0.1, (300, 3))
    p0[:, 2] = 0.0
    e1 = np.stack([rng.uniform(0.5, 0.8, 300), rng.uniform(-0.1, 0.1, 300), np.zeros(300)], 1)
    e2 = np.stack([rng.uniform(-0.1, 0.1, 300), rng.uniform(0.5, 0.8, 300), np.zeros(300)], 1)
    for dup, src in ((70, 5), (140, 10)):
        p0[dup], e1[dup], e2[dup] = p0[src], e1[src], e2[src]
    p0, e1, e2 = (x.astype(np.float32) for x in (p0, e1, e2))
    cl = mesh_kernel.build_clusters(p0, e1, e2)
    targets = np.array([5, 10, 70, 140, 3, 200, 299])
    cen = p0[targets] + (e1[targets] + e2[targets]) / 3.0
    cen = np.repeat(cen, 8, 0) + rng.uniform(-0.05, 0.05, (len(targets) * 8, 3))
    o = cen + np.array([0.0, 0.0, 2.0]) + rng.uniform(-0.2, 0.2, cen.shape) * [1, 1, 0]
    d = cen - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return cl, o.astype(np.float32), d.astype(np.float32)


def write_rod(path, x, z, r, y0=-0.8, y1=0.8, n=7):
    """A straight vertical rod at (x, z) as a cubic B-spline control file
    (rows of ``x y z r``; collinear control points make the straight
    span), as tests/test_projective.py writes it."""
    ys = np.linspace(y0, y1, n)
    with open(path, "w") as f:
        f.write("\n".join(f"{x:.8f} {y:.8f} {z:.8f} {r:.8f}" for y in ys) + "\n")


def rod_desc(st, curve_file, res=64, spp=16):
    """tests/test_projective.py's rod scene: a receiver wall at z = 0 seen
    from an off-axis camera at (2.5, 0, 4), a small bright area light at
    (0, 0, 3) and a vertical rod occluder near (0.25, *, 2.0) (write it
    with ``write_rod``).  The shadow falls on image columns ~15-26 of 64,
    the rod itself on ~49-55."""
    return {
        "type": "scene",
        "integrator": {"type": "direct_projective"},
        "sensor": {
            "type": "perspective", "fov": 50,
            "to_world": st().look_at(origin=[2.5, 0, 4], target=[0, 0, 0], up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res, "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "wall": {"type": "rectangle", "to_world": st().scale([2.5, 2.5, 1]),
                 "bsdf": {"type": "diffuse", "reflectance": 0.8 * np.ones(3)}},
        "light": {"type": "rectangle",
                  "to_world": st().translate([0, 0, 3]) @ st().rotate([0, 1, 0], 180)
                  @ st().scale([0.02, 0.02, 1]),
                  "emitter": {"type": "area", "radiance": 4.0e4 * np.ones(3)}},
        "rod": {"type": "bsplinecurve", "filename": curve_file},
    }


def shadow_band(img):
    """The loss band of the rod scene: the image columns W/8 .. W/2, where
    the shadow falls (the rod's own silhouette lies outside it)."""
    W = img.shape[1]
    return img[:, W // 8: W // 2, :].mean()


def shadow_art_band(img):
    """shadow_art.xml's loss band: the columns W/8 .. 2W/5, where the front
    view of the wire falls on the wall at z = -1.2 (the wire's own
    silhouette lies right of it)."""
    W = img.shape[1]
    return img[:, W // 8: 2 * W // 5, :].mean()


def soft_band_grads(scene, draws, width, device, band=shadow_band):
    """``projective.render_soft`` of ``scene`` on ``device`` with ``draws``
    (jitter [spp, H*W, 2], uniforms [spp, n_bounces, H*W, 8]), its loss
    ``band(img)`` and the gradients by autograd: returns (loss, d loss / d
    theta for a translation of the curve along x, the node sums of d loss
    / d (a, b) [C + 1, 3] and of d loss / d (r0, r1) [C + 1]), on the CPU,
    float64.  A node is an end two spans share (b of span i = a of span i
    + 1); where a shadow segment is closest to a node the two spans' equal
    clearances tie, so only the node's sum is well defined."""
    import torch

    from tpu_rt_torch.integrator import projective

    curves = {k: v.to(device).requires_grad_(True)
              for k, v in projective.curve_segments(scene.geometry).items()}
    theta = torch.zeros((), device=device, requires_grad=True)
    shift = torch.stack([theta, theta * 0.0, theta * 0.0])
    moved = dict(curves, a=curves["a"] + shift, b=curves["b"] + shift)
    spp = draws[0].shape[0]
    loss = band(projective.render_soft(scene, moved, spp=spp, width=width, device=device,
                                       draws=draws))
    loss.backward()

    def nodes(g0, g1):
        g0, g1 = g0.detach().double().cpu(), g1.detach().double().cpu()
        n = torch.zeros((g0.shape[0] + 1,) + tuple(g0.shape[1:]), dtype=torch.float64)
        n[:-1] += g0
        n[1:] += g1
        return n

    return (float(loss.detach()), float(theta.grad),
            nodes(curves["a"].grad, curves["b"].grad), nodes(curves["r0"].grad, curves["r1"].grad))


def textured_rect_desc(st, reflectance, res=32, spp=1):
    """tests/test_textures.py's scene: a camera facing a unit rectangle
    (its reflectance a colour or a bitmap dict) lit by a point light."""
    return {
        "type": "scene",
        "integrator": {"type": "direct"},
        "sensor": {
            "type": "perspective", "fov": 35,
            "to_world": st().look_at(origin=[0, 0, 3.2], target=[0, 0, 0], up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res, "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "rect": {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": reflectance}},
        "light": {"type": "point", "position": [0.5, 0.8, 3.0], "intensity": 20.0 * np.ones(3)},
    }


def hard_band_loss(scene, spp, seed, device, band=shadow_band, batch=64):
    """``band`` of the hard render of ``scene`` (box filter, max_depth 2:
    a pixel the mean of its finite samples) at ``spp`` samples a pixel,
    traced ``batch`` samples a pixel at a time through
    ``integrator/path.py::path_trace``.  The draws come from a
    ``torch.Generator`` seeded by ``seed`` in ``render``'s order (a
    batch's jitter, then its bounces), so ``batch=1`` gives
    ``band(path.render(scene, spp, seed, max_depth=2))`` exactly; a larger
    batch, the same estimator in spp / batch calls."""
    import torch

    from tpu_rt_torch.integrator import path
    from tpu_rt_torch.sensor import camera

    scene = scene.to(device)
    c = scene.camera
    H, W = c.height, c.width
    ys, xs = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = torch.zeros((H * W, 3), dtype=torch.float32, device=device)
    count = torch.zeros((H * W, 1), dtype=torch.float32, device=device)
    for b0 in range(0, spp, batch):
        nb = min(batch, spp - b0)
        pix = xy.repeat(nb, 1)
        o, d, t0, t1 = camera.sample_ray_extents(
            c, pix + torch.rand(pix.shape, generator=gen, device=device))
        L, _ = path.path_trace(scene, o, d, gen=gen, max_depth=2, tmin0=t0, tmax0=t1)
        ok = torch.isfinite(L).all(-1, keepdim=True)
        for i in range(nb):  # in sample order, as the film adds them
            s = slice(i * H * W, (i + 1) * H * W)
            total = total + torch.where(ok[s], L[s], 0.0)
            count = count + ok[s].float()
    return float(band((total / count.clamp(min=1.0)).reshape(H, W, 3)))


def texture_ratio_error(png, device, res=32, seed=5):
    """tests/test_textures.py:189-237's exact-ratio check on ``device``:
    ``textured_rect_desc`` rendered with the bitmap ``png`` and with a
    white reflectance at the same seed (the same rays and draws), their
    ratio against ``eval_bitmap`` at the uv where the render's first-wave
    camera rays meet z = 0.  Returns (the largest error over the lit
    pixels, the lit share)."""
    import torch

    import tpu_rt_torch as tt
    from tpu_rt_torch.bsdf import texture
    from tpu_rt_torch.sensor import camera

    st = tt.ScalarTransform4f
    sc_tex = tt.load_dict(textured_rect_desc(st, {"type": "bitmap", "filename": png}, res=res))
    sc_one = tt.load_dict(textured_rect_desc(st, np.ones(3, np.float32), res=res))
    img_t = tt.render(sc_tex, seed=seed, device=device).cpu().numpy()
    img_w = tt.render(sc_one, seed=seed, device=device).cpu().numpy()
    lit = img_w[..., 0] > 1e-6
    ratio = np.where(lit[..., None], img_t / np.maximum(img_w, 1e-12), 0.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    jitter = torch.rand((res * res, 2), generator=gen, device=device)  # the render's first draw
    ys, xs = torch.meshgrid(torch.arange(res, device=device), torch.arange(res, device=device),
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    o, d, _, _ = camera.sample_ray_extents(sc_tex.camera.to(device), xy + jitter)
    o, d = o.double().cpu().numpy(), d.double().cpu().numpy()
    t = -o[:, 2] / d[:, 2]
    uv = np.stack([0.5 * (o[:, 0] + t * d[:, 0] + 1), 0.5 * (o[:, 1] + t * d[:, 1] + 1)], -1)
    expect = texture.eval_bitmap(sc_tex.tex_data, sc_tex.tex_hw,
                                 torch.zeros(res * res, dtype=torch.int32),
                                 torch.from_numpy(uv.astype(np.float32))).numpy()
    return float(np.abs(ratio - expect.reshape(res, res, 3))[lit].max()), float(lit.mean())


def soft_band_grad(scene, spp, seed, width, device, band=shadow_band, batch=64):
    """(``band`` of ``projective.render_soft(scene, curves, spp, seed,
    width)``, its derivative with respect to a translation of the curve
    along x), traced ``batch`` samples a pixel at a time through
    ``integrator/path.py::path_trace`` with render_soft's shadow geometry
    and soft curves; each batch's part of the (linear) band is
    backpropagated at once.  The draws follow render_soft's order (a
    batch's jitter, then its bounces), so ``batch=1`` is render_soft's
    estimate on its own draws, summed in another order."""
    import torch

    from tpu_rt_torch.integrator import path, projective
    from tpu_rt_torch.sensor import camera

    scene = scene.to(device)
    base = projective.curve_segments(scene.geometry)
    sgeom = projective.geometry_without_curves(scene.geometry)
    c = scene.camera
    H, W = c.height, c.width
    ys, xs = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    theta = torch.zeros((), device=device, requires_grad=True)
    loss = 0.0
    for b0 in range(0, spp, batch):
        nb = min(batch, spp - b0)
        shift = torch.stack([theta, theta * 0.0, theta * 0.0])
        soft = dict(base, a=base["a"] + shift, b=base["b"] + shift, width=width)
        pix = xy.repeat(nb, 1)
        o, d, t0, t1 = camera.sample_ray_extents(
            c, pix + torch.rand(pix.shape, generator=gen, device=device))
        L, _ = path.path_trace(scene, o, d, gen=gen, max_depth=2, tmin0=t0, tmax0=t1,
                               shadow_geom=sgeom, soft_curves=soft)
        part = band(L.reshape(nb, H, W, 3).sum(0) / spp)
        part.backward()
        loss += float(part.detach())
    return loss, float(theta.grad)


def world_fails(rank, n, device):
    """A rank function for ``parallel/dryrun.py::run_world`` whose rank 1
    raises."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def world_hangs(rank, n, device):
    """A rank function whose rank 1 never returns (rank 0 then waits in
    the closing barrier)."""
    import time

    while rank == 1:
        time.sleep(1)
    return rank

"""Write the shadow-art fixtures beside this script.

* ``wire.txt``: 51 control points (rows of ``x y z r``) of a uniform cubic
  B-spline, a trefoil knot of about 0.36 in extent whose last three points
  repeat its first three, so the wire closes on itself; its radius runs
  from 0.01 to 0.02.  Flattened at 4 samples a span it gives 192
  swept-sphere spans; as a tube mesh (8 samples a span, 8 sides), 6 144
  triangles.
* ``shadow_art.xml`` (scene version 2.1.0): the shadow-art scene class,
  a ``direct_projective`` integrator over the wire between two small
  rectangle area lights of radiance 40 000 and two diffuse receiver walls
  (x = -1.2 and z = -1.2): the light at x = 0.8 casts the wire's side view
  onto the first wall, 2.5 times magnified, the light at z = 0.8 its front
  view onto the second (each wall also takes the other light's shadow,
  fainter); a perspective camera of fov 100 sees both, 256 x 128, box
  filter, ``$spp`` 64 samples (``$resx``, ``$resy`` and ``$spp`` can be
  overridden).

numpy only, deterministic.

Run:  python tests/assets/shadow_art/make_shadow_art.py
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_CONTROL = 51


def wire_points(n=N_CONTROL):
    """[n, 4] control points: a trefoil knot, radius 0.015 +- 0.005; the
    spline's 3 extra points close it."""
    t = 2.0 * np.pi * np.arange(n) / (n - 3)
    xyz = 0.12 * np.stack([np.sin(t) + 2.0 * np.sin(2.0 * t),
                           np.cos(t) - 2.0 * np.cos(2.0 * t),
                           -np.sin(3.0 * t)], -1)
    r = 0.015 + 0.005 * np.sin(2.0 * t)
    return np.concatenate([xyz, r[:, None]], -1)


SCENE = """<scene version="2.1.0">
    <!-- The shadow-art scene class (tests/assets/shadow_art/make_shadow_art.py):
         a direct_projective integrator, a bsplinecurve wire (wire.txt, 51
         control points) between two rectangle area lights of radiance
         40 000 and two diffuse receiver walls, each wall showing another
         shadow of the wire; fov 100, 256 x 128, box filter, 64 spp.
         Override with load_file(path, resx=..., resy=..., spp=...). -->
    <default name="resx" value="256"/>
    <default name="resy" value="128"/>
    <default name="spp" value="64"/>

    <integrator type="direct_projective"/>

    <sensor type="perspective">
        <float name="fov" value="100"/>
        <transform name="to_world">
            <lookat origin="1.6, 0.4, 1.6" target="-0.7, 0, -0.7" up="0, 1, 0"/>
        </transform>
        <sampler type="independent">
            <integer name="sample_count" value="$spp"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="$resx"/>
            <integer name="height" value="$resy"/>
            <rfilter type="box"/>
        </film>
    </sensor>

    <shape type="bsplinecurve" id="wire">
        <string name="filename" value="wire.txt"/>
        <bsdf type="diffuse">
            <rgb name="reflectance" value="0.3, 0.3, 0.3"/>
        </bsdf>
    </shape>

    <shape type="rectangle" id="wall_x">
        <transform name="to_world">
            <scale x="1.6" y="1.6" z="1"/>
            <rotate x="0" y="1" z="0" angle="90"/>
            <translate x="-1.2" y="0" z="0"/>
        </transform>
        <bsdf type="diffuse">
            <rgb name="reflectance" value="0.8, 0.8, 0.8"/>
        </bsdf>
    </shape>

    <shape type="rectangle" id="wall_z">
        <transform name="to_world">
            <scale x="1.6" y="1.6" z="1"/>
            <translate x="0" y="0" z="-1.2"/>
        </transform>
        <bsdf type="diffuse">
            <rgb name="reflectance" value="0.8, 0.8, 0.8"/>
        </bsdf>
    </shape>

    <shape type="rectangle" id="light_x">
        <transform name="to_world">
            <scale x="0.01" y="0.01" z="1"/>
            <rotate x="0" y="1" z="0" angle="-90"/>
            <translate x="0.8" y="0" z="0"/>
        </transform>
        <emitter type="area">
            <rgb name="radiance" value="40000, 40000, 40000"/>
        </emitter>
    </shape>

    <shape type="rectangle" id="light_z">
        <transform name="to_world">
            <scale x="0.01" y="0.01" z="1"/>
            <rotate x="0" y="1" z="0" angle="180"/>
            <translate x="0" y="0" z="0.8"/>
        </transform>
        <emitter type="area">
            <rgb name="radiance" value="40000, 40000, 40000"/>
        </emitter>
    </shape>
</scene>
"""


def main():
    pts = wire_points()
    np.savetxt(os.path.join(HERE, "wire.txt"), pts, fmt="%.8f")
    print(f"wrote wire.txt: {pts.shape[0]} control points, radius {pts[:, 3].min():.4f} "
          f"to {pts[:, 3].max():.4f}")
    with open(os.path.join(HERE, "shadow_art.xml"), "w") as fh:
        fh.write(SCENE)
    print("wrote shadow_art.xml")


if __name__ == "__main__":
    main()

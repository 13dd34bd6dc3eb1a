"""film.roofline: the film kernels' share of their roofline, %.

The least time of an image's film work (``yardstick.film_work``: every
primary ray against every prim, every sample splatted; a lower bound from
the cell's shapes) against the device time a call of the kernels that
``path_film.cu`` declares (K1's trace kernel, film_splat and their kin).
"""

import yardstick

SOURCES = ["path_film.cu"]


def read(ctx):
    sh = ctx.shapes
    t = ctx.layer_s(SOURCES) / ctx.calls
    if t <= 0:
        return None
    ops, nbytes = yardstick.film_work(sh["W"] * sh["H"], sh["spp"], sh["n_prims"],
                                      sh["radius"], sh["launches"])
    return 100.0 * yardstick.bound_s(ops, nbytes)[0] / t

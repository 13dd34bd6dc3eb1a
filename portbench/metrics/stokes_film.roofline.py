"""stokes_film.roofline: the Stokes film kernels' share of their roofline, %.

The least time of a Stokes image's film work against the device time a
call of the kernels that ``path_film.cu`` declares (K3 in K2's loop,
film_splat and their kin).  The work, from the cell's shapes and the plain
reference's counts on the checked call's seed, never from the port:
``yardstick.film_work`` with 13 planes an offset (every primary ray
against every prim; the splat of 12 Stokes values and a weight over the
filter's offsets; the planes out), plus every other closest-hit sweep and
every shadow sweep against every prim, plus OPS_MUELLER for each
scattering event at which the reference chains a Mueller matrix.
"""

import yardstick

SOURCES = ["path_film.cu"]
# The least work of one event in the reference's form (``_mueller_chain``):
# the turn onto the scattering plane, the s axis cross(p_A, p_B) (9), its
# squared length (5), 1 / sqrt (2) and scale (3), cos 2phi and sin 2phi's
# dot (5), cross and dot (14), n2 (3), C2 (2) and S2 (3); a channel, T's
# rows turned (4 rows x 2 x (2 multiplies, an add)) and its four new
# columns (16 entries x (2 multiplies, an add))
OPS_MUELLER_TURN, OPS_MUELLER_CHANNEL = 46, 72
OPS_MUELLER = OPS_MUELLER_TURN + 3 * OPS_MUELLER_CHANNEL


def read(ctx):
    sh, c = ctx.shapes, ctx.counts
    if not c:
        return None
    t = ctx.layer_s(SOURCES) / ctx.calls
    if t <= 0:
        return None
    n_pix = sh["W"] * sh["H"]
    ops, nbytes = yardstick.film_work(n_pix, sh["spp"], sh["n_prims"], sh["radius"],
                                      sh["launches"], n_val=sh["n_val"])
    # film_work holds the primary sweeps, one a sample
    sweeps = c["closest"] - n_pix * sh["spp"] + c["any"]
    ops += sweeps * sh["n_prims"] * yardstick.OPS_PRIM + c["mueller"] * OPS_MUELLER
    return 100.0 * yardstick.bound_s(ops, nbytes)[0] / t

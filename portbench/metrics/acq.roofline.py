"""acq.roofline: the acquisition kernel's share of its roofline, %.

The least time of an acquisition (``yardstick.acq_work``: the sweeps
against every prim and the taps deposited, as the plain reference counted
them on the checked call's seed, with the pair rays in) against the device
time a call of the kernels that ``us_acq.cu`` declares (K10).
"""

import yardstick

SOURCES = ["us_acq.cu"]


def read(ctx):
    sh, c = ctx.shapes, ctx.counts
    if not c:
        return None
    t = ctx.layer_s(SOURCES) / ctx.calls
    if t <= 0:
        return None
    ops, nbytes = yardstick.acq_work(sh["A"], sh["E"], sh["n_prims"], c["closest"] + c["any"],
                                     c["taps"], 20 * sh["n_prims"])
    return 100.0 * yardstick.bound_s(ops, nbytes)[0] / t

"""das.roofline: the beamformer's share of its roofline, %.

The least time of a frame's delay-and-sum (``yardstick.das_work``: the
least work of the gather form, the RF in and the image out, from the
cell's shapes) against the device time a call of the kernels that
``us_das.cu`` declares (the packing pass and the DAS kernel).
"""

import yardstick

SOURCES = ["us_das.cu"]


def read(ctx):
    sh = ctx.shapes
    t = ctx.layer_s(SOURCES) / ctx.calls
    if t <= 0:
        return None
    ops, nbytes = yardstick.das_work(sh["A"], sh["E"], sh["T"], sh["nx"], sh["nz"])
    return 100.0 * yardstick.bound_s(ops, nbytes)[0] / t

"""glue_idle.image: the device's idle time inside the calls' outermost
``tpu_rt_torch.`` spans, on the device's intervals anchored to the
host's clock (``devtrace.anchor``), ms a call: the idle the program's
glue leaves inside a call, apart from the closed loop's between calls."""


def read(ctx):
    s = ctx.anchored_split()
    return None if s is None else s["glue_idle_ms"]

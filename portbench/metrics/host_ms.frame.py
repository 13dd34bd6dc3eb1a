"""host_ms.frame: the duration of the calls' outermost ``tpu_rt_torch.``
spans, the host's time from a call's entry to its return under the
profiler, ms a call."""


def read(ctx):
    s = ctx.anchored_split()
    return None if s is None else s["host_ms"]

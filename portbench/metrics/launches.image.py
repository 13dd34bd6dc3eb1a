"""launches.image: kernel launches the host issued a call, from the
trace's launch calls (CUDA's runtime and driver APIs) in the window."""


def read(ctx):
    return ctx.launches / ctx.calls

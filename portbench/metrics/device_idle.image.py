"""device_idle.image: the share of the traced window in which no kernel,
copy or memset ran on the device, %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

"""The device's idle share of the traced window [%]: 100 (1 - busy /
window), busy the union of the profiler's kernel, copy and set records."""


def read(ctx):
    if not ctx.window_s or not ctx.device_records():
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

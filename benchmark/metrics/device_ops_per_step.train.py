"""Device operations (kernels, copies, sets) per traced training step."""


def read(ctx):
    tr, n = ctx.device_trace, ctx.values.get("traced_steps")
    if tr is None or not n or not tr.device_ops:
        return None
    return tr.device_ops / n

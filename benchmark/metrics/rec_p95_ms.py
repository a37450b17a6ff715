"""The 95th percentile of the latency of the requests due in the window
before the profiler started, over all of them, as `rec_p50_ms` times
them, in ms."""


def read(ctx):
    return ctx.values.get("rec_p95_ms")

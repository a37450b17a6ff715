"""Requests a DIN wave carried over the window: the change in the
batcher's `n_requests` over the change in its `n_waves`."""


def read(ctx):
    waves = ctx.counters.get("waves", 0)
    return ctx.counters["wave_requests"] / waves if waves else None

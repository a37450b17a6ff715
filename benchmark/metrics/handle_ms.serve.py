"""Median time inside `RecSysServer.handle` for `/getrecforyou`, in ms:
recall and rank of one request, from the benchmark's wrapper."""


def read(ctx):
    return ctx.spans.median_ms("handle")

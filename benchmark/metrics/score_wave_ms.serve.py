"""Median wall time of one `ModelScorer.score_wave` call, in ms, from the
benchmark's wrapper; the call ends on its copy back to the host, a
synchronise."""


def read(ctx):
    return ctx.spans.median_ms("score_wave")

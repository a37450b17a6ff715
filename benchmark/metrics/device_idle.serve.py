"""Share of the traced window in which no kernel, copy or set ran on the
card, in %."""

from benchmark.harness import idle_percent


def read(ctx):
    return idle_percent(ctx)

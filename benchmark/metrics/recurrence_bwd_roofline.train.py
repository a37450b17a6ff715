"""DIEN's two recurrences' steps backward (their autograd VJP: the
reverse chain and the recurrent weights' gradients) against their
roofline, in %, as `recurrence_fwd_roofline.train` reads the forward,
over the `bench.rnn_bwd` ranges (`costs_dien.rnn_bwd_cost`)."""

from benchmark import costs_dien
from benchmark.harness import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "bench.rnn_bwd", costs_dien.rnn_bwd_cost)

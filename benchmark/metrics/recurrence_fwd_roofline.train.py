"""DIEN's two recurrences' steps forward (the input projections made)
against their roofline, in %: the longer of their bytes (each input read
once, each output written once) at the HBM rate and their operations at
the TF32 peak, over the device time of every kernel launched inside the
`bench.rnn_fwd` ranges, per call (`benchmark/costs_dien.py::rnn_fwd_cost`,
the mean of the GRU's and the AUGRU's)."""

from benchmark import costs_dien
from benchmark.harness import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "bench.rnn_fwd", costs_dien.rnn_fwd_cost)

"""The DIN activation unit's forward against its roofline, in %: the
longer of its bytes (each input read once, the output written once) at
the HBM rate and its operations at the TF32 peak, the fastest way the
card multiplies float32 inputs, over the device time of every kernel
launched inside the `bench.din_fwd` ranges, per call."""

from benchmark import costs
from benchmark.harness import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "bench.din_fwd", costs.din_attention_cost)

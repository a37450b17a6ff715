"""The DIN activation unit's backward (its autograd VJP: the kernel, its
reduce and the weight-gradient products) against its roofline, in %, as
`din_fwd_roofline.train` reads the forward, over the `bench.din_bwd`
ranges."""

from benchmark import costs
from benchmark.harness import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "bench.din_bwd", costs.din_attention_bwd_cost)

"""The model FLOPs of a step (three times DIN's forward count, frozen in
`benchmark/costs.py`) over the step time of the window's steps before
the traced ones, as a share of the peak of the configuration's compute
dtype, in %."""


def read(ctx):
    v = ctx.values
    if not v.get("step_s"):
        return None
    return 100.0 * v["flops_per_step"] / v["step_s"] / v["peak_flops"]

"""Device time a traced step of the kernels, copies and sets launched
inside the program's `dlrm.lookups` span (DLRM-DCNv2's 26 pooled lookups,
forward), in ms; `backward_ms.train.py` says how a launch is matched to a
span. None where the trace holds no such span."""

import os
import runpy

SPANS = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "backward_ms.train.py"))


def read(ctx):
    return SPANS["launched_ms"](ctx.device_trace, "dlrm.lookups")

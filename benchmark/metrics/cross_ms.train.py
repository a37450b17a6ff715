"""Device time a traced step of the kernels, copies and sets launched
inside the program's DLRM-DCNv2 cross-layer spans (`dlrm.cross` around
the low-rank cross layers' forward, `dlrm.cross.backward` around their
autograd backward), in ms; `backward_ms.train.py` says how a launch is
matched to a span. None where the trace holds neither."""

import os
import runpy

SPANS = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "backward_ms.train.py"))
NAMES = ("dlrm.cross", "dlrm.cross.backward")


def read(ctx):
    got = [SPANS["launched_ms"](ctx.device_trace, name) for name in NAMES]
    got = [v for v in got if v is not None]
    return sum(got) if got else None

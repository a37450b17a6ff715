"""Device time a traced step of the kernels, copies and sets launched
inside the program's four DIEN recurrence spans (`dien.gru` and
`dien.augru` around the two recurrences' forward, `dien.gru.backward` and
`dien.augru.backward` around their autograd backward: input projections,
steps and weight gradients), in ms; `backward_ms.train.py` says how a
launch is matched to a span. None where the trace holds none of them."""

import os
import runpy

SPANS = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "backward_ms.train.py"))
NAMES = ("dien.gru", "dien.augru", "dien.gru.backward", "dien.augru.backward")


def read(ctx):
    got = [SPANS["launched_ms"](ctx.device_trace, name) for name in NAMES]
    got = [v for v in got if v is not None]
    return sum(got) if got else None

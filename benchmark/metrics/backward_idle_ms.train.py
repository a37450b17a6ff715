"""Device idle time a traced step inside the program's `trainer.backward`
ranges, in ms: the length of those ranges less the part of it that the
union of the device's kernels, copies and sets covers
(`backward_ms.train.py` holds the span helpers)."""

import os
import runpy

from benchmark.trace import _union

SPANS = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "backward_ms.train.py"))


def read(ctx):
    tr = ctx.device_trace
    n = SPANS["steps"](tr)
    ivs = SPANS["intervals"](tr, "trainer.backward") if n else []
    if not ivs:
        return None
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in tr.device])
    idle = 0.0
    for s, e in ivs:
        covered = sum(min(e, b) - max(s, a) for a, b in busy if a < e and b > s)
        idle += (e - s) - covered
    return idle / 1e3 / n

"""Host synchronisations a traced step: the CUDA runtime's stream, device
and event synchronise calls, on any thread, that start inside the
program's `trainer.step` ranges (`backward_ms.train.py` holds the span
helpers)."""

import os
import runpy

SPANS = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "backward_ms.train.py"))
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def read(ctx):
    tr = ctx.device_trace
    n = SPANS["steps"](tr)
    if not n:
        return None
    return len(SPANS["host_events_in"](tr, SPANS["STEP"], lambda e: e.get("name") in SYNCS)) / n

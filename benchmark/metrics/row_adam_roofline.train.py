"""The lazy row-Adam against its roofline, in %: its least bytes a step
at the HBM rate (`costs_dlrm.row_adam_bytes`: each distinct touched row's
[table | mu | nu] read and written and its gradient row read, plus the
ids, over the traced steps' batches, counted at set-up by
`drivers/dlrm_train_steps.py`) over the device time a step of the kernels
launched inside the program's `trainer.row_adam` span
(`row_adam_ms.train`). None where the trace holds no such span."""

import os
import runpy

from benchmark import peaks

MS = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "row_adam_ms.train.py"))


def read(ctx):
    ms, nbytes = MS["read"](ctx), ctx.values.get("row_adam_bytes")
    if not ms or not nbytes:
        return None
    return 100.0 * (nbytes / peaks.HBM_BYTES_PER_S * 1e3) / ms

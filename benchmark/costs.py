"""The work of the measured operations, counted from their shapes.

Frozen copies of the program's arithmetic, so that a later change to the
program cannot move the yardstick:

- `din_flops_per_example`: DIN's branch of
  `sparrowrecsys_torch/tools/mfu_zoo.py::flops_per_example`, the forward
  FLOPs of one example (a training step counts three times this:
  forward, input gradient and weight gradient);
- `din_attention_cost` and `din_attention_bwd_cost`: the DIN activation
  unit's forward and backward (bytes, operations), from
  `sparrowrecsys_torch/tools/kernel_bench.py`: each input byte read once
  and each output byte written once, a multiply-add two operations.
"""

from __future__ import annotations


def din_flops_per_example(dim: int, hidden: int, t: int, att: int = 32) -> float:
    """Forward FLOPs of one DIN example: the activation unit over T steps
    and the tower (5D + 7 inputs -> hidden -> hidden/2 -> 1)."""
    return 2.0 * (t * (4 * dim * att + att)
                  + (5 * dim + 7) * hidden + hidden * (hidden // 2) + hidden // 2)


def din_attention_cost(b: int, t: int, d: int, h: int, live_steps: int, live_rows: int):
    """(bytes, operations) of the forward: the history, the candidate and
    the unit's weights read, [B, D] written; per live step h @ (wa+wb) +
    (h*c) @ wd and H for the second layer, per live row c @ (wc-wa)."""
    nbytes = (b * t * d + b * d + 4 * d * h + 3 * h + 1 + b * d) * 4
    return nbytes, 2 * (live_steps * (2 * d * h + h) + live_rows * d * h)


def din_attention_bwd_cost(b: int, t: int, d: int, h: int, live_steps: int, live_rows: int):
    """(bytes, operations) of the backward: the history, the candidate and
    the output gradient read, dh and dc written, the weights read and
    their gradients written; per live step the recompute, dh and the
    weight gradients, per live row the candidate's terms."""
    n_w = 4 * d * h + 3 * h + 1
    nbytes = (2 * (b * t * d + b * d) + b * d + 2 * n_w) * 4
    return nbytes, 2 * (live_steps * (6 * d * h + 4 * h) + live_rows * 3 * d * h)

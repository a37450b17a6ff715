"""The work of DIEN's measured operations, counted from their shapes.

- `dien_flops_per_example`: the forward FLOPs of one DIEN example, a
  multiply-add two (a training step counts three times this: forward,
  input gradient and weight gradient);
- `gru_scan_cost`, `gru_scan_bwd_cost`, `augru_scan_cost`,
  `augru_scan_bwd_cost`: (bytes, operations) of each recurrence's steps,
  the input projections already made, counted as the work the function
  must do whatever implements it. Forward: its inputs read once and its
  outputs written once. Backward: the output gradient, the forward's
  inputs and outputs read, the input and weight gradients written.
  Operations: the recurrent products, per live step of the GRU (a masked
  step carries its state) and per step of the AUGRU: 3H^2 multiply-adds
  forward; backward the dh chain's 3H^2 and the weight gradients' 3H^2.
- `rnn_fwd_cost`, `rnn_bwd_cost`: what one `bench.rnn_fwd` or
  `bench.rnn_bwd` range holds on average, the mean of the GRU's and the
  AUGRU's (each opens one a step), in `harness.roofline_percent`'s form.
"""

from __future__ import annotations

F32 = 4
#: The mask's bytes a step (bool).
MASK = 1


def dien_flops_per_example(dim: int, hidden: int, t: int, att: int = 32,
                           aux: bool = True) -> float:
    """Forward FLOPs of one DIEN example of T history steps, states of
    width `dim`: the GRU (input projection and recurrent product, 3 gates),
    the attention (state * candidate -> att -> 1), the AUGRU (the same as
    the GRU), the tower (5 dim + 7 inputs -> hidden -> hidden/2 -> 1) and
    the two auxiliary heads over T - 1 steps (2 dim -> att -> 1)."""
    d = h = dim
    steps = t * (3 * d * h + 3 * h * h) + t * (h * att + att) + t * (3 * h * h + 3 * h * h)
    tower = (5 * d + 7) * hidden + hidden * (hidden // 2) + hidden // 2
    heads = (t - 1) * 2 * (2 * d * att + att) if aux else 0
    return 2.0 * (steps + tower + heads)


def gru_scan_cost(b: int, t: int, h: int, live_steps: int):
    """Forward: gx [B, T, 3H], the mask [B, T] and U [H, 3H] read, hs
    [B, T, H] written."""
    nbytes = (b * t * 3 * h + 3 * h * h + b * t * h) * F32 + b * t * MASK
    return nbytes, 2 * live_steps * 3 * h * h


def gru_scan_bwd_cost(b: int, t: int, h: int, live_steps: int):
    """Backward: dhs [B, T, H], gx, the mask, U and hs read, dgx [B, T, 3H]
    and dU [H, 3H] written."""
    nbytes = (b * t * h + b * t * 3 * h + 3 * h * h + b * t * h
              + b * t * 3 * h + 3 * h * h) * F32 + b * t * MASK
    return nbytes, 2 * live_steps * 6 * h * h


def augru_scan_cost(b: int, t: int, h: int):
    """Forward: x [B, T, 3H], the attention [B, T] and U_rz, U_h read, the
    final state [B, H] written."""
    nbytes = (b * t * 3 * h + b * t + 3 * h * h + b * h) * F32
    return nbytes, 2 * b * t * 3 * h * h


def augru_scan_bwd_cost(b: int, t: int, h: int):
    """Backward: dh [B, H], x, the attention, U and the final state read, dx
    [B, T, 3H], the attention's gradient [B, T] and dU written."""
    nbytes = (b * h + b * t * 3 * h + b * t + 3 * h * h + b * h
              + b * t * 3 * h + b * t + 3 * h * h) * F32
    return nbytes, 2 * b * t * 6 * h * h


def rnn_fwd_cost(b: int, t: int, d: int, att: int, live_steps: int, live_rows: int):
    """The mean of the two recurrences' forward (bytes, operations)."""
    g, a = gru_scan_cost(b, t, d, live_steps), augru_scan_cost(b, t, d)
    return (g[0] + a[0]) / 2, (g[1] + a[1]) / 2


def rnn_bwd_cost(b: int, t: int, d: int, att: int, live_steps: int, live_rows: int):
    """The mean of the two recurrences' backward (bytes, operations)."""
    g, a = gru_scan_bwd_cost(b, t, d, live_steps), augru_scan_bwd_cost(b, t, d)
    return (g[0] + a[0]) / 2, (g[1] + a[1]) / 2

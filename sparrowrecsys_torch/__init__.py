"""SparrowRecSys on PyTorch and CUDA: the port of `sparrowrecsys_tpu`.

The JAX package beside this one is the reference. This package imports
`torch` and numpy and nothing of JAX, flax, msgpack or
`sparrowrecsys_tpu`: what it needs from there it keeps as its own copy.

Ported so far: the serving plane with its full-feature rankers (DeepFM,
DeepFMv2, DIN), and their training plane (`training/loop.py::Trainer`
with the group-fused Adam and the lazy row-Adam, the streaming metrics,
the flax checkpoint reader and writer, `training/run.py`). Every TPU
kernel of the JAX package has a hand-written CUDA counterpart for Hopper
under `csrc/`: `ops/fm.py::fm_cross` and `ops/attention.py::din_attention`
with their backward kernels behind `torch.autograd.Function`s, and
`ops/rowio.py::rows_gather`/`rows_write` under the row-Adam.

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"`, `--cpu`); without CUDA they raise instead of moving to
the CPU quietly.
"""

__version__ = "0.1.0"

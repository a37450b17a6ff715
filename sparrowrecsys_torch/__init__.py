"""SparrowRecSys on PyTorch and CUDA: the port of `sparrowrecsys_tpu`.

The JAX package beside this one is the reference. This package imports
`torch` and numpy and nothing of JAX, flax, msgpack or
`sparrowrecsys_tpu`: what it needs from there it keeps as its own copy.

Ported so far: the serving plane with its full-feature rankers (DeepFM,
DeepFMv2, DIN), the flax checkpoint reader, and the two forward kernels
on that path (`ops/fm.py::fm_cross`, `ops/attention.py::din_attention`),
hand-written CUDA for Hopper under `csrc/`.

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"`, `--cpu`); without CUDA they raise instead of moving to
the CPU quietly.
"""

__version__ = "0.1.0"

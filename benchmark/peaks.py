"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), that the
rooflines are priced at.

A frozen copy: `sparrowrecsys_torch/tools/mfu_zoo.py` and
`tools/kernel_bench.py` hold the same numbers for the program's own
tools; a later change there does not move the benchmark's yardstick.
"""

#: TF32 on the tensor cores: the fastest way the card multiplies float32
#: inputs, so no float32 implementation can beat a bound priced at it.
TF32_FLOPS = 495e12
#: HBM3 bytes per second.
HBM_BYTES_PER_S = 3.35e12

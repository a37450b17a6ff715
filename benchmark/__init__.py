"""The benchmark of `sparrowrecsys_torch` on an NVIDIA H100.

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
in the file `BENCHMARK.json` names, its traffic in `traffic/<mix>.json`
(whose `kind` names a module of `drivers/`), and each per-layer metric
in `metrics/<metric>.py`. `reference/` is the plain PyTorch reference
that decides `correct`; it imports nothing of the program.
"""

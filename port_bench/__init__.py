"""port_bench: the benchmark of the PyTorch and CUDA path tracer
(`pathtracer_tpu_torch`) on an NVIDIA H100.

`run.py` is the command; `harness` runs one cell; `spec` finds a cell's
files by name; `entries/` drive the program; `reference/` is the plain
path tracer that decides `correct`; `compare` gives the compared numbers;
`profiling` and `roofline` read the traced run; `metrics/` hold one
per-layer metric each; `readings` reads the comparison's numbers over many
seeds and the control's, from which the limits in `limits/` were set.
Nothing here imports JAX or the JAX package `pathtracer_tpu`.
"""

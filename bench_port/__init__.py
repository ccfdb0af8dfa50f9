"""The benchmark of the PyTorch and CUDA port (`singa_tpu_torch`).

`run.py` runs one cell; `harness.py` finds the cell's files by name;
`drivers/` hold the general train and serve drivers, `cells/` and
`configs/` the data each cell and configuration is, `metrics/` one
reader per per-layer metric, `reference/` the plain PyTorch references
that decide `correct`, `counts/` the frozen FLOP and byte arithmetic.
Nothing here imports JAX or the JAX package.
"""

"""The benchmark of lodestar_tpu_torch, the PyTorch and CUDA port: one cell
of BENCHMARK.json a run (``python3 -m portbench``), driven by the data
files beside this package."""

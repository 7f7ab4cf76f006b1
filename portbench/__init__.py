"""portbench: the benchmark of the PyTorch and CUDA port (bpt_tpu_torch).
See README.md."""

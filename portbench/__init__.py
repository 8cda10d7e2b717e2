"""The benchmark of the PyTorch/CUDA port (``cuda_mat_tpu_torch``): one
command runs one cell once (``portbench/run.py``); ``BENCHMARK.json`` at the
repository's root names the cells, their configurations and traffic, and
the metrics."""

"""The benchmark of the PyTorch and CUDA port, ``ssdn_tpu_torch``: run.py runs one cell of BENCHMARK.json."""

"""The benchmark of gzp_tpu_torch, the PyTorch and CUDA port: one cell of
``BENCHMARK.json`` per run of ``portbench/run.py`` (see ``README.md``)."""

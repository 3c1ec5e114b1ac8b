"""The benchmark of the PyTorch/CUDA port ``idg_tpu_torch``: whole gridding
and degridding passes on one H100, driven by ``BENCHMARK.json``. See
``benchmark/README.md``."""

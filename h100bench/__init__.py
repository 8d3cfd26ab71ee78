"""The benchmark of ``totsu_tpu_torch`` on one NVIDIA H100: ``run.py``
runs one cell of ``BENCHMARK.json`` once and prints the result line."""

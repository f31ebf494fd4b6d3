"""The benchmark of ``vaeunet_tpu_torch`` on one NVIDIA H100: its harness,
its plain reference, and the data files of its configurations, traffic
mixes, limits and per-layer metrics.  ``python3 benchmark/run.py
--workload NAME --seed N --seconds S --trace 0|1`` from the root of a
checkout runs one cell of ``BENCHMARK.json``."""

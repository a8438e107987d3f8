"""gwbench: the benchmark of ``goworld_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m gwbench.run --workload aoi_100k.walk --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix, driver or metric
sits in a file of its own under this folder, found by its name (see
``README.md``). Nothing here imports ``jax`` or the JAX package, and
``reference/`` imports nothing of the program.
"""

"""The port's benchmark: ``python3 bench/run.py --workload <cell> ...``.

The cells, metrics and bounds are in ``BENCHMARK.json`` at the root of the
repository; every configuration, traffic mix and per-layer metric is a
file of its own under this directory, found by its name.
"""

"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix,
generator, driver or per-layer metric is a file of its own, found by the
name that ``BENCHMARK.json`` or the files it names give.
"""

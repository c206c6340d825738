"""The H100 benchmark of the PyTorch/CUDA port (``repro_torch``).

``python h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name; see :mod:`h100bench.harness`.
"""

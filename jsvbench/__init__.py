"""jsvbench: the benchmark of jsvx_torch, the PyTorch / CUDA port.

``python3 jsvbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, cell, entry point or per-layer metric is a
file of its own under ``configs/``, ``workloads/``, ``entries/`` and
``metrics/``, found by name.
"""

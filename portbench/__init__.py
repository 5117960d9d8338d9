"""portbench: the benchmark of ``drin_tpu_torch`` on NVIDIA GPUs.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
result line (``harness.py``).  Everything a cell needs is found by name:
``configs/<config>.json``, ``cells/<cell>.json``, ``drivers/<driver>.py``,
``systems/<system>.py`` (how the port is built for a configuration and how
its answers are judged), ``reference/<model>.py`` (the plain PyTorch
reference), ``metrics/<metric>.py`` (a per-layer metric's reader) and
``peaks.json``.
"""

"""The benchmark of ``apm_torch`` on one NVIDIA H100.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``) and
each per-layer metric (``metrics/<name>.py``). The yardstick (input
generators, the plain reference, the trace reduction, the counted work)
lives here and imports nothing of the JAX package.
"""

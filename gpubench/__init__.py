"""Benchmark of the PyTorch/CUDA port of the ψ-score system (``repro_torch``).

``BENCHMARK.json`` at the repository root names the cells; each cell's
configuration (``configs/``), traffic mix (``traffic/``), entry into the
system (``entries/``), input generator (``gen/``) and metric readers
(``metrics/``) are files of their own, found by name. ``run.py`` is the
command; ``harness.py`` drives one run.
"""

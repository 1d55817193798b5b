"""The benchmark of the PyTorch port (``repro_torch``) on one H100: its
harness, its traffic, its configurations with their plain references, the
readers of its metrics and the arithmetic of its bounds.  ``run.py`` is
the command; ``BENCHMARK.json`` at the repository's root names the cells.
"""

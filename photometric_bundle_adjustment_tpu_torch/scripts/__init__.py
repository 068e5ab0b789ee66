"""Probe entry points: the counterparts of the JAX package's probe scripts
``scripts/grid_overhead.py`` and ``scripts/exp_roll.py``."""

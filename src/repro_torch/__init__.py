"""PyTorch + CUDA port of the ACO system (``repro``), for one NVIDIA H100.

The layout mirrors ``repro``: ``core/`` holds the colony (sampling, TSP
substrate, pheromone, construction, the ACO engine), ``kernels/`` the
hand-written CUDA kernels for Hopper (``kernels/csrc``) with a plain
PyTorch version beside each.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (``device.resolve``).

This package imports torch and numpy only: never jax, never ``repro``.
"""

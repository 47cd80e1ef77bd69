"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 -m cudabench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout and prints one JSON result line.  Everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own, found
by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (the colony's settings, the
  service's) as it is run;
- ``workloads/<traffic>.json``: the traffic mix, parameters only, naming
  its driver;
- ``traffic/<driver>.py``: the drivers (a closed colony loop, an open-loop
  Poisson replayer);
- ``metrics/<metric>.py``: one reader per per-layer metric.

``reference/`` holds the plain reference that decides ``correct``;
``peaks.py`` the card's peaks and the kernels' operation counts.  Nothing
here imports ``jax`` or the JAX package ``repro``.
"""

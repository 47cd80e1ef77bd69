"""Sparse/paged problem representation: candidate-list-restricted storage,
construction and pheromone updates that never touch a dense (n, n) row.
The PyTorch port of ``repro.sparse``.

- ``store``:      SparseProblem / SparseColonyState, builders, lazy
                  distance pages, resident-byte accounting
- ``construct``:  candidate-page tour construction + Partial-ACO mutation
- ``pheromone``:  O(n·k) evaporation/deposit, overflow-slot adoption
- ``aco``:        sparse_colony_step / run_sparse drivers
"""
from . import aco, construct, pheromone, store                  # noqa: F401
from .aco import (init_sparse_colony, run_sparse,               # noqa: F401
                  sparse_colony_step)
from .store import (SparseColonyState, SparseProblem,           # noqa: F401
                    make_sparse_problem, resident_bytes)
